// Fused ADMM iteration chunk for Hopper (sm_90a), cluster variant: each
// scenario's operator lives in the shared memory of one thread-block
// cluster for the whole chunk.
//
// Replaces the TPU kernels acmpc_tpu/ops/pallas_admm.py::_admm_kernel
// (body _admm_body) and ::_admm_kernel_active: per scenario, n_iters
// relaxed ADMM iterations with a fixed operator,
//
//   xt = W [x; rho*z - y] + c0     W (n, n+m), row-major
//   zt = A xt                      A (m, n), row-major
//   x  = alpha xt + (1-alpha) x
//   zr = alpha zt + (1-alpha) z
//   z  = clip(zr + y * (1/rho), l, u)
//   y  = y + rho (zr - z)
//
// What bounds it on this card. Each iteration reads W and A once,
// 4 (n (n+m) + m n) bytes (1.04 MB per scenario at horizon 50: n = 248,
// m = 398) for 2 (n (n+m) + m n) flops, 0.5 flop per byte: bytes, and
// tensor cores have nothing to reuse. The TPU kernel keeps the operator
// in VMEM for the whole chunk; one block's 227 KB of shared memory cannot
// hold it, so a one-block-per-scenario design re-reads it from HBM every
// iteration (25 x 265 MB per chunk at B = 256), and at B = 1 puts the
// whole chain on one SM of 132.
//
// What the design does about it. A cluster of C CTAs holds one
// scenario: CTA r keeps a contiguous slice of W's rows and of A's rows in
// its shared memory (at horizon 50, C = 5: 50 + 80 rows, 210 KB; C = 8:
// 31 + 50 rows, 132 KB), loaded once per launch by bulk asynchronous
// copies (cp.async.bulk, completing on one mbarrier per operator, so the
// first GEMV starts while A still lands). HBM then moves each operator
// once per chunk, as on the TPU, and at small B the chain spreads over
// C SMs. Every CTA keeps the full stacked vector [x; w] and the full xt;
// each iteration has two phases:
//   (a) xt rows of this CTA = W slice [x; w] + c0, stored into every
//       peer's xt through distributed shared memory; x of these rows
//       relaxed in place;
//   (b) once all of xt has landed: zt rows = A slice xt, the z, y update
//       of these rows, and the new w rows and x rows stored into every
//       peer's stacked vector; phase (a) of the next iteration starts
//       once all of it has landed.
// The DSMEM stores are st.async, each completing its 4 bytes on an
// mbarrier of the receiving CTA, so a CTA waits only for the bytes it
// needs, and no iteration has a cluster-wide barrier, which would wait
// for the slowest CTA and for every store in flight. The GEMVs read
// shared memory only; a warp takes up to four rows at a time, so each
// load of the vector serves four rows. What is left per iteration is
// the latency of the dependent chain (GEMV, reduction, DSMEM stores,
// wait), which one resident CTA per SM does not hide
// (bench/chunk_sweep.py times it per iteration).
//
// The box block ([box] launches, g not null). Every caller's A ends in
// an identity over the n variables (the control QP's A = [A_eq; I], the
// raceline's A = I), which Ruiz scaling keeps diagonal: A_s = [A_d;
// diag(g)], m = m_d + n. Read densely, that block is n^2 floats of A and
// n^2 more of W (K^-1 diag(g), the same K^-1 as W's first block, stored
// twice), re-read every iteration. The [box] launch takes the operator
// as the QP's construction fixes it: W_s = [K^-1 | K^-1 A_d'] (n, n+m_d),
// A_d (m_d, n) and g (n,), and per iteration
//
//   xt   = W_s [sigma x + g (rho_b z_b - y_b); rho_d z_d - y_d] + c0
//   zt_d = A_d xt,   zt_b = g xt
//
// with relax, clip and the dual update as above over all m rows (the
// dense rows first, then the box rows). sigma stays out of the matrix:
// folding it in as (g / sigma) w_b would scale rounding by 1 / sigma.
// Box row i belongs to variable i, so the CTA that owns W row i updates
// it in phase (a), right after xt_i, and stores sigma x_i + g_i w_i in
// place of x_i in phase (b). Per scenario the operator shrinks from
// 1.04 MB to 0.54 MB at horizon 50 (C = 3 fits where 5 did), from 4.17
// to 2.19 MB at horizon 100 (a cluster of 10 where no 16 held it) and
// from 4.12 to 1.38 MB for the 586-point raceline; the exchange carries
// n + m_d floats instead of n + m. Where m_d = 0 no CTA reads xt in
// phase (b); the xt stores still go out, since a CTA's wait for them is
// what tells it that every peer has read the stacked vector it is about
// to overwrite.
//
// Bulk copies need 16-byte-aligned addresses and sizes. A W row is
// 4 (n + m) bytes (2,584 at horizon 50, not a multiple of 16), and the
// base pointers are only 4-byte aligned in general, so each slice lands
// at an offset in shared memory congruent to its global address mod 16:
// the aligned middle goes by bulk copy, a ragged head and tail of at most
// three floats each by plain loads. Any (n, m) works.
//
// active (nullable, one byte per scenario): where active[b] == 0 the
// whole cluster copies x, z, y through and returns before any DSMEM
// access. An active CTA waits for every store into it, then for a
// cluster barrier, before it exits, so no CTA exits while a peer may
// still write into it.

#include <cooperative_groups.h>

#include "admm_chunk_common.cuh"

namespace cg = cooperative_groups;

namespace {

using admm::gemv;
using admm::kThreads;
using admm::kWarps;
using admm::load_slice;
using admm::map_rank;
using admm::mbar_expect_tx;
using admm::mbar_init;
using admm::mbar_wait;
using admm::st_async;

constexpr int kMaxCluster = 16;
constexpr int kBarrierBytes = 32;  // four mbarriers

// Shared-memory layout of one CTA, in floats after the mbarriers:
// W slice | A slice | stacked [x; w] (n+m_d) | xt (n) | c0 rows | x rows |
// z, y, rho, 1/rho, l, u rows of A's slice | with the box block, g, z,
// y, rho, 1/rho, l, u and the stacked value of the W rows' box rows.
// Each slice reserves 3 floats for its alignment shift and is rounded to
// 4 floats, so every region after it stays 16-byte aligned.
struct Layout {
  int rows_w, rows_a;      // rows per CTA; the last CTAs may hold fewer
  long long w_slab, a_slab;
  long long bytes;
};

__host__ __device__ __forceinline__ long long round4(long long v) {
  return (v + 3) & ~3LL;
}

// m_d: A's rows (W has n + m_d columns); box: the box block's vectors
__host__ __device__ __forceinline__ Layout layout(int n, int m_d, int C,
                                                  bool box) {
  Layout L;
  L.rows_w = (n + C - 1) / C;
  L.rows_a = (m_d + C - 1) / C;
  L.w_slab = round4((long long)L.rows_w * (n + m_d) + 3);
  L.a_slab = round4((long long)L.rows_a * n + 3);
  const long long floats = L.w_slab + L.a_slab + (n + m_d) + n +
                           2LL * L.rows_w + 6LL * L.rows_a +
                           (box ? 8LL * L.rows_w : 0LL);
  L.bytes = kBarrierBytes + 4 * floats;
  return L;
}

template <bool kBox>
__global__ void __launch_bounds__(kThreads, 1)
admm_chunk_cluster_kernel(const float* __restrict__ W,
                          const float* __restrict__ A,
                          const float* __restrict__ c0,
                          const float* __restrict__ g,
                          const float* __restrict__ rho,
                          const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          const float* __restrict__ x_in,
                          const float* __restrict__ z_in,
                          const float* __restrict__ y_in,
                          const uint8_t* __restrict__ active,
                          float* __restrict__ x_out,
                          float* __restrict__ z_out,
                          float* __restrict__ y_out, int n, int m,
                          int n_iters, float alpha, float one_minus_alpha,
                          float sigma) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A's rows; with the box block, rows [m_d, m) of z, y, rho, l, u are
  // the box rows, row m_d + i that of variable i
  const int m_d = kBox ? m - n : m;
  const int k_w = n + m_d;
  const Layout L = layout(n, m_d, C, kBox);
  // this CTA's rows: W (and x, xt, box) rows [wr0, wr0 + nw), A (and z,
  // y) rows [ar0, ar0 + na)
  const int wr0 = min(n, rank * L.rows_w);
  const int nw = min(n, wr0 + L.rows_w) - wr0;
  const int ar0 = min(m_d, rank * L.rows_a);
  const int na = min(m_d, ar0 + L.rows_a) - ar0;

  x_in += (size_t)b * n;
  x_out += (size_t)b * n;
  c0 += (size_t)b * n;
  if (kBox) g += (size_t)b * n;
  const size_t vm = (size_t)b * m;
  z_in += vm;
  y_in += vm;
  z_out += vm;
  y_out += vm;
  rho += vm;
  lo += vm;
  hi += vm;

  if (active != nullptr && active[b] == 0) {
    for (int i = tid; i < nw; i += kThreads) {
      x_out[wr0 + i] = x_in[wr0 + i];
      if (kBox) {
        z_out[m_d + wr0 + i] = z_in[m_d + wr0 + i];
        y_out[m_d + wr0 + i] = y_in[m_d + wr0 + i];
      }
    }
    for (int j = tid; j < na; j += kThreads) {
      z_out[ar0 + j] = z_in[ar0 + j];
      y_out[ar0 + j] = y_in[ar0 + j];
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // mbarriers: the W and A loads, then xt and stacked, which complete
  // when every element of the iteration's vector has landed
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_xt = &bars[2];
  uint64_t* bar_st = &bars[3];
  float* w_region = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* a_region = w_region + L.w_slab;
  float* stacked = a_region + L.a_slab;
  float* xt = stacked + k_w;
  float* cs = xt + n;
  float* x_own = cs + L.rows_w;
  float* z = x_own + L.rows_w;
  float* y = z + L.rows_a;
  float* r = y + L.rows_a;
  float* inv_r = r + L.rows_a;
  float* l = inv_r + L.rows_a;
  float* h = l + L.rows_a;
  // the box rows of this CTA's W rows (kBox only)
  float* gb = h + L.rows_a;
  float* zb = gb + L.rows_w;
  float* yb = zb + L.rows_w;
  float* rb = yb + L.rows_w;
  float* inv_rb = rb + L.rows_w;
  float* lb = inv_rb + L.rows_w;
  float* hb = lb + L.rows_w;
  float* v_own = hb + L.rows_w;  // sigma x + g w of the row, to stack

  const float* W_src = W + ((size_t)b * n + wr0) * k_w;
  const float* A_src = A + ((size_t)b * m_d + ar0) * n;
  // slices congruent to their global addresses mod 16 bytes
  float* Ws = w_region + ((reinterpret_cast<uintptr_t>(W_src) >> 2) & 3);
  float* As = a_region + ((reinterpret_cast<uintptr_t>(A_src) >> 2) & 3);

  if (n_iters > 0) {
    if (tid == 0) {
      for (int i = 0; i < 4; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    load_slice(Ws, W_src, (long long)nw * k_w, &bars[0], tid);
    load_slice(As, A_src, (long long)na * n, &bars[1], tid);
  }

  for (int i = tid; i < k_w; i += kThreads) {
    if (i >= n) {
      stacked[i] = rho[i - n] * z_in[i - n] - y_in[i - n];
    } else if (kBox) {
      const int j = m_d + i;
      stacked[i] = sigma * x_in[i] + g[i] * (rho[j] * z_in[j] - y_in[j]);
    } else {
      stacked[i] = x_in[i];
    }
  }
  for (int i = tid; i < nw; i += kThreads) {
    cs[i] = c0[wr0 + i];
    x_own[i] = x_in[wr0 + i];
    if (kBox) {
      const int j = m_d + wr0 + i;
      const float rj = rho[j];
      gb[i] = g[wr0 + i];
      zb[i] = z_in[j];
      yb[i] = y_in[j];
      rb[i] = rj;
      inv_rb[i] = 1.0f / rj;
      lb[i] = lo[j];
      hb[i] = hi[j];
    }
  }
  for (int j = tid; j < na; j += kThreads) {
    const float rj = rho[ar0 + j];
    z[j] = z_in[ar0 + j];
    y[j] = y_in[ar0 + j];
    r[j] = rj;
    inv_r[j] = 1.0f / rj;
    l[j] = lo[ar0 + j];
    h[j] = hi[ar0 + j];
  }
  // every CTA of the cluster has started and initialised its barriers
  // and vectors before any DSMEM store
  cluster.sync();

  // lane p < C stores into peer p: the shared::cluster addresses of the
  // peer's xt, stacked vector and their barriers
  uint32_t peer_xt = 0, peer_st = 0, peer_bar_xt = 0, peer_bar_st = 0;
  if (lane < C) {
    peer_xt = map_rank(xt, lane);
    peer_st = map_rank(stacked, lane);
    peer_bar_xt = map_rank(bar_xt, lane);
    peer_bar_st = map_rank(bar_st, lane);
  }

  // Every element of xt and of the stacked vector is stored once per
  // iteration, by its owner, into every CTA, so each CTA waits for its
  // own 4 n and 4 (n + m_d) bytes and never for a cluster-wide barrier.
  // Why one buffer of each is enough: a CTA stores the iteration's last
  // xt row only after all its warps have read the stacked vector, and its
  // last stacked row only after all its warps have read xt; a peer
  // overwrites either buffer only after it has received all of the other
  // from this CTA.
  for (int it = 0; it < n_iters; ++it) {
    // (a) this CTA's rows of xt = W [x; w] + c0, to every peer; with the
    // box block, the update of each row's box row
    mbar_wait(it == 0 ? &bars[0] : bar_st, it == 0 ? 0 : (it - 1) & 1);
    if (tid == 0) {
      mbar_expect_tx(bar_xt, 4u * n);
      mbar_expect_tx(bar_st, 4u * k_w);
    }
    gemv(Ws, k_w, stacked, k_w, nw, warp, lane, [&](int i, float s) {
      const float xt_i = s + cs[i];
      if (lane < C) st_async(peer_xt + 4u * (wr0 + i), xt_i, peer_bar_xt);
      if (lane == 0) {
        x_own[i] = alpha * xt_i + one_minus_alpha * x_own[i];
        if constexpr (kBox) {
          const admm::RowUpdate u =
              admm::row_update(gb[i] * xt_i, zb[i], yb[i], rb[i], inv_rb[i],
                               lb[i], hb[i], alpha, one_minus_alpha);
          zb[i] = u.z;
          yb[i] = u.y;
          v_own[i] = sigma * x_own[i] + gb[i] * u.w;
        }
      }
    });

    // (b) this CTA's rows of zt = A xt, their z, y update, and the new w
    // and x rows to every peer's stacked vector
    mbar_wait(bar_xt, it & 1);
    if (it == 0) mbar_wait(&bars[1], 0);
    gemv(As, n, xt, n, na, warp, lane, [&](int j, float zt) {
      const admm::RowUpdate u = admm::row_update(
          zt, z[j], y[j], r[j], inv_r[j], l[j], h[j], alpha, one_minus_alpha);
      __syncwarp();
      if (lane == 0) {
        z[j] = u.z;
        y[j] = u.y;
      }
      if (lane < C) st_async(peer_st + 4u * (n + ar0 + j), u.w, peer_bar_st);
    });
    // x row i (and its box row) was updated by lane 0 of warp i % kWarps
    // in (a)
    __syncwarp();
    if (lane < C) {
      const float* own = kBox ? v_own : x_own;
      for (int i = warp; i < nw; i += kWarps) {
        st_async(peer_st + 4u * (wr0 + i), own[i], peer_bar_st);
      }
    }
  }
  if (n_iters > 0) mbar_wait(bar_st, (n_iters - 1) & 1);
  // nothing is in flight into any CTA's shared memory past this point
  cluster.sync();

  for (int i = tid; i < nw; i += kThreads) {
    x_out[wr0 + i] = x_own[i];
    if (kBox) {
      z_out[m_d + wr0 + i] = zb[i];
      y_out[m_d + wr0 + i] = yb[i];
    }
  }
  for (int j = tid; j < na; j += kThreads) {
    z_out[ar0 + j] = z[j];
    y_out[ar0 + j] = y[j];
  }
}

// The kernel of a launch with or without the box block, its layout, or
// false where the arguments are out of range.
bool checked(int n, int m, int C, int box, Layout* L, const void** fn) {
  if (C < 1 || C > kMaxCluster || n < 1 || m < 0 || (box && m < n)) {
    return false;
  }
  *L = layout(n, box ? m - n : m, C, box != 0);
  *fn = box ? (const void*)admm_chunk_cluster_kernel<true>
            : (const void*)admm_chunk_cluster_kernel<false>;
  return true;
}

}  // namespace

// Dynamic shared memory of one CTA for a cluster of C CTAs, in bytes;
// box != 0: A is the m - n rows of A_d and W has n + m - n columns.
extern "C" long long admm_chunk_cluster_smem_bytes(int n, int m, int C,
                                                   int box) {
  return layout(n, box ? m - n : m, C, box != 0).bytes;
}

// How many clusters of C CTAs at (n, m) the card holds at once
// (cudaOccupancyMaxActiveClusters) into *count; returns a CUDA error code.
extern "C" int admm_chunk_cluster_max_active(int n, int m, int C, int box,
                                             int* count) {
  Layout L;
  const void* fn;
  if (!checked(n, m, C, box, &L, &fn)) return (int)cudaErrorInvalidValue;
  cudaError_t err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, 1, C, kThreads, L.bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launch B clusters of C CTAs on `stream`; returns a CUDA error code (0
// on success): that of a refused attribute or launch, else
// cudaGetLastError(). All pointers are device pointers; `active` may be
// null, and `g` is null for a dense operator (sigma is then unused).
extern "C" int admm_chunk_cluster_launch(
    const float* W, const float* A, const float* c0, const float* g,
    const float* rho, const float* lo, const float* hi, const float* x,
    const float* z, const float* y, const uint8_t* active, float* x_out,
    float* z_out, float* y_out, int B, int n, int m, int C, int n_iters,
    float alpha, float one_minus_alpha, float sigma, void* stream) {
  Layout L;
  const void* fn;
  const int box = g != nullptr;
  if (!checked(n, m, C, box, &L, &fn)) return (int)cudaErrorInvalidValue;
  cudaError_t err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, B, C, kThreads, L.bytes, stream);
  if (box) {
    err = cudaLaunchKernelEx(&cfg, admm_chunk_cluster_kernel<true>, W, A, c0,
                             g, rho, lo, hi, x, z, y, active, x_out, z_out,
                             y_out, n, m, n_iters, alpha, one_minus_alpha,
                             sigma);
  } else {
    err = cudaLaunchKernelEx(&cfg, admm_chunk_cluster_kernel<false>, W, A, c0,
                             g, rho, lo, hi, x, z, y, active, x_out, z_out,
                             y_out, n, m, n_iters, alpha, one_minus_alpha,
                             sigma);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
