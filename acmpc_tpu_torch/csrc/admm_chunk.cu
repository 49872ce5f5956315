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

using admm::kThreads;
using admm::kWarps;

constexpr int kMaxCluster = 16;
constexpr unsigned kPieceBytes = 32768;  // one bulk copy, a multiple of 16
constexpr int kBarrierBytes = 32;         // four mbarriers

// Shared-memory layout of one CTA, in floats after the mbarriers:
// W slice | A slice | stacked [x; w] (n+m) | xt (n) | c0 rows | x rows |
// z, y, rho, 1/rho, l, u rows. Each slice reserves 3 floats for its
// alignment shift and is rounded to 4 floats, so every region after it
// stays 16-byte aligned.
struct Layout {
  int rows_w, rows_a;      // rows per CTA; the last CTAs may hold fewer
  long long w_slab, a_slab;
  long long bytes;
};

__host__ __device__ __forceinline__ long long round4(long long v) {
  return (v + 3) & ~3LL;
}

__host__ __device__ __forceinline__ Layout layout(int n, int m, int C) {
  Layout L;
  L.rows_w = (n + C - 1) / C;
  L.rows_a = (m + C - 1) / C;
  L.w_slab = round4((long long)L.rows_w * (n + m) + 3);
  L.a_slab = round4((long long)L.rows_a * n + 3);
  const long long floats = L.w_slab + L.a_slab + (n + m) + n +
                           2LL * L.rows_w + 6LL * L.rows_a;
  L.bytes = kBarrierBytes + 4 * floats;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// acquire at cluster scope: the xt and stacked barriers complete on
// stores from other CTAs
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// DSMEM store of one float that completes 4 bytes on the mbarrier `bar`
// of the same (remote) CTA
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// Copy src[0:count] to dst[0:count], where dst and src are congruent mod
// 16 bytes: the aligned middle by bulk copies completing on `bar` (thread
// 0 arms it, also when the middle is empty), head and tail by plain loads.
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           long long count, uint64_t* bar,
                                           int tid) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t g1 = g0 + 4 * (uintptr_t)count;
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15;
  const uintptr_t a1 = g1 & ~(uintptr_t)15;
  long long head = count, tail_from = count;
  uint32_t bulk = 0;
  if (a0 < a1) {
    head = (long long)((a0 - g0) / 4);
    tail_from = (long long)((a1 - g0) / 4);
    bulk = (uint32_t)(a1 - a0);
  }
  if (tid == 0) {
    mbar_expect_tx(bar, bulk);
    for (uint32_t off = 0; off < bulk; off += kPieceBytes) {
      const uint32_t size = min(kPieceBytes, bulk - off);
      bulk_copy(reinterpret_cast<char*>(dst + head) + off,
                reinterpret_cast<const char*>(src + head) + off, size, bar);
    }
  }
  for (long long i = tid; i < head; i += kThreads) dst[i] = src[i];
  for (long long i = tail_from + tid; i < count; i += kThreads) {
    dst[i] = src[i];
  }
}

// R rows of a row-major matrix in shared memory (rows row0, row0 + kWarps,
// ...) against v[0:len], one warp; epi(row, dot) on every lane per row.
template <int R, typename Epi>
__device__ __forceinline__ void dot_rows(const float* __restrict__ mat,
                                         int stride,
                                         const float* __restrict__ v, int len,
                                         int row0, int lane, Epi& epi) {
  const float* p[R];
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p[i] = mat + (size_t)(row0 + i * kWarps) * stride;
    acc[i] = 0.0f;
  }
#pragma unroll 4
  for (int k = lane; k < len; k += 32) {
    const float vk = v[k];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = fmaf(p[i][k], vk, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) epi(row0 + i * kWarps, admm::warp_sum(acc[i]));
}

// rows [0, rows) of mat against v: warp w takes rows w, w + kWarps, ...,
// four at a time
template <typename Epi>
__device__ __forceinline__ void gemv(const float* __restrict__ mat,
                                     int stride, const float* __restrict__ v,
                                     int len, int rows, int warp, int lane,
                                     Epi epi) {
  for (int row = warp; row < rows; row += 4 * kWarps) {
    const int left = (rows - row + kWarps - 1) / kWarps;
    if (left >= 4) {
      dot_rows<4>(mat, stride, v, len, row, lane, epi);
    } else if (left == 3) {
      dot_rows<3>(mat, stride, v, len, row, lane, epi);
    } else if (left == 2) {
      dot_rows<2>(mat, stride, v, len, row, lane, epi);
    } else {
      dot_rows<1>(mat, stride, v, len, row, lane, epi);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
admm_chunk_cluster_kernel(const float* __restrict__ W,
                          const float* __restrict__ A,
                          const float* __restrict__ c0,
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
                          int n_iters, float alpha, float one_minus_alpha) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_w = n + m;
  const Layout L = layout(n, m, C);
  // this CTA's rows: W (and x, xt) rows [wr0, wr0 + nw), A (and z, y)
  // rows [ar0, ar0 + na)
  const int wr0 = min(n, rank * L.rows_w);
  const int nw = min(n, wr0 + L.rows_w) - wr0;
  const int ar0 = min(m, rank * L.rows_a);
  const int na = min(m, ar0 + L.rows_a) - ar0;

  x_in += (size_t)b * n;
  x_out += (size_t)b * n;
  c0 += (size_t)b * n;
  const size_t vm = (size_t)b * m;
  z_in += vm;
  y_in += vm;
  z_out += vm;
  y_out += vm;
  rho += vm;
  lo += vm;
  hi += vm;

  if (active != nullptr && active[b] == 0) {
    for (int i = tid; i < nw; i += kThreads) x_out[wr0 + i] = x_in[wr0 + i];
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

  const float* W_src = W + ((size_t)b * n + wr0) * k_w;
  const float* A_src = A + ((size_t)b * m + ar0) * n;
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
    stacked[i] = i < n ? x_in[i] : rho[i - n] * z_in[i - n] - y_in[i - n];
  }
  for (int i = tid; i < nw; i += kThreads) {
    cs[i] = c0[wr0 + i];
    x_own[i] = x_in[wr0 + i];
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
  // own 4 n and 4 (n + m) bytes and never for a cluster-wide barrier.
  // Why one buffer of each is enough: a CTA stores the iteration's last
  // xt row only after all its warps have read the stacked vector, and its
  // last stacked row only after all its warps have read xt; a peer
  // overwrites either buffer only after it has received all of the other
  // from this CTA.
  for (int it = 0; it < n_iters; ++it) {
    // (a) this CTA's rows of xt = W [x; w] + c0, to every peer
    mbar_wait(it == 0 ? &bars[0] : bar_st, it == 0 ? 0 : (it - 1) & 1);
    if (tid == 0) {
      mbar_expect_tx(bar_xt, 4u * n);
      mbar_expect_tx(bar_st, 4u * k_w);
    }
    gemv(Ws, k_w, stacked, k_w, nw, warp, lane, [&](int i, float s) {
      const float xt_i = s + cs[i];
      if (lane < C) st_async(peer_xt + 4u * (wr0 + i), xt_i, peer_bar_xt);
      if (lane == 0) x_own[i] = alpha * xt_i + one_minus_alpha * x_own[i];
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
    // x row i was relaxed by lane 0 of warp i % kWarps in (a)
    __syncwarp();
    if (lane < C) {
      for (int i = warp; i < nw; i += kWarps) {
        st_async(peer_st + 4u * (wr0 + i), x_own[i], peer_bar_st);
      }
    }
  }
  if (n_iters > 0) mbar_wait(bar_st, (n_iters - 1) & 1);
  // nothing is in flight into any CTA's shared memory past this point
  cluster.sync();

  for (int i = tid; i < nw; i += kThreads) x_out[wr0 + i] = x_own[i];
  for (int j = tid; j < na; j += kThreads) {
    z_out[ar0 + j] = z[j];
    y_out[ar0 + j] = y[j];
  }
}

// A refused attribute is returned, and cleared from the runtime's last
// error so that it is not reported again by a later launch.
cudaError_t configure(int C, long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      admm_chunk_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && C > 8) {
    err = cudaFuncSetAttribute(admm_chunk_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int B, int C, long long smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * C));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// Dynamic shared memory of one CTA for a cluster of C CTAs, in bytes.
extern "C" long long admm_chunk_cluster_smem_bytes(int n, int m, int C) {
  return layout(n, m, C).bytes;
}

// How many clusters of C CTAs at (n, m) the card holds at once
// (cudaOccupancyMaxActiveClusters) into *count; returns a CUDA error code.
extern "C" int admm_chunk_cluster_max_active(int n, int m, int C, int* count) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  const long long smem = layout(n, m, C).bytes;
  cudaError_t err = configure(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, C, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(
      count, (const void*)admm_chunk_cluster_kernel, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launch B clusters of C CTAs on `stream`; returns a CUDA error code (0
// on success): that of a refused attribute or launch, else
// cudaGetLastError(). All pointers are device pointers; `active` may be
// null.
extern "C" int admm_chunk_cluster_launch(const float* W, const float* A,
                                         const float* c0, const float* rho,
                                         const float* lo, const float* hi,
                                         const float* x, const float* z,
                                         const float* y, const uint8_t* active,
                                         float* x_out, float* z_out,
                                         float* y_out, int B, int n, int m,
                                         int C, int n_iters, float alpha,
                                         float one_minus_alpha, void* stream) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  const long long smem = layout(n, m, C).bytes;
  cudaError_t err = configure(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, B, C, smem, stream);
  err = cudaLaunchKernelEx(&cfg, admm_chunk_cluster_kernel, W, A, c0, rho, lo,
                           hi, x, z, y, active, x_out, z_out, y_out, n, m,
                           n_iters, alpha, one_minus_alpha);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
