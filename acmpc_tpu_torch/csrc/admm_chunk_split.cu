// Fused ADMM iteration chunk for Hopper (sm_90a), split variant: for
// operators that no thread-block cluster holds whole in shared memory.
// Each scenario's operator is split over a cluster of C CTAs; every CTA
// keeps as many of its rows in shared memory as fit and streams the rest
// from L2 every iteration through a ring of shared-memory stages.
//
// Replaces the TPU kernels acmpc_tpu/ops/pallas_admm.py::_admm_kernel
// (body _admm_body) and ::_admm_kernel_active for horizons above 92 (the
// mapping control at horizon 100: n = 498, m = 798, a 4.17 MB operator
// per scenario, where a cluster of 16 would need 274 KB per CTA against
// 227 KB). The function is that of admm_chunk.cu; see there.
//
// What bounds it on this card: bytes. Each iteration reads W and A once,
// 4 (n (n+m) + m n) bytes for 2 (n (n+m) + m n) flops, 0.5 flop per byte.
//
// The box block ([box] launches, g not null), as in admm_chunk.cu: the
// operator arrives as W_s = [K^-1 | K^-1 A_d'] (n, n + m_d), A_d (m_d, n)
// and the diagonal g of the box rows, and the CTA that owns W row i
// updates box row i in phase (a). Only W_s's and A_d's rows are resident
// or streamed. Every plan since the box block took the control QPs into
// clusters serves one such shape: the raceline at 1,953 points (n = 1,953,
// m_d = 0), 15.3 MB of W_s an iteration across its 16 CTAs where the
// dense operator was 45.8 MB; a CTA holds 22 of its 123 rows and streams
// the rest.
//
// What the design does about it. As in admm_chunk.cu, CTA r of the
// cluster owns a contiguous slice of W's rows and of A's rows, the
// vectors move between CTAs by st.async stores onto each receiver's
// mbarriers, and each iteration has the phases (a) xt = W [x; w] + c0 and
// (b) zt = A xt with the z, y update. Of its slices a CTA keeps the head
// rows resident: res_w rows of W and res_a of A (the layout keeps W whole
// first and gives up A rows before W rows: an A row is 2.6x shorter, so a
// ring stage holds several and more warps share each stage), loaded once
// per launch by bulk copies, so HBM moves most of the operator once per
// chunk. The tail rows are read again every iteration, from L2 (the
// batch's operators, 33 MB at B = 8, fit its 50 MB), through a ring of S
// stages, each a group of whole rows of one matrix:
//   - one producer warp (its lane 0) walks the fixed sequence of stages,
//     iteration after iteration: W tail stages, then A tail stages. It
//     refills a stage as soon as its "empty" mbarrier says every consumer
//     warp has released it, by cp.async.bulk completing on the stage's
//     "full" mbarrier. The operator is the same every iteration, so the
//     next phase's first S stages are in flight while the current phase's
//     GEMV and its DSMEM wait run;
//   - the 16 consumer warps own rows round-robin, resident rows first and
//     streamed rows after them, so each warp holds at most one row of a
//     stage (a stage has at most 16 rows). A warp takes its rows of the
//     ring's first S stages first (they are already there), then its
//     resident rows, then its later stages. The empty barrier expects 16
//     arrivals: each owner warp arrives once, the owner of the stage's last
//     row for the rows the stage lacks, so one count fits every stage;
//   - a warp waits only on the stages it owns, so it may reach a slot's
//     next use while the slot's previous use, owned by other warps, is
//     still in flight, and a parity wait would then take the previous
//     phase for its own. The producer therefore publishes each slot's fill
//     number once it has issued it (its previous use then released, so
//     complete), and an owner waits for that number before it waits on
//     the full barrier, which is then at most one phase ahead.
//
// Bulk copies need 16-byte-aligned addresses and sizes; rows are 4 n or
// 4 (n + m) bytes, and base pointers only 4-byte aligned. A stage lands at
// an offset in its ring slot congruent to its global address mod 16. Its
// aligned middle goes by bulk copy; its ragged head and tail (at most 3
// floats each, or the whole stage when it is under 32 bytes) are the same
// every iteration, so they are loaded once into an edge table in shared
// memory and the producer writes them into the slot before arming it.
// The resident slices land as in admm_chunk.cu.
//
// active (nullable, one byte per scenario): where active[b] == 0 the whole
// cluster copies x, z, y through and returns before any DSMEM access or
// copy. An active CTA consumes every stage the producer issues, waits for
// every store into it, then for a cluster barrier, before it exits, so no
// copy or peer store into a CTA is in flight when it exits.

#include <cooperative_groups.h>

#include <algorithm>

#include "admm_chunk_common.cuh"

namespace cg = cooperative_groups;

namespace {

using admm::bulk_copy;
using admm::dot_rows;
using admm::gemv;
using admm::kPieceBytes;
using admm::kThreads;  // the consumer warps
using admm::kWarps;
using admm::load_slice;
using admm::map_rank;
using admm::mbar_arrive;
using admm::mbar_expect_tx;
using admm::mbar_init;
using admm::mbar_init_count;
using admm::mbar_wait;
using admm::st_async;

constexpr int kBlock = kThreads + 32;  // 16 consumer warps + the producer
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 16;
constexpr int kEdgeFloats = 8;  // a stage's ragged head and tail
constexpr long long kSmemPerBlock = 232448;

__host__ __device__ __forceinline__ long long round4(long long v) {
  return (v + 3) & ~3LL;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Shared-memory layout of one CTA: 4 + 2 S mbarriers and S fill numbers
// (8 bytes each, rounded to 16 bytes), then in floats:
// resident W rows | resident A rows | S ring slots | edge table |
// stacked [x; w] (n+m_d) | xt (n) | c0 rows | x rows | z, y, rho, 1/rho,
// l, u rows of A's slice | with the box block, g, z, y, rho, 1/rho, l, u
// and the stacked value of the W rows' box rows. Resident regions reserve 3 floats for their alignment shift
// and are rounded to 4 floats, as are the slots, so every region stays
// 16-byte aligned. Computed on the host and passed to the kernel.
struct Layout {
  int rows_w, rows_a;            // rows per CTA; the last CTAs may hold fewer
  int res_w, res_a;              // of those, rows held in shared memory
  int stage_floats;              // one ring slot
  int per_stage_w, per_stage_a;  // whole rows of W or A in one stage
  int stages;                    // S, slots in the ring
  int max_streamed;              // stages per iteration, CTA with most rows
  long long w_slab, a_slab, edges, bar_bytes, bytes;
};

// m_d: A's rows (W has n + m_d columns); box: the box block's vectors
Layout layout_with(int n, int m_d, int C, int S, int stage_bytes, bool box,
                   int res_w, int res_a) {
  const int k_w = n + m_d;
  Layout L;
  L.rows_w = ceil_div(n, C);
  L.rows_a = ceil_div(m_d, C);
  L.res_w = res_w;
  L.res_a = res_a;
  L.stages = S;
  L.stage_floats =
      (int)round4(std::max((long long)stage_bytes / 4, (long long)k_w + 3));
  L.per_stage_w = std::min(kWarps, (L.stage_floats - 3) / k_w);
  L.per_stage_a = std::min(kWarps, (L.stage_floats - 3) / n);
  L.max_streamed = ceil_div(L.rows_w - res_w, L.per_stage_w) +
                   ceil_div(L.rows_a - res_a, L.per_stage_a);
  L.w_slab = round4((long long)res_w * k_w + 3);
  L.a_slab = round4((long long)res_a * n + 3);
  L.edges = (long long)kEdgeFloats * L.max_streamed;
  L.bar_bytes = (8LL * (4 + 3 * S) + 15) / 16 * 16;
  const long long floats = L.w_slab + L.a_slab +
                           (long long)S * L.stage_floats + L.edges + k_w + n +
                           2LL * L.rows_w + 6LL * L.rows_a +
                           (box ? 8LL * L.rows_w : 0LL);
  L.bytes = L.bar_bytes + 4 * floats;
  return L;
}

// The most resident rows that fit: all of W and A, then one A row fewer
// at a time, then one W row fewer at a time. bytes > kSmemPerBlock where
// not even the vectors and the ring fit.
Layout layout(int n, int m_d, int C, int S, int stage_bytes, bool box) {
  int res_w = ceil_div(n, C), res_a = ceil_div(m_d, C);
  Layout L = layout_with(n, m_d, C, S, stage_bytes, box, res_w, res_a);
  while (L.bytes > kSmemPerBlock && (res_a > 0 || res_w > 0)) {
    if (res_a > 0) {
      --res_a;
    } else {
      --res_w;
    }
    L = layout_with(n, m_d, C, S, stage_bytes, box, res_w, res_a);
  }
  return L;
}

// A run of `count` floats at `src`, split at its 16-byte boundaries:
// floats [0, head) and [tail_from, count) go by plain loads, the middle
// (`bulk` bytes, from src + head) by bulk copy.
struct Ragged {
  int head, tail_from;
  uint32_t bulk;
};

__device__ __forceinline__ Ragged ragged(const float* src, int count) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t g1 = g0 + 4 * (uintptr_t)count;
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15;
  const uintptr_t a1 = g1 & ~(uintptr_t)15;
  if (a0 >= a1) return {count, count, 0u};  // under 32 bytes
  return {(int)((a0 - g0) / 4), (int)((a1 - g0) / 4), (uint32_t)(a1 - a0)};
}

// floats of a stage's slot before its first row: its global address mod
// 16, so that the aligned middle lands 16-byte aligned
__device__ __forceinline__ int shift_of(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// The streamed tail of one slice: rows [0, rows) after the resident ones,
// `per_stage` to a stage; stage s starts at src + s * per_stage * stride.
struct Tail {
  const float* src;
  int stride, rows, per_stage, stages;

  __device__ __forceinline__ const float* stage_src(int s) const {
    return src + (size_t)s * per_stage * stride;
  }
  __device__ __forceinline__ int stage_rows(int s) const {
    return min(per_stage, rows - s * per_stage);
  }
};

// Stage s of an iteration, W's tail stages first: its first float in
// global memory and its length in floats.
struct Run {
  const float* src;
  int count;
};

__device__ __forceinline__ Run stage_run(const Tail& tw, const Tail& ta,
                                         int s) {
  if (s < tw.stages) return {tw.stage_src(s), tw.stage_rows(s) * tw.stride};
  s -= tw.stages;
  return {ta.stage_src(s), ta.stage_rows(s) * ta.stride};
}

// This warp's streamed rows of one phase whose stage index lies in
// [s_lo, s_hi), in order. Row j of the tail is the slice's row res + j and
// belongs to warp (res + j) % kWarps. Stage s of the phase is the ring's
// fill number q0 + s: slot q % S, the (q / S)-th use of that slot. The
// warp waits until the producer has issued fill q (filled[slot] == q),
// then on the slot's full barrier; it arrives on the slot's empty barrier
// once it has read its row, the owner of the stage's last row for the
// rows the stage lacks.
template <typename Epi>
__device__ __forceinline__ void stream_rows(
    const Tail& t, int res, const float* ring, uint64_t* full,
    uint64_t* empty, const volatile int* filled, const Layout& L, int q0,
    int s_lo, int s_hi, const float* __restrict__ v, int len, int warp,
    int lane, Epi& epi) {
  int j = (warp - res % kWarps + kWarps) % kWarps;
  for (; j < t.rows; j += kWarps) {
    const int s = j / t.per_stage;
    if (s < s_lo) continue;
    if (s >= s_hi) break;
    const int q = q0 + s;
    const int slot = q % L.stages;
    while (filled[slot] != q) {
    }
    mbar_wait(&full[slot], (uint32_t)((q / L.stages) & 1));
    const float* buf = ring + (size_t)slot * L.stage_floats +
                       shift_of(t.stage_src(s));
    const int row = j - s * t.per_stage;
    auto at_row = [&](int, float dot) { epi(res + j, dot); };
    dot_rows<1>(buf, t.stride, v, len, row, lane, at_row);
    __syncwarp();
    if (lane == 0) {
      const int rows = t.stage_rows(s);
      const bool last = row == rows - 1;
      mbar_arrive(&empty[slot], last ? (uint32_t)(kWarps - rows + 1) : 1u);
    }
  }
}

template <bool kBox>
__global__ void __launch_bounds__(kBlock, 1)
admm_chunk_split_kernel(const float* __restrict__ W,
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
                        float* __restrict__ x_out, float* __restrict__ z_out,
                        float* __restrict__ y_out, int n, int m, int n_iters,
                        float alpha, float one_minus_alpha, float sigma,
                        Layout L) {
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
  const int S = L.stages;
  // this CTA's rows: W (and x, xt, box) rows [wr0, wr0 + nw), A (and z,
  // y) rows [ar0, ar0 + na); the first rw and ra of them resident
  const int wr0 = min(n, rank * L.rows_w);
  const int nw = min(n, wr0 + L.rows_w) - wr0;
  const int ar0 = min(m_d, rank * L.rows_a);
  const int na = min(m_d, ar0 + L.rows_a) - ar0;
  const int rw = min(nw, L.res_w);
  const int ra = min(na, L.res_a);

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
    for (int i = tid; i < nw; i += kBlock) {
      x_out[wr0 + i] = x_in[wr0 + i];
      if (kBox) {
        z_out[m_d + wr0 + i] = z_in[m_d + wr0 + i];
        y_out[m_d + wr0 + i] = y_in[m_d + wr0 + i];
      }
    }
    for (int j = tid; j < na; j += kBlock) {
      z_out[ar0 + j] = z_in[ar0 + j];
      y_out[ar0 + j] = y_in[ar0 + j];
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // mbarriers: the resident W and A loads, xt and stacked (complete when
  // every element of the iteration's vector has landed), then the ring's
  // full and empty barriers; then the fill number last issued to each
  // slot
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_xt = &bars[2];
  uint64_t* bar_st = &bars[3];
  uint64_t* full = &bars[4];
  uint64_t* empty = full + S;
  volatile int* filled = reinterpret_cast<volatile int*>(empty + S);
  float* w_region = reinterpret_cast<float*>(smem_raw + L.bar_bytes);
  float* a_region = w_region + L.w_slab;
  float* ring = a_region + L.a_slab;
  float* edges = ring + (size_t)S * L.stage_floats;
  float* stacked = edges + L.edges;
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
  // resident slices congruent to their global addresses mod 16 bytes
  float* Ws = w_region + shift_of(W_src);
  float* As = a_region + shift_of(A_src);
  const Tail tail_w{W_src + (size_t)rw * k_w, k_w, nw - rw, L.per_stage_w,
                    ceil_div(nw - rw, L.per_stage_w)};
  const Tail tail_a{A_src + (size_t)ra * n, n, na - ra, L.per_stage_a,
                    ceil_div(na - ra, L.per_stage_a)};
  // stages per iteration: W's tail, then A's
  const int T = tail_w.stages + tail_a.stages;

  if (n_iters > 0) {
    if (tid == 0) {
      for (int i = 0; i < 4; ++i) mbar_init(&bars[i]);
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i]);
        mbar_init_count(&empty[i], kWarps);
        filled[i] = -1;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid < kThreads) {
      load_slice(Ws, W_src, (long long)rw * k_w, &bars[0], tid);
      load_slice(As, A_src, (long long)ra * n, &bars[1], tid);
    }
    // the edge table: each stage's ragged head at [0, 4), tail at [4, 8)
    for (int s = tid; s < T; s += kBlock) {
      const Run run = stage_run(tail_w, tail_a, s);
      const Ragged g = ragged(run.src, run.count);
      float* e = edges + kEdgeFloats * s;
      for (int i = 0; i < g.head; ++i) e[i] = run.src[i];
      for (int i = g.tail_from; i < run.count; ++i) {
        e[4 + i - g.tail_from] = run.src[i];
      }
    }
  }

  for (int i = tid; i < k_w; i += kBlock) {
    if (i >= n) {
      stacked[i] = rho[i - n] * z_in[i - n] - y_in[i - n];
    } else if (kBox) {
      const int j = m_d + i;
      stacked[i] = sigma * x_in[i] + g[i] * (rho[j] * z_in[j] - y_in[j]);
    } else {
      stacked[i] = x_in[i];
    }
  }
  for (int i = tid; i < nw; i += kBlock) {
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
  for (int j = tid; j < na; j += kBlock) {
    const float rj = rho[ar0 + j];
    z[j] = z_in[ar0 + j];
    y[j] = y_in[ar0 + j];
    r[j] = rj;
    inv_r[j] = 1.0f / rj;
    l[j] = lo[ar0 + j];
    h[j] = hi[ar0 + j];
  }
  // every CTA of the cluster has started and initialised its barriers,
  // edge table and vectors before any DSMEM store or ring copy
  cluster.sync();

  if (warp == kWarps) {
    // the producer: fill number q = it * T + s is stage s of iteration it,
    // into slot q % S once the slot's previous use has been released
    if (lane == 0) {
      for (int it = 0; it < n_iters; ++it) {
        for (int s = 0; s < T; ++s) {
          const int q = it * T + s;
          const int slot = q % S;
          const int use = q / S;
          if (use > 0) mbar_wait(&empty[slot], (uint32_t)((use - 1) & 1));
          const Run run = stage_run(tail_w, tail_a, s);
          const Ragged g = ragged(run.src, run.count);
          float* dst =
              ring + (size_t)slot * L.stage_floats + shift_of(run.src);
          const float* e = edges + kEdgeFloats * s;
          for (int i = 0; i < g.head; ++i) dst[i] = e[i];
          for (int i = g.tail_from; i < run.count; ++i) {
            dst[i] = e[4 + i - g.tail_from];
          }
          // these generic stores, and those of earlier uses of the slot,
          // before the bulk copy's async-proxy writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(&full[slot], g.bulk);
          for (uint32_t off = 0; off < g.bulk; off += kPieceBytes) {
            bulk_copy(reinterpret_cast<char*>(dst + g.head) + off,
                      reinterpret_cast<const char*>(run.src + g.head) + off,
                      min(kPieceBytes, g.bulk - off), &full[slot]);
          }
          filled[slot] = q;
        }
      }
    }
    __syncwarp();
  } else {
    // lane p < C stores into peer p: the shared::cluster addresses of the
    // peer's xt, stacked vector and their barriers
    uint32_t peer_xt = 0, peer_st = 0, peer_bar_xt = 0, peer_bar_st = 0;
    if (lane < C) {
      peer_xt = map_rank(xt, lane);
      peer_st = map_rank(stacked, lane);
      peer_bar_xt = map_rank(bar_xt, lane);
      peer_bar_st = map_rank(bar_st, lane);
    }
    auto xt_row = [&](int i, float s) {
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
    };
    auto z_row = [&](int j, float zt) {
      const admm::RowUpdate u = admm::row_update(
          zt, z[j], y[j], r[j], inv_r[j], l[j], h[j], alpha, one_minus_alpha);
      __syncwarp();
      if (lane == 0) {
        z[j] = u.z;
        y[j] = u.y;
      }
      if (lane < C) st_async(peer_st + 4u * (n + ar0 + j), u.w, peer_bar_st);
    };

    // One buffer of xt and of the stacked vector is enough, as in
    // admm_chunk.cu: a CTA stores the iteration's last xt row only after
    // all its warps have read the stacked vector, and its last stacked
    // row only after all its warps have read xt.
    for (int it = 0; it < n_iters; ++it) {
      const int q = it * T;
      // (a) this CTA's rows of xt = W [x; w] + c0, to every peer
      mbar_wait(it == 0 ? &bars[0] : bar_st, it == 0 ? 0 : (it - 1) & 1);
      if (tid == 0) {
        mbar_expect_tx(bar_xt, 4u * n);
        mbar_expect_tx(bar_st, 4u * k_w);
      }
      stream_rows(tail_w, rw, ring, full, empty, filled, L, q, 0, S, stacked, k_w,
                  warp, lane, xt_row);
      gemv(Ws, k_w, stacked, k_w, rw, warp, lane, xt_row);
      stream_rows(tail_w, rw, ring, full, empty, filled, L, q, S, tail_w.stages,
                  stacked, k_w, warp, lane, xt_row);

      // (b) this CTA's rows of zt = A xt, their z, y update, and the new
      // w and x rows to every peer's stacked vector
      mbar_wait(bar_xt, it & 1);
      if (it == 0) mbar_wait(&bars[1], 0);
      const int qa = q + tail_w.stages;
      stream_rows(tail_a, ra, ring, full, empty, filled, L, qa, 0, S, xt, n, warp,
                  lane, z_row);
      gemv(As, n, xt, n, ra, warp, lane, z_row);
      stream_rows(tail_a, ra, ring, full, empty, filled, L, qa, S, tail_a.stages, xt,
                  n, warp, lane, z_row);
      // x row i (and its box row) was updated by lane 0 of its owner
      // warp in (a): warp i % kWarps owns row i, resident or streamed
      __syncwarp();
      if (lane < C) {
        const float* own = kBox ? v_own : x_own;
        for (int i = warp; i < nw; i += kWarps) {
          st_async(peer_st + 4u * (wr0 + i), own[i], peer_bar_st);
        }
      }
    }
    if (n_iters > 0) mbar_wait(bar_st, (n_iters - 1) & 1);
  }
  // nothing is in flight into any CTA's shared memory past this point:
  // every stage issued was consumed, every store into this CTA landed
  cluster.sync();

  for (int i = tid; i < nw; i += kBlock) {
    x_out[wr0 + i] = x_own[i];
    if (kBox) {
      z_out[m_d + wr0 + i] = zb[i];
      y_out[m_d + wr0 + i] = yb[i];
    }
  }
  for (int j = tid; j < na; j += kBlock) {
    z_out[ar0 + j] = z[j];
    y_out[ar0 + j] = y[j];
  }
}

// The layout and kernel of a launch, or cudaErrorInvalidValue where the
// arguments are out of range or not even the vectors and the ring fit;
// box != 0: A is the m - n rows of A_d and W has n + m - n columns.
cudaError_t checked_layout(int n, int m, int C, int S, int stage_bytes,
                           int box, Layout* L, const void** fn) {
  if (C < 1 || C > kMaxCluster || S < 1 || S > kMaxStages ||
      stage_bytes < 16 || n < 1 || m < 0 || (box ? m < n : m < 1)) {
    return cudaErrorInvalidValue;
  }
  *L = layout(n, box ? m - n : m, C, S, stage_bytes, box != 0);
  *fn = box ? (const void*)admm_chunk_split_kernel<true>
            : (const void*)admm_chunk_split_kernel<false>;
  return L->bytes > kSmemPerBlock ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes, for clusters of C CTAs and
// a ring of S stages of stage_bytes (at least one W row); above 232,448
// where nothing fits.
extern "C" long long admm_chunk_split_smem_bytes(int n, int m, int C, int S,
                                                 int stage_bytes, int box) {
  return layout(n, box ? m - n : m, C, S, stage_bytes, box != 0).bytes;
}

// Rows of the W slice and of the A slice each CTA holds in shared memory.
extern "C" void admm_chunk_split_resident_rows(int n, int m, int C, int S,
                                               int stage_bytes, int box,
                                               int* res_w, int* res_a) {
  const Layout L = layout(n, box ? m - n : m, C, S, stage_bytes, box != 0);
  *res_w = L.res_w;
  *res_a = L.res_a;
}

// How many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) into *count; returns a CUDA error code.
extern "C" int admm_chunk_split_max_active(int n, int m, int C, int S,
                                           int stage_bytes, int box,
                                           int* count) {
  Layout L;
  const void* fn;
  cudaError_t err = checked_layout(n, m, C, S, stage_bytes, box, &L, &fn);
  if (err != cudaSuccess) return (int)err;
  err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, 1, C, kBlock, L.bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launch B clusters of C CTAs on `stream`; returns a CUDA error code (0
// on success): that of a refused layout, attribute or launch, else
// cudaGetLastError(). All pointers are device pointers; `active` may be
// null, and `g` is null for a dense operator (sigma is then unused).
extern "C" int admm_chunk_split_launch(
    const float* W, const float* A, const float* c0, const float* g,
    const float* rho, const float* lo, const float* hi, const float* x,
    const float* z, const float* y, const uint8_t* active, float* x_out,
    float* z_out, float* y_out, int B, int n, int m, int C, int S,
    int stage_bytes, int n_iters, float alpha, float one_minus_alpha,
    float sigma, void* stream) {
  Layout L;
  const void* fn;
  const int box = g != nullptr;
  cudaError_t err = checked_layout(n, m, C, S, stage_bytes, box, &L, &fn);
  if (err != cudaSuccess) return (int)err;
  err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, B, C, kBlock, L.bytes, stream);
  if (box) {
    err = cudaLaunchKernelEx(&cfg, admm_chunk_split_kernel<true>, W, A, c0, g,
                             rho, lo, hi, x, z, y, active, x_out, z_out,
                             y_out, n, m, n_iters, alpha, one_minus_alpha,
                             sigma, L);
  } else {
    err = cudaLaunchKernelEx(&cfg, admm_chunk_split_kernel<false>, W, A, c0,
                             g, rho, lo, hi, x, z, y, active, x_out, z_out,
                             y_out, n, m, n_iters, alpha, one_minus_alpha,
                             sigma, L);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
