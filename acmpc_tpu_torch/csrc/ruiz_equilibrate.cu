// Ruiz equilibration of a batch of QPs for Hopper (sm_90a): one
// thread-block cluster a lane, every pass in one launch.
//
// Replaces no TPU kernel: the JAX package leaves
// acmpc_tpu/qp/admm.py::_ruiz_equilibrate (l.126) to XLA, and its plain
// PyTorch version (ops/ruiz.py::ruiz_equilibrate_reference) launches some
// 31 kernels a pass, each reading or writing a whole (B, n, n) or
// (B, m, n) matrix. Per lane, n_iters passes of
//
//   dd = 1 / sqrt(clamp(max(colmax|P|, colmax|A|), lo, hi))     (n,)
//   ee = 1 / sqrt(clamp(rowmax|A|, lo, hi))                      (m,)
//   P = (P dd_i) dd_j,  q = q dd,  A = (A ee_i) dd_j,  d = d dd,  e = e ee
//   g = 1 / clamp(max(mean_j colmax|P|, max|q|), lo, hi)
//   P = P g,  q = q g,  c = c g
//
// What bounds it on this card. The least work is P and A read once and
// P_s and A_s written once: 8 (n^2 + m n) bytes a lane (1.28 MB at
// horizon 50, n = 248, m = 398; 328 MB at B = 256, 0.098 ms at
// 3.35 TB/s); the passes' arithmetic (three multiplies, an abs and two
// max a matrix element) is below the bytes' time. The plain version
// moves both matrices through device memory a dozen times a pass.
//
// What the design does about it. A cluster of C CTAs holds one lane: CTA
// r owns a contiguous slab of P's rows and of A's rows (a resident plan
// keeps both in its shared memory for all the passes, loaded once by
// bulk copies, as the chunk kernels load their operator), so device
// memory sees P and A once in and once out. One pass is one sweep over
// each slab that scales it in place and, in the same read, takes the
// column maxima (and A's row maxima) of the scaled values that the next
// pass needs; the column maxima meet across the cluster through
// distributed shared memory, one cluster barrier a pass. The cost
// normalisation needs no second sweep: for g > 0 rounding is monotonic,
// so colmax|fl(g P)| = fl(g colmax|P|) bit for bit, and the next pass's
// sweep applies g together with its own dd (P = ((P g) dd_i) dd_j,
// rounded after each product, as the plain version rounds). The last g
// is applied as P_s is written out. Where no cluster of 16 holds a lane
// (the raceline at 1,953 points: 30.5 MB), the streamed plan runs the
// same passes on the slabs in device memory (P_s and A_s, in place after
// the first pass), where they stay in L2 while the lane's cluster works.
//
// Rounding. Every product, square root and division is the IEEE-rounded
// operation the plain version takes (no --use_fast_math; __fmul_rn keeps
// products out of fused multiply-adds), and maxima are exact. The mean
// over n is the one step that differs from PyTorch's CUDA reduction, in
// two ways: its summation order (here per thread, then across a warp,
// then across the warps), and its division, a true sum / n where
// PyTorch's mean multiplies the sum by a rounded 1 / n (an ulp apart at
// most, even where the sums agree). NaN
// propagates as torch.amax, torch.maximum and torch.clamp propagate it:
// maxima are taken on the bits of |x|, where a NaN is above +inf.

#include <cooperative_groups.h>

#include "admm_chunk_common.cuh"

namespace cg = cooperative_groups;

namespace {

using admm::kThreads;
using admm::kWarps;
using admm::load_slice;
using admm::mbar_init;
using admm::mbar_wait;

constexpr int kMaxCluster = 16;
constexpr int kBarrierBytes = 16;  // two mbarriers: the P and A slabs
// a sweep takes kBlockCols columns at a time, kCols to a lane
constexpr int kCols = 8;
constexpr int kBlockCols = 32 * kCols;
constexpr uint32_t kAbs = 0x7fffffffu;
constexpr uint32_t kNaN = 0x7fffffffu;

// Shared-memory layout of one CTA, in floats after the mbarriers: the P
// slab | the A slab (a resident plan only; each with 3 floats of room for
// its alignment shift, rounded to 4 floats) | dd (between passes the
// reduced column maxima of P), the reduced column maxima of A, q, d (n
// each) | the CTA's column maxima of P and of A, two buffers of each
// (4 n) | row maxima, ee and e of the A rows | 2 kWarps of scratch.
struct Layout {
  int rows_p, rows_a;  // rows per CTA; the last CTAs may hold fewer
  long long p_slab, a_slab;
  long long bytes;
};

__host__ __device__ __forceinline__ long long round4(long long v) {
  return (v + 3) & ~3LL;
}

__host__ __device__ __forceinline__ Layout layout(int n, int m, int C,
                                                  bool resident) {
  Layout L;
  L.rows_p = (n + C - 1) / C;
  L.rows_a = (m + C - 1) / C;
  L.p_slab = resident ? round4((long long)L.rows_p * n + 3) : 0;
  L.a_slab = resident ? round4((long long)L.rows_a * n + 3) : 0;
  const long long floats =
      L.p_slab + L.a_slab + 8LL * n + 3LL * L.rows_a + 2 * kWarps;
  L.bytes = kBarrierBytes + 4 * floats;
  return L;
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & kAbs;
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// 1 / sqrt(clamp(norm, lo, hi)): torch's sqrt, then its reciprocal
__device__ __forceinline__ float scale_of(float norm, float lo, float hi) {
  return __fdiv_rn(1.0f, __fsqrt_rn(clamp_nan(norm, lo, hi)));
}

// Rows [0, rows) of a row-major (rows, n) slab, one warp a row (rows
// warp, warp + kWarps, ...), kCols columns a lane. kScale: each element
// becomes ((v pre) row[i]) col[j] (pre only with kPre) and is stored at
// dst; else it is only read. The column maxima of the |values| go into
// part (shared memory, atomicMax on the bits), with kRows the row
// maxima into rmax. An element is read and written by the same thread in
// every pass.
template <bool kScale, bool kPre, bool kRows>
__device__ __forceinline__ void sweep(const float* src, float* dst, int rows,
                                      int n, float pre, const float* row,
                                      const float* col, uint32_t* part,
                                      uint32_t* rmax, int warp, int lane) {
  for (int j0 = 0; j0 < n; j0 += kBlockCols) {
    float cs[kCols];
    uint32_t acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int j = j0 + lane + 32 * k;
      cs[k] = (kScale && j < n) ? col[j] : 0.0f;
      acc[k] = 0u;
    }
    for (int i = warp; i < rows; i += kWarps) {
      const float* s = src + (size_t)i * n;
      float* t = kScale ? dst + (size_t)i * n : nullptr;
      const float r = kScale ? row[i] : 0.0f;
      uint32_t racc = 0u;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < n) {
          float v = s[j];
          if (kScale) {
            if (kPre) v = __fmul_rn(v, pre);
            v = __fmul_rn(__fmul_rn(v, r), cs[k]);
            t[j] = v;
          }
          const uint32_t a = abs_bits(v);
          acc[k] = max(acc[k], a);
          if (kRows) racc = max(racc, a);
        }
      }
      if (kRows) {
        racc = __reduce_max_sync(0xffffffffu, racc);
        if (lane == 0) rmax[i] = j0 == 0 ? racc : max(rmax[i], racc);
      }
    }
    if (warp < rows) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < n) atomicMax(&part[j], acc[k]);
      }
    }
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
ruiz_equilibrate_kernel(const float* P, const float* __restrict__ q,
                        const float* A, float* Ps, float* __restrict__ qs,
                        float* As, float* __restrict__ c_out,
                        float* __restrict__ d_out, float* __restrict__ e_out,
                        int n, int m, int n_iters, float lo, float hi) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Layout L = layout(n, m, C, kResident);
  // this CTA's rows: P rows [p0, p0 + np), A rows [a0, a0 + na)
  const int p0 = min(n, rank * L.rows_p);
  const int np = min(n, p0 + L.rows_p) - p0;
  const int a0 = min(m, rank * L.rows_a);
  const int na = min(m, a0 + L.rows_a) - a0;

  const size_t p_off = ((size_t)b * n + p0) * n;
  const size_t a_off = ((size_t)b * m + a0) * n;
  const float* P_rows = P + p_off;
  const float* A_rows = A + a_off;
  float* Ps_rows = Ps + p_off;
  float* As_rows = As + a_off;
  q += (size_t)b * n;
  qs += (size_t)b * n;
  d_out += (size_t)b * n;
  e_out += (size_t)b * m + a0;

  if (n_iters == 0) {
    for (long long i = tid; i < (long long)np * n; i += kThreads) {
      Ps_rows[i] = P_rows[i];
    }
    for (long long i = tid; i < (long long)na * n; i += kThreads) {
      As_rows[i] = A_rows[i];
    }
    for (int i = tid; i < na; i += kThreads) e_out[i] = 1.0f;
    if (rank == 0) {
      for (int j = tid; j < n; j += kThreads) {
        qs[j] = q[j];
        d_out[j] = 1.0f;
      }
      if (tid == 0) c_out[b] = 1.0f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* p_region = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* a_region = p_region + L.p_slab;
  float* dd = a_region + L.a_slab;
  uint32_t* col_p = reinterpret_cast<uint32_t*>(dd);  // between passes
  uint32_t* col_a = reinterpret_cast<uint32_t*>(dd + n);
  float* qv = dd + 2 * n;
  float* dv = dd + 3 * n;
  uint32_t* parts = reinterpret_cast<uint32_t*>(dd + 4 * n);
  uint32_t* rmax = parts + 4 * n;
  float* ee = reinterpret_cast<float*>(rmax + L.rows_a);
  float* ev = ee + L.rows_a;
  float* scratch = ev + L.rows_a;
  // buffer k of the CTA's column maxima of P, and of A
  auto part_p = [&](int k) { return parts + (2 * k) * n; };
  auto part_a = [&](int k) { return parts + (2 * k + 1) * n; };

  // the slabs a sweep reads and writes: in shared memory, congruent to
  // their global addresses mod 16 bytes, or in place in P_s and A_s
  float* slab_p = Ps_rows;
  float* slab_a = As_rows;
  if (kResident) {
    slab_p = p_region + ((reinterpret_cast<uintptr_t>(P_rows) >> 2) & 3);
    slab_a = a_region + ((reinterpret_cast<uintptr_t>(A_rows) >> 2) & 3);
    if (tid == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    load_slice(slab_p, P_rows, (long long)np * n, &bars[0], tid);
    load_slice(slab_a, A_rows, (long long)na * n, &bars[1], tid);
  }
  for (int j = tid; j < n; j += kThreads) {
    qv[j] = q[j];
    dv[j] = 1.0f;
    part_p(1)[j] = 0u;
    part_a(1)[j] = 0u;
  }
  for (int i = tid; i < na; i += kThreads) ev[i] = 1.0f;
  __syncthreads();

  // the norms of the first pass: column maxima of |P| and |A|, row
  // maxima of |A|, into buffer 1
  const float* src_p = kResident ? slab_p : P_rows;
  const float* src_a = kResident ? slab_a : A_rows;
  if (kResident) mbar_wait(&bars[0], 0);
  sweep<false, false, false>(src_p, nullptr, np, n, 0.0f, nullptr, nullptr,
                             part_p(1), nullptr, warp, lane);
  if (kResident) mbar_wait(&bars[1], 0);
  sweep<false, false, true>(src_a, nullptr, na, n, 0.0f, nullptr, nullptr,
                            part_a(1), rmax, warp, lane);

  float g = 1.0f;  // the last pass's cost scale, not yet applied to P
  float c = 1.0f;
  for (int it = 0; it <= n_iters; ++it) {
    const int buf = (it + 1) & 1;  // the buffer the last sweep filled
    // every CTA's partial maxima have landed; a peer reads them, and
    // overwrites its own, only past this barrier
    cluster.sync();
    for (int j = tid; j < n; j += kThreads) {
      // every peer's two values in flight at once, then their maxima
      uint32_t vp[kMaxCluster], va[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < C) {
          vp[r] = cluster.map_shared_rank(part_p(buf), r)[j];
          va[r] = cluster.map_shared_rank(part_a(buf), r)[j];
        }
      }
      uint32_t mp = 0u, ma = 0u;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < C) {
          mp = max(mp, vp[r]);
          ma = max(ma, va[r]);
        }
      }
      col_p[j] = mp;
      col_a[j] = ma;
    }
    if (it > 0) {
      // cost normalisation of the pass: g from the mean of P's column
      // maxima and max |q|, applied to q and c now and to P by the next
      // sweep (or the write-out)
      float sum = 0.0f;
      uint32_t qmax = 0u;
      for (int j = tid; j < n; j += kThreads) {
        sum = __fadd_rn(sum, __uint_as_float(col_p[j]));
        qmax = max(qmax, abs_bits(qv[j]));
      }
      sum = admm::warp_sum(sum);
      qmax = __reduce_max_sync(0xffffffffu, qmax);
      if (lane == 0) {
        scratch[warp] = sum;
        scratch[kWarps + warp] = __uint_as_float(qmax);
      }
      __syncthreads();
      sum = 0.0f;
      qmax = 0u;
      for (int w = 0; w < kWarps; ++w) {
        sum = __fadd_rn(sum, scratch[w]);
        qmax = max(qmax, __float_as_uint(scratch[kWarps + w]));
      }
      const float mean = __fdiv_rn(sum, (float)n);
      const float qn = __uint_as_float(qmax);
      const float norm =
          (mean != mean || qn != qn) ? __uint_as_float(kNaN) : fmaxf(mean, qn);
      g = __fdiv_rn(1.0f, clamp_nan(norm, lo, hi));
      c = __fmul_rn(c, g);
      for (int j = tid; j < n; j += kThreads) qv[j] = __fmul_rn(qv[j], g);
    }
    if (it == n_iters) break;

    // the pass's scalings from the column maxima of P g and of A, and the
    // row maxima of A; q, d and e scaled
    const int next = it & 1;
    for (int j = tid; j < n; j += kThreads) {
      const uint32_t cp = abs_bits(__fmul_rn(g, __uint_as_float(col_p[j])));
      const float s = scale_of(__uint_as_float(max(cp, col_a[j])), lo, hi);
      dd[j] = s;
      qv[j] = __fmul_rn(qv[j], s);
      dv[j] = __fmul_rn(dv[j], s);
      part_p(next)[j] = 0u;
      part_a(next)[j] = 0u;
    }
    for (int i = tid; i < na; i += kThreads) {
      const float s = scale_of(__uint_as_float(rmax[i]), lo, hi);
      ee[i] = s;
      ev[i] = __fmul_rn(ev[i], s);
    }
    __syncthreads();
    sweep<true, true, false>(src_p, slab_p, np, n, g, dd + p0, dd,
                             part_p(next), nullptr, warp, lane);
    sweep<true, false, true>(src_a, slab_a, na, n, 1.0f, ee, dd,
                             part_a(next), rmax, warp, lane);
    src_p = slab_p;
    src_a = slab_a;
  }

  // P_s = P g (the last g), A_s as it stands; the vectors
  for (long long i = tid; i < (long long)np * n; i += kThreads) {
    Ps_rows[i] = __fmul_rn(slab_p[i], g);
  }
  if (kResident) {
    for (long long i = tid; i < (long long)na * n; i += kThreads) {
      As_rows[i] = slab_a[i];
    }
  }
  for (int i = tid; i < na; i += kThreads) e_out[i] = ev[i];
  if (rank == 0) {
    for (int j = tid; j < n; j += kThreads) {
      qs[j] = qv[j];
      d_out[j] = dv[j];
    }
    if (tid == 0) c_out[b] = c;
  }
  // no CTA exits while a peer may still read its partial maxima
  cluster.sync();
}

// The kernel of a plan, its layout, or false where the arguments are out
// of range.
bool checked(int n, int m, int C, int resident, Layout* L, const void** fn) {
  if (C < 1 || C > kMaxCluster || n < 1 || m < 0) return false;
  *L = layout(n, m, C, resident != 0);
  *fn = resident ? (const void*)ruiz_equilibrate_kernel<true>
                 : (const void*)ruiz_equilibrate_kernel<false>;
  return true;
}

}  // namespace

// Dynamic shared memory of one CTA for a cluster of C CTAs, in bytes;
// resident != 0: the CTA holds its slabs of P and A.
extern "C" long long ruiz_equilibrate_smem_bytes(int n, int m, int C,
                                                 int resident) {
  return layout(n, m, C, resident != 0).bytes;
}

// How many clusters of C CTAs at (n, m) the card holds at once
// (cudaOccupancyMaxActiveClusters) into *count; returns a CUDA error code.
extern "C" int ruiz_equilibrate_max_active(int n, int m, int C, int resident,
                                           int* count) {
  Layout L;
  const void* fn;
  if (!checked(n, m, C, resident, &L, &fn)) return (int)cudaErrorInvalidValue;
  cudaError_t err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, 1, C, kThreads, L.bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launch B clusters of C CTAs on `stream`: P (B, n, n), q (B, n), A (B, m,
// n) in; P_s, q_s, A_s of the same shapes, c (B,), d (B, n), e (B, m)
// out; all device pointers, fp32, contiguous, outputs apart from inputs.
// Returns a CUDA error code (0 on success): that of a refused attribute
// or launch, else cudaGetLastError().
extern "C" int ruiz_equilibrate_launch(const float* P, const float* q,
                                       const float* A, float* Ps, float* qs,
                                       float* As, float* c, float* d,
                                       float* e, int B, int n, int m, int C,
                                       int resident, int n_iters, float lo,
                                       float hi, void* stream) {
  Layout L;
  const void* fn;
  if (!checked(n, m, C, resident, &L, &fn) || n_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = admm::configure_cluster(fn, C, L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  admm::cluster_launch_config(&cfg, &attr, B, C, kThreads, L.bytes, stream);
  if (resident) {
    err = cudaLaunchKernelEx(&cfg, ruiz_equilibrate_kernel<true>, P, q, A, Ps,
                             qs, As, c, d, e, n, m, n_iters, lo, hi);
  } else {
    err = cudaLaunchKernelEx(&cfg, ruiz_equilibrate_kernel<false>, P, q, A,
                             Ps, qs, As, c, d, e, n, m, n_iters, lo, hi);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
