// Fused ADMM iteration chunk for Hopper (sm_90a), streaming variant: for
// operators that no thread-block cluster can hold in shared memory.
//
// Replaces the TPU kernels acmpc_tpu/ops/pallas_admm.py::_admm_kernel
// (body _admm_body) and ::_admm_kernel_active for those shapes (the
// mapping control at horizon 100: n = 498, m = 798, a 4.17 MB operator
// per scenario, above the 16 x 227 KB of the largest cluster). The
// function is that of admm_chunk.cu; see there.
//
// What bounds it on this card: bytes. Each iteration reads W and A once,
// 4 (n (n+m) + m n) bytes for 2 (n (n+m) + m n) flops, 0.5 flop per byte,
// from global memory: the operator does not stay on chip, so the floor
// is the HBM rate (or L2's, when the batch's operators fit in its 50 MB).
//
// What the design does about it: one block per scenario keeps the whole
// dependent chain of an iteration (two GEMVs and the elementwise update)
// inside one block, with the vectors in shared memory (3n + 7m floats)
// and only W and A read from global memory. Each GEMV gives one warp per
// row: the lanes walk the row with stride 32, so every load instruction
// of a warp reads 128 contiguous bytes, and a shuffle reduction ends the
// row. Two independent accumulators keep two loads in flight per lane.
//
// active (nullable, one byte per scenario): where active[b] == 0 the block
// copies x, z, y through and returns.

#include "admm_chunk_common.cuh"

namespace {

using admm::kThreads;
using admm::kWarps;

// dot(row[0:len], v[0:len]) over one warp; every lane gets the result
__device__ __forceinline__ float warp_dot(const float* __restrict__ row,
                                          const float* __restrict__ v,
                                          int len, int lane) {
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  int k = lane;
  for (; k + 32 < len; k += 64) {
    acc0 = fmaf(__ldg(row + k), v[k], acc0);
    acc1 = fmaf(__ldg(row + k + 32), v[k + 32], acc1);
  }
  if (k < len) acc0 = fmaf(__ldg(row + k), v[k], acc0);
  return admm::warp_sum(acc0 + acc1);
}

__global__ void __launch_bounds__(kThreads)
admm_chunk_stream_kernel(const float* __restrict__ W,
                         const float* __restrict__ A,
                         const float* __restrict__ c0,
                         const float* __restrict__ rho,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi,
                         const float* __restrict__ x_in,
                         const float* __restrict__ z_in,
                         const float* __restrict__ y_in,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ x_out, float* __restrict__ z_out,
                         float* __restrict__ y_out, int n, int m, int n_iters,
                         float alpha, float one_minus_alpha) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_w = n + m;

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
    for (int i = tid; i < n; i += kThreads) x_out[i] = x_in[i];
    for (int j = tid; j < m; j += kThreads) {
      z_out[j] = z_in[j];
      y_out[j] = y_in[j];
    }
    return;
  }

  const float* __restrict__ Wb = W + (size_t)b * n * k_w;
  const float* __restrict__ Ab = A + (size_t)b * m * n;

  // shared layout: stacked = [x (n) | w = rho z - y (m)], then xt, c0,
  // z, y, rho, 1/rho, l, u; x lives in the stacked vector's head
  extern __shared__ float smem[];
  float* stacked = smem;
  float* x = stacked;
  float* w = stacked + n;
  float* xt = stacked + k_w;
  float* cs = xt + n;
  float* z = cs + n;
  float* y = z + m;
  float* r = y + m;
  float* inv_r = r + m;
  float* l = inv_r + m;
  float* h = l + m;

  for (int i = tid; i < n; i += kThreads) {
    x[i] = x_in[i];
    cs[i] = c0[i];
  }
  for (int j = tid; j < m; j += kThreads) {
    const float rj = rho[j];
    const float zj = z_in[j];
    const float yj = y_in[j];
    z[j] = zj;
    y[j] = yj;
    r[j] = rj;
    inv_r[j] = 1.0f / rj;
    l[j] = lo[j];
    h[j] = hi[j];
    w[j] = rj * zj - yj;
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // xt = W [x; w] + c0, one warp per row
    for (int row = warp; row < n; row += kWarps) {
      const float s = warp_dot(Wb + (size_t)row * k_w, stacked, k_w, lane);
      if (lane == 0) xt[row] = s + cs[row];
    }
    __syncthreads();
    // zt = A xt, one warp per row, then that row's z/y update; x is not
    // read in this phase, so its update runs beside
    for (int row = warp; row < m; row += kWarps) {
      const float zt = warp_dot(Ab + (size_t)row * n, xt, n, lane);
      if (lane == 0) {
        const admm::RowUpdate u = admm::row_update(
            zt, z[row], y[row], r[row], inv_r[row], l[row], h[row], alpha,
            one_minus_alpha);
        z[row] = u.z;
        y[row] = u.y;
        w[row] = u.w;
      }
    }
    for (int i = tid; i < n; i += kThreads) {
      x[i] = alpha * xt[i] + one_minus_alpha * x[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) x_out[i] = x[i];
  for (int j = tid; j < m; j += kThreads) {
    z_out[j] = z[j];
    y_out[j] = y[j];
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" long long admm_chunk_stream_smem_bytes(int n, int m) {
  return (long long)sizeof(float) * (3 * (long long)n + 7 * (long long)m);
}

// Launch on `stream`, one block per scenario; returns a CUDA error code
// (0 on success): that of a refused attribute, else cudaGetLastError()
// after the launch. All pointers are device pointers; `active` may be
// null.
extern "C" int admm_chunk_stream_launch(const float* W, const float* A,
                                        const float* c0, const float* rho,
                                        const float* lo, const float* hi,
                                        const float* x, const float* z,
                                        const float* y, const uint8_t* active,
                                        float* x_out, float* z_out,
                                        float* y_out, int B, int n, int m,
                                        int n_iters, float alpha,
                                        float one_minus_alpha, void* stream) {
  const long long smem = admm_chunk_stream_smem_bytes(n, m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_chunk_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not reported again by a later launch
      return (int)err;
    }
  }
  admm_chunk_stream_kernel<<<B, kThreads, (size_t)smem,
                             (cudaStream_t)stream>>>(
      W, A, c0, rho, lo, hi, x, z, y, active, x_out, z_out, y_out, n, m,
      n_iters, alpha, one_minus_alpha);
  return (int)cudaGetLastError();
}
