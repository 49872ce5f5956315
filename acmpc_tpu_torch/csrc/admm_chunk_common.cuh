// Pieces shared by the two ADMM chunk kernels (admm_chunk.cu, the
// cluster kernel, and admm_chunk_stream.cu, the streaming kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace admm {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// One constraint row's update after zt = (A xt)[row]; returns the new w
// = rho z - y that the next iteration's first GEMV reads.
struct RowUpdate {
  float z, y, w;
};

__device__ __forceinline__ RowUpdate row_update(float zt, float z, float y,
                                                float rho, float inv_rho,
                                                float lo, float hi,
                                                float alpha,
                                                float one_minus_alpha) {
  const float zr = alpha * zt + one_minus_alpha * z;
  const float zn = fminf(fmaxf(zr + y * inv_rho, lo), hi);
  const float yn = y + rho * (zr - zn);
  return {zn, yn, rho * zn - yn};
}

}  // namespace admm
