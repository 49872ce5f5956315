// Pieces shared by the two ADMM chunk kernels (admm_chunk.cu, the
// cluster kernel; admm_chunk_split.cu, the split kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace admm {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kPieceBytes = 32768;  // one bulk copy, a multiple of 16

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

// --- mbarriers, bulk copies and distributed shared memory (clusters) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// an mbarrier whose phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init_count(uint64_t* bar,
                                                uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `count` arrivals at once (release: this thread's earlier accesses, and
// those its warp ordered before it by __syncwarp, precede the phase's end)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
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

// --- GEMV over rows held in shared memory ---

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
  for (int i = 0; i < R; ++i) epi(row0 + i * kWarps, warp_sum(acc[i]));
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

// --- host side of a cluster launch ---

// Allow `smem` bytes of dynamic shared memory, and clusters above 8 CTAs.
// A refused attribute is returned, and cleared from the runtime's last
// error so that it is not reported again by a later launch.
inline cudaError_t configure_cluster(const void* kernel, int C,
                                     long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// B clusters of C CTAs of `threads` threads each
inline void cluster_launch_config(cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr, int B, int C,
                                  int threads, long long smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * C));
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace admm
