// SegFormer's all-MLP head (Xie et al., arXiv:2105.15203): the four
// stages' projections brought to stage 1's grid and concatenated, deepest
// first, into the fuse convolution's input, in one pass.
//
// Replaces no TPU kernel: the JAX package has no SegFormer. PyTorch's
// composition is a bilinear resize (upsample_bilinear2d, NHWC) of each of
// stages 2-4 and a torch.cat of the four: at 1280x736 in bf16 1.26 +
// 0.39 ms a frame on an H100, the resized maps (271 MB) written, read back
// and written again. This kernel writes the concatenation directly:
//
//   part i  (N, h_i, w_i, C)   stage i + 1's projection, channels last
//   out     (N, H, W, 4C)      channels last: part 3 at channel 0, part 2
//                              at C, part 1 at 2C, part 0 at 3C
//
// with C = 768. A part on the output's grid is copied; any other is
// resampled as PyTorch's upsample_bilinear2d with align_corners=False
// computes it, to the bit: scale = h / H in float32 (the host's division),
// source index max(scale * (y + 0.5) - 0.5, 0), its integer part and the
// next index clamped at the edge, and in float32
//
//   h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d)
//
// with the fused multiply-adds that PyTorch's compiled kernel forms from
// it, fma(h0, fma(w1, b, w0 * a), h1 * fma(w0, c, w1 * d)) (found on the
// card against PyTorch 2.11 built with CUDA 12.8: of the 27 ways to
// contract the three sums, the one bit-equal in float32; in bf16 only the
// outer sum can differ), written out with round-to-nearest intrinsics so
// that no contraction of this file's compiler can differ; rounded once to
// the parts' type.
//
// What bounds it: bytes. At 1280x736 in bf16 the parts are read once
// (120.1 MB) and the output written once (361.8 MB): 481.9 MB, 0.144 ms at
// 3.35 TB/s. Design: a warp a pixel; the pixel's rows, columns and
// weights are computed once for all its channels, and its 4C channels
// written as 16-byte streaming stores (.cs: the convolution that reads
// them next cannot find 362 MB in L2), 12 a lane in bf16. The three
// resampled parts (30 MB) stay in the 50 MB L2, and a block's warps take
// neighbouring pixels of one row, so that most of their 16-byte taps hit
// in L1; the blocks run in row-major order (0.182 ms a launch against
// 0.200 with a column of rows at a time, at 1280x736 bf16 on an H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 4;
constexpr int kChannels = 768;  // SegFormer B2-B5's decoder width
constexpr int kWarps = 8;       // a block's warps: neighbouring pixels of one row
constexpr int kThreads = 32 * kWarps;

struct Part {
  const void* data;
  int h, w;
  float scale_h, scale_w;  // h / H and w / W in float32
};

struct Parts {
  Part p[kParts];  // shallowest first
};

// 16 bytes of T, widened to float32 and rounded back
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kLen = 8;
  __device__ static void widen(const uint4& raw, float (&f)[kLen]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kLen / 2; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 narrow(const float (&f)[kLen]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kLen / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int kLen = 4;
  __device__ static void widen(const uint4& raw, float (&f)[kLen]) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 narrow(const float (&f)[kLen]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// one axis of a pixel's 2 x 2 neighbourhood: the near and far index and
// their weights, as area_pixel_compute_source_index and the resize
// kernel form them (the index's multiply-add contracted as nvcc contracts
// it; on the head's grids, sides divisible by 32, every scale is a power
// of two and the index exact either way)
struct Taps {
  int near, far;
  float l0, l1;
};

__device__ __forceinline__ Taps taps(float scale, int dst, int size) {
  float src = __fmaf_rn(scale, static_cast<float>(dst) + 0.5f, -0.5f);
  src = src < 0.f ? 0.f : src;
  const int near = static_cast<int>(src);
  const int step = near < size - 1 ? 1 : 0;
  const float l1 = src - near;
  const float l0 = 1.f - l1;
  return {near, near + step, l0, l1};
}

// a block a segment of kWarps * pixels_per_warp pixels of one row, the
// blocks in row-major order (a row's segments, then the next row)
template <typename T>
__global__ void __launch_bounds__(kThreads) segformer_resample_kernel(Parts parts, T* __restrict__ out, int H,
                                                                     int W, int pixels_per_warp, int segments) {
  using V = Vec<T>;
  constexpr int kVectors = kChannels / V::kLen;  // a part's pixel: 96 (bf16) or 192 (float32)
  constexpr int kPerLane = kVectors / 32;
  static_assert(kVectors % 32 == 0, "a part's pixel must be whole 16-byte vectors for every lane");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / segments;  // n * H + y
  const int segment = blockIdx.x - row * segments;
  const int n = row / H;
  const int y = row - n * H;
  uint4* out_row = reinterpret_cast<uint4*>(out) + static_cast<long long>(row) * W * (kParts * kVectors);

  for (int j = 0; j < pixels_per_warp; ++j) {
    const int x = (segment * pixels_per_warp + j) * kWarps + warp;
    if (x >= W) break;
    uint4* dst = out_row + static_cast<long long>(x) * (kParts * kVectors) + lane;
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      const Part& part = parts.p[kParts - 1 - q];  // deepest first
      const uint4* src = static_cast<const uint4*>(part.data) + lane;
      uint4* o = dst + q * kVectors;
      if (part.h == H && part.w == W) {
        const uint4* s = src + (static_cast<long long>(row) * W + x) * kVectors;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) __stcs(o + 32 * k, __ldg(s + 32 * k));
        continue;
      }
      const Taps ty = taps(part.scale_h, y, part.h);
      const Taps tx = taps(part.scale_w, x, part.w);
      const long long top = (static_cast<long long>(n) * part.h + ty.near) * part.w;
      const long long bottom = (static_cast<long long>(n) * part.h + ty.far) * part.w;
      const uint4* pa = src + (top + tx.near) * kVectors;
      const uint4* pb = src + (top + tx.far) * kVectors;
      const uint4* pc = src + (bottom + tx.near) * kVectors;
      const uint4* pd = src + (bottom + tx.far) * kVectors;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        float a[V::kLen], b[V::kLen], c[V::kLen], d[V::kLen], r[V::kLen];
        V::widen(__ldg(pa + 32 * k), a);
        V::widen(__ldg(pb + 32 * k), b);
        V::widen(__ldg(pc + 32 * k), c);
        V::widen(__ldg(pd + 32 * k), d);
#pragma unroll
        for (int e = 0; e < V::kLen; ++e) {
          const float top_row = __fmaf_rn(tx.l1, b[e], __fmul_rn(tx.l0, a[e]));
          const float bottom_row = __fmaf_rn(tx.l0, c[e], __fmul_rn(tx.l1, d[e]));
          r[e] = __fmaf_rn(ty.l0, top_row, __fmul_rn(ty.l1, bottom_row));
        }
        __stcs(o + 32 * k, V::narrow(r));
      }
    }
  }
}

}  // namespace

// One launch on ``stream``: parts p0..p3 (shallowest first) of (h_i, w_i)
// into out (N, H, W, 4 * 768), all channels last and 16-byte aligned;
// dtype 0 bf16, 1 float32; a warp takes pixels_per_warp pixels of a row.
// Returns a CUDA error code, or cudaErrorInvalidValue for sizes the kernel
// does not take (the wrapper checks them too).
extern "C" int segformer_resample_launch(const void* p0, const void* p1, const void* p2, const void* p3, int h0,
                                         int w0, int h1, int w1, int h2, int w2, int h3, int w3, void* out, int N,
                                         int H, int W, int dtype, int pixels_per_warp, void* stream) {
  if (N < 1 || H < 1 || W < 1 || pixels_per_warp < 1 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int per_block = kWarps * pixels_per_warp;
  const long long segments = (W + per_block - 1) / per_block;
  if (static_cast<long long>(N) * H * segments > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* data[kParts] = {p0, p1, p2, p3};
  const int hs[kParts] = {h0, h1, h2, h3}, ws[kParts] = {w0, w1, w2, w3};
  Parts parts{};
  for (int i = 0; i < kParts; ++i) {
    if (hs[i] < 1 || ws[i] < 1 || data[i] == nullptr) return cudaErrorInvalidValue;
    // PyTorch's area_pixel_compute_scale: (float)input_size / output_size
    parts.p[i] = {data[i], hs[i], ws[i], static_cast<float>(hs[i]) / static_cast<float>(H),
                  static_cast<float>(ws[i]) / static_cast<float>(W)};
  }
  const unsigned blocks = static_cast<unsigned>(N * H * segments);
  const int segs = static_cast<int>(segments);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    segformer_resample_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, s>>>(parts, static_cast<__nv_bfloat16*>(out), H, W, pixels_per_warp, segs);
  else
    segformer_resample_kernel<float>
        <<<blocks, kThreads, 0, s>>>(parts, static_cast<float*>(out), H, W, pixels_per_warp, segs);
  return cudaGetLastError();
}
