// The camera frame's JPEG round trip for Hopper (sm_90a): an (H, W, 3)
// uint8 BGR frame to what OpenCV's default JPEG encode and decode return
// (libjpeg: quality 95, 4:2:0 chroma, the integer "slow" DCT both ways,
// fancy upsampling), byte for byte. The entropy coding between encoder
// and decoder is lossless and is left out; every other step is libjpeg's
// integer arithmetic, stage by stage as ops/jpeg_round_trip.py lists it
// (its plain version, jpeg_round_trip_reference, is the same arithmetic
// in PyTorch ops).
//
// Replaces no TPU kernel: the JAX package runs the round trip on the host
// with OpenCV (acmpc_tpu/perception/perceiver.py, _encode_decode_image),
// so that the segmenter sees the JPEG-degraded pixels it was trained on.
// Here it is the first node of the perception graph, on the raw frame
// after its upload.
//
// What bounds it on this card: memory. The frame is read once and written
// once, 2 x 3 H W bytes (5.65 MB at 1280x736, 1.7 us at 3.35 TB/s); the
// integer work, about 1e8 operations, is a few microseconds across 132 SMs.
//
// What the design does about it. Two launches:
//  1. jpeg_round_trip_blocks: a CTA of 192 threads takes a strip of 4 MCUs
//     (16 x 64 pixels). It reads the strip into shared memory once (one
//     16-byte load a thread where the strip lies inside the frame and rows
//     are 16-byte multiples; else byte loads with the edge clamps), turns
//     it into 16 luma blocks and 4 + 4 chroma blocks (the colour
//     conversion, the 2x2 average), and a thread takes one row of one
//     block: the forward DCT's row pass; then that block's column: the
//     column pass, quantisation, dequantisation and the inverse DCT's
//     column pass, all in registers; then a row again for the inverse's
//     row pass and the range limit. The decoded luma (hp x wp) and chroma
//     (two hp/2 x wp/2 planes), 1.5 hp wp bytes (1.4 MB at 1280x736), go
//     to a scratch that stays in L2. Rows of the shared planes are padded
//     by one word, so that a warp's 32 rows or columns (4 blocks x 8) fall
//     in distinct banks.
//  2. jpeg_round_trip_colour: a thread takes 4 pixels of a row, reads
//     their luma (one 4-byte load) and the 4 chroma column sums around
//     them from the scratch, upsamples, converts to BGR and writes the
//     12 bytes, as three 4-byte stores where the row allows.
// The chroma of one strip's upsampling reaches into its neighbours' blocks
// (one chroma row and column of halo), which the scratch between the two
// launches provides without recomputing them.
//
// The edges (libjpeg's encoder pads so): the last column repeats to whole
// blocks of each plane, the chroma's before it is averaged down; the last
// row repeats to an even count, and the averaged chroma's last row (row
// ceil(H/2) - 1) to whole blocks. The decoder upsamples ceil(H/2) x
// ceil(W/2) chroma samples, each edge sample repeated, or by plain 2x2
// replication where the chroma is at most 2 samples wide.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMcus = 4;                // MCUs a CTA of the blocks kernel, along a row
constexpr int kTileW = 16 * kMcus;      // 64 pixels
constexpr int kTileH = 16;
constexpr int kThreads = 192;           // 24 blocks x 8 rows
constexpr int kYStride = kTileW + 1;    // shared luma row, padded
constexpr int kCW = kTileW / 2;         // 32 chroma samples a strip row
constexpr int kCStride = kCW + 1;
constexpr int kCbOff = kTileH * kYStride;
constexpr int kCrOff = kCbOff + 8 * kCStride;
constexpr int kPlaneInts = kCrOff + 8 * kCStride;
constexpr int kColourThreads = 128;     // 4-pixel groups a CTA of the colour kernel

// jccolor.c / jdcolor.c: 16 fraction bits
constexpr int fix16(double x) { return static_cast<int>(x * 65536.0 + 0.5); }
constexpr int kOneHalf = 1 << 15;
constexpr int kCbCrBias = (128 << 16) + kOneHalf - 1;
constexpr int kYR = fix16(0.299), kYG = fix16(0.587), kYB = fix16(0.114);
constexpr int kCbR = fix16(0.16874), kCbG = fix16(0.33126), kHalfC = fix16(0.5);
constexpr int kCrG = fix16(0.41869), kCrB = fix16(0.08131);
constexpr int kRCr = fix16(1.402), kGCb = fix16(0.34414), kGCr = fix16(0.71414), kBCb = fix16(1.772);

// jfdctint.c / jidctint.c (CONST_BITS 13, PASS1_BITS 2)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr int F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr int F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

struct Tables {
  int q[2][64];  // luminance, chrominance; natural order
};

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// one pass of jpeg_fdct_islow: FIRST the row pass (outputs scaled by
// 2^PASS1_BITS), else the column pass
template <bool FIRST>
__device__ __forceinline__ void fdct_pass(const int* x, int* o) {
  const int t0 = x[0] + x[7], t7 = x[0] - x[7];
  const int t1 = x[1] + x[6], t6 = x[1] - x[6];
  const int t2 = x[2] + x[5], t5 = x[2] - x[5];
  const int t3 = x[3] + x[4], t4 = x[3] - x[4];
  const int t10 = t0 + t3, t13 = t0 - t3;
  const int t11 = t1 + t2, t12 = t1 - t2;
  constexpr int n = FIRST ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
  if (FIRST) {
    o[0] = (t10 + t11) * (1 << kPass1Bits);
    o[4] = (t10 - t11) * (1 << kPass1Bits);
  } else {
    o[0] = descale(t10 + t11, kPass1Bits);
    o[4] = descale(t10 - t11, kPass1Bits);
  }
  int z1 = (t12 + t13) * F0541;
  o[2] = descale(z1 + t13 * F0765, n);
  o[6] = descale(z1 - t12 * F1847, n);
  z1 = t4 + t7;
  int z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  const int z5 = (z3 + z4) * F1175;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  o[7] = descale(t4 * F0298 + z1 + z3, n);
  o[5] = descale(t5 * F2053 + z2 + z4, n);
  o[3] = descale(t6 * F3072 + z2 + z3, n);
  o[1] = descale(t7 * F1501 + z1 + z4, n);
}

// one pass of jpeg_idct_islow, descaled by N bits
template <int N>
__device__ __forceinline__ void idct_pass(const int* x, int* o) {
  int z1 = (x[2] + x[6]) * F0541;
  const int e2 = z1 - x[6] * F1847;
  const int e3 = z1 + x[2] * F0765;
  const int e0 = (x[0] + x[4]) * (1 << kConstBits);
  const int e1 = (x[0] - x[4]) * (1 << kConstBits);
  const int t10 = e0 + e3, t13 = e0 - e3, t11 = e1 + e2, t12 = e1 - e2;
  int t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  int z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int z5 = (z3 + z4) * F1175;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 = t0 * F0298 + z1 + z3;
  t1 = t1 * F2053 + z2 + z4;
  t2 = t2 * F3072 + z2 + z3;
  t3 = t3 * F1501 + z1 + z4;
  o[0] = descale(t10 + t3, N);
  o[7] = descale(t10 - t3, N);
  o[1] = descale(t11 + t2, N);
  o[6] = descale(t11 - t2, N);
  o[2] = descale(t12 + t1, N);
  o[5] = descale(t12 - t1, N);
  o[3] = descale(t13 + t0, N);
  o[4] = descale(t13 - t0, N);
}

// jdmaster.c's post-IDCT range-limit table at v & 1023
__device__ __forceinline__ int range_limit(int v) {
  const int i = v & 1023;
  return i < 128 ? i + 128 : (i < 512 ? 255 : (i < 896 ? 0 : i - 896));
}

__device__ __forceinline__ int luma(int b, int g, int r) {
  return (kYR * r + kYG * g + kYB * b + kOneHalf) >> 16;
}
__device__ __forceinline__ int blue_diff(int b, int g, int r) {
  return (-kCbR * r - kCbG * g + kHalfC * b + kCbCrBias) >> 16;
}
__device__ __forceinline__ int red_diff(int b, int g, int r) {
  return (kHalfC * r - kCrG * g - kCrB * b + kCbCrBias) >> 16;
}

__global__ void __launch_bounds__(kThreads)
jpeg_round_trip_blocks(const uint8_t* __restrict__ frame, uint8_t* __restrict__ ys,
                       uint8_t* __restrict__ cbs, uint8_t* __restrict__ crs, int H, int W,
                       int wp, Tables tables) {
  __shared__ __align__(16) uint8_t pix[kTileH * kTileW * 3];
  __shared__ int plane[kPlaneInts];
  __shared__ int q[2][64];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  if (tid < 128) q[tid >> 6][tid & 63] = tables.q[tid >> 6][tid & 63];

  // the strip's pixels, the last row and column repeated past the frame
  const bool inside = r0 + kTileH <= H && c0 + kTileW <= W;
  if (inside && (W * 3) % 16 == 0 && (reinterpret_cast<uintptr_t>(frame) & 15) == 0) {
    constexpr int kVecs = kTileW * 3 / 16;  // 12 a row
    const int r = tid / kVecs, k = tid % kVecs;
    const uint4* src = reinterpret_cast<const uint4*>(frame + (static_cast<size_t>(r0 + r) * W + c0) * 3);
    reinterpret_cast<uint4*>(pix)[r * kVecs + k] = __ldg(src + k);
  } else {
    for (int i = tid; i < kTileH * kTileW * 3; i += kThreads) {
      const int r = i / (kTileW * 3), rem = i % (kTileW * 3);
      const int gr = min(r0 + r, H - 1), gc = min(c0 + rem / 3, W - 1);
      pix[i] = frame[(static_cast<size_t>(gr) * W + gc) * 3 + rem % 3];
    }
  }
  __syncthreads();

  // colour conversion, less 128: luma a pixel; chroma a 2x2 average, the
  // averaged rows past ceil(H/2) repeating the last
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const uint8_t* p = pix + 3 * i;
    plane[(i / kTileW) * kYStride + i % kTileW] = luma(p[0], p[1], p[2]) - 128;
  }
  const int last = (H + 1) / 2 - 1 - r0 / 2;  // the strip's last chroma row with data
  for (int i = tid; i < 8 * kCW; i += kThreads) {
    const int ci = i / kCW, cj = i % kCW;
    const int src = min(ci, last);
    int sb = 0, sr = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint8_t* p = pix + ((2 * src + (d >> 1)) * kTileW + 2 * cj + (d & 1)) * 3;
      sb += blue_diff(p[0], p[1], p[2]);
      sr += red_diff(p[0], p[1], p[2]);
    }
    const int bias = 1 + (cj & 1);  // c0 / 2 is even: the column's parity in the plane
    plane[kCbOff + ci * kCStride + cj] = ((sb + bias) >> 2) - 128;
    plane[kCrOff + ci * kCStride + cj] = ((sr + bias) >> 2) - 128;
  }
  __syncthreads();

  // blocks 0-15 luma (2 rows of 8), 16-19 Cb, 20-23 Cr; k the row or column
  const int blk = tid >> 3, k = tid & 7;
  int* base;
  int stride, t;
  if (blk < 16) {
    base = plane + (blk >> 3) * 8 * kYStride + (blk & 7) * 8;
    stride = kYStride;
    t = 0;
  } else {
    base = plane + (blk < 20 ? kCbOff : kCrOff) + (blk & 3) * 8;
    stride = kCStride;
    t = 1;
  }
  int x[8], o[8];
  int* row = base + k * stride;
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = row[j];
  fdct_pass<true>(x, o);
#pragma unroll
  for (int j = 0; j < 8; ++j) row[j] = o[j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = base[i * stride + k];
  fdct_pass<false>(x, o);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    // jcdctmgr.c: |c| / (8 q) rounded half up, the sign kept; then times q
    const int qq = q[t][v * 8 + k];
    const int c = o[v];
    const int level = (abs(c) + 4 * qq) / (8 * qq);
    x[v] = (c < 0 ? -level : level) * qq;
  }
  idct_pass<kConstBits - kPass1Bits>(x, o);
#pragma unroll
  for (int i = 0; i < 8; ++i) base[i * stride + k] = o[i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = row[j];
  idct_pass<kConstBits + kPass1Bits + 3>(x, o);
#pragma unroll
  for (int j = 0; j < 8; ++j) row[j] = range_limit(o[j]);
  __syncthreads();

  // the decoded strip to the scratch, 4 bytes a store; MCUs past wp are
  // not written
  const int cols = min(kTileW, wp - c0);
  for (int i = tid; i < kTileH * (kTileW / 4); i += kThreads) {
    const int r = i / (kTileW / 4), c = 4 * (i % (kTileW / 4));
    if (c < cols) {
      const int* p = plane + r * kYStride + c;
      const uint32_t word = p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
      *reinterpret_cast<uint32_t*>(ys + static_cast<size_t>(r0 + r) * wp + c0 + c) = word;
    }
  }
  const int cw = wp / 2;
  for (int i = tid; i < 2 * 8 * (kCW / 4); i += kThreads) {
    const int comp = i / (8 * (kCW / 4)), r = (i / (kCW / 4)) % 8, c = 4 * (i % (kCW / 4));
    if (c < cols / 2) {
      const int* p = plane + (comp ? kCrOff : kCbOff) + r * kCStride + c;
      const uint32_t word = p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
      uint8_t* dst = (comp ? crs : cbs) + static_cast<size_t>(r0 / 2 + r) * cw + c0 / 2 + c;
      *reinterpret_cast<uint32_t*>(dst) = word;
    }
  }
}

// the 4 column sums (3 x near row + far row) around chroma columns j, j + 1
// of one plane, each column clamped to [0, dw - 1]
__device__ __forceinline__ void column_sums(const uint8_t* near, const uint8_t* far, int j, int dw,
                                            int* cs) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int col = min(max(j - 1 + m, 0), dw - 1);
    cs[m] = 3 * near[col] + far[col];
  }
}

__global__ void __launch_bounds__(kColourThreads)
jpeg_round_trip_colour(const uint8_t* __restrict__ ys, const uint8_t* __restrict__ cbs,
                       const uint8_t* __restrict__ crs, uint8_t* __restrict__ out, int H, int W,
                       int wp) {
  const int r = blockIdx.y;
  const int g = blockIdx.x * kColourThreads + threadIdx.x;
  const int c = 4 * g;
  if (c >= W) return;
  const int cw = wp / 2, dh = (H + 1) / 2, dw = (W + 1) / 2;
  const uint32_t yword = *reinterpret_cast<const uint32_t*>(ys + static_cast<size_t>(r) * wp + c);
  const int i = r >> 1;
  int cb[4], cr[4];
  if (dw <= 2) {  // h2v2_upsample: each chroma sample to a 2x2 square
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int col = min((c + p) >> 1, dw - 1);
      cb[p] = cbs[static_cast<size_t>(i) * cw + col];
      cr[p] = crs[static_cast<size_t>(i) * cw + col];
    }
  } else {  // h2v2_fancy_upsample: the far row above for even rows, below for odd
    const int f = min(max(i + ((r & 1) ? 1 : -1), 0), dh - 1);
    int sb[4], sr[4];
    column_sums(cbs + static_cast<size_t>(i) * cw, cbs + static_cast<size_t>(f) * cw, c >> 1, dw, sb);
    column_sums(crs + static_cast<size_t>(i) * cw, crs + static_cast<size_t>(f) * cw, c >> 1, dw, sr);
    cb[0] = (3 * sb[1] + sb[0] + 8) >> 4;
    cb[1] = (3 * sb[1] + sb[2] + 7) >> 4;
    cb[2] = (3 * sb[2] + sb[1] + 8) >> 4;
    cb[3] = (3 * sb[2] + sb[3] + 7) >> 4;
    cr[0] = (3 * sr[1] + sr[0] + 8) >> 4;
    cr[1] = (3 * sr[1] + sr[2] + 7) >> 4;
    cr[2] = (3 * sr[2] + sr[1] + 8) >> 4;
    cr[3] = (3 * sr[2] + sr[3] + 7) >> 4;
  }
  uint8_t bgr[12];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int y = (yword >> (8 * p)) & 0xff;
    const int xb = cb[p] - 128, xr = cr[p] - 128;
    const int red = y + ((kRCr * xr + kOneHalf) >> 16);
    const int green = y + ((-kGCb * xb + kOneHalf - kGCr * xr) >> 16);
    const int blue = y + ((kBCb * xb + kOneHalf) >> 16);
    bgr[3 * p] = static_cast<uint8_t>(min(max(blue, 0), 255));
    bgr[3 * p + 1] = static_cast<uint8_t>(min(max(green, 0), 255));
    bgr[3 * p + 2] = static_cast<uint8_t>(min(max(red, 0), 255));
  }
  uint8_t* dst = out + (static_cast<size_t>(r) * W + c) * 3;
  if (c + 4 <= W && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    uint32_t words[3];
    memcpy(words, bgr, 12);
    reinterpret_cast<uint32_t*>(dst)[0] = words[0];
    reinterpret_cast<uint32_t*>(dst)[1] = words[1];
    reinterpret_cast<uint32_t*>(dst)[2] = words[2];
  } else {
    const int n = 3 * min(4, W - c);
    for (int b = 0; b < n; ++b) dst[b] = bgr[b];
  }
}

}  // namespace

// Launch both kernels on `stream`: frame and out are (H, W, 3) uint8 on the
// device, scratch holds 1.5 hp wp bytes (hp, wp: H and W rounded up to 16),
// tables the (2, 64) quantisation tables in natural order on the host
// (passed by value into the launch, so a CUDA graph keeps them). Returns a
// CUDA error code: cudaErrorInvalidValue for an empty frame, else
// cudaGetLastError() after each launch.
extern "C" int jpeg_round_trip_launch(const void* frame, void* out, void* scratch, int H, int W,
                                      const int* tables, void* stream) {
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  memcpy(t.q, tables, sizeof(t.q));
  const int hp = (H + 15) / 16 * 16, wp = (W + 15) / 16 * 16;
  auto* ys = static_cast<uint8_t*>(scratch);
  uint8_t* cbs = ys + static_cast<size_t>(hp) * wp;
  uint8_t* crs = cbs + static_cast<size_t>(hp / 2) * (wp / 2);
  auto* s = static_cast<cudaStream_t>(stream);
  const dim3 strips((wp + kTileW - 1) / kTileW, hp / kTileH);
  jpeg_round_trip_blocks<<<strips, kThreads, 0, s>>>(static_cast<const uint8_t*>(frame), ys, cbs, crs,
                                                     H, W, wp, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (W + 3) / 4;
  const dim3 rows((groups + kColourThreads - 1) / kColourThreads, H);
  jpeg_round_trip_colour<<<rows, kColourThreads, 0, s>>>(ys, cbs, crs, static_cast<uint8_t*>(out), H,
                                                        W, wp);
  return static_cast<int>(cudaGetLastError());
}
