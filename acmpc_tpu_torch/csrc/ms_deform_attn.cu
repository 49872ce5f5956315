// Multi-scale deformable attention (Zhu et al., Deformable DETR,
// arXiv:2010.04159) as Mask2Former's pixel decoder runs it: the
// sampling of one encoder layer, one launch a layer.
//
// Replaces no TPU kernel: the JAX package has no Mask2Former. PyTorch's
// only composition of the op is F.grid_sample per level plus a reshape,
// sum and weighting (Deformable DETR's ms_deform_attn_core_pytorch):
// several launches and a (heads, head_dim, queries, points) intermediate
// a level. This kernel takes the two linears' outputs as they are and
// does the rest in registers:
//
//   value   (N, S, M, D)           bf16, the value projection
//   offsets (N, S, M, L, P, 2)     bf16, the sampling_offsets linear (x, y)
//   logits  (N, S, M, L * P)       bf16, the attention_weights linear
//   out     (N, S, M, D)           bf16
//
// The queries are the S tokens themselves (the encoder's self-attention):
// query q lies on its own level l_q at (x_q, y_q), and its reference
// point is ((x_q + 0.5) / W_lq, (y_q + 0.5) / H_lq), as the published
// get_reference_points gives it with every valid ratio 1. Per head and
// point, in float32:
//
//   loc   = ref + offset / (W_l, H_l)            (float32, not bf16: a
//            bf16 location at 160 columns is off by up to ~0.3 px)
//   w_im  = loc_x * W_l - 0.5, h_im = loc_y * H_l - 0.5
//   a     = softmax over the L * P logits of the head (float32)
//   out  += a * bilinear(value_l, h_im, w_im)    (zero padding, corners
//            not aligned: grid_sample's, and the published CUDA kernel's
//            four-tap arithmetic)
//
// with the location arithmetic rounded step by step (no contraction to
// fused multiply-adds), as ops/ms_deform_attn.py's plain version rounds it.
//
// What bounds it: the value of a layer (S x 256 bf16, 9.9 MB at 1280x736)
// sits in the 50 MB L2, and each (query, head) gathers L * P * 4 taps of
// D channels from it: the gathers' latency and L2 traffic, not HBM.
// Design: a thread owns 8 channels (one 16-byte load a tap) of one
// (query, head), so four neighbouring threads cover a head's 32 channels
// and a warp eight (query, head) pairs; each thread forms its own
// locations and softmax (12 exps) rather than sharing them, and keeps
// its 8 sums in registers; the output is one 16-byte store a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;  // channels a thread: one 16-byte load of bf16
constexpr int kThreads = 256;
constexpr int L = 3;  // levels (the pixel decoder's res5, res4, res3)
constexpr int P = 4;  // points a level and head

struct Levels {
  int h[L];
  int w[L];
  int start[L];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kChunk]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads) ms_deform_attn_kernel(
    const __nv_bfloat16* __restrict__ value, const __nv_bfloat16* __restrict__ offsets,
    const __nv_bfloat16* __restrict__ logits, __nv_bfloat16* __restrict__ out, int N, int S, int M,
    int D, Levels lv) {
  const int chunks = D / kChunk;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(N) * S * M * chunks) return;
  const int c = static_cast<int>(t % chunks);
  long long r = t / chunks;
  const int m = static_cast<int>(r % M);
  r /= M;
  const int q = static_cast<int>(r % S);
  const int n = static_cast<int>(r / S);

  // the query's own level and position: its reference point
  int lq = 0;
#pragma unroll
  for (int l = 1; l < L; ++l) lq = q >= lv.start[l] ? l : lq;
  const int iq = q - lv.start[lq];
  const int yq = iq / lv.w[lq];
  const int xq = iq - yq * lv.w[lq];
  const float ref_x = __fdiv_rn(static_cast<float>(xq) + 0.5f, static_cast<float>(lv.w[lq]));
  const float ref_y = __fdiv_rn(static_cast<float>(yq) + 0.5f, static_cast<float>(lv.h[lq]));

  // the head's softmax over its L * P points, in float32
  const long long row = (static_cast<long long>(n) * S + q) * M + m;
  const __nv_bfloat16* lg = logits + row * (L * P);
  float a[L * P];
  float top = -INFINITY;
#pragma unroll
  for (int i = 0; i < L * P; ++i) {
    a[i] = __bfloat162float(lg[i]);
    top = fmaxf(top, a[i]);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < L * P; ++i) {
    a[i] = expf(a[i] - top);
    sum += a[i];
  }

  const __nv_bfloat16* off = offsets + row * (L * P * 2);
  const long long pitch = static_cast<long long>(M) * D;  // a token's value row
  const __nv_bfloat16* vbase = value + static_cast<long long>(n) * S * pitch + m * D + c * kChunk;
  float acc[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const float Hf = static_cast<float>(H), Wf = static_cast<float>(W);
    const __nv_bfloat16* vl = vbase + static_cast<long long>(lv.start[l]) * pitch;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float ox = __bfloat162float(off[2 * i]);
      const float oy = __bfloat162float(off[2 * i + 1]);
      const float loc_x = __fadd_rn(ref_x, __fdiv_rn(ox, Wf));
      const float loc_y = __fadd_rn(ref_y, __fdiv_rn(oy, Hf));
      const float w_im = __fsub_rn(__fmul_rn(loc_x, Wf), 0.5f);
      const float h_im = __fsub_rn(__fmul_rn(loc_y, Hf), 0.5f);
      if (!(h_im > -1.f && w_im > -1.f && h_im < Hf && w_im < Wf)) continue;
      const float weight = a[i] / sum;
      const float hl = floorf(h_im), wl = floorf(w_im);
      const int h_low = static_cast<int>(hl), w_low = static_cast<int>(wl);
      const float lh = h_im - hl, lw = w_im - wl;
      const float hh = 1.f - lh, hw = 1.f - lw;
      const float w1 = hh * hw, w2 = hh * lw, w3 = lh * hw, w4 = lh * lw;
      float v1[kChunk], v2[kChunk], v3[kChunk], v4[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) v1[k] = v2[k] = v3[k] = v4[k] = 0.f;
      const bool top_in = h_low >= 0, bottom_in = h_low + 1 <= H - 1;
      const bool left_in = w_low >= 0, right_in = w_low + 1 <= W - 1;
      if (top_in && left_in) load8(vl + (static_cast<long long>(h_low) * W + w_low) * pitch, v1);
      if (top_in && right_in) load8(vl + (static_cast<long long>(h_low) * W + w_low + 1) * pitch, v2);
      if (bottom_in && left_in) load8(vl + (static_cast<long long>(h_low + 1) * W + w_low) * pitch, v3);
      if (bottom_in && right_in) load8(vl + (static_cast<long long>(h_low + 1) * W + w_low + 1) * pitch, v4);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float val = w1 * v1[k] + w2 * v2[k] + w3 * v3[k] + w4 * v4[k];
        acc[k] += weight * val;
      }
    }
  }

  uint4 packed;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int k = 0; k < kChunk / 2; ++k) o[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  *reinterpret_cast<uint4*>(out + row * D + c * kChunk) = packed;
}

}  // namespace

// One launch on ``stream``: the three levels of shapes (h_l, w_l), their
// tokens concatenated in that order (S = sum h_l * w_l). Returns a CUDA
// error code, or cudaErrorInvalidValue for a shape the kernel does not
// take (D a multiple of 8; the wrapper checks it too).
extern "C" int ms_deform_attn_launch(const void* value, const void* offsets, const void* logits,
                                     void* out, int N, int S, int M, int D, int h0, int w0, int h1, int w1,
                                     int h2, int w2, void* stream) {
  if (D % kChunk != 0 || N < 1 || S < 1) return cudaErrorInvalidValue;
  Levels lv{};
  const int hs[L] = {h0, h1, h2}, ws[L] = {w0, w1, w2};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return cudaErrorInvalidValue;
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.start[l] = start;
    start += hs[l] * ws[l];
  }
  if (start != S) return cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(N) * S * M * (D / kChunk);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  ms_deform_attn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const __nv_bfloat16*>(offsets),
      static_cast<const __nv_bfloat16*>(logits), static_cast<__nv_bfloat16*>(out), N, S, M, D, lv);
  return cudaGetLastError();
}
