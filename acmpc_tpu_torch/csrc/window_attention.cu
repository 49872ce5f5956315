// Shifted-window attention with relative position bias (Liu et al., Swin
// Transformer, arXiv:2103.14030), the attention core of one Swin block as
// Mask2Former's D2SwinTransformer runs it: one launch a block.
//
// Replaces no TPU kernel: the JAX package has no Swin. The published block
// pads the normed map to whole windows, rolls it by -shift, partitions it
// into windows, runs the qkv Linear, forms softmax(q k^T / sqrt(d) + B_rel +
// M_shift) v per window and head, and reverses the partition, the roll and
// the padding: about ten passes over the residual stream and the (windows x
// heads x n x n) scores a block. No library kernel takes this layout with
// a bias and a region mask made from indices. This kernel takes the qkv
// Linear's output of the real tokens as it is and turns the padding, the
// shift, the partition and its reverse into index arithmetic:
//
//   qkv   (N, H, W, 3C)   the qkv Linear of the real tokens: q | k | v, head h
//                          at channels h * 32 .. h * 32 + 31 of each
//   bias  (3C)            the qkv Linear's bias: the q, k and v of a token of
//                          the zero padding (the Linear of a zero)
//   table ((2w-1)^2, heads)  the relative position bias table
//   out   (N, H, W, C)    each real token's output at its own place
//
// Window (wy, wx) of the map rolled by -s and padded to Hp x Wp holds, at
// row r and column c, the rolled position (ys, xs) = (wy w + r, wx w + c),
// which is the unrolled (y, x) = ((ys + s) mod Hp, (xs + s) mod Wp): a real
// token where y < H and x < W, else a token of the padding (its key and
// value the bias, as published: padding is unmasked in unshifted windows).
// Per window and head, in float32 from bf16 products:
//
//   s_ij = (q_i . k_j) / sqrt(32) + table[(r_i - r_j + w - 1) (2w - 1)
//                                          + (c_i - c_j + w - 1), head]
//          - 100 in shifted blocks (s > 0) where the rolled positions of i
//            and j lie in different regions: rows [0, Hp - w), [Hp - w,
//            Hp - s), [Hp - s, Hp), and the same of columns (the
//            published mask)
//   out_i = sum_j softmax_j(s_ij) v_j
//
// What bounds it: bytes. The real tokens' q, k and v are read once and the
// output written once (4 C bf16 a token: 700.9 MB over Swin-L's 24 blocks
// at 1280x736, 0.209 ms at 3.35 TB/s), against 50.5 GFLOP of
// Q K^T and P V (0.051 ms at the bf16 peak). Design (bf16): a CTA a
// (window, head), a warp a tile of 16 queries (9 warps at w = 12: the
// window's 144 tokens, no remainder); the window's Q, K and V of the head
// (27 KB) in shared memory, V transposed, rows padded so that the fragment
// loads meet no bank twice; Q K^T and P V on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 sums), a warp's 16 x 144 scores held
// in registers for the softmax (float32, max and sum across the quad that
// shares a row), P rounded to bf16 for P V as FlashAttention does; the
// output staged through the warp's own Q rows and stored 16 bytes a lane.
// A float32 map takes a CUDA-core kernel (a thread a query, two passes over
// the keys in shared memory): no tensor core rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kMaxWindow = 12;
constexpr int kMaxTokens = kMaxWindow * kMaxWindow;                     // 144
constexpr int kMaxTable = (2 * kMaxWindow - 1) * (2 * kMaxWindow - 1);  // 529
constexpr int kPadded = -1;  // a token of the zero padding: q, k, v are the bias
constexpr int kBeyond = -2;  // a row past the window's tokens (an mma tile's remainder)
constexpr int kLdQ = kHeadDim + 8;  // bf16 a row of Q and K: conflict-free fragment loads
constexpr float kMasked = -100.0f;  // the published region mask

struct Geometry {
  int H, W;    // the real grid
  int Hp, Wp;  // padded to whole windows
  int ws, shift;
  int nWx, nW;  // windows a row, an image
  int C, heads;
  float scale;
};

// window position p's token (kPadded for the padding), its region label
// (shifted blocks) and its relative coordinate r (2w - 1) + c
__device__ __forceinline__ void locate(const Geometry& g, int window, int p, int& tok, int& label,
                                       int& rel) {
  const int n = window / g.nW;
  const int w = window - n * g.nW;
  const int wy = w / g.nWx, wx = w - wy * g.nWx;
  const int r = p / g.ws, c = p - r * g.ws;
  const int ys = wy * g.ws + r, xs = wx * g.ws + c;  // in the rolled, padded map
  int y = ys + g.shift, x = xs + g.shift;
  if (y >= g.Hp) y -= g.Hp;
  if (x >= g.Wp) x -= g.Wp;
  tok = (y < g.H && x < g.W) ? (n * g.H + y) * g.W + x : kPadded;
  label = 0;
  if (g.shift) {
    const int hr = ys < g.Hp - g.ws ? 0 : (ys < g.Hp - g.shift ? 1 : 2);
    const int wr = xs < g.Wp - g.ws ? 0 : (xs < g.Wp - g.shift ? 1 : 2);
    label = 3 * hr + wr;
  }
  rel = r * (2 * g.ws - 1) + c;
}

// the prologue both kernels share: each position's token, label and
// relative coordinate, the head's column of the table as float32
template <typename T>
__device__ __forceinline__ void window_setup(const Geometry& g, const T* __restrict__ table, int rows,
                                             int* toks, int* labels, int* rels, float* tab) {
  const int n = g.ws * g.ws;
  for (int p = threadIdx.x; p < rows; p += blockDim.x) {
    int tok = kBeyond, label = 0, rel = 0;
    if (p < n) locate(g, blockIdx.x, p, tok, label, rel);
    toks[p] = tok;
    labels[p] = label;
    rels[p] = rel;
  }
  const int entries = (2 * g.ws - 1) * (2 * g.ws - 1);
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    if constexpr (sizeof(T) == 2) {
      tab[i] = __bfloat162float(table[i * g.heads + blockIdx.y]);
    } else {
      tab[i] = table[i * g.heads + blockIdx.y];
    }
  }
}

// the score's bias and mask of query (rel_q, label_q) and key (rel_k, label_k)
__device__ __forceinline__ float bias_mask(const float* tab, int centre, int rel_q, int label_q, int rel_k,
                                           int label_k) {
  return tab[centre + rel_q - rel_k] + (label_q != label_k ? kMasked : 0.0f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16, tensor cores: KT tiles of 16 queries (one a warp) and of 16 keys
template <int KT>
__global__ void __launch_bounds__(32 * KT) window_attention_mma(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ table, __nv_bfloat16* __restrict__ out, Geometry g) {
  constexpr int NP = 16 * KT;     // the window's positions, padded to whole tiles
  constexpr int kLdV = NP + 8;    // bf16 a row of V^T: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 Qs[NP * kLdQ];
  __shared__ __align__(16) __nv_bfloat16 Ks[NP * kLdQ];
  __shared__ __align__(16) __nv_bfloat16 Vt[kHeadDim * kLdV];
  __shared__ float tab[kMaxTable];
  __shared__ int toks[NP], labels[NP], rels[NP];

  const int n = g.ws * g.ws;
  const int head = blockIdx.y;
  window_setup(g, table, NP, toks, labels, rels, tab);
  __syncthreads();

  // the head's q, k and v of every position: 16-byte loads, 4 a vector,
  // 6 a thread (NP * 12 vectors over 32 KT threads), all issued before the
  // first store so that they are in flight together
  constexpr int kLoads = NP * 12 / (32 * KT);
  static_assert(kLoads * 32 * KT == NP * 12, "the vectors split evenly over the threads");
  const long long row = 3LL * g.C;
  uint4 vals[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = threadIdx.x + it * 32 * KT;
    const int p = i / 12, rem = i - 12 * p;
    const int tok = toks[p];
    const int col = (rem >> 2) * g.C + head * kHeadDim + (rem & 3) * 8;
    vals[it] = make_uint4(0u, 0u, 0u, 0u);
    if (tok >= 0) {
      vals[it] = __ldg(reinterpret_cast<const uint4*>(qkv + tok * row + col));
    } else if (tok == kPadded) {
      vals[it] = __ldg(reinterpret_cast<const uint4*>(bias + col));
    }
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = threadIdx.x + it * 32 * KT;
    const int p = i / 12, rem = i - 12 * p;
    const int part = rem >> 2, sub = rem & 3;
    const uint4 v = vals[it];
    if (part == 0) {
      *reinterpret_cast<uint4*>(&Qs[p * kLdQ + sub * 8]) = v;
    } else if (part == 1) {
      *reinterpret_cast<uint4*>(&Ks[p * kLdQ + sub * 8]) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) Vt[(sub * 8 + k) * kLdV + p] = e[k];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp + gid, r1 = r0 + 8;

  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = 16 * ks + 2 * tq;
    qa[ks][0] = lds32(&Qs[r0 * kLdQ + c]);
    qa[ks][1] = lds32(&Qs[r1 * kLdQ + c]);
    qa[ks][2] = lds32(&Qs[r0 * kLdQ + c + 8]);
    qa[ks][3] = lds32(&Qs[r1 * kLdQ + c + 8]);
  }

  // S = Q K^T: 2 KT tiles of 8 keys, c0 c1 on row r0, c2 c3 on row r1
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const int key = 8 * j + gid;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c = 16 * ks + 2 * tq;
      mma_bf16(s[j], qa[ks], lds32(&Ks[key * kLdQ + c]), lds32(&Ks[key * kLdQ + c + 8]));
    }
  }

  // scale, bias and mask, then the softmax's row maxima
  const int centre = (g.ws - 1) * 2 * g.ws;
  const int rq0 = rels[r0], rq1 = rels[r1], lq0 = labels[r0], lq1 = labels[r1];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * j + 2 * tq + e;
      if (key < n) {
        const int rk = rels[key], lk = labels[key];
        s[j][e] = s[j][e] * g.scale + bias_mask(tab, centre, rq0, lq0, rk, lk);
        s[j][2 + e] = s[j][2 + e] * g.scale + bias_mask(tab, centre, rq1, lq1, rk, lk);
      } else {
        s[j][e] = s[j][2 + e] = -INFINITY;
      }
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = __expf(s[j][e] - m0);
      s[j][2 + e] = __expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // O = P V: P's A fragments are the score tiles 2 kk and 2 kk + 1 in bf16
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int key = 16 * kk + 2 * tq;
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) {
      const int dim = 8 * d + gid;
      mma_bf16(acc[d], pa, lds32(&Vt[dim * kLdV + key]), lds32(&Vt[dim * kLdV + key + 8]));
    }
  }

  // normalise, stage in the warp's own Q rows, store 16 bytes a lane
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = 8 * d + 2 * tq;
    *reinterpret_cast<uint32_t*>(&Qs[r0 * kLdQ + c]) = pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(&Qs[r1 * kLdQ + c]) = pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int chunk = lane + 32 * it;
    const int p = 16 * warp + (chunk >> 2), sub = chunk & 3;
    const int tok = p < n ? toks[p] : kBeyond;
    if (tok >= 0) {
      *reinterpret_cast<uint4*>(out + static_cast<long long>(tok) * g.C + head * kHeadDim + sub * 8) =
          *reinterpret_cast<const uint4*>(&Qs[p * kLdQ + sub * 8]);
    }
  }
}

// float32, CUDA cores: a thread a query, two passes over the keys (the
// maximum, then the exponentials' sum and the weighted values)
__global__ void __launch_bounds__(160) window_attention_f32(const float* __restrict__ qkv,
                                                            const float* __restrict__ bias,
                                                            const float* __restrict__ table,
                                                            float* __restrict__ out, Geometry g) {
  __shared__ __align__(16) float Ks[kMaxTokens * kHeadDim];
  __shared__ __align__(16) float Vs[kMaxTokens * kHeadDim];
  __shared__ float tab[kMaxTable];
  __shared__ int toks[kMaxTokens], labels[kMaxTokens], rels[kMaxTokens];

  const int n = g.ws * g.ws;
  const int head = blockIdx.y;
  window_setup(g, table, n, toks, labels, rels, tab);
  __syncthreads();

  const long long row = 3LL * g.C;
  auto vector = [&](int tok, int part, int sub) {
    const int col = part * g.C + head * kHeadDim + sub * 4;
    return tok >= 0 ? __ldg(reinterpret_cast<const float4*>(qkv + tok * row + col))
                    : __ldg(reinterpret_cast<const float4*>(bias + col));
  };
  for (int i = threadIdx.x; i < n * 16; i += blockDim.x) {
    const int p = i >> 4, part = 1 + ((i >> 3) & 1), sub = i & 7;
    *reinterpret_cast<float4*>(&(part == 1 ? Ks : Vs)[p * kHeadDim + sub * 4]) = vector(toks[p], part, sub);
  }
  __syncthreads();

  const int p = threadIdx.x;
  if (p >= n) return;
  const int tok = toks[p];
  if (tok < 0) return;  // a query of the padding: cropped
  float q[kHeadDim];
#pragma unroll
  for (int sub = 0; sub < kHeadDim / 4; ++sub) {
    const float4 v = vector(tok, 0, sub);
    q[4 * sub] = v.x;
    q[4 * sub + 1] = v.y;
    q[4 * sub + 2] = v.z;
    q[4 * sub + 3] = v.w;
  }
  const int centre = (g.ws - 1) * 2 * g.ws;
  const int rq = rels[p], lq = labels[p];
  auto score = [&](int key) {
    float dot = 0.0f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) dot = fmaf(q[d], Ks[key * kHeadDim + d], dot);
    return dot * g.scale + bias_mask(tab, centre, rq, lq, rels[key], labels[key]);
  };
  float m = -INFINITY;
  for (int key = 0; key < n; ++key) m = fmaxf(m, score(key));
  float l = 0.0f, acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.0f;
  for (int key = 0; key < n; ++key) {
    const float e = expf(score(key) - m);
    l += e;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(e, Vs[key * kHeadDim + d], acc[d]);
  }
  const float inv = 1.0f / l;
  float* o = out + static_cast<long long>(tok) * g.C + head * kHeadDim;
#pragma unroll
  for (int sub = 0; sub < kHeadDim / 4; ++sub) {
    reinterpret_cast<float4*>(o)[sub] =
        make_float4(acc[4 * sub] * inv, acc[4 * sub + 1] * inv, acc[4 * sub + 2] * inv, acc[4 * sub + 3] * inv);
  }
}

template <int KT>
void launch_mma(dim3 grid, const void* qkv, const void* bias, const void* table, void* out, const Geometry& g,
                cudaStream_t stream) {
  window_attention_mma<KT><<<grid, 32 * KT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(table), static_cast<__nv_bfloat16*>(out), g);
}

}  // namespace

// dtype 0: bf16 (tensor cores), 1: float32. Returns the launch's CUDA error
// (0 on success); 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
extern "C" int window_attention_launch(const void* qkv, const void* bias, const void* table, void* out,
                                       int dtype, int N, int H, int W, int C, int heads, int window,
                                       int shift, void* stream) {
  if (window < 1 || window > kMaxWindow || shift < 0 || shift >= window || C != heads * kHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.H = H;
  g.W = W;
  g.Hp = (H + window - 1) / window * window;
  g.Wp = (W + window - 1) / window * window;
  g.ws = window;
  g.shift = shift;
  g.nWx = g.Wp / window;
  g.nW = (g.Hp / window) * g.nWx;
  g.C = C;
  g.heads = heads;
  g.scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const dim3 grid(N * g.nW, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    window_attention_f32<<<grid, (window * window + 31) / 32 * 32, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias), static_cast<const float*>(table),
        static_cast<float*>(out), g);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((window * window + 15) / 16) {
    case 1: launch_mma<1>(grid, qkv, bias, table, out, g, s); break;
    case 2: launch_mma<2>(grid, qkv, bias, table, out, g, s); break;
    case 3: launch_mma<3>(grid, qkv, bias, table, out, g, s); break;
    case 4: launch_mma<4>(grid, qkv, bias, table, out, g, s); break;
    case 5: launch_mma<5>(grid, qkv, bias, table, out, g, s); break;
    case 6: launch_mma<6>(grid, qkv, bias, table, out, g, s); break;
    case 7: launch_mma<7>(grid, qkv, bias, table, out, g, s); break;
    case 8: launch_mma<8>(grid, qkv, bias, table, out, g, s); break;
    default: launch_mma<9>(grid, qkv, bias, table, out, g, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
