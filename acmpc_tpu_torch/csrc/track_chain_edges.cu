// Track-chain edges for Hopper (sm_90a): one launch per frame takes the
// (H, W) drivable mask to each row's leftmost and rightmost column of
// the run chain connected to the vehicle.
//
// Replaces acmpc_tpu/perception/tracks.py:62-173: select_vehicle_connected_runs
// (l.62: the usable rows above the bonnet, the OR of each `band`-row block,
// the AND of the band selection back onto the rows, the fallback to the
// raw mask when nothing was selected), its _chain_scan (l.121, an XLA
// lax.scan) and row_edge_columns (l.162) on the result. Per band, from the
// one holding row bonnet - 1 up:
//
//   seeds = row & (started ? prev_sel : central third [W/3, 2W/3))
//   sel   = the runs of `row` that hold a seed; has = any(sel)
//   started |= has; miss = has ? 0 : miss + started; dead = miss > gap
//   prev_sel = has ? sel : prev_sel
//
// What bounds it on this card. The bytes are few: the mask read once
// (0.94 MB at 1280x736) and 17 bytes of edges a row written, 0.28 us at
// 3.35 TB/s. The chain is not: each band depends on the one below, so
// the ~150 usable bands at band 4 (600 rows at band 1) are that many
// dependent steps, and the time is their latency. A one-CTA scan of the
// band rows alone, a column a thread, paid three block barriers and a
// per-column loop a row, about 1.27 us; the PyTorch ops around it cost
// ~20 more launches a frame.
//
// What the design does about it. One CTA of 16 warps per frame, three
// stages overlapped:
//  1. Warps 1-15 pack the mask, bottom-up from row bonnet - 1 (the rows
//     at and below the bonnet last), four rows a unit: a lane takes 64
//     columns (four 16-byte loads, three such words in flight; byte
//     loads when W is not a multiple of 16) to one 64-bit word, stored
//     to shared memory, and ORs it into its band's row by a shared
//     64-bit atomic. Each warp publishes its count of finished units
//     with a release store, so the walk starts on the first band while
//     the rows above are still loading. A unit the output no longer
//     needs is skipped: rows at and below the bonnet once the chain has
//     started (they output nothing), rows in bands above a dead chain.
//  2. Warp 0 walks the bands with no block barrier, each band row loaded
//     a step before its use. Lane l holds words l, l + 32, ... (K =
//     ceil(words / 32) of them; one at W <= 2048). Seeds spread to their
//     runs by carry arithmetic: inside a word an add's carry chain fills
//     a run above its lowest seed, the same on bit-reversed words below
//     its highest; across lanes the carries are a carry-lookahead on
//     ballots (generate: the word's edge run holds a seed; propagate:
//     the word is all ones), one 32-bit add each way. `has` is
//     __any_sync, so started, miss and dead are warp-uniform registers;
//     a band with a selection writes it over its band row, and a flag;
//     once dead the walk stops (the bands above stay unflagged).
//  3. After one barrier, each row's edges, a lane a row: its bits ANDed
//     with its band's selection (or zero), or its raw bits if the chain
//     never started; the first and last set bit by __ffsll / __clzll.
//     The mask bytes, when asked, a warp a row.
// The walk's dependent chain is what is left of the time: about 22
// dependent instructions a band, four of them bit reversals and three
// warp votes.
// The full-resolution bits stay in shared memory (8 * (ceil(W / 64) | 1)
// bytes a row: 124 KB at 1280x736) rather than being read again from
// L2: one SM pulls the frame at a few hundred GB/s at best, so a second
// read would cost as much again as the packing, while the fallback and
// the AND need every row. Rows are padded to an odd number of words so
// that the 32 rows the edge stage reads at once fall in distinct banks.
// At band 1 the selection overwrites its own row in place (it is a
// subset of the row and the row is read before), so the frame needs the
// rows, plus the band rows when band > 1 (31 KB at band 4), plus a byte
// of flag a band.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kProducers = kWarps - 1;  // warps 1..15 pack; warp 0 walks
constexpr int kUnitRows = 4;            // rows a producer packs a unit
constexpr int kInFlight = 3;            // 64-column words a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
// the opt-in shared memory of a block (227 KB), less room for the
// static arrays; ops/track_chain.py refuses larger frames with the same
// figure
constexpr size_t kMaxDynamicSmem = 232448 - 1024;
constexpr int kMaxWords = 128;  // 64-bit words a row: W <= 8192

// what the walk tells the producers: the chain has started, and the
// bands below `dead_below` will select nothing
struct WalkState {
  int started;
  int dead_below;
};

// Stage stamps, compiled in only with -DTRACK_CHAIN_EDGES_STAMPS
// (bench/chain_stages.py): this SM's clock64 at the start, when the first
// band is loaded, at the walk's end, at the last producer's end and at
// the edge stage's end (its last warp).
#ifdef TRACK_CHAIN_EDGES_STAMPS
__device__ unsigned long long stage_stamps[5];
__device__ __forceinline__ void stamp(int stage) {
  atomicMax(&stage_stamps[stage], static_cast<unsigned long long>(clock64()));
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void publish(int* p, int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ int observe(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

// r / d for r * d < 2^32 by one multiply: m = ceil(2^32 / d), d > 1
__device__ __forceinline__ int quotient(int r, int d, uint32_t m) {
  return d == 1 ? r : static_cast<int>(__umulhi(static_cast<uint32_t>(r), m));
}

// the row packed at step s: rows rbot - 1 down to 0, then H - 1 down to rbot
__device__ __forceinline__ int row_of_step(int s, int rbot, int H) {
  return s < rbot ? rbot - 1 - s : H - 1 - (s - rbot);
}

// bit i set where byte i of w is not zero
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return (__vsetne4(w, 0u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12;
}

// four bits to four 0/1 bytes
__device__ __forceinline__ uint32_t bytes4(uint32_t n) {
  return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint64_t low_bits(int n) {
  return n <= 0 ? 0ull : (n >= 64 ? ~0ull : (1ull << n) - 1ull);
}

// the bits of x's runs that lie at or above a seed of s (s within x): an
// add's carry runs up a run of ones from its lowest seed and stops at the
// first zero
__device__ __forceinline__ uint64_t fill_up(uint64_t x, uint64_t s) {
  return (((x + s) ^ x ^ s) | s) & x;
}

// x's run holding bit 0 (0 if bit 0 is clear)
__device__ __forceinline__ uint64_t bottom_run(uint64_t x) { return x & ~(x + 1ull); }

// 64 columns of one row (n of them inside the row), one byte each in
// four uint4: 16-byte loads, or byte loads where the row is not
// 16-byte aligned
template <bool kVec>
__device__ __forceinline__ void load64(const uint8_t* p, int n, uint4 (&v)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    v[b] = make_uint4(0u, 0u, 0u, 0u);
    if (kVec) {
      if (16 * b < n) v[b] = __ldg(reinterpret_cast<const uint4*>(p) + b);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (16 * b + j < n) w[j >> 2] |= static_cast<uint32_t>(p[16 * b + j] != 0) << (8 * (j & 3));
      v[b] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// one unit's rows (row steps s0 .. s_end - 1) into raw, a 64-bit word an
// item, kInFlight items a lane at a time
template <bool kVec>
__device__ __forceinline__ void pack_unit(const uint8_t* __restrict__ mask, uint64_t* raw,
                                          uint64_t* band_or, int s0, int s_end, int lane,
                                          int H, int W, int nw, int ws, int rbot, int band,
                                          uint32_t band_magic) {
  int s = s0 + lane / nw, j = lane % nw;  // this lane's first item
  while (s < s_end) {
    uint4 v[kInFlight][4];
    int dst[kInFlight], band_dst[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const bool live = s < s_end;
      const int r = row_of_step(min(s, s_end - 1), rbot, H);
      dst[q] = live ? r * ws + j : -1;
      band_dst[q] = live && band > 1 && r < rbot ? quotient(r, band, band_magic) * ws + j : -1;
      load64<kVec>(mask + static_cast<size_t>(r) * W + 64 * j, live ? W - 64 * j : 0, v[q]);
      for (j += 32; j >= nw; j -= nw) ++s;
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (dst[q] < 0) continue;
      uint64_t bits = 0ull;
#pragma unroll
      for (int b = 0; b < 4; ++b) bits |= static_cast<uint64_t>(bits16(v[q][b])) << (16 * b);
      raw[dst[q]] = bits;
      if (band_dst[q] >= 0 && bits != 0ull)
        atomicOr(reinterpret_cast<unsigned long long*>(band_or + band_dst[q]), bits);
    }
  }
}

// stage 1: producer `p` packs units p, p + 15, ... of four row steps,
// skipping a unit whose rows the output no longer needs: rows at and
// below the bonnet once the chain has started, rows above a dead chain
__device__ void pack_rows(const uint8_t* __restrict__ mask, uint64_t* raw,
                          uint64_t* band_or, int* ready, const volatile WalkState* walk, int p,
                          int lane, int H, int W, int nw, int ws, int rbot, int band,
                          uint32_t band_magic) {
  const bool vec = (W & 15) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const int n_units = (H + kUnitRows - 1) / kUnitRows;
  int done = 0;
  for (int u = p; u < n_units; u += kProducers) {
    const int s0 = u * kUnitRows, s_end = min(H, s0 + kUnitRows);
    bool needed = true;
    if (s0 >= rbot) {
      needed = walk->started == 0;
    } else {
      const int top_band = quotient(row_of_step(s0, rbot, H), band, band_magic);
      needed = top_band >= walk->dead_below;
    }
    if (needed) {
      if (vec) {
        pack_unit<true>(mask, raw, band_or, s0, s_end, lane, H, W, nw, ws, rbot, band,
                        band_magic);
      } else {
        pack_unit<false>(mask, raw, band_or, s0, s_end, lane, H, W, nw, ws, rbot, band,
                         band_magic);
      }
    }
    // every lane's stores, then the count: a release that the walk's
    // acquire pairs with
    __syncwarp();
    if (lane == 0) publish(&ready[p], ++done);
  }
  if (lane == 0) stamp(3);
}

// row steps every producer has finished (a prefix of the packing order)
__device__ __forceinline__ int packed_steps(const int* ready, int lane, int H) {
  const int first =
      lane < kProducers ? observe(&ready[lane]) * kProducers + lane : 0x7fffffff;
  const int unit = __reduce_min_sync(kFull, first);
  // the lanes that acquired order the others' reads after them
  __syncwarp();
  return min(unit, (H + kUnitRows - 1) / kUnitRows) * kUnitRows;
}

// waits until every row of band k is packed, then loads its band row
// (lanes past the row's words read its last word)
template <int K>
__device__ __forceinline__ void load_band(const uint64_t* band_rows, const int* ready,
                                          int lane, int H, int nw, int ws, int rbot,
                                          int band, int k, int& packed, uint64_t (&next)[K]) {
  const int need = rbot - k * band;  // row steps up to the band's lowest row
  while (packed < need) packed = packed_steps(ready, lane, H);
  const uint64_t* row = band_rows + static_cast<size_t>(k) * ws;
#pragma unroll
  for (int i = 0; i < K; ++i) next[i] = row[min(i * 32 + lane, nw - 1)];
}

// stage 2: the chain, on warp 0, each band row loaded a step ahead;
// returns whether anything was selected. kBand is the band when fixed
// at compile time (1, whose walk compiles apart), else 0
template <int K, int kBand>
__device__ bool walk_chain(uint64_t* band_rows, uint8_t* has_band,
                           const int* ready, volatile WalkState* walk, int lane,
                           int H, int W, int nw, int ws, int rbot, int band_arg,
                           int gap) {
  const int band = kBand > 0 ? kBand : band_arg;
  const int top = (rbot + band - 1) / band - 1;  // the band holding row rbot - 1
  uint64_t central[K], lanes_of_row[K], prev[K], x[K];
  const int lo = W / 3, hi = 2 * W / 3;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = i * 32 + lane;
    central[i] = low_bits(hi - 64 * j) & ~low_bits(lo - 64 * j);
    lanes_of_row[i] = j < nw ? ~0ull : 0ull;
    prev[i] = 0ull;
  }
  uint64_t next[K];
  int packed = 0;
  bool started = false;
  int miss = 0;
  if (top >= 0) {
    load_band<K>(band_rows, ready, lane, H, nw, ws, rbot, band, top, packed, next);
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = next[i] & lanes_of_row[i];
  }
  if (lane == 0) stamp(1);
  for (int k = top; k >= 0; --k) {
    if (k > 0) load_band<K>(band_rows, ready, lane, H, nw, ws, rbot, band, k - 1, packed, next);
    uint64_t up[K], dn[K], rx[K], sel[K];
    uint32_t full[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint64_t s = x[i] & (started ? prev[i] : central[i]);
      up[i] = fill_up(x[i], s);
      rx[i] = __brevll(x[i]);
      dn[i] = __brevll(fill_up(rx[i], __brevll(s)));
    }
    // carries up the lanes (and from lane 31 of round i to lane 0 of
    // round i + 1): generate where the word's top run holds a seed,
    // propagate where the word is all ones
    uint32_t carry = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t g = __ballot_sync(kFull, static_cast<uint32_t>(up[i] >> 63));
      full[i] = __ballot_sync(kFull, x[i] == ~0ull);
      const uint32_t a = g | full[i];
      const uint64_t sum = static_cast<uint64_t>(a) + g + carry;
      const uint32_t in = static_cast<uint32_t>(sum) ^ a ^ g;
      carry = static_cast<uint32_t>(sum >> 32);
      sel[i] = up[i] | dn[i] | (((in >> lane) & 1u) ? bottom_run(x[i]) : 0ull);
    }
    // and down, on lane-reversed ballots
    carry = 0u;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const uint32_t g = __brev(__ballot_sync(kFull, static_cast<uint32_t>(dn[i] & 1ull)));
      const uint32_t a = g | __brev(full[i]);
      const uint64_t sum = static_cast<uint64_t>(a) + g + carry;
      const uint32_t in = __brev(static_cast<uint32_t>(sum) ^ a ^ g);
      carry = static_cast<uint32_t>(sum >> 32);
      if ((in >> lane) & 1u) sel[i] |= __brevll(bottom_run(rx[i]));
    }
    uint64_t any = 0ull;
#pragma unroll
    for (int i = 0; i < K; ++i) any |= sel[i];
    const bool has = __any_sync(kFull, any != 0ull);
    if (has) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = i * 32 + lane;
        if (j < nw) band_rows[static_cast<size_t>(k) * ws + j] = sel[i];
        prev[i] = sel[i];
      }
      if (lane == 0) {
        has_band[k] = 1;
        if (!started) walk->started = 1;
      }
    }
    started = started || has;
    miss = has ? 0 : miss + (started ? 1 : 0);
    if (miss > gap) {  // dead: the bands below k select nothing
      if (lane == 0) walk->dead_below = k;
      break;
    }
    // the next band row, from loads issued a step ago
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = next[i] & lanes_of_row[i];
  }
  return started;
}

// stage 3: each row's edges, a lane a row: its output bits are its
// bits ANDed with its band's selection (or zero), or its raw bits if the
// chain never started; rows are padded to an odd number of words, so the
// 32 rows a warp reads at once fall in distinct banks. Then, when asked,
// the mask bytes, a warp a row
__device__ void write_rows(const uint64_t* raw, const uint64_t* band_sel,
                           const uint8_t* has_band, bool started, int tid, int warp,
                           int lane, int H, int W, int nw, int ws, int rbot, int band,
                           uint32_t band_magic, long long* left, long long* right,
                           uint8_t* valid, uint8_t* out) {
  auto word = [&](int r, int k, bool keep, int j) {
    const uint64_t f = raw[static_cast<size_t>(r) * ws + j];
    return started ? (keep ? f & band_sel[static_cast<size_t>(k) * ws + j] : 0ull) : f;
  };
  for (int r = tid; r < H; r += kThreads) {
    const int k = quotient(r, band, band_magic);
    const bool keep = r < rbot && has_band[k] != 0;
    int first = -1, last = -1;
    if (!started || keep) {
      for (int j = 0; j < nw; ++j) {
        const uint64_t f = word(r, k, keep, j);
        if (f != 0ull) {
          if (first < 0) first = 64 * j + __ffsll(static_cast<long long>(f)) - 1;
          last = 64 * j + 63 - __clzll(static_cast<long long>(f));
        }
      }
    }
    left[r] = first < 0 ? 0 : first;
    right[r] = last < 0 ? 0 : last;
    valid[r] = last >= 0 ? 1 : 0;
  }
  if (out == nullptr) return;
  const bool vec = (W & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int r = warp; r < H; r += kWarps) {
    const int k = quotient(r, band, band_magic);
    const bool keep = r < rbot && has_band[k] != 0;
    for (int j = lane; j < nw; j += 32) {
      const uint64_t f = word(r, k, keep, j);
      uint8_t* o = out + static_cast<size_t>(r) * W + 64 * j;
      const int n = min(64, W - 64 * j);
      if (vec) {
        for (int b = 0; b < n / 16; ++b) {
          const uint32_t x = static_cast<uint32_t>(f >> (16 * b));
          reinterpret_cast<uint4*>(o)[b] =
              make_uint4(bytes4(x), bytes4(x >> 4), bytes4(x >> 8), bytes4(x >> 12));
        }
      } else {
        for (int b = 0; b < n; ++b) o[b] = static_cast<uint8_t>((f >> b) & 1ull);
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    track_chain_edges_kernel(const uint8_t* __restrict__ mask, int H, int W,
                             int rbot, int band, int gap, long long* left,
                             long long* right, uint8_t* valid, uint8_t* out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ready[kProducers];
  __shared__ WalkState walk;
  __shared__ int chain_started;

  const int nw = (W + 63) / 64;
  const int ws = nw | 1;  // words a row takes in shared memory
  const int n_bands = (H + band - 1) / band;
  const uint32_t band_magic = band > 1 ? 0xffffffffu / band + 1u : 0u;
  uint64_t* raw = reinterpret_cast<uint64_t*>(smem);
  // each band's row (the OR of its usable rows), then its selection in
  // its place; at band 1 the rows themselves
  uint64_t* band_sel = band == 1 ? raw : raw + static_cast<size_t>(H) * ws;
  uint8_t* has_band = reinterpret_cast<uint8_t*>(
      raw + static_cast<size_t>(H) * ws + (band == 1 ? 0 : static_cast<size_t>(n_bands) * ws));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < n_bands; k += kThreads) has_band[k] = 0;
  if (band > 1)
    for (int i = tid; i < n_bands * ws; i += kThreads) band_sel[i] = 0ull;
  if (tid < kProducers) ready[tid] = 0;
  if (tid == 0) {
    walk.started = 0;
    walk.dead_below = -1;
#ifdef TRACK_CHAIN_EDGES_STAMPS
    for (int i = 0; i < 5; ++i) stage_stamps[i] = 0ull;
#endif
  }
  __syncthreads();
  if (tid == 0) stamp(0);

  if (warp == 0) {
    const bool started =
        band == 1 ? walk_chain<K, 1>(band_sel, has_band, ready, &walk, lane, H, W, nw, ws,
                                     rbot, band, gap)
                  : walk_chain<K, 0>(band_sel, has_band, ready, &walk, lane, H, W, nw, ws,
                                     rbot, band, gap);
    if (lane == 0) {
      chain_started = started;
      stamp(2);
    }
  } else {
    pack_rows(mask, raw, band_sel, ready, &walk, warp - 1, lane, H,
              W, nw, ws, rbot, band, band_magic);
  }
  __syncthreads();
  write_rows(raw, band_sel, has_band, chain_started != 0, tid, warp, lane, H, W, nw, ws,
             rbot, band, band_magic, left, right, valid, out);
  if (lane == 0) stamp(4);
}

// Dynamic shared memory of one frame: the packed rows, the band rows
// when band > 1, a flag byte a band.
size_t smem_bytes(int H, int W, int band) {
  const size_t ws = ((static_cast<size_t>(W) + 63) / 64) | 1;  // words a row, odd
  const size_t n_bands = (static_cast<size_t>(H) + band - 1) / band;
  return 8 * ws * H + (band > 1 ? 8 * ws * n_bands : 0) + n_bands;
}

template <int K>
cudaError_t launch(const uint8_t* mask, int H, int W, int rbot, int band, int gap,
                   long long* left, long long* right, uint8_t* valid, uint8_t* out,
                   size_t smem, cudaStream_t stream) {
  static size_t opted_in = 0;  // the largest size this instance was allowed
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_chain_edges_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  track_chain_edges_kernel<K><<<1, kThreads, smem, stream>>>(
      mask, H, W, rbot, band, gap, left, right, valid, out);
  return cudaGetLastError();
}

}  // namespace

#ifdef TRACK_CHAIN_EDGES_STAMPS
// The last launch's stage stamps (see stamp()), after a synchronise.
extern "C" int track_chain_edges_read_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, stage_stamps, sizeof(stage_stamps)));
}
#endif

// Launch on `stream`: mask is (H, W) bytes on the device (0 = empty,
// anything else drivable), bonnet the first row not usable, band >= 1
// rows a chain step, gap >= 0 the steps a chain survives with no
// selection. Writes left and right (int64) and valid (bool) per row and,
// when out is not null, the (H, W) 0/1 selected mask. Returns a CUDA
// error code: cudaErrorInvalidValue for a shape the kernel does not take
// (W above 8192, a frame above the shared memory), else
// cudaGetLastError() after the launch.
extern "C" int track_chain_edges_launch(const void* mask, int H, int W, int bonnet,
                                        int band, int gap, void* left, void* right,
                                        void* valid, void* out, void* stream) {
  if (H <= 0 || W <= 0 || band <= 0 || gap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (W + 63) / 64;
  const size_t smem = smem_bytes(H, W, band);
  if (nw > kMaxWords || smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int rbot = bonnet < 0 ? 0 : (bonnet > H ? H : bonnet);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* l = static_cast<long long*>(left);
  auto* r = static_cast<long long*>(right);
  auto* v = static_cast<uint8_t*>(valid);
  auto* o = static_cast<uint8_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nw <= 32) {
    err = launch<1>(m, H, W, rbot, band, gap, l, r, v, o, smem, s);
  } else if (nw <= 64) {
    err = launch<2>(m, H, W, rbot, band, gap, l, r, v, o, smem, s);
  } else {
    err = launch<4>(m, H, W, rbot, band, gap, l, r, v, o, smem, s);
  }
  return static_cast<int>(err);
}
