// Connected-run chain scan for Hopper (sm_90a): one CTA walks the
// frame's rows bottom-up inside the kernel.
//
// Replaces acmpc_tpu/perception/tracks.py:121 (_chain_scan), an XLA
// lax.scan, not a Pallas kernel. Over (N, W) boolean rows, from the last
// row up:
//
//   run_id = cumsum(~row)                  runs of drivable pixels
//   seeds  = row & (started ? prev_sel : central third)
//   sel    = row & (some seed in the pixel's run); 0 once dead
//   has    = any(sel)
//   started |= has; miss = has ? 0 : miss + started; dead |= miss > gap
//   prev_sel = has ? sel : prev_sel
//
// What bounds it on this card. Each row depends on the one below it, so
// the N rows (184 at 1280x736 with 4-row bands) are N dependent
// block-wide steps. The bytes are few (the rows read once and the
// selection written once: 1.2 MB at 1280x736, band 4, under 1 us at
// 3.35 TB/s), so neither bytes nor operations bound it: the latency of
// the chain does, a few block barriers per row. Written as PyTorch ops,
// each step is about 20 launches, ~4,000 per frame, which the host
// issues one by one.
//
// What the design does about it. One launch for the whole chain: one
// CTA of 256 threads per frame loops over the rows, each thread owning a
// strip of ceil(W / 256) adjacent columns (5 at W = 1280) as a bit mask
// in registers. Per row: a warp-shuffle scan plus a shared table of warp
// sums gives each strip its count of empty pixels before it, hence the
// run ids; each seed stamps its run in a shared table of W + 1 run
// stamps (a plain store of the row's stamp; no clearing, no atomics);
// after a barrier each pixel reads its run's stamp; __syncthreads_or
// gives `has`, so `started`, `miss` and `dead` are block-uniform
// registers. Three barriers per row. The next row's bytes are loaded at
// the top of each step, so their latency hides behind this row's work;
// once the chain is dead the remaining rows are written as zeros with no
// barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// columns per thread, one bit each in a 32-bit mask: W <= 8192
constexpr int kMaxCols = 32;

__device__ __forceinline__ uint32_t load_strip(const uint8_t* row, int ncols) {
  uint32_t bits = 0;
  for (int j = 0; j < ncols; ++j) bits |= static_cast<uint32_t>(row[j] != 0) << j;
  return bits;
}

__global__ void __launch_bounds__(kThreads)
    track_chain_scan_kernel(const uint8_t* __restrict__ rows,
                            uint8_t* __restrict__ out, int N, int W, int cols,
                            int gap) {
  extern __shared__ int stamp_of_run[];  // W + 1 entries
  __shared__ int warp_empties[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = tid * cols;
  const int ncols = max(0, min(cols, W - c0));  // this strip: [c0, c0 + ncols)

  for (int k = tid; k <= W; k += kThreads) stamp_of_run[k] = 0;
  uint32_t central = 0;
  for (int j = 0; j < ncols; ++j) {
    const int c = c0 + j;
    if (c >= W / 3 && c < 2 * W / 3) central |= 1u << j;
  }

  uint32_t prev = 0;
  bool started = false, dead = false;
  int miss = 0;
  uint32_t next = load_strip(rows + static_cast<size_t>(N - 1) * W + c0, ncols);
  __syncthreads();  // the stamp table is cleared

  for (int step = 0; step < N; ++step) {
    const int r = N - 1 - step;
    const uint32_t row = next;
    if (r > 0) next = load_strip(rows + static_cast<size_t>(r - 1) * W + c0, ncols);
    uint8_t* out_row = out + static_cast<size_t>(r) * W + c0;
    if (dead) {  // block-uniform: every thread takes this branch
      for (int j = 0; j < ncols; ++j) out_row[j] = 0;
      continue;
    }

    // empty pixels before this strip: an exclusive scan over the block
    const int empties = ncols - __popc(row);
    int incl = empties;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_empties[warp] = incl;
    __syncthreads();
    int base = incl - empties;
    for (int w = 0; w < warp; ++w) base += warp_empties[w];

    // a drivable pixel's run id is the count of empty pixels up to it
    // (jnp.cumsum(~row)); each seed stamps its run with this row's stamp
    const int stamp = step + 1;
    const uint32_t seeds = row & (started ? prev : central);
    int id = base;
    for (int j = 0; j < ncols; ++j) {
      if (!((row >> j) & 1u)) {
        ++id;
      } else if ((seeds >> j) & 1u) {
        stamp_of_run[id] = stamp;
      }
    }
    __syncthreads();
    uint32_t sel = 0;
    id = base;
    for (int j = 0; j < ncols; ++j) {
      if (!((row >> j) & 1u)) {
        ++id;
      } else if (stamp_of_run[id] == stamp) {
        sel |= 1u << j;
      }
    }
    // also orders this row's reads of the tables before the next row's
    // writes
    const bool has = __syncthreads_or(sel != 0u);
    for (int j = 0; j < ncols; ++j) out_row[j] = static_cast<uint8_t>((sel >> j) & 1u);

    started = started || has;
    if (has) {
      miss = 0;
      prev = sel;
    } else if (started) {
      ++miss;
    }
    dead = miss > gap;  // dead was false on this path
  }
}

}  // namespace

// Launch on `stream`: rows and out are (N, W) bytes on the device (0 =
// empty, anything else drivable; out gets 0/1). Returns a CUDA error code:
// cudaErrorInvalidValue for a width above 32 * 256 columns, else
// cudaGetLastError() after the launch.
extern "C" int track_chain_scan_launch(const void* rows, void* out, int N,
                                       int W, int gap, void* stream) {
  if (N <= 0 || W <= 0) return 0;
  const int cols = (W + kThreads - 1) / kThreads;
  if (cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * (static_cast<size_t>(W) + 1);
  track_chain_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<uint8_t*>(out), N, W, cols,
      gap);
  return static_cast<int>(cudaGetLastError());
}
