// Nearest-neighbour + 2-opt tour ordering for map boundary point clouds.
//
// The port's copy of the JAX package's native tour
// (acmpc_tpu/native/tsp_tour.cpp): inputs are near-ordered noisy laps, so
// a greedy construction plus 2-opt refinement under a time bound
// reproduces the lap loop. Host code, exposed through a C ABI for ctypes.
//
// Built at first use by acmpc_tpu_torch/native.py (ops/cuda_build.py,
// build_host_library) into build/torch_kernels/.

#include <chrono>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double dist2(const float* xy, int a, int b) {
  const double dx = double(xy[2 * a]) - double(xy[2 * b]);
  const double dy = double(xy[2 * a + 1]) - double(xy[2 * b + 1]);
  return dx * dx + dy * dy;
}

inline double dist(const float* xy, int a, int b) {
  return std::sqrt(dist2(xy, a, b));
}

double now_s() {
  using namespace std::chrono;
  return duration<double>(steady_clock::now().time_since_epoch()).count();
}

}  // namespace

extern "C" {

// Orders n 2-D points into a closed tour. `order` receives the n indices.
// Spends at most `time_bound_s` seconds in 2-opt refinement.
void acmpc_tsp_tour(const float* xy, int n, int* order, double time_bound_s) {
  if (n <= 0) return;
  if (n == 1) { order[0] = 0; return; }

  // ---- nearest-neighbour construction --------------------------------
  std::vector<int> tour;
  tour.reserve(n);
  std::vector<uint8_t> used(n, 0);
  int current = 0;
  used[0] = 1;
  tour.push_back(0);
  for (int step = 1; step < n; ++step) {
    int best = -1;
    double best_d = 1e300;
    for (int j = 0; j < n; ++j) {
      if (used[j]) continue;
      const double d = dist2(xy, current, j);
      if (d < best_d) { best_d = d; best = j; }
    }
    used[best] = 1;
    tour.push_back(best);
    current = best;
  }

  // ---- 2-opt refinement under the time bound --------------------------
  const double t_end = now_s() + time_bound_s;
  bool improved = true;
  while (improved && now_s() < t_end) {
    improved = false;
    for (int i = 0; i < n - 1; ++i) {
      const int a = tour[i];
      const int a2 = tour[i + 1];
      const double d_a = dist(xy, a, a2);
      for (int j = i + 2; j < n; ++j) {
        const int b = tour[j];
        const int b2 = tour[(j + 1) % n];
        if (a == b2) continue;
        const double delta =
            dist(xy, a, b) + dist(xy, a2, b2) - d_a - dist(xy, b, b2);
        if (delta < -1e-9) {
          // reverse tour[i+1 .. j]
          for (int lo = i + 1, hi = j; lo < hi; ++lo, --hi) {
            const int tmp = tour[lo];
            tour[lo] = tour[hi];
            tour[hi] = tmp;
          }
          improved = true;
          break;  // d_a changed; restart this i
        }
      }
      if ((i & 63) == 0 && now_s() >= t_end) break;
    }
  }

  for (int i = 0; i < n; ++i) order[i] = tour[i];
}

}  // extern "C"
