// Native greedy box NMS — C++ equivalent of the reference's compiled
// extension (misc/nms/cpu_nms.pyx:20-71), exposed to Python via ctypes
// (simple_hrnet_tpu_torch/ops/nms.py::nms_numpy). The port's own copy of
// the JAX package's native/nms.cpp, built at first use by
// simple_hrnet_tpu_torch/ops/cuda/build.py::host_library.
//
// Semantics are identical to the Cython version: score-descending greedy
// selection with the classic +1 box-extent convention, suppressing
// overlap > thresh. dets is row-major (n, 5): [x1, y1, x2, y2, score].
// keep_out must have room for n ints; the return value is the kept count.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

int cpu_nms(const float* dets, int n, float thresh, int* keep_out) {
  if (n <= 0) return 0;

  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + 5 * i;
    areas[i] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
  }

  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  // Tie-break by DESCENDING index: numpy's scores.argsort()[::-1] (used by
  // both the python fallback and the reference Cython cpu_nms) reverses a
  // stable ascending sort, so equal scores come out highest-index first.
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    const float sa = dets[5 * a + 4], sb = dets[5 * b + 4];
    if (sa != sb) return sa > sb;
    return a > b;
  });

  std::vector<uint8_t> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* di = dets + 5 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + 5 * j;
      const float xx1 = std::max(di[0], dj[0]);
      const float yy1 = std::max(di[1], dj[1]);
      const float xx2 = std::min(di[2], dj[2]);
      const float yy2 = std::min(di[3], dj[3]);
      const float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      const float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      const float inter = w * h;
      const float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"
