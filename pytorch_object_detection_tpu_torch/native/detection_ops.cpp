// Native host-side detection runtime ops.
//
// The card does all tensor compute; these are the host-side
// pieces that the reference delegated to native libraries (pycocotools'
// C extension for COCO matching, torchvision's C++ NMS for the CPU path):
//
//   * voc_match      — greedy VOC matching for one (image, class)
//   * coco_match     — COCO-protocol matching across T IoU thresholds
//   * nms_cpu        — exact greedy NMS (CPU fallback / verification oracle)
//
// Exposed as a plain C ABI for ctypes (no pybind11).
// Build: see lib.py (g++ -O3 -shared -fPIC, at first use).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double iou(const float* a, const float* b) {
  const double ix1 = std::max(a[0], b[0]);
  const double iy1 = std::max(a[1], b[1]);
  const double ix2 = std::min(a[2], b[2]);
  const double iy2 = std::min(a[3], b[3]);
  const double iw = std::max(0.0, ix2 - ix1);
  const double ih = std::max(0.0, iy2 - iy1);
  const double inter = iw * ih;
  const double area_a = double(a[2] - a[0]) * double(a[3] - a[1]);
  const double area_b = double(b[2] - b[0]) * double(b[3] - b[1]);
  const double uni = area_a + area_b - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// Greedy VOC matching for one image+class. Predictions must be sorted by
// descending score. Writes tp[j] in {0,1}. Matches the reference protocol
// (test.py:113-144): best-IoU GT must clear the threshold AND be unassigned.
void voc_match(const float* gt_boxes, int n_gt,
               const float* pred_boxes, int n_pred,
               float iou_threshold, uint8_t* tp) {
  std::vector<uint8_t> assigned(n_gt, 0);
  for (int j = 0; j < n_pred; ++j) {
    tp[j] = 0;
    if (n_gt == 0) continue;
    int best = -1;
    double best_iou = -1.0;
    const float* p = pred_boxes + 4 * j;
    for (int g = 0; g < n_gt; ++g) {
      const double v = iou(gt_boxes + 4 * g, p);
      if (v > best_iou) {
        best_iou = v;
        best = g;
      }
    }
    if (best >= 0 && best_iou >= iou_threshold && !assigned[best]) {
      assigned[best] = 1;
      tp[j] = 1;
    }
  }
}

// COCO-protocol matching for one image+class across n_thr thresholds.
// gt_ignore[g] marks crowd/out-of-area GTs. Detections sorted by descending
// score. Outputs (row-major [n_thr, n_pred]):
//   matched[t, j] = 1 if det j matched a real GT at threshold t
//   ignored[t, j] = 1 if det j matched an ignored GT (or is out-of-range
//                   unmatched — the caller pre-computes det_out)
void coco_match(const float* gt_boxes, const uint8_t* gt_ignore,
                const uint8_t* gt_crowd, int n_gt,
                const float* det_boxes, const uint8_t* det_out, int n_det,
                const float* thresholds, int n_thr,
                uint8_t* matched, uint8_t* ignored) {
  // precompute IoU matrix [n_det, n_gt]; crowd GTs use
  // intersection-over-det-area (COCOeval iscrowd semantics)
  std::vector<double> ious(size_t(n_det) * n_gt);
  for (int d = 0; d < n_det; ++d)
    for (int g = 0; g < n_gt; ++g) {
      const float* db = det_boxes + 4 * d;
      const float* gb = gt_boxes + 4 * g;
      if (gt_crowd && gt_crowd[g]) {
        const double ix = std::max(0.0, double(std::min(db[2], gb[2])) - std::max(db[0], gb[0]));
        const double iy = std::max(0.0, double(std::min(db[3], gb[3])) - std::max(db[1], gb[1]));
        const double da = double(db[2] - db[0]) * double(db[3] - db[1]);
        ious[size_t(d) * n_gt + g] = da > 0 ? ix * iy / da : 0.0;
      } else {
        ious[size_t(d) * n_gt + g] = iou(db, gb);
      }
    }

  std::vector<uint8_t> taken(n_gt);
  for (int t = 0; t < n_thr; ++t) {
    std::fill(taken.begin(), taken.end(), 0);
    const double thr = thresholds[t];
    for (int d = 0; d < n_det; ++d) {
      uint8_t* m = matched + size_t(t) * n_det + d;
      uint8_t* ig = ignored + size_t(t) * n_det + d;
      *m = 0;
      *ig = 0;
      int best = -1;
      double best_iou = std::min(double(thr), 1.0 - 1e-10);
      for (int g = 0; g < n_gt; ++g) {
        // only crowd GTs are re-matchable (COCOeval keys this on iscrowd,
        // not on the ignore flag)
        if (taken[g] && !(gt_crowd && gt_crowd[g])) continue;
        // once holding a real match, do not switch to ignored GTs
        if (best > -1 && !gt_ignore[best] && gt_ignore[g]) break;
        const double v = ious[size_t(d) * n_gt + g];
        if (v < best_iou) continue;
        best_iou = v;
        best = g;
      }
      if (best == -1) {
        *ig = det_out ? det_out[d] : 0;
        continue;
      }
      taken[best] = 1;
      if (gt_ignore[best]) *ig = 1;
      else *m = 1;
    }
  }
}

// Exact greedy NMS on score-sorted boxes; keep[j] in {0,1}.
void nms_cpu(const float* boxes, const uint8_t* valid, int n,
             float iou_threshold, uint8_t* keep) {
  std::vector<uint8_t> suppressed(n, 0);
  for (int i = 0; i < n; ++i) {
    keep[i] = 0;
    if (!valid[i] || suppressed[i]) continue;
    keep[i] = 1;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j] || !valid[j]) continue;
      if (iou(boxes + 4 * i, boxes + 4 * j) > iou_threshold) suppressed[j] = 1;
    }
  }
}

int native_abi_version() { return 3; }

}  // extern "C"
