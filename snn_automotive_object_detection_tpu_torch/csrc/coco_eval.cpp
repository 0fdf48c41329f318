// Fast COCO detection matching — native equivalent of the pycocotools C
// extension the reference depends on (coco_eval.py -> COCOeval.evaluate).
//
// Performs the per-(image, category) greedy matching for all area ranges and
// IoU thresholds in one call; accumulation stays vectorised numpy on the
// Python side. Exact pycocotools semantics:
//   * detections in descending score order
//   * GT iterated non-ignored first
//   * a GT already matched (and not crowd) is skipped
//   * once a non-ignored best match exists, ignored GTs stop the scan
//   * unmatched detections outside the area range are ignored, not FPs
//
// Built with: g++ -O3 -shared -fPIC -o libcocoeval.so coco_eval.cpp

#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// ious:      [nd, ng] row-major
// d_area:    [nd]
// g_crowd:   [ng] (0/1)
// g_area:    [ng]
// iou_thrs:  [nt]
// area_rng:  [na, 2] (lo, hi)
// dtm:       [na, nt, nd] out, gt index or -1
// dt_ig:     [na, nt, nd] out, 0/1
// num_gt:    [na] out, countable GT per range
void coco_match(
    int nd, int ng,
    const double* ious,
    const double* d_area,
    const uint8_t* g_crowd,
    const double* g_area,
    const double* iou_thrs, int nt,
    const double* area_rng, int na,
    int64_t* dtm,
    uint8_t* dt_ig,
    int64_t* num_gt) {
  std::vector<uint8_t> g_ig(ng);
  std::vector<int> gt_order(ng);
  std::vector<int64_t> gtm(ng);

  for (int ai = 0; ai < na; ++ai) {
    const double lo = area_rng[ai * 2];
    const double hi = area_rng[ai * 2 + 1];
    int64_t countable = 0;
    for (int g = 0; g < ng; ++g) {
      g_ig[g] = g_crowd[g] || g_area[g] < lo || g_area[g] > hi;
      if (!g_ig[g]) ++countable;
    }
    num_gt[ai] = countable;

    // stable order: non-ignored first (pycocotools gtind via stable argsort)
    int pos = 0;
    for (int g = 0; g < ng; ++g) if (!g_ig[g]) gt_order[pos++] = g;
    for (int g = 0; g < ng; ++g) if (g_ig[g]) gt_order[pos++] = g;

    for (int ti = 0; ti < nt; ++ti) {
      const double thr = iou_thrs[ti];
      int64_t* dtm_row = dtm + (static_cast<int64_t>(ai) * nt + ti) * nd;
      uint8_t* dig_row = dt_ig + (static_cast<int64_t>(ai) * nt + ti) * nd;
      std::fill(gtm.begin(), gtm.end(), -1);

      for (int d = 0; d < nd; ++d) {
        double best_iou = std::min(thr, 1.0 - 1e-10);
        int best_g = -1;
        const double* iou_row = ious + static_cast<int64_t>(d) * ng;
        for (int oi = 0; oi < ng; ++oi) {
          const int g = gt_order[oi];
          if (gtm[g] >= 0 && !g_crowd[g]) continue;
          if (best_g >= 0 && !g_ig[best_g] && g_ig[g]) break;
          if (iou_row[g] < best_iou) continue;
          best_iou = iou_row[g];
          best_g = g;
        }
        if (best_g >= 0) {
          dtm_row[d] = best_g;
          gtm[best_g] = d;
          dig_row[d] = g_ig[best_g];
        } else {
          dtm_row[d] = -1;
          const bool out_of_range = d_area[d] < lo || d_area[d] > hi;
          dig_row[d] = out_of_range ? 1 : 0;
        }
      }
    }
  }
}

}  // extern "C"
