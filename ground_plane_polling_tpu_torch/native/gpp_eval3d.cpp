// Native core for the KITTI devkit-semantics evaluator (utils/eval3d.py).
//
// The external KITTI devkit this replaces (evaluate_object_3d_offline.cpp)
// is C++ because the protocol is per-image greedy matching across ~41 score
// thresholds — branchy scalar work that vectorizes poorly. This library
// mirrors the two hot spots exactly:
//   * rotated-rectangle intersection (Sutherland-Hodgman convex clip) for
//     the BEV / 3D overlap matrices;
//   * the per-image, per-threshold matching loop (devkit
//     computeStatistics, compute_fp pass) accumulating tp/fp/fn/AOS.
// Semantics are defined by the numpy implementation in utils/eval3d.py
// (a copy of the JAX package's native/gpp_eval3d.cpp);
// tests/test_torch_eval3d.py holds the two paths and the JAX package's
// core equal. Built on first use into _build/ by utils/eval3d_native.py
// (g++ -O3 -shared -fPIC -std=c++17).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct P2 {
  double x, z;
};

// Clip convex polygon `poly` (n vertices) by the half-plane left of a->b.
// Writes into `out`, returns the new vertex count. Max output n+1.
int clip_halfplane(const P2* poly, int n, P2 a, P2 b, P2* out) {
  if (n == 0) return 0;
  const double dx = b.x - a.x, dz = b.z - a.z;
  int m = 0;
  P2 prev = poly[n - 1];
  double sp = dx * (prev.z - a.z) - dz * (prev.x - a.x);
  for (int i = 0; i < n; ++i) {
    P2 cur = poly[i];
    double sc = dx * (cur.z - a.z) - dz * (cur.x - a.x);
    if (sc >= 0) {
      if (sp < 0) {
        double t = sp / (sp - sc);
        out[m++] = {prev.x + t * (cur.x - prev.x),
                    prev.z + t * (cur.z - prev.z)};
      }
      out[m++] = cur;
    } else if (sp >= 0) {
      double t = sp / (sp - sc);
      out[m++] = {prev.x + t * (cur.x - prev.x),
                  prev.z + t * (cur.z - prev.z)};
    }
    prev = cur;
    sp = sc;
  }
  return m;
}

double poly_area(const P2* poly, int n) {
  if (n < 3) return 0.0;
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const P2& p = poly[i];
    const P2& q = poly[(i + 1) % n];
    s += p.x * q.z - q.x * p.z;
  }
  return 0.5 * std::fabs(s);
}

// Ground-plane corners of a KITTI box (x, z, ry, l, w), CCW — matches
// eval3d.rotated_rect_corners (R_y restricted to (x, z)).
void rect_corners(double x, double z, double ry, double l, double w,
                  P2* c) {
  const double co = std::cos(ry), si = std::sin(ry);
  const double l2 = 0.5 * l, w2 = 0.5 * w;
  const double xs[4] = {l2, -l2, -l2, l2};
  const double zs[4] = {w2, w2, -w2, -w2};
  for (int i = 0; i < 4; ++i) {
    c[i] = {co * xs[i] + si * zs[i] + x, -si * xs[i] + co * zs[i] + z};
  }
}

void ccw(P2* c, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    s += c[i].x * c[(i + 1) % n].z - c[(i + 1) % n].x * c[i].z;
  }
  if (s < 0) std::reverse(c, c + n);
}

double rect_intersection(const P2* ca, const P2* cb) {
  // corners arrive CCW from rect_corners; clip b by a's 4 half-planes
  P2 buf1[16], buf2[16];
  int n = 4;
  for (int i = 0; i < 4; ++i) buf1[i] = cb[i];
  P2* cur = buf1;
  P2* nxt = buf2;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_halfplane(cur, n, ca[e], ca[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  return poly_area(cur, n);
}

}  // namespace

extern "C" {

// det/gt rows: [x, z, ry, l, w] -> out[i*ng + j] = BEV IoU
int gpp_bev_overlap(const double* det, int nd, const double* gt, int ng,
                    double* out) {
  for (int i = 0; i < nd; ++i) {
    P2 cd[4];
    rect_corners(det[i * 5], det[i * 5 + 1], det[i * 5 + 2],
                 det[i * 5 + 3], det[i * 5 + 4], cd);
    ccw(cd, 4);
    const double area_d = det[i * 5 + 3] * det[i * 5 + 4];
    for (int j = 0; j < ng; ++j) {
      P2 cg[4];
      rect_corners(gt[j * 5], gt[j * 5 + 1], gt[j * 5 + 2], gt[j * 5 + 3],
                   gt[j * 5 + 4], cg);
      ccw(cg, 4);
      const double inter = rect_intersection(cd, cg);
      const double area_g = gt[j * 5 + 3] * gt[j * 5 + 4];
      const double uni = area_d + area_g - inter;
      out[i * ng + j] = inter / std::max(uni, 1e-12);
    }
  }
  return 0;
}

// det/gt rows: [x, z, ry, l, w, y, h] (y = bottom face, camera y down)
int gpp_3d_overlap(const double* det, int nd, const double* gt, int ng,
                   double* out) {
  for (int i = 0; i < nd; ++i) {
    P2 cd[4];
    rect_corners(det[i * 7], det[i * 7 + 1], det[i * 7 + 2],
                 det[i * 7 + 3], det[i * 7 + 4], cd);
    ccw(cd, 4);
    const double y_d = det[i * 7 + 5], h_d = det[i * 7 + 6];
    const double vol_d = det[i * 7 + 3] * det[i * 7 + 4] * h_d;
    for (int j = 0; j < ng; ++j) {
      const double y_g = gt[j * 7 + 5], h_g = gt[j * 7 + 6];
      const double dh = std::min(y_d, y_g) - std::max(y_d - h_d, y_g - h_g);
      if (dh <= 0) {
        out[i * ng + j] = 0.0;
        continue;
      }
      P2 cg[4];
      rect_corners(gt[j * 7], gt[j * 7 + 1], gt[j * 7 + 2], gt[j * 7 + 3],
                   gt[j * 7 + 4], cg);
      ccw(cg, 4);
      const double inter = rect_intersection(cd, cg) * dh;
      const double vol_g = gt[j * 7 + 3] * gt[j * 7 + 4] * h_g;
      const double uni = vol_d + vol_g - inter;
      out[i * ng + j] = inter / std::max(uni, 1e-12);
    }
  }
  return 0;
}

// devkit computeStatistics (compute_fp=true) for ONE image across T score
// thresholds, ACCUMULATING into out_tp/out_fp/out_fn/out_sim (caller
// zero-initializes across images). Mirrors eval3d._compute_statistics.
//   overlap:  (nd, ng) row-major, metric-specific
//   scores:   (nd,)
//   ignored_det: (nd,) in {-1, 0, 1}; ignored_gt: (ng,) in {-1, 0, 1}
//   dc_ov:    (nd, ndc) 2D intersection/det-area overlaps (ndc may be 0)
//   alpha_*:  orientation for AOS (ignored when compute_aos == 0)
int gpp_compute_stats(const double* overlap, int nd, int ng,
                      const double* scores, const int32_t* ignored_det,
                      const int32_t* ignored_gt, const double* dc_ov,
                      int ndc, const double* alpha_det,
                      const double* alpha_gt, int compute_aos,
                      double min_overlap, const double* thresholds, int T,
                      int64_t* out_tp, int64_t* out_fp, int64_t* out_fn,
                      double* out_sim) {
  constexpr int NO_DETECTION = -1;
  bool assigned[4096];
  if (nd > 4096) return 1;
  for (int ti = 0; ti < T; ++ti) {
    const double thresh = thresholds[ti];
    for (int j = 0; j < nd; ++j) assigned[j] = false;
    int64_t tp = 0, fp = 0, fn = 0;
    double sim = 0.0;
    for (int i = 0; i < ng; ++i) {
      if (ignored_gt[i] == -1) continue;
      int det_idx = NO_DETECTION;
      double max_ov = 0.0;
      bool assigned_ignored_det = false;
      for (int j = 0; j < nd; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || scores[j] < thresh)
          continue;
        const double ov = overlap[j * ng + i];
        if (ov > min_overlap &&
            (ov > max_ov || assigned_ignored_det) && ignored_det[j] == 0) {
          max_ov = ov;
          det_idx = j;
          assigned_ignored_det = false;
        } else if (ov > min_overlap && det_idx == NO_DETECTION &&
                   ignored_det[j] == 1) {
          det_idx = j;
          assigned_ignored_det = true;
        }
      }
      if (det_idx == NO_DETECTION && ignored_gt[i] == 0) {
        ++fn;
      } else if (det_idx != NO_DETECTION &&
                 (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = true;
      } else if (det_idx != NO_DETECTION) {
        ++tp;
        if (compute_aos) {
          sim += 0.5 * (1.0 + std::cos(alpha_gt[i] - alpha_det[det_idx]));
        }
        assigned[det_idx] = true;
      }
    }
    for (int j = 0; j < nd; ++j) {
      if (!(assigned[j] || ignored_det[j] != 0 || scores[j] < thresh)) ++fp;
    }
    if (ndc > 0) {
      for (int j = 0; j < nd; ++j) {
        if (assigned[j] || ignored_det[j] != 0 || scores[j] < thresh)
          continue;
        for (int d = 0; d < ndc; ++d) {
          if (dc_ov[j * ndc + d] > min_overlap) {
            assigned[j] = true;
            --fp;
            break;
          }
        }
      }
    }
    out_tp[ti] += tp;
    out_fp[ti] += fp;
    out_fn[ti] += fn;
    out_sim[ti] += sim;
  }
  return 0;
}

}  // extern "C"
