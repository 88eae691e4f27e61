// rso_baseline: measured CPU baseline of the reference stereo-VO algorithm.
//
// The reference (famoreno/stereo-vo) cannot be compiled in this image (it
// needs MRPT >= 1.0, absent; see reference CMakeLists.txt:42).  This is a
// faithful, freshly-written host-side implementation of its per-frame
// algorithm on OpenCV 4.x, used to produce the measured FPS/ATE oracle that
// BASELINE.md requires instead of an estimate:
//   stage 1  pyramid            (stage1_rectify.cpp:80-83)
//   stage 2  FAST detect + KLT response + grid NMS, row-sorted
//            (stage2_detect.cpp:519-576, m_non_max_sup :225-283)
//   stage 3  row-bucketed SAD stereo match + ratio + 1-to-1
//            (stage3_match_left_right.cpp:185-419)
//   stage 4  windowed SAD tracking both eyes + 1-to-1 + RANSAC F-filter
//            (stage4_match_consecutive.cpp:435-738)
//   stage 5  grid NMS + closed-form triangulation + two-phase robust
//            Gauss-Newton pose solve (stage5_optimization.cpp:392-736,
//            m_evalRGN :275-390, m_pinhole_stereo_projection :35-257)
//
// It is NOT a translation: plain structs + free functions, OpenCV types, no
// MRPT.  Where a formula has only one form (SAD, triangulation, pinhole
// Jacobian) the math necessarily matches.
//
// The pose solver is also exported with a C ABI (baseline_solve_pose) so the
// Python test suite can check the JAX solver against reference semantics on
// identical correspondences.
//
// Build: see build.sh (binary rso_baseline + shared lib librso_baseline.so).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <opencv2/calib3d.hpp>
#include <opencv2/core.hpp>
#include <opencv2/features2d.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

using cv::Mat;
using std::vector;

namespace {

struct CamParams {
  double fxl, fyl, cxl, cyl;
  double fxr, fyr, cxr, cyr;
  double baseline;
};

struct SolverParams {
  bool use_robust = true;
  double kernel_param = 3.0;
  int initial_max_iters = 10;
  int max_iters = 100;
  double min_mod = 1e-3;
  int max_incr_cost = 3;
  double residual_threshold = 10.0;
};

struct Keypoint {
  float x, y, response;
};

struct StereoMatch {
  int li, ri;  // indices into the left / right keypoint lists
};

struct OctaveData {
  Mat imgL, imgR;
  vector<Keypoint> kpsL, kpsR;       // row-sorted (y then x)
  vector<StereoMatch> matches;
};

struct FrameData {
  vector<OctaveData> oct;
};

// ---------------------------------------------------------------------------
// stage 1: pyramid (2x decimation chain)
// ---------------------------------------------------------------------------
vector<Mat> build_pyramid(const Mat& img, int n_octaves) {
  vector<Mat> pyr(n_octaves);
  pyr[0] = img;
  for (int o = 1; o < n_octaves; ++o) {
    cv::resize(pyr[o - 1], pyr[o],
               cv::Size(pyr[o - 1].cols / 2, pyr[o - 1].rows / 2), 0, 0,
               cv::INTER_AREA);
  }
  return pyr;
}

// ---------------------------------------------------------------------------
// stage 2: detection.  FAST segment test + Shi-Tomasi response gate, then the
// occupancy-grid suppression of the reference (best-response first, cell size
// min_distance/2, mark the 4-neighborhood) capped at a per-octave budget.
// ---------------------------------------------------------------------------
vector<Keypoint> detect_octave(const Mat& img, int fast_th, double min_resp,
                               int min_distance, size_t budget) {
  vector<cv::KeyPoint> raw;
  cv::FAST(img, raw, fast_th, /*nonmaxSuppression=*/true,
           cv::FastFeatureDetector::TYPE_9_16);

  Mat resp;
  cv::cornerMinEigenVal(img, resp, 2 * 4 + 1);  // KLT window = 4

  vector<Keypoint> cand;
  cand.reserve(raw.size());
  const int border = 8;
  for (const auto& kp : raw) {
    int xi = (int)kp.pt.x, yi = (int)kp.pt.y;
    if (xi < border || yi < border || xi >= img.cols - border ||
        yi >= img.rows - border)
      continue;
    // MRPT's KLT_response is the unnormalized min-eigenvalue of the summed
    // structure tensor; OpenCV normalizes by the window size.  Rescale so
    // the minimum_KLT_response threshold keeps its reference meaning.
    float r = resp.at<float>(yi, xi) * 81.0f * 127.5f;
    if (r < (float)min_resp) continue;
    cand.push_back({kp.pt.x, kp.pt.y, r});
  }

  // response-sorted occupancy-grid suppression (m_non_max_sup semantics)
  vector<int> order(cand.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = (int)i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return cand[a].response > cand[b].response;
  });
  const double cell = std::max(1.0, min_distance / 2.0);
  const int gx = (int)(1 + img.cols / cell), gy = (int)(1 + img.rows / cell);
  vector<uint8_t> occupied((size_t)gx * gy, 0);
  vector<Keypoint> out;
  out.reserve(std::min(budget, cand.size()));
  for (int idx : order) {
    if (out.size() >= budget) break;
    int sx = (int)(cand[idx].x / cell), sy = (int)(cand[idx].y / cell);
    if (occupied[(size_t)sy * gx + sx]) continue;
    occupied[(size_t)sy * gx + sx] = 1;
    if (sx > 0) occupied[(size_t)sy * gx + sx - 1] = 1;
    if (sy > 0) occupied[(size_t)(sy - 1) * gx + sx] = 1;
    if (sx < gx - 1) occupied[(size_t)sy * gx + sx + 1] = 1;
    if (sy < gy - 1) occupied[(size_t)(sy + 1) * gx + sx] = 1;
    out.push_back(cand[idx]);
  }
  // row-sort (the reference keeps row-bucketed lists for stage 3)
  std::sort(out.begin(), out.end(), [](const Keypoint& a, const Keypoint& b) {
    return a.y != b.y ? a.y < b.y : a.x < b.x;
  });
  return out;
}

// ---------------------------------------------------------------------------
// SAD over the 8x8 patch (x-3..x+4, y-3..y+4) — the reference's pixel kernel
// (compute_SAD8.cpp:71-97; one canonical scalar form).
// ---------------------------------------------------------------------------
inline uint32_t sad8(const Mat& a, const Mat& b, int xa, int ya, int xb,
                     int yb) {
  uint32_t acc = 0;
  for (int dy = -3; dy <= 4; ++dy) {
    const uint8_t* pa = a.ptr<uint8_t>(ya + dy) + (xa - 3);
    const uint8_t* pb = b.ptr<uint8_t>(yb + dy) + (xb - 3);
    for (int dx = 0; dx < 8; ++dx)
      acc += (uint32_t)std::abs((int)pa[dx] - (int)pb[dx]);
  }
  return acc;
}

inline bool patch_in_bounds(const Mat& m, float x, float y) {
  int xi = (int)x, yi = (int)y;
  return xi >= 3 && yi >= 3 && xi + 4 < m.cols && yi + 4 < m.rows;
}

// ---------------------------------------------------------------------------
// stage 3: row-bucketed SAD stereo matching with best/second-best ratio test
// and 1-to-1 right-feature arbitration (keep lowest distance).
// ---------------------------------------------------------------------------
vector<StereoMatch> stereo_match_octave(const OctaveData& oc, double max_y_diff,
                                        double max_sad, double max_ratio) {
  const size_t nL = oc.kpsL.size(), nR = oc.kpsR.size();
  vector<int> best_r(nL, -1);
  vector<double> best_d(nL, 1e18);
  const double max_disp = 0.7 * oc.imgL.cols;
  for (size_t i = 0; i < nL; ++i) {
    const Keypoint& kl = oc.kpsL[i];
    if (!patch_in_bounds(oc.imgL, kl.x, kl.y)) continue;
    double d1 = 1e18, d2 = 1e18;
    int bj = -1;
    for (size_t j = 0; j < nR; ++j) {
      const Keypoint& kr = oc.kpsR[j];
      if (std::abs(std::round(kr.y) - std::round(kl.y)) > max_y_diff) continue;
      double disp = kl.x - kr.x;
      if (disp < 1.0 || disp > max_disp) continue;
      if (!patch_in_bounds(oc.imgR, kr.x, kr.y)) continue;
      double d = (double)sad8(oc.imgL, oc.imgR, (int)std::round(kl.x),
                              (int)std::round(kl.y), (int)std::round(kr.x),
                              (int)std::round(kr.y));
      if (d < d1) {
        d2 = d1;
        d1 = d;
        bj = (int)j;
      } else if (d < d2) {
        d2 = d;
      }
    }
    if (bj < 0 || d1 > max_sad) continue;
    if (d2 < 1e17 && d1 / std::max(d2, 1.0) > max_ratio) continue;
    best_r[i] = bj;
    best_d[i] = d1;
  }
  // 1-to-1: keep the lowest-distance left feature per right feature
  vector<int> owner(nR, -1);
  for (size_t i = 0; i < nL; ++i) {
    int j = best_r[i];
    if (j < 0) continue;
    if (owner[j] < 0 || best_d[i] < best_d[owner[j]]) owner[j] = (int)i;
  }
  vector<StereoMatch> out;
  for (size_t j = 0; j < nR; ++j)
    if (owner[j] >= 0) out.push_back({owner[j], (int)j});
  return out;
}

// ---------------------------------------------------------------------------
// stage 4: windowed SAD tracking of stereo matches across frames: both-eye
// SAD, 1-to-1 arbitration, then a fundamental-matrix RANSAC filter per eye
// (the same cv::findFundamentalMat call the reference makes).
// ---------------------------------------------------------------------------
struct TrackedPair {
  int prev_idx, cur_idx;  // indices into the octave match lists
};

vector<TrackedPair> track_octave(const OctaveData& prev, const OctaveData& cur,
                                 double win_w, double win_h, double max_sad) {
  const size_t nP = prev.matches.size(), nC = cur.matches.size();
  vector<int> best_c(nP, -1);
  vector<double> best_d(nP, 1e18);
  for (size_t p = 0; p < nP; ++p) {
    const Keypoint& pl = prev.kpsL[prev.matches[p].li];
    const Keypoint& pr = prev.kpsR[prev.matches[p].ri];
    if (!patch_in_bounds(prev.imgL, pl.x, pl.y) ||
        !patch_in_bounds(prev.imgR, pr.x, pr.y))
      continue;
    double d1 = 1e18;
    int bc = -1;
    for (size_t c = 0; c < nC; ++c) {
      const Keypoint& cl = cur.kpsL[cur.matches[c].li];
      const Keypoint& cr = cur.kpsR[cur.matches[c].ri];
      if (std::abs(cl.x - pl.x) > win_w || std::abs(cl.y - pl.y) > win_h)
        continue;
      if (std::abs(cr.x - pr.x) > win_w || std::abs(cr.y - pr.y) > win_h)
        continue;
      if (!patch_in_bounds(cur.imgL, cl.x, cl.y) ||
          !patch_in_bounds(cur.imgR, cr.x, cr.y))
        continue;
      double d =
          (double)sad8(prev.imgL, cur.imgL, (int)std::round(pl.x),
                       (int)std::round(pl.y), (int)std::round(cl.x),
                       (int)std::round(cl.y)) +
          (double)sad8(prev.imgR, cur.imgR, (int)std::round(pr.x),
                       (int)std::round(pr.y), (int)std::round(cr.x),
                       (int)std::round(cr.y));
      if (d < d1) {
        d1 = d;
        bc = (int)c;
      }
    }
    if (bc < 0 || d1 > 2.0 * max_sad) continue;
    best_c[p] = bc;
    best_d[p] = d1;
  }
  // 1-to-1 on current matches
  vector<int> owner(nC, -1);
  for (size_t p = 0; p < nP; ++p) {
    int c = best_c[p];
    if (c < 0) continue;
    if (owner[c] < 0 || best_d[p] < best_d[owner[c]]) owner[c] = (int)p;
  }
  vector<TrackedPair> pairs;
  for (size_t c = 0; c < nC; ++c)
    if (owner[c] >= 0) pairs.push_back({owner[c], (int)c});

  // fundamental-matrix consistency per eye (stage4:681-705)
  if (pairs.size() >= 8) {
    vector<cv::Point2f> pL, cL, pR, cR;
    for (const auto& t : pairs) {
      const auto& pm = prev.matches[t.prev_idx];
      const auto& cm = cur.matches[t.cur_idx];
      pL.emplace_back(prev.kpsL[pm.li].x, prev.kpsL[pm.li].y);
      cL.emplace_back(cur.kpsL[cm.li].x, cur.kpsL[cm.li].y);
      pR.emplace_back(prev.kpsR[pm.ri].x, prev.kpsR[pm.ri].y);
      cR.emplace_back(cur.kpsR[cm.ri].x, cur.kpsR[cm.ri].y);
    }
    Mat inlL, inlR;
    cv::findFundamentalMat(pL, cL, cv::FM_RANSAC, 1.0, 0.99, inlL);
    cv::findFundamentalMat(pR, cR, cv::FM_RANSAC, 1.0, 0.99, inlR);
    vector<TrackedPair> kept;
    for (size_t k = 0; k < pairs.size(); ++k) {
      bool okL = inlL.empty() || inlL.at<uint8_t>((int)k) != 0;
      bool okR = inlR.empty() || inlR.at<uint8_t>((int)k) != 0;
      if (okL && okR) kept.push_back(pairs[k]);
    }
    return kept;
  }
  return pairs;
}

// ---------------------------------------------------------------------------
// stage 5: two-phase robust Gauss-Newton pose solve
// ---------------------------------------------------------------------------
struct Obs {
  double ulp, vlp, urp, vrp;  // previous-frame observation (uL,vL,uR,vR)
  double ulc, vlc, urc, vrc;  // current-frame observation
};

// Rodrigues rotation + the nine dR/dw derivative entries via cv::Rodrigues's
// 3x9 Jacobian (same closed form as the reference's hand-expanded algebra;
// validated against it by the Python parity tests).
struct RotDeriv {
  double R[9];
  double dR[3][9];  // dR/dw_k
};

RotDeriv rotvec_with_jacobian(const double w[3]) {
  Mat rv(3, 1, CV_64F);
  for (int i = 0; i < 3; ++i) rv.at<double>(i) = w[i];
  Mat R, J;
  cv::Rodrigues(rv, R, J);  // J is 3x9: d(R row-major)/d(rvec)
  RotDeriv out;
  for (int i = 0; i < 9; ++i) out.R[i] = R.at<double>(i / 3, i % 3);
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 9; ++i) out.dR[k][i] = J.at<double>(k, i);
  return out;
}

// One GN phase (reference while loops :549-598 and :650-700).  Returns false
// on a NaN condition number (voecBadCondNumber).  residuals out has the
// squared 4-vector norm per observation (masked entries keep DBL_MAX).
bool gn_phase(const vector<Obs>& obs, const vector<bool>& mask,
              const vector<cv::Point3d>& lmks, const CamParams& cam,
              const SolverParams& sp, int max_iters, double pose[6],
              unsigned int& timesInc, vector<double>& residuals, int& iters,
              bool& aborted) {
  const double b2 = sp.use_robust ? sp.kernel_param * sp.kernel_param : 0.0;
  const double b2_1 = sp.use_robust ? 1.0 / b2 : 0.0;
  double pCost = 0.0, cCost = 0.0;
  bool done = false;
  aborted = false;
  iters = 0;
  while (iters < max_iters && !done && !aborted) {
    pCost = cCost;
    cCost = 0.0;
    RotDeriv rd = rotvec_with_jacobian(pose);
    double H[36] = {0}, g[6] = {0};
    size_t li = 0;
    for (size_t m = 0; m < obs.size(); ++m) {
      if (!mask[m]) continue;
      const cv::Point3d& P = lmks[li++];
      const double* R = rd.R;
      double Xc = R[0] * P.x + R[1] * P.y + R[2] * P.z + pose[3];
      double Yc = R[3] * P.x + R[4] * P.y + R[5] * P.z + pose[4];
      double Zc = R[6] * P.x + R[7] * P.y + R[8] * P.z + pose[5];
      double X2 = Xc - cam.baseline;
      double pul = cam.fxl * Xc / Zc + cam.cxl;
      double pvl = cam.fyl * Yc / Zc + cam.cyl;
      double pur = cam.fxr * X2 / Zc + cam.cxr;
      double pvr = cam.fyr * Yc / Zc + cam.cyr;

      double J[4][6];
      bool jac_ok = true;
      for (int j = 0; j < 6; ++j) {
        double Xd, Yd, Zd;
        if (j < 3) {
          const double* dR = rd.dR[j];
          Xd = dR[0] * P.x + dR[1] * P.y + dR[2] * P.z;
          Yd = dR[3] * P.x + dR[4] * P.y + dR[5] * P.z;
          Zd = dR[6] * P.x + dR[7] * P.y + dR[8] * P.z;
        } else {
          Xd = j == 3;
          Yd = j == 4;
          Zd = j == 5;
        }
        J[0][j] = cam.fxl * (Xd * Zc - Xc * Zd) / (Zc * Zc);
        J[1][j] = cam.fyl * (Yd * Zc - Yc * Zd) / (Zc * Zc);
        J[2][j] = cam.fxr * (Xd * Zc - X2 * Zd) / (Zc * Zc);
        J[3][j] = cam.fyr * (Yd * Zc - Yc * Zd) / (Zc * Zc);
        for (int r = 0; r < 4; ++r)
          if (!std::isfinite(J[r][j])) jac_ok = false;
      }
      if (!jac_ok) continue;  // m_jacobian_is_good gate (h:919-928)

      double r4[4] = {obs[m].ulc - pul, obs[m].vlc - pvl, obs[m].urc - pur,
                      obs[m].vrc - pvr};
      double s = r4[0] * r4[0] + r4[1] * r4[1] + r4[2] * r4[2] + r4[3] * r4[3];
      residuals[m] = s;
      double rho_p = 1.0, fi;
      if (sp.use_robust) {
        double n = std::sqrt(1.0 + s * b2_1);
        rho_p = 1.0 / n;
        fi = b2 * (n - 1.0);
      } else {
        fi = 0.5 * s;
      }
      cCost += fi;
      for (int a = 0; a < 6; ++a) {
        double JTr = 0.0;
        for (int r = 0; r < 4; ++r) JTr += J[r][a] * r4[r];
        g[a] += rho_p * JTr;
        for (int b = 0; b < 6; ++b) {
          double JTJ = 0.0;
          for (int r = 0; r < 4; ++r) JTJ += J[r][a] * J[r][b];
          H[a * 6 + b] += JTJ;  // note: reference weights g only, not H
        }
      }
    }
    Mat Hm(6, 6, CV_64F, H), gm(6, 1, CV_64F, g);
    cv::SVD svd(Hm);
    double cond = svd.w.at<double>(0) / svd.w.at<double>(5);
    if (!std::isfinite(cond)) return false;  // voecBadCondNumber
    Mat dx;
    svd.backSubst(gm, dx);
    double mod = 0.0;
    for (int k = 0; k < 6; ++k) {
      pose[k] += dx.at<double>(k);
      mod += dx.at<double>(k) * dx.at<double>(k);
    }
    if (iters > 0) {
      done = std::sqrt(mod) < sp.min_mod;
      if (pCost < cCost && (int)(++timesInc) > sp.max_incr_cost) aborted = true;
    }
    ++iters;
  }
  return true;
}

void triangulate(const vector<Obs>& obs, const vector<bool>& mask,
                 const CamParams& cam, vector<cv::Point3d>& lmks) {
  lmks.clear();
  for (size_t m = 0; m < obs.size(); ++m) {
    if (!mask[m]) continue;
    double b_d = cam.baseline / (cam.fxl * (cam.cxr - obs[m].urp) +
                                 cam.fxr * (obs[m].ulp - cam.cxl));
    lmks.emplace_back(b_d * cam.fxr * (obs[m].ulp - cam.cxl),
                      b_d * cam.fxr * (obs[m].vlp - cam.cyl),
                      b_d * cam.fxl * cam.fxr);
  }
}

// Full stage-5: survivors-NMS omitted here (the caller already decimates),
// two GN phases with the residual-threshold inlier cut in between, final
// pose = inverse of accumulated deltaPose.
bool solve_pose_full(const vector<Obs>& obs, vector<bool> mask,
                     const CamParams& cam, const SolverParams& sp,
                     const double init_pose[6], double out_pose[6],
                     int* out_iters) {
  size_t n = 0;
  for (auto b : mask) n += b;
  if (n < 8) return false;
  vector<cv::Point3d> lmks;
  triangulate(obs, mask, cam, lmks);
  double pose[6];
  std::memcpy(pose, init_pose, sizeof(pose));
  vector<double> residuals(obs.size(), 1e300);
  unsigned int timesInc = 0;
  int it1 = 0, it2 = 0;
  bool aborted = false;
  if (!gn_phase(obs, mask, lmks, cam, sp, sp.initial_max_iters, pose, timesInc,
                residuals, it1, aborted))
    return false;
  // inlier cut + landmark rebuild (stage5:601-638)
  for (size_t m = 0; m < obs.size(); ++m)
    if (residuals[m] > sp.residual_threshold) mask[m] = false;
  n = 0;
  for (auto b : mask) n += b;
  if (n < 8) return false;
  triangulate(obs, mask, cam, lmks);
  if (!gn_phase(obs, mask, lmks, cam, sp, sp.max_iters, pose, timesInc,
                residuals, it2, aborted))
    return false;
  if (out_iters) {
    out_iters[0] = it1;
    out_iters[1] = it2;
  }
  // outPose = inverse of deltaPose (stage5:715-718)
  RotDeriv rd = rotvec_with_jacobian(pose);
  Mat R(3, 3, CV_64F);
  for (int i = 0; i < 9; ++i) R.at<double>(i / 3, i % 3) = rd.R[i];
  Mat Rt = R.t(), rv;
  cv::Rodrigues(Rt, rv);
  double tx = pose[3], ty = pose[4], tz = pose[5];
  out_pose[0] = rv.at<double>(0);
  out_pose[1] = rv.at<double>(1);
  out_pose[2] = rv.at<double>(2);
  out_pose[3] = -(Rt.at<double>(0, 0) * tx + Rt.at<double>(0, 1) * ty +
                  Rt.at<double>(0, 2) * tz);
  out_pose[4] = -(Rt.at<double>(1, 0) * tx + Rt.at<double>(1, 1) * ty +
                  Rt.at<double>(1, 2) * tz);
  out_pose[5] = -(Rt.at<double>(2, 0) * tx + Rt.at<double>(2, 1) * ty +
                  Rt.at<double>(2, 2) * tz);
  return !aborted;
}

// stage-5 entry decimation: the reference NMS-decimates the tracked set on
// the previous-left keypoints (stage5:470-474) with the same occupancy grid.
vector<bool> stage5_nms(const vector<Obs>& obs, int img_h, int img_w,
                        int min_distance) {
  const double cell = std::max(1.0, min_distance / 2.0);
  const int gx = (int)(1 + img_w / cell), gy = (int)(1 + img_h / cell);
  vector<uint8_t> occupied((size_t)gx * gy, 0);
  vector<bool> keep(obs.size(), false);
  for (size_t i = 0; i < obs.size(); ++i) {
    int sx = (int)(obs[i].ulp / cell), sy = (int)(obs[i].vlp / cell);
    if (sx < 0 || sy < 0 || sx >= gx || sy >= gy) continue;
    if (occupied[(size_t)sy * gx + sx]) continue;
    occupied[(size_t)sy * gx + sx] = 1;
    if (sx > 0) occupied[(size_t)sy * gx + sx - 1] = 1;
    if (sy > 0) occupied[(size_t)(sy - 1) * gx + sx] = 1;
    if (sx < gx - 1) occupied[(size_t)sy * gx + sx + 1] = 1;
    if (sy < gy - 1) occupied[(size_t)(sy + 1) * gx + sx] = 1;
    keep[i] = true;
  }
  return keep;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI exports for Python parity tests
// ---------------------------------------------------------------------------
extern "C" {

// prev_obs/cur_obs: [N,4] row-major (uL,vL,uR,vR); mask: [N] u8;
// cam9: fxl,fyl,cxl,cyl,fxr,fyr,cxr,cyr,baseline
// sp7:  use_robust,kernel_param,initial_max_iters,max_iters,min_mod,
//       max_incr_cost,residual_threshold
// Returns 1 on a valid solve, 0 otherwise.  out_pose: [6] (w,t) of the
// current frame wrt the previous one (already inverted, the reference's
// result.outPose convention).
int baseline_solve_pose(const double* prev_obs, const double* cur_obs,
                        const uint8_t* mask, int n, const double* cam9,
                        const double* sp7, const double* init_pose,
                        double* out_pose, int* out_iters) {
  CamParams cam{cam9[0], cam9[1], cam9[2], cam9[3], cam9[4],
                cam9[5], cam9[6], cam9[7], cam9[8]};
  SolverParams sp;
  sp.use_robust = sp7[0] != 0.0;
  sp.kernel_param = sp7[1];
  sp.initial_max_iters = (int)sp7[2];
  sp.max_iters = (int)sp7[3];
  sp.min_mod = sp7[4];
  sp.max_incr_cost = (int)sp7[5];
  sp.residual_threshold = sp7[6];
  vector<Obs> obs(n);
  vector<bool> m(n);
  for (int i = 0; i < n; ++i) {
    obs[i] = {prev_obs[4 * i], prev_obs[4 * i + 1], prev_obs[4 * i + 2],
              prev_obs[4 * i + 3], cur_obs[4 * i],  cur_obs[4 * i + 1],
              cur_obs[4 * i + 2],  cur_obs[4 * i + 3]};
    m[i] = mask[i] != 0;
  }
  double init[6] = {0, 0, 0, 0, 0, 0};
  if (init_pose) std::memcpy(init, init_pose, sizeof(init));
  return solve_pose_full(obs, m, cam, sp, init, out_pose, out_iters) ? 1 : 0;
}

// Run the full per-frame pipeline over a preloaded image sequence.
// imgs: n_frames*2 interleaved (L0,R0,L1,R1,...) u8 buffers of h*w.
// Writes per-frame (w,t) deltas into out_poses [n_frames,6] (frame 0 zeros)
// and validity into out_valid.  Returns elapsed processing seconds.
double baseline_run(const uint8_t** imgs, int n_frames, int h, int w,
                    const double* cam9, int n_octaves, int fast_th,
                    double min_resp, int min_distance, int budget,
                    double max_y_diff, double max_sad, double max_ratio,
                    double win_w, double win_h, double* out_poses,
                    uint8_t* out_valid) {
  CamParams cam{cam9[0], cam9[1], cam9[2], cam9[3], cam9[4],
                cam9[5], cam9[6], cam9[7], cam9[8]};
  SolverParams sp;
  auto t0 = std::chrono::steady_clock::now();
  FrameData prev;
  bool have_prev = false;
  double last_pose[6] = {0};  // warm start (use_previous_pose_as_initial)
  for (int f = 0; f < n_frames; ++f) {
    Mat L(h, w, CV_8U, const_cast<uint8_t*>(imgs[2 * f]));
    Mat R(h, w, CV_8U, const_cast<uint8_t*>(imgs[2 * f + 1]));
    FrameData cur;
    cur.oct.resize(n_octaves);
    vector<Mat> pL = build_pyramid(L, n_octaves);
    vector<Mat> pR = build_pyramid(R, n_octaves);
    for (int o = 0; o < n_octaves; ++o) {
      OctaveData& oc = cur.oct[o];
      oc.imgL = pL[o];
      oc.imgR = pR[o];
      size_t b = (size_t)(budget >> o);
      oc.kpsL = detect_octave(oc.imgL, fast_th, min_resp, min_distance, b);
      oc.kpsR = detect_octave(oc.imgR, fast_th, min_resp, min_distance, b);
      oc.matches = stereo_match_octave(oc, max_y_diff, max_sad, max_ratio);
    }
    std::memset(out_poses + 6 * f, 0, 6 * sizeof(double));
    out_valid[f] = 0;
    if (have_prev) {
      // stage 4 per octave, then gather to full scale (stage5:417-456)
      vector<Obs> obs;
      for (int o = 0; o < n_octaves; ++o) {
        double s = (double)(1 << o);
        auto pairs = track_octave(prev.oct[o], cur.oct[o], win_w, win_h,
                                  max_sad);
        for (const auto& t : pairs) {
          const auto& pm = prev.oct[o].matches[t.prev_idx];
          const auto& cm = cur.oct[o].matches[t.cur_idx];
          const auto& P = prev.oct[o];
          const auto& C = cur.oct[o];
          obs.push_back({s * P.kpsL[pm.li].x, s * P.kpsL[pm.li].y,
                         s * P.kpsR[pm.ri].x, s * P.kpsR[pm.ri].y,
                         s * C.kpsL[cm.li].x, s * C.kpsL[cm.li].y,
                         s * C.kpsR[cm.ri].x, s * C.kpsR[cm.ri].y});
        }
      }
      if (obs.size() >= 8) {
        vector<bool> keep = stage5_nms(obs, h, w, min_distance);
        double pose[6];
        if (solve_pose_full(obs, keep, cam, sp, last_pose, pose, nullptr)) {
          std::memcpy(out_poses + 6 * f, pose, sizeof(pose));
          out_valid[f] = 1;
          // reference warm start stores the *accumulated deltaPose*; the
          // inverse relationship is symmetric for the next frame's init
          RotDeriv rd = rotvec_with_jacobian(pose);
          Mat Rm(3, 3, CV_64F);
          for (int i = 0; i < 9; ++i)
            Rm.at<double>(i / 3, i % 3) = rd.R[i];
          Mat rv;
          cv::Rodrigues(Mat(Rm.t()), rv);
          last_pose[0] = rv.at<double>(0);
          last_pose[1] = rv.at<double>(1);
          last_pose[2] = rv.at<double>(2);
          for (int k = 0; k < 3; ++k) {
            double acc = 0;
            for (int c = 0; c < 3; ++c)
              acc -= Rm.at<double>(c, k) * pose[3 + c];
            last_pose[3 + k] = acc;
          }
        }
      }
    }
    prev = std::move(cur);
    have_prev = true;
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// standalone binary: run over a directory of left_%04d.png / right_%04d.png
// ---------------------------------------------------------------------------
int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: rso_baseline SCENE_DIR N_FRAMES [fx cx cy baseline "
                 "fast_th max_sad]\n");
    return 2;
  }
  std::string dir = argv[1];
  int n = std::atoi(argv[2]);
  double fx = argc > 3 ? std::atof(argv[3]) : 320.0;
  double cx = argc > 4 ? std::atof(argv[4]) : 188.0;
  double cy = argc > 5 ? std::atof(argv[5]) : 120.0;
  double baseline = argc > 6 ? std::atof(argv[6]) : 0.4;
  int fast_th = argc > 7 ? std::atoi(argv[7]) : 20;
  double max_sad = argc > 8 ? std::atof(argv[8]) : 1500.0;

  vector<Mat> mats;
  vector<const uint8_t*> ptrs;
  char buf[512];
  for (int f = 0; f < n; ++f) {
    for (const char* side : {"left", "right"}) {
      std::snprintf(buf, sizeof(buf), "%s/%s_%04d.png", dir.c_str(), side, f);
      Mat m = cv::imread(buf, cv::IMREAD_GRAYSCALE);
      if (m.empty()) {
        std::fprintf(stderr, "cannot read %s\n", buf);
        return 2;
      }
      mats.push_back(m);
    }
  }
  for (auto& m : mats) ptrs.push_back(m.ptr<uint8_t>(0));
  int h = mats[0].rows, w = mats[0].cols;
  double cam9[9] = {fx, fx, cx, cy, fx, fx, cx, cy, baseline};
  vector<double> poses((size_t)n * 6);
  vector<uint8_t> valid(n);
  double secs = baseline_run(ptrs.data(), n, h, w, cam9, /*n_octaves=*/3,
                             fast_th, /*min_resp=*/10.0, /*min_distance=*/3,
                             /*budget=*/500, /*max_y_diff=*/1.0, max_sad,
                             /*max_ratio=*/0.7, /*win_w=*/40.0,
                             /*win_h=*/40.0, poses.data(), valid.data());
  // write trajectory deltas (w1..3,t1..3,valid) for the Python harness
  std::snprintf(buf, sizeof(buf), "%s/baseline_deltas.txt", dir.c_str());
  FILE* fp = std::fopen(buf, "w");
  for (int f = 0; f < n; ++f) {
    std::fprintf(fp, "%.9f %.9f %.9f %.9f %.9f %.9f %d\n", poses[6 * f],
                 poses[6 * f + 1], poses[6 * f + 2], poses[6 * f + 3],
                 poses[6 * f + 4], poses[6 * f + 5], (int)valid[f]);
  }
  std::fclose(fp);
  int nval = 0;
  for (int f = 1; f < n; ++f) nval += valid[f];
  std::printf(
      "{\"frames\": %d, \"seconds\": %.4f, \"fps\": %.2f, \"valid\": %d}\n", n,
      secs, n / secs, nval);
  return 0;
}
