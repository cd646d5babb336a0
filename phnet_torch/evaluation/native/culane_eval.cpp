// CULane lane evaluator of the PyTorch port: an own copy of
// phnet_tpu/evaluation/native/culane_eval.cpp, C ABI included, built with
// g++ by phnet_torch/ops/_build.py and loaded with ctypes by
// phnet_torch/evaluation/native_eval.py (the scorer) and
// phnet_torch/evaluation/culane_metric.py (which draws its lanes with
// culane_thick_line, the pixel-exact replica of cv2.line below, so that
// the Python metric needs no OpenCV). The notes below are the original's.
//
// CULane-format lane evaluator, self-contained C++ (no OpenCV).
//
// Native equivalent of the reference's evaluation/culane C++ tool
// (spline.cpp / lane_compare.cpp / counter.cpp / evaluate.cpp): per frame,
// spline-interpolate both lane sets, rasterize each lane with
// cv::line(thickness=w) semantics into a bitmap, compute pairwise pixel
// IoU, KM-match, and count TP at IoU > threshold. OpenMP parallelizes
// over frames.
//
// EXACT-SEMANTICS port (round 4; replaces the earlier approximations):
//  * spline: per-segment natural cubic splines in the chord parameter,
//    sampled `times`x per input segment, float32 point storage — a direct
//    transcription of Spline::splineInterpTimes + cal_fun
//    (spline.cpp:7-46,104-178), bit-matching evaluation/official_oracle.py.
//  * raster: a pixel-exact replica of OpenCV's integer thick-line path —
//    ThickLine's perpendicular quad via FillConvexPoly (XY_SHIFT=16
//    fixed point, Line2 edge strokes, truncating edge-slope division)
//    plus filled midpoint-circle end caps — validated pixel-identical
//    against cv2.line on randomized segments (tests/test_native_raster.py).
//  * matching: verbatim port of hungarianGraph.hpp's KM matcher including
//    its 1e-2 feasibility slack and d==1e10 early-out, and counter.cpp's
//    count_im_pair counting/miou (anno rows, miou = matched IoU sum /
//    n_detect per frame).
//
// The only intentional difference from the reference binary is mechanical:
// each lane is rasterized once and reused across pairs (the official tool
// redraws both lanes per pair); the drawn bitmap is identical either way.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ======================= OpenCV-replica rasterizer =======================
// All semantics below mirror opencv/modules/imgproc/src/drawing.cpp for
// CV_8UC1 images, color=1, line_type=8 (LINE_8), as the official scorer
// uses them. Coordinates are XY_SHIFT=16 fixed point.

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = 1 << XY_SHIFT;

struct Img {
  uint8_t* data;
  int w, h;  // width, height; row-major, step == w
  inline void set(int x, int y) {
    if (0 <= x && x < w && 0 <= y && y < h) data[(int64_t)y * w + x] = 1;
  }
  inline void hline(int xl, int xr, int y) {  // inclusive, caller-clipped
    if (y < 0 || y >= h) return;
    if (xl < 0) xl = 0;
    if (xr >= w) xr = w - 1;
    if (xl > xr) return;
    std::memset(data + (int64_t)y * w + xl, 1, (size_t)(xr - xl + 1));
  }
};

struct P2l {
  int64_t x, y;
};

// cvRound: round half to even (the default FPU rounding mode).
inline int64_t cv_round(double v) { return (int64_t)std::nearbyint(v); }

// cv::clipLine(Size2l, Point2l&, Point2l&) — integer Cohen-Sutherland.
bool clip_line(int64_t width, int64_t height, P2l& pt1, P2l& pt2) {
  if (width <= 0 || height <= 0) return false;
  int64_t right = width - 1, bottom = height - 1;
  int64_t &x1 = pt1.x, &y1 = pt1.y, &x2 = pt2.x, &y2 = pt2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (a - y1) * (x2 - x1) / (y2 - y1);
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (a - y2) * (x2 - x1) / (y2 - y1);
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (a - x1) * (y2 - y1) / (x2 - x1);
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (a - x2) * (y2 - y1) / (x2 - x1);
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// cv::Line() == LineIterator(img, pt1, pt2, 8, /*left_to_right=*/true):
// clip to the image, normalize left-to-right, midpoint stepping with
// err = dM - 2*dm. Validated pixel-identical against
// cv2.line(thickness=1, LINE_8) on 1500 randomized (clipped) segments.
void line_bresenham(Img& img, P2l pt1, P2l pt2) {
  if (!clip_line(img.w, img.h, pt1, pt2)) return;
  int64_t x1 = pt1.x, y1 = pt1.y, x2 = pt2.x, y2 = pt2.y;
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {  // left_to_right normalization
    x1 = x2;
    y1 = y2;
    dx = -dx;
    dy = -dy;
  }
  int ystep = dy >= 0 ? 1 : -1;
  dy = dy >= 0 ? dy : -dy;
  bool majx = !(dy > dx);
  int64_t dM = majx ? dx : dy, dm = majx ? dy : dx;
  int64_t err = dM - 2 * dm;
  int64_t x = x1, y = y1;
  for (int64_t k = 0; k <= dM; ++k) {
    img.set((int)x, (int)y);
    bool adv = err < 0;
    err += -2 * dm + (adv ? 2 * dM : 0);
    if (majx) {
      x += 1;
      if (adv) y += ystep;
    } else {
      y += ystep;
      if (adv) x += 1;
    }
  }
}

// ThickLine's thickness<=1 stroke for XY_SHIFT fixed-point endpoints:
// current OpenCV rounds to integer pixels and runs the LineIterator
// Bresenham (validated against cv2.line(thickness=1, shift=16) on 1000
// randomized segments).
void line2(Img& img, P2l pt1, P2l pt2) {
  P2l a{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, (pt1.y + (XY_ONE >> 1)) >> XY_SHIFT};
  P2l b{(pt2.x + (XY_ONE >> 1)) >> XY_SHIFT, (pt2.y + (XY_ONE >> 1)) >> XY_SHIFT};
  line_bresenham(img, a, b);
}

// drawing.cpp Line2(): the fixed-point sub-pixel walk FillConvexPoly uses
// for its polygon edge strokes (distinct from the rounded thickness=1
// path above; validated through the fillConvexPoly comparison).
void line2_fill_edge(Img& img, P2l pt1, P2l pt2) {
  int64_t sw = (int64_t)img.w << XY_SHIFT, sh = (int64_t)img.h << XY_SHIFT;
  if (!clip_line(sw, sh, pt1, pt2)) return;

  int64_t dx = pt2.x - pt1.x;
  int64_t dy = pt2.y - pt1.y;

  int64_t j = dx < 0 ? -1 : 0;
  int64_t ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0;
  int64_t ay = (dy ^ i) - i;

  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    pt1.x ^= pt2.x & j;
    pt2.x ^= pt1.x & j;
    pt1.x ^= pt2.x & j;
    pt1.y ^= pt2.y & j;
    pt2.y ^= pt1.y & j;
    pt1.y ^= pt2.y & j;
    x_step = XY_ONE;
    y_step = (dy << XY_SHIFT) / (ax | 1);
    ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    pt1.x ^= pt2.x & i;
    pt2.x ^= pt1.x & i;
    pt1.x ^= pt2.x & i;
    pt1.y ^= pt2.y & i;
    pt2.y ^= pt1.y & i;
    pt1.y ^= pt2.y & i;
    x_step = (dx << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
  }

  pt1.x += XY_ONE >> 1;
  pt1.y += XY_ONE >> 1;

  img.set((int)((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT),
          (int)((pt2.y + (XY_ONE >> 1)) >> XY_SHIFT));
  while (ecount >= 0) {
    img.set((int)(pt1.x >> XY_SHIFT), (int)(pt1.y >> XY_SHIFT));
    pt1.x += x_step;
    pt1.y += y_step;
    --ecount;
  }
}

// drawing.cpp FillConvexPoly() for line_type=8, vertices in `shift`
// fixed point (ThickLine passes shift=XY_SHIFT).
void fill_convex_poly(Img& img, const P2l* v, int npts, int shift) {
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];

  int delta = (1 << shift) >> 1;
  int i, y, imin = 0;
  int edges = npts;
  int64_t xmin, xmax, ymin, ymax;
  const int delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;

  P2l p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;

  xmin = xmax = v[0].x;
  ymin = ymax = v[0].y;

  for (i = 0; i < npts; i++) {
    P2l p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (shift == 0) {
      P2l pt0{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT};
      P2l pt1{p.x >> XY_SHIFT, p.y >> XY_SHIFT};
      line_bresenham(img, pt0, pt1);
    } else {
      line2_fill_edge(img, p0, p);
    }
    p0 = p;
  }

  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;

  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 ||
      (int)xmin >= img.w || (int)ymin >= img.h)
    return;

  ymax = std::min<int64_t>(ymax, img.h - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y = (int)ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;

  do {
    for (i = 0; i < 2; i++) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        int ty = 0;
        for (; edges-- > 0;) {
          ty = (int)((v[idx].y + delta) >> shift);
          if (ty > y) {
            int64_t xs = v[idx0].x;
            int64_t xe = v[idx].x;
            if (shift != XY_SHIFT) {
              xs <<= XY_SHIFT - shift;
              xe <<= XY_SHIFT - shift;
            }
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;

    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < img.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= img.w) xx2 = img.w - 1;
        img.hline(xx1, xx2, y);
      }
    }

    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

// drawing.cpp Circle() with fill=1 (filled midpoint circle).
void circle_fill(Img& img, int64_t cx, int64_t cy, int radius) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  bool inside = cx >= radius && cx < img.w - radius && cy >= radius &&
                cy < img.h - radius;

  while (dx >= dy) {
    int y11 = (int)(cy - dy), y12 = (int)(cy + dy);
    int y21 = (int)(cy - dx), y22 = (int)(cy + dx);
    int x11 = (int)(cx - dx), x12 = (int)(cx + dx);
    int x21 = (int)(cx - dy), x22 = (int)(cx + dy);

    if (inside) {
      img.hline(x11, x12, y11);
      img.hline(x11, x12, y12);
      img.hline(x21, x22, y21);
      img.hline(x21, x22, y22);
    } else if (x11 < img.w && x12 >= 0 && y21 < img.h && y22 >= 0) {
      x11 = std::max(x11, 0);
      x12 = std::min(x12, img.w - 1);
      if ((unsigned)y11 < (unsigned)img.h) img.hline(x11, x12, y11);
      if ((unsigned)y12 < (unsigned)img.h) img.hline(x11, x12, y12);
      if (x21 < img.w && x22 >= 0) {
        x21 = std::max(x21, 0);
        x22 = std::min(x22, img.w - 1);
        if ((unsigned)y21 < (unsigned)img.h) img.hline(x21, x22, y21);
        if ((unsigned)y22 < (unsigned)img.h) img.hline(x21, x22, y22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// drawing.cpp ThickLine() for integer endpoints (shift=0), LINE_8,
// flags=3 (both round caps) — exactly what cv::line(...) invokes.
void thick_line(Img& img, int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                int thickness) {
  if (thickness <= 1) {
    line_bresenham(img, {x0, y0}, {x1, y1});
    return;
  }

  // This OpenCV (5.x) clips the segment to the canvas inflated by the
  // thickness BEFORE computing the band, so an endpoint far outside the
  // image slides along the line to the inflated border and the band
  // geometry follows the clipped endpoints. Measured: the margin=t
  // pre-clip is the unique variant matching cv2.line on 300/300 fuzz
  // cases with out-of-canvas endpoints (tools/check_raster.py); in-image
  // segments are unaffected.
  {
    P2l a{x0 + thickness, y0 + thickness};
    P2l b{x1 + thickness, y1 + thickness};
    if (!clip_line(img.w + 2 * (int64_t)thickness,
                   img.h + 2 * (int64_t)thickness, a, b))
      return;
    x0 = a.x - thickness;
    y0 = a.y - thickness;
    x1 = b.x - thickness;
    y1 = b.y - thickness;
  }

  P2l p0{x0 << XY_SHIFT, y0 << XY_SHIFT};
  P2l p1{x1 << XY_SHIFT, y1 << XY_SHIFT};

  constexpr double INV_XY_ONE = 1.0 / XY_ONE;
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int oddThickness = thickness & 1;
  int64_t th = (int64_t)thickness << (XY_SHIFT - 1);

  if (std::fabs(r) > DBL_EPSILON) {
    r = (double)(th + oddThickness * XY_ONE * 0.5) / std::sqrt(r);
    double dp2x = dx * r, dp2y = dy * r;
    P2l pt[4];
    pt[0].x = p0.x + cv_round(dp2y);
    pt[0].y = p0.y + cv_round(dp2x);
    pt[1].x = p0.x - cv_round(dp2y);
    pt[1].y = p0.y - cv_round(dp2x);
    pt[2].x = p1.x - cv_round(dp2y);
    pt[2].y = p1.y - cv_round(dp2x);
    pt[3].x = p1.x + cv_round(dp2y);
    pt[3].y = p1.y + cv_round(dp2x);
    fill_convex_poly(img, pt, 4, XY_SHIFT);
  }

  // both end caps (flags = 3)
  for (int i = 0; i < 2; i++) {
    circle_fill(img, (p0.x + (XY_ONE >> 1)) >> XY_SHIFT,
                (p0.y + (XY_ONE >> 1)) >> XY_SHIFT,
                (int)((th + (XY_ONE >> 1)) >> XY_SHIFT));
    p0 = p1;
  }
}

// ====================== official spline + lane draw ======================

struct Ptf {
  float x, y;  // cv::Point2f storage, matching the reference exactly
};

using Lanes = std::vector<std::vector<Ptf>>;

// read_lane_file (evaluate.cpp:208-233): every text line becomes a lane,
// including empty and single-point ones — no filtering.
Lanes parse_lines_txt(const char* path) {
  Lanes lanes;
  std::ifstream in(path);
  if (!in.good()) return lanes;
  std::string line;
  while (std::getline(in, line)) {
    std::istringstream ss(line);
    std::vector<Ptf> lane;
    double x, y;
    while (ss >> x >> y) lane.push_back({(float)x, (float)y});
    lanes.push_back(std::move(lane));
  }
  return lanes;
}

// Spline::splineInterpTimes + cal_fun (spline.cpp:7-46,104-178): per-
// segment natural cubic splines in the chord-length parameter, TDMA
// solve, `times` samples per input segment, Point2f (float32) storage.
std::vector<Ptf> spline_interp_times(const std::vector<Ptf>& ptsf,
                                     int times = 50) {
  const int n = (int)ptsf.size();
  std::vector<Ptf> out;
  if (n == 2) {
    out.reserve(times + 1);
    for (int k = 0; k <= times; ++k) {
      double u = (double)k / times;
      out.push_back({(float)(ptsf[0].x + (ptsf[1].x - ptsf[0].x) * u),
                     (float)(ptsf[0].y + (ptsf[1].y - ptsf[0].y) * u)});
    }
    return out;
  }
  if (n < 2) return ptsf;

  // cal_fun on float32 points promoted to double
  std::vector<double> px(n), py(n), h(n - 1);
  for (int i = 0; i < n; ++i) {
    px[i] = ptsf[i].x;
    py[i] = ptsf[i].y;
  }
  for (int i = 0; i < n - 1; ++i) {
    double dx = px[i + 1] - px[i], dy = py[i + 1] - py[i];
    h[i] = std::sqrt(dx * dx + dy * dy);
  }
  std::vector<double> A(n - 2), B(n - 2), C(n - 2), Dx(n - 2), Dy(n - 2);
  for (int i = 0; i < n - 2; ++i) {
    A[i] = h[i];
    B[i] = 2.0 * (h[i] + h[i + 1]);
    C[i] = h[i + 1];
    Dx[i] = 6.0 * ((px[i + 2] - px[i + 1]) / h[i + 1] -
                   (px[i + 1] - px[i]) / h[i]);
    Dy[i] = 6.0 * ((py[i + 2] - py[i + 1]) / h[i + 1] -
                   (py[i + 1] - py[i]) / h[i]);
  }
  // TDMA forward sweep (spline.cpp:139-148)
  C[0] /= B[0];
  Dx[0] /= B[0];
  Dy[0] /= B[0];
  for (int i = 1; i < n - 2; ++i) {
    double tmp = B[i] - A[i] * C[i - 1];
    C[i] /= tmp;
    Dx[i] = (Dx[i] - A[i] * Dx[i - 1]) / tmp;
    Dy[i] = (Dy[i] - A[i] * Dy[i - 1]) / tmp;
  }
  std::vector<double> Mx(n, 0.0), My(n, 0.0);
  Mx[n - 2] = Dx[n - 3];
  My[n - 2] = Dy[n - 3];
  for (int i = n - 4; i >= 0; --i) {  // spline.cpp:151-155
    Mx[i + 1] = Dx[i] - C[i] * Mx[i + 2];
    My[i + 1] = Dy[i] - C[i] * My[i + 2];
  }
  Mx[0] = Mx[n - 1] = 0.0;
  My[0] = My[n - 1] = 0.0;

  out.reserve((size_t)(n - 1) * times + 1);
  for (int i = 0; i < n - 1; ++i) {
    double a_x = px[i];
    double b_x = (px[i + 1] - px[i]) / h[i] -
                 (2.0 * h[i] * Mx[i] + h[i] * Mx[i + 1]) / 6.0;
    double c_x = Mx[i] / 2.0;
    double d_x = (Mx[i + 1] - Mx[i]) / (6.0 * h[i]);
    double a_y = py[i];
    double b_y = (py[i + 1] - py[i]) / h[i] -
                 (2.0 * h[i] * My[i] + h[i] * My[i + 1]) / 6.0;
    double c_y = My[i] / 2.0;
    double d_y = (My[i + 1] - My[i]) / (6.0 * h[i]);
    double delta = h[i] / times;
    for (int k = 0; k < times; ++k) {
      double t1 = delta * k;
      out.push_back({(float)(a_x + b_x * t1 + c_x * t1 * t1 + d_x * t1 * t1 * t1),
                     (float)(a_y + b_y * t1 + c_y * t1 * t1 + d_y * t1 * t1 * t1)});
    }
  }
  out.push_back(ptsf[n - 1]);
  return out;
}

// LaneCompare::get_lane_similarity draw half (lane_compare.cpp:20-48):
// interp (3+ points) then cv::line segments at the given thickness.
// Point2f -> Point conversion is saturate_cast<int> == cvRound.
void draw_lane(const std::vector<Ptf>& lane, int w, int h, int width,
               std::vector<uint8_t>& buf) {
  std::fill(buf.begin(), buf.end(), 0);
  Img img{buf.data(), w, h};
  const std::vector<Ptf>& p =
      lane.size() == 2 ? lane : spline_interp_times(lane, 50);
  if (p.size() < 2) return;
  std::vector<P2l> pi(p.size());
  for (size_t i = 0; i < p.size(); ++i)
    pi[i] = {cv_round((double)p[i].x), cv_round((double)p[i].y)};
  for (size_t nseg = 0; nseg + 1 < pi.size(); ++nseg)
    thick_line(img, pi[nseg].x, pi[nseg].y, pi[nseg + 1].x, pi[nseg + 1].y,
               width);
}

// ======================= official KM matcher =============================
// pipartiteGraph::match (hungarianGraph.hpp:6-71) verbatim, including the
// 1e-2 feasibility slack and the d==1e10 early return.

struct KM {
  int m, n;
  std::vector<std::vector<double>> mat;
  std::vector<double> left_w, right_w;
  std::vector<int> left_match, right_match;
  std::vector<char> lu, ru;

  bool dfs(int u) {
    lu[u] = 1;
    for (int v = 0; v < n; ++v) {
      if (!ru[v] && std::fabs(left_w[u] + right_w[v] - mat[u][v]) < 1e-2) {
        ru[v] = 1;
        if (right_match[v] == -1 || dfs(right_match[v])) {
          right_match[v] = u;
          left_match[u] = v;
          return true;
        }
      }
    }
    return false;
  }

  // similarity: [na][nd]; returns anno-side match indices (-1 unmatched)
  std::vector<int> match(const std::vector<std::vector<double>>& sim) {
    int M = (int)sim.size(), N = (int)sim[0].size();
    bool exchange = M > N;
    if (exchange) {
      m = N;
      n = M;
      mat.assign(m, std::vector<double>(n));
      for (int i = 0; i < m; ++i)
        for (int j = 0; j < n; ++j) mat[i][j] = sim[j][i];
    } else {
      m = M;
      n = N;
      mat = sim;
    }
    left_w.assign(m, 0.0);
    right_w.assign(n, 0.0);
    for (int i = 0; i < m; ++i)
      left_w[i] = *std::max_element(mat[i].begin(), mat[i].end());
    left_match.assign(m, -1);
    right_match.assign(n, -1);

    for (int u = 0; u < m; ++u) {
      for (;;) {
        lu.assign(m, 0);
        ru.assign(n, 0);
        if (dfs(u)) break;
        double d = 1e10;
        for (int i = 0; i < m; ++i)
          if (lu[i])
            for (int j = 0; j < n; ++j)
              if (!ru[j]) d = std::min(d, left_w[i] + right_w[j] - mat[i][j]);
        if (d == 1e10) return exchange ? right_match : left_match;
        for (int i = 0; i < m; ++i)
          if (lu[i]) left_w[i] -= d;
        for (int j = 0; j < n; ++j)
          if (ru[j]) right_w[j] += d;
      }
    }
    return exchange ? right_match : left_match;
  }
};

// ======================= frame scoring ===================================

struct FrameResult {
  long tp = 0, fp = 0, fn = 0, n_pred = 0;
  double iou_sum = 0;   // sum of matched similarities (native aggregate)
  double miou = 0;      // official per-frame miou = iou_sum / n_detect
};

// Counter::count_im_pair (counter.cpp:72-136), with lanes pre-rasterized
// once per side (bitmaps identical to the official per-pair redraw).
FrameResult eval_frame(const Lanes& pred, const Lanes& anno, int w, int h,
                       int width, double thr) {
  FrameResult r;
  r.n_pred = (long)pred.size();
  if (anno.empty() && pred.empty()) {
    r.miou = 1.0;
    return r;
  }
  if (anno.empty()) {
    r.fp = (long)pred.size();
    return r;
  }
  if (pred.empty()) {
    r.fn = (long)anno.size();
    return r;
  }

  size_t npix = (size_t)w * h;
  std::vector<std::vector<uint8_t>> pm(pred.size());
  std::vector<std::vector<uint8_t>> am(anno.size());
  std::vector<long> psum(pred.size(), 0), asum(anno.size(), 0);
  for (size_t i = 0; i < pred.size(); ++i) {
    if (pred[i].size() >= 2) {
      pm[i].assign(npix, 0);
      draw_lane(pred[i], w, h, width, pm[i]);
      for (size_t k = 0; k < npix; ++k) psum[i] += pm[i][k];
    }
  }
  for (size_t j = 0; j < anno.size(); ++j) {
    if (anno[j].size() >= 2) {
      am[j].assign(npix, 0);
      draw_lane(anno[j], w, h, width, am[j]);
      for (size_t k = 0; k < npix; ++k) asum[j] += am[j][k];
    }
  }

  // similarity[anno][detect], 0 when either side has < 2 points
  std::vector<std::vector<double>> sim(
      anno.size(), std::vector<double>(pred.size(), 0.0));
  for (size_t j = 0; j < anno.size(); ++j) {
    if (anno[j].size() < 2) continue;
    for (size_t i = 0; i < pred.size(); ++i) {
      if (pred[i].size() < 2) continue;
      long inter = 0;
      const uint8_t* a = am[j].data();
      const uint8_t* b = pm[i].data();
      for (size_t k = 0; k < npix; ++k) inter += a[k] & b[k];
      double uni = (double)asum[j] + (double)psum[i] - (double)inter;
      sim[j][i] = uni > 0 ? (double)inter / uni : 0.0;
    }
  }

  KM km;
  std::vector<int> anno_match = km.match(sim);
  long tp = 0;
  double iou_sum = 0.0;
  for (size_t j = 0; j < anno.size(); ++j) {
    int i = anno_match[j];
    if (i >= 0) iou_sum += sim[j][i];
    if (i >= 0 && sim[j][i] > thr) tp++;
  }
  r.tp = tp;
  r.fp = (long)pred.size() - tp;
  r.fn = (long)anno.size() - tp;
  r.iou_sum = iou_sum;
  r.miou = iou_sum / (double)pred.size();
  return r;
}

}  // namespace

extern "C" {

// Evaluate n (pred, anno) file pairs; outputs accumulated counters.
// iou_sum = summed matched similarity (native aggregate weighting);
// returns number of frames processed.
int culane_evaluate_files(const char** pred_paths, const char** anno_paths,
                          int n, int img_w, int img_h, int lane_width,
                          double iou_thr, long* tp, long* fp, long* fn,
                          double* iou_sum, long* n_pred) {
  long TP = 0, FP = 0, FN = 0, NP = 0;
  double IOU = 0;
#pragma omp parallel for schedule(dynamic) reduction(+:TP,FP,FN,NP,IOU)
  for (int i = 0; i < n; ++i) {
    Lanes pred = parse_lines_txt(pred_paths[i]);
    Lanes anno = parse_lines_txt(anno_paths[i]);
    FrameResult r = eval_frame(pred, anno, img_w, img_h, lane_width, iou_thr);
    TP += r.tp;
    FP += r.fp;
    FN += r.fn;
    NP += r.n_pred;
    IOU += r.iou_sum;
  }
  *tp = TP;
  *fp = FP;
  *fn = FN;
  *iou_sum = IOU;
  *n_pred = NP;
  return n;
}

// v2: additionally returns the OFFICIAL aggregate miou numerator — the sum
// of per-frame mious (matched IoU / n_detect, 1.0 for empty-empty frames;
// evaluate.cpp:170-187 divides by the frame count).
int culane_evaluate_files_v2(const char** pred_paths, const char** anno_paths,
                             int n, int img_w, int img_h, int lane_width,
                             double iou_thr, long* tp, long* fp, long* fn,
                             double* iou_sum, long* n_pred,
                             double* frame_miou_sum) {
  long TP = 0, FP = 0, FN = 0, NP = 0;
  double IOU = 0, MIOU = 0;
#pragma omp parallel for schedule(dynamic) reduction(+:TP,FP,FN,NP,IOU,MIOU)
  for (int i = 0; i < n; ++i) {
    Lanes pred = parse_lines_txt(pred_paths[i]);
    Lanes anno = parse_lines_txt(anno_paths[i]);
    FrameResult r = eval_frame(pred, anno, img_w, img_h, lane_width, iou_thr);
    TP += r.tp;
    FP += r.fp;
    FN += r.fn;
    NP += r.n_pred;
    IOU += r.iou_sum;
    MIOU += r.miou;
  }
  *tp = TP;
  *fp = FP;
  *fn = FN;
  *iou_sum = IOU;
  *n_pred = NP;
  *frame_miou_sum = MIOU;
  return n;
}

// ---- rasterizer test hooks (pixel-exactness vs cv2, tests/) -------------

// Full official draw path for one lane: spline (3+ points), cvRound to
// int, thick_line per segment. xy: [n*2] doubles. out: [h*w] bytes.
void culane_draw_lane(const double* xy, int n, int img_w, int img_h,
                      int width, uint8_t* out) {
  std::vector<Ptf> lane(n);
  for (int i = 0; i < n; ++i)
    lane[i] = {(float)xy[2 * i], (float)xy[2 * i + 1]};
  std::vector<uint8_t> buf((size_t)img_w * img_h, 0);
  draw_lane(lane, img_w, img_h, width, buf);
  std::memcpy(out, buf.data(), buf.size());
}

// cv::line(img, p0, p1, 1, thickness, LINE_8) replica on a caller buffer.
void culane_thick_line(int x0, int y0, int x1, int y1, int thickness,
                       int img_w, int img_h, uint8_t* out) {
  Img img{out, img_w, img_h};
  thick_line(img, x0, y0, x1, y1, thickness);
}

// cv::fillConvexPoly(img, pts, 1, LINE_8, shift) replica (npts vertices).
void culane_fill_convex_poly(const long long* xy, int npts, int shift,
                             int img_w, int img_h, uint8_t* out) {
  Img img{out, img_w, img_h};
  std::vector<P2l> v(npts);
  for (int i = 0; i < npts; ++i) v[i] = {xy[2 * i], xy[2 * i + 1]};
  fill_convex_poly(img, v.data(), npts, shift);
}

// cv::circle(img, c, r, 1, FILLED) replica.
void culane_circle_fill(int cx, int cy, int radius, int img_w, int img_h,
                        uint8_t* out) {
  Img img{out, img_w, img_h};
  circle_fill(img, cx, cy, radius);
}

// cv::line(..., thickness=1, LINE_8, shift=16) replica (Line2 path).
void culane_line2(long long x0, long long y0, long long x1, long long y1,
                  int img_w, int img_h, uint8_t* out) {
  Img img{out, img_w, img_h};
  line2(img, {x0, y0}, {x1, y1});
}

// official spline, for direct comparison with the python oracle.
// out must hold (n-1)*times+1 (n>2), times+1 (n==2) or n (n<2) pairs of
// floats; returns the number of points written.
int culane_spline_interp(const double* xy, int n, int times, float* out) {
  std::vector<Ptf> pts(n);
  for (int i = 0; i < n; ++i)
    pts[i] = {(float)xy[2 * i], (float)xy[2 * i + 1]};
  std::vector<Ptf> res = spline_interp_times(pts, times);
  for (size_t i = 0; i < res.size(); ++i) {
    out[2 * i] = res[i].x;
    out[2 * i + 1] = res[i].y;
  }
  return (int)res.size();
}

}  // extern "C"
