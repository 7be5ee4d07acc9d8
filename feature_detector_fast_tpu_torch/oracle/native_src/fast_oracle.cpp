// Scalar FAST oracle — native differential-test reference.
//
// Plays the role of the reference's `opencv_compat.rs`: a deliberately
// simple, loop-based implementation of the exact OpenCV-3.2 FAST semantics
// (detection, both score functions, border-quirk nonmax), fast enough to
// diff the CUDA kernels against on full 1080p frames.  Written from the
// semantic spec (see ops/fast.py docstring), not translated from the
// reference's SIMD code.
//
// Semantics anchored on the reference's src/opencv_compat.rs:
//   detect        :79-169   (strict |center - tap| > t, wraparound run >= n)
//   max-t score   :172-209  (32-ring windowed min/max extremes)
//   SAD score     :278-299  (paper eq. 3)
//   nonmax        :212-262  (strict 8-neighbor max, rows 3 and H-4 dropped)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kRing = 16;
constexpr int kRadius = 3;
// Clockwise from twelve o'clock; order matters for the arc test.
constexpr int kCircleDx[kRing] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
constexpr int kCircleDy[kRing] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

enum NonmaxMode : int32_t {
  kNonmaxOff = 0,
  kNonmaxMaxThreshold = 1,
  kNonmaxSumAbsolute = 2,
};

inline const uint8_t* px(const uint8_t* img, int32_t w, int32_t x, int32_t y) {
  return img + static_cast<int64_t>(y) * w + x;
}

// Wraparound consecutive-run predicate: does any circular window of n
// flags hold entirely?
bool has_consecutive(const bool flags[kRing], int n) {
  for (int s = 0; s < kRing; ++s) {
    int run = 0;
    for (int i = 0; i < kRing; ++i) {
      if (flags[(s + i) % kRing]) {
        ++run;
      } else {
        break;
      }
    }
    if (run >= n) return true;
  }
  return false;
}

bool is_keypoint(const uint8_t* img, int32_t w, int32_t x, int32_t y, int t, int n) {
  const int c = *px(img, w, x, y);
  bool bright[kRing], dark[kRing];
  for (int i = 0; i < kRing; ++i) {
    const int p = *px(img, w, x + kCircleDx[i], y + kCircleDy[i]);
    bright[i] = p - c > t;
    dark[i] = c - p > t;
  }
  return has_consecutive(bright, n) || has_consecutive(dark, n);
}

// OpenCV's nonmax score: maximum t for which (x, y) stays a keypoint.
uint16_t score_max_threshold(const uint8_t* img, int32_t w, int32_t x, int32_t y,
                             int n) {
  const int c = *px(img, w, x, y);
  int16_t diff[2 * kRing];
  for (int i = 0; i < 2 * kRing; ++i) {
    const int k = i % kRing;
    diff[i] = static_cast<int16_t>(
        c - *px(img, w, x + kCircleDx[k], y + kCircleDy[k]));
  }
  int extreme_highest = INT32_MIN;
  int extreme_lowest = INT32_MAX;
  for (int k = 0; k < kRing; ++k) {
    int mn = diff[k], mx = diff[k];
    for (int i = 1; i < n; ++i) {
      const int v = diff[k + i];
      if (v < mn) mn = v;
      if (v > mx) mx = v;
    }
    if (mn > extreme_highest) extreme_highest = mn;
    if (mx < extreme_lowest) extreme_lowest = mx;
  }
  const int a = std::abs(extreme_highest);
  const int b = std::abs(extreme_lowest);
  return static_cast<uint16_t>(a < b ? a : b);
}

// Paper eq. 3: max of summed bright/dark threshold excesses.
uint16_t score_sum_abs(const uint8_t* img, int32_t w, int32_t x, int32_t y, int t) {
  const int c = *px(img, w, x, y);
  int sum_light = 0, sum_dark = 0;
  for (int i = 0; i < kRing; ++i) {
    const int p = *px(img, w, x + kCircleDx[i], y + kCircleDy[i]);
    if (c - p > t) sum_light += (c - p) - t;
    if (p - c > t) sum_dark += (p - c) - t;
  }
  return static_cast<uint16_t>(sum_light > sum_dark ? sum_light : sum_dark);
}

}  // namespace

extern "C" {

// Detect keypoints; returns the total count found.  Writes up to `cap`
// (x, y) pairs into out_xy (row-major emission order).  If the count
// exceeds cap, the overflow is simply not written — caller re-calls with a
// larger buffer.  nonmax_mode: 0 off, 1 max-threshold, 2 sum-absolute.
int32_t fast_oracle_detect(const uint8_t* img, int32_t h, int32_t w,
                           int32_t threshold, int32_t count,
                           int32_t nonmax_mode, uint32_t* out_xy,
                           int32_t cap) {
  if (h < 7 || w < 7 || count < 9 || count > 16) return -1;

  // Pass 1: dense candidacy + (if nonmax) dense scores of candidates.
  std::vector<uint8_t> kp(static_cast<size_t>(h) * w, 0);
  std::vector<uint16_t> score;
  const bool do_nonmax = nonmax_mode != kNonmaxOff;
  if (do_nonmax) score.assign(static_cast<size_t>(h) * w, 0);

  for (int32_t y = kRadius; y < h - kRadius; ++y) {
    for (int32_t x = kRadius; x < w - kRadius; ++x) {
      if (!is_keypoint(img, w, x, y, threshold, count)) continue;
      kp[static_cast<size_t>(y) * w + x] = 1;
      if (do_nonmax) {
        score[static_cast<size_t>(y) * w + x] =
            nonmax_mode == kNonmaxMaxThreshold
                ? score_max_threshold(img, w, x, y, count)
                : score_sum_abs(img, w, x, y, threshold);
      }
    }
  }

  int32_t found = 0;
  for (int32_t y = kRadius; y < h - kRadius; ++y) {
    for (int32_t x = kRadius; x < w - kRadius; ++x) {
      if (!kp[static_cast<size_t>(y) * w + x]) continue;
      if (do_nonmax) {
        // Rows y==3 and y==H-4 compete as neighbors but are dropped.
        if (y == kRadius || y == h - kRadius - 1) continue;
        const uint16_t s = score[static_cast<size_t>(y) * w + x];
        bool suppressed = false;
        for (int dy = -1; dy <= 1 && !suppressed; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            if (dx == 0 && dy == 0) continue;
            const size_t idx = static_cast<size_t>(y + dy) * w + (x + dx);
            if (kp[idx] && s <= score[idx]) {
              suppressed = true;
              break;
            }
          }
        }
        if (suppressed) continue;
      }
      if (found < cap) {
        out_xy[2 * found] = static_cast<uint32_t>(x);
        out_xy[2 * found + 1] = static_cast<uint32_t>(y);
      }
      ++found;
    }
  }
  return found;
}

// Dense single-pixel probes for micro-tests.
int32_t fast_oracle_is_keypoint(const uint8_t* img, int32_t h, int32_t w,
                                int32_t x, int32_t y, int32_t threshold,
                                int32_t count) {
  (void)h;
  return is_keypoint(img, w, x, y, threshold, count) ? 1 : 0;
}

uint16_t fast_oracle_score_max_threshold(const uint8_t* img, int32_t h,
                                         int32_t w, int32_t x, int32_t y,
                                         int32_t count) {
  (void)h;
  return score_max_threshold(img, w, x, y, count);
}

uint16_t fast_oracle_score_sum_abs(const uint8_t* img, int32_t h, int32_t w,
                                   int32_t x, int32_t y, int32_t threshold) {
  (void)h;
  return score_sum_abs(img, w, x, y, threshold);
}

}  // extern "C"
