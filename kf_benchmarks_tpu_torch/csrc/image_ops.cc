// PIL's image operations on uint8 HWC arrays, as the input path's train and
// eval preprocessing uses them: ``Image.resize`` with the NEAREST, BILINEAR,
// BICUBIC and BOX filters, ``convert("L")`` and the ImageEnhance
// Brightness, Color and Contrast enhancers (``Image.blend`` of the image
// with its degenerate). Each follows Pillow's C code so that the results are
// PIL's to the bit:
//
// * resize (Resample.c): coefficients from the filter at the scale's support
//   (antialiased when downscaling), normalised, then 22-bit fixed point;
//   a horizontal pass over the rows the vertical pass needs, then the
//   vertical pass; NEAREST is the affine nearest-neighbour scaler of
//   Geometry.c (ImagingScaleAffine).
// * convert("L") (Convert.c): L = (19595 R + 38470 G + 7471 B + 2^15) >> 16.
// * blend (Blend.c): out = in1 + alpha (in2 - in1) in single precision,
//   truncated, and clipped when alpha leaves [0, 1].
// * Contrast's grey level: int(mean(L) + 0.5), the mean from ImageStat.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

double box_filter(double x) { return (x > -0.5 && x <= 0.5) ? 1.0 : 0.0; }

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// Resample.c precompute_coeffs + normalize_coeffs_8bpc.
int precompute(int in_size, float in0, float in1, int out_size,
               const Filter& f, std::vector<int>& bounds,
               std::vector<int32_t>& kk) {
  double scale = (double)(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> k((size_t)out_size * ksize);
  bounds.resize((size_t)out_size * 2);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* kp = &k[(size_t)xx * ksize];
    int x = 0;
    for (; x < xmax; ++x) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      kp[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x)
      if (ww != 0.0) kp[x] /= ww;
    for (; x < ksize; ++x) kp[x] = 0;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(k.size());
  for (size_t i = 0; i < k.size(); ++i)
    kk[i] = k[i] < 0 ? (int32_t)(-0.5 + k[i] * (1 << PRECISION_BITS))
                     : (int32_t)(0.5 + k[i] * (1 << PRECISION_BITS));
  return ksize;
}

inline uint8_t clip8(int32_t v) {
  v >>= PRECISION_BITS;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void resample(const uint8_t* in, int w, int h, int c, uint8_t* out, int ow,
              int oh, const Filter& f) {
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  int ksh = precompute(w, 0.0f, (float)w, ow, f, bh, kh);
  int ksv = precompute(h, 0.0f, (float)h, oh, f, bv, kv);
  bool need_h = ow != w, need_v = oh != h;
  int y_first = bv[0];
  int y_last = bv[(size_t)oh * 2 - 2] + bv[(size_t)oh * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int sw = w, sh = h;
  if (need_h) {
    for (int i = 0; i < oh; ++i) bv[(size_t)i * 2] -= y_first;
    sh = y_last - y_first;
    tmp.resize((size_t)ow * sh * c);
    for (int yy = 0; yy < sh; ++yy) {
      const uint8_t* row = in + (size_t)(yy + y_first) * w * c;
      uint8_t* orow = &tmp[(size_t)yy * ow * c];
      for (int xx = 0; xx < ow; ++xx) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[(size_t)xx * ksh];
        for (int ch = 0; ch < c; ++ch) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; ++x)
            ss += row[(size_t)(x + xmin) * c + ch] * k[x];
          orow[(size_t)xx * c + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    sw = ow;
  } else if (!need_v) {
    memcpy(out, in, (size_t)w * h * c);
    return;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; ++yy) {
      int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      const int32_t* k = &kv[(size_t)yy * ksv];
      uint8_t* orow = out + (size_t)yy * sw * c;
      for (int xx = 0; xx < sw * c; ++xx) {
        int32_t ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; ++y)
          ss += src[(size_t)(y + ymin) * sw * c + xx] * k[y];
        orow[xx] = clip8(ss);
      }
    }
  } else {
    memcpy(out, src, (size_t)sw * sh * c);
  }
  (void)sh;
}

inline int coord(double v) { return v < 0.0 ? -1 : (int)v; }

void nearest(const uint8_t* in, int w, int h, int c, uint8_t* out, int ow,
             int oh) {
  double a0 = (double)((float)w - 0.0f) / ow;
  double a4 = (double)((float)h - 0.0f) / oh;
  std::vector<int> xin(ow, 0);
  int xmin = ow, xmax = 0;
  double xo = 0.0 + a0 * 0.5;
  for (int x = 0; x < ow; ++x) {
    int xi = coord(xo);
    if (xi >= 0 && xi < w) {
      xmax = x + 1;
      if (x < xmin) xmin = x;
      xin[x] = xi;
    }
    xo += a0;
  }
  double yo = 0.0 + a4 * 0.5;
  for (int y = 0; y < oh; ++y) {
    int yi = coord(yo);
    uint8_t* orow = out + (size_t)y * ow * c;
    memset(orow, 0, (size_t)ow * c);
    if (yi >= 0 && yi < h) {
      const uint8_t* row = in + (size_t)yi * w * c;
      for (int x = xmin; x < xmax; ++x)
        memcpy(orow + (size_t)x * c, row + (size_t)xin[x] * c, c);
    }
    yo += a4;
  }
}

inline uint8_t luma(const uint8_t* p) {
  return (uint8_t)((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >>
                   16);
}

// Image.blend(im1, im2, alpha) on one byte.
inline uint8_t blend(int in1, int in2, float alpha) {
  if (alpha >= 0 && alpha <= 1.0f)
    return (uint8_t)((float)in1 + alpha * (float)(in2 - in1));
  float t = (float)in1 + alpha * (float)(in2 - in1);
  if (t <= 0.0f) return 0;
  if (t >= 255.0f) return 255;
  return (uint8_t)t;
}

}  // namespace

extern "C" {

// Image.resize((ow, oh), filter) of an (h, w, c) image; filter 0 NEAREST,
// 1 BILINEAR, 2 BICUBIC, 3 BOX (PIL's "area"). Returns 0, or -1 for a bad
// argument.
int kfi_resize(const uint8_t* in, int w, int h, int c, uint8_t* out, int ow,
               int oh, int filter) {
  if (w <= 0 || h <= 0 || ow <= 0 || oh <= 0 || c <= 0) return -1;
  if (ow == w && oh == h) {
    memcpy(out, in, (size_t)w * h * c);
    return 0;
  }
  switch (filter) {
    case 0:
      nearest(in, w, h, c, out, ow, oh);
      return 0;
    case 1:
      resample(in, w, h, c, out, ow, oh, Filter{bilinear_filter, 1.0});
      return 0;
    case 2:
      resample(in, w, h, c, out, ow, oh, Filter{bicubic_filter, 2.0});
      return 0;
    case 3:
      resample(in, w, h, c, out, ow, oh, Filter{box_filter, 0.5});
      return 0;
    default:
      return -1;
  }
}

// convert("L") of n RGB pixels.
void kfi_grayscale(const uint8_t* rgb, size_t n, uint8_t* out) {
  for (size_t i = 0; i < n; ++i) out[i] = luma(rgb + 3 * i);
}

// ImageEnhance.<kind>(img).enhance(factor) of n RGB pixels; kind 0
// Brightness (degenerate black), 1 Color (degenerate: the L image as RGB),
// 2 Contrast (degenerate: grey at the L image's rounded mean).
int kfi_enhance(const uint8_t* rgb, size_t n, int kind, double factor,
                uint8_t* out) {
  float alpha = (float)factor;  // Image.blend takes a C float
  if (kind == 0) {
    for (size_t i = 0; i < 3 * n; ++i) out[i] = blend(0, rgb[i], alpha);
    return 0;
  }
  if (kind == 1) {
    for (size_t i = 0; i < n; ++i) {
      int l = luma(rgb + 3 * i);
      for (int ch = 0; ch < 3; ++ch)
        out[3 * i + ch] = blend(l, rgb[3 * i + ch], alpha);
    }
    return 0;
  }
  if (kind == 2) {
    uint64_t sum = 0;
    for (size_t i = 0; i < n; ++i) sum += luma(rgb + 3 * i);
    int mean = n ? (int)((double)sum / (double)n + 0.5) : 0;
    for (size_t i = 0; i < 3 * n; ++i) out[i] = blend(mean, rgb[i], alpha);
    return 0;
  }
  return -1;
}

// convert("HSV") of n RGB pixels (PIL's rgb2hsv_row, after colorsys.py):
// v the largest channel, s and h in [0, 255], truncated, with PIL's mix of
// float and double arithmetic.
void kfi_rgb_to_hsv(const uint8_t* rgb, size_t n, uint8_t* out) {
  for (size_t i = 0; i < n; ++i) {
    const uint8_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    const uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    const uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    uint8_t uh = 0, us = 0;
    if (minc != maxc) {
      float cr = (float)(maxc - minc);
      float s = cr / (float)maxc;
      float rc = ((float)(maxc - r)) / cr;
      float gc = ((float)(maxc - g)) / cr;
      float bc = ((float)(maxc - b)) / cr;
      float h;
      if (r == maxc) {
        h = bc - gc;
      } else if (g == maxc) {
        h = 2.0 + rc - bc;
      } else {
        h = 4.0 + gc - rc;
      }
      h = fmod((h / 6.0 + 1.0), 1.0);
      int ih = (int)(h * 255.0), is = (int)(s * 255.0);
      uh = (uint8_t)(ih < 0 ? 0 : ih > 255 ? 255 : ih);
      us = (uint8_t)(is < 0 ? 0 : is > 255 ? 255 : is);
    }
    out[3 * i] = uh;
    out[3 * i + 1] = us;
    out[3 * i + 2] = maxc;
  }
}

// convert("RGB") of n HSV pixels (PIL's hsv2rgb).
void kfi_hsv_to_rgb(const uint8_t* hsv, size_t n, uint8_t* out) {
  for (size_t x = 0; x < n; ++x) {
    const uint8_t h = hsv[3 * x], s = hsv[3 * x + 1], v = hsv[3 * x + 2];
    uint8_t* o = out + 3 * x;
    if (s == 0) {
      o[0] = o[1] = o[2] = v;
      continue;
    }
    int i = (int)floor((float)h * 6.0 / 255.0);
    float f = (float)h * 6.0 / 255.0 - (float)i;
    float fs = ((float)s) / 255.0;
    int p = (int)round((float)v * (1.0 - fs));
    int q = (int)round((float)v * (1.0 - fs * f));
    int t = (int)round((float)v * (1.0 - fs * (1.0 - f)));
    uint8_t up = (uint8_t)(p < 0 ? 0 : p > 255 ? 255 : p);
    uint8_t uq = (uint8_t)(q < 0 ? 0 : q > 255 ? 255 : q);
    uint8_t ut = (uint8_t)(t < 0 ? 0 : t > 255 ? 255 : t);
    switch (i % 6) {
      case 0: o[0] = v; o[1] = ut; o[2] = up; break;
      case 1: o[0] = uq; o[1] = v; o[2] = up; break;
      case 2: o[0] = up; o[1] = v; o[2] = ut; break;
      case 3: o[0] = up; o[1] = uq; o[2] = v; break;
      case 4: o[0] = ut; o[1] = up; o[2] = v; break;
      case 5: o[0] = v; o[1] = up; o[2] = uq; break;
    }
  }
}

}  // extern "C"
