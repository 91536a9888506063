// Native host-side pixel/data-path operations for cora-tpu.
//
// The device compute path is JAX/XLA; this library covers the *host* runtime
// hot paths around it (the role the reference fills with Cython/C + OpenMP,
// cora/util/{pmesh.pyx,pmesh_util.c}):
//   - HEALPix RING ang2pix / pix2ang (vectorised, OpenMP)
//   - ring-grid <-> HEALPix-pixel map layout conversion (the device keeps
//     maps in a dense [nring, 4*nside] grid; converting multi-GB cubes for
//     IO is memory-bandwidth bound and parallelises well)
//   - point-source catalogue painting (scatter-add with atomics)
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

// south-cap in-ring index helper
static inline int64_t p2j(int64_t q, int64_t i) {
  int64_t j = q + 1 - 2 * i * (i - 1);
  return 4 * i + 1 - j;
}

extern "C" {

// ---------------------------------------------------------------------------
// HEALPix RING scheme
// ---------------------------------------------------------------------------

void ang2pix_ring(int64_t nside, const double *theta, const double *phi,
                  int64_t *ipix, int64_t n) {
  const double twopi = 2.0 * M_PI;
  const int64_t npix = 12 * nside * nside;
  const int64_t ncap = 2 * nside * (nside - 1);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double z = std::cos(theta[i]);
    double za = std::fabs(z);
    double tt = std::fmod(phi[i], twopi);
    if (tt < 0) tt += twopi;
    tt /= (0.5 * M_PI);

    int64_t pix;
    if (za <= 2.0 / 3.0) {
      double temp1 = nside * (0.5 + tt);
      double temp2 = nside * 0.75 * z;
      int64_t jp = (int64_t)std::floor(temp1 - temp2);
      int64_t jm = (int64_t)std::floor(temp1 + temp2);

      int64_t ir = nside + 1 + jp - jm;
      int64_t kshift = 1 - (ir & 1);

      int64_t ip = (jp + jm - nside + kshift + 1) / 2;
      ip = ((ip % (4 * nside)) + 4 * nside) % (4 * nside);

      pix = ncap + (ir - 1) * 4 * nside + ip;
    } else {
      double tp = tt - std::floor(tt);
      double tmp = nside * std::sqrt(3.0 * (1.0 - za));
      int64_t jp = (int64_t)(tp * tmp);
      int64_t jm = (int64_t)((1.0 - tp) * tmp);

      int64_t ir = jp + jm + 1;
      int64_t ip = (int64_t)(tt * ir);
      ip = ((ip % (4 * ir)) + 4 * ir) % (4 * ir);

      if (z > 0)
        pix = 2 * ir * (ir - 1) + ip;
      else
        pix = npix - 2 * ir * (ir + 1) + ip;
    }
    ipix[i] = pix;
  }
}

void pix2ang_ring(int64_t nside, const int64_t *ipix, double *theta,
                  double *phi, int64_t n) {
  const int64_t npix = 12 * nside * nside;
  const int64_t ncap = 2 * nside * (nside - 1);

#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n; ++k) {
    int64_t p = ipix[k];
    double th, ph;
    if (p < ncap) {
      double pp = (p + 1) / 2.0;
      int64_t i = (int64_t)(std::sqrt(pp - std::sqrt(std::floor(pp)))) + 1;
      int64_t j = p + 1 - 2 * i * (i - 1);
      th = std::acos(1.0 - (double)(i * i) / (3.0 * nside * nside));
      ph = (j - 0.5) * M_PI / (2.0 * i);
    } else if (p < npix - ncap) {
      int64_t q = p - ncap;
      int64_t i = q / (4 * nside) + nside;
      int64_t j = q % (4 * nside) + 1;
      int64_t s = (i - nside + 1) % 2;
      th = std::acos(4.0 / 3.0 - 2.0 * i / (3.0 * nside));
      ph = (j - 1.0 + s / 2.0) * M_PI / (2.0 * nside);
    } else {
      int64_t q = npix - 1 - p;
      double pp = (q + 1) / 2.0;
      int64_t i = (int64_t)(std::sqrt(pp - std::sqrt(std::floor(pp)))) + 1;
      int64_t j = p2j(q, i);
      th = std::acos(-(1.0 - (double)(i * i) / (3.0 * nside * nside)));
      ph = (j - 0.5) * M_PI / (2.0 * i);
    }
    theta[k] = th;
    phi[k] = ph;
  }
}

// ---------------------------------------------------------------------------
// Ring-grid <-> pixel layout conversion
// ---------------------------------------------------------------------------

// grid:  [nmap, nring, width] (row-major), pixels: [nmap, npix]
// start[r] is the RING index of the first pixel of ring r; nq[r] its length.
void grid_to_pixels_f32(const float *grid, float *pixels, const int64_t *start,
                        const int64_t *nq, int64_t nring, int64_t width,
                        int64_t npix, int64_t nmap) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t m = 0; m < nmap; ++m) {
    for (int64_t r = 0; r < nring; ++r) {
      const float *src = grid + (m * nring + r) * width;
      float *dst = pixels + m * npix + start[r];
      std::memcpy(dst, src, sizeof(float) * nq[r]);
    }
  }
}

void pixels_to_grid_f32(const float *pixels, float *grid, const int64_t *start,
                        const int64_t *nq, int64_t nring, int64_t width,
                        int64_t npix, int64_t nmap) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t m = 0; m < nmap; ++m) {
    for (int64_t r = 0; r < nring; ++r) {
      float *dst = grid + (m * nring + r) * width;
      const float *src = pixels + m * npix + start[r];
      std::memcpy(dst, src, sizeof(float) * nq[r]);
      if (nq[r] < width)
        std::memset(dst + nq[r], 0, sizeof(float) * (width - nq[r]));
    }
  }
}

void grid_to_pixels_f64(const double *grid, double *pixels,
                        const int64_t *start, const int64_t *nq, int64_t nring,
                        int64_t width, int64_t npix, int64_t nmap) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t m = 0; m < nmap; ++m) {
    for (int64_t r = 0; r < nring; ++r) {
      const double *src = grid + (m * nring + r) * width;
      double *dst = pixels + m * npix + start[r];
      std::memcpy(dst, src, sizeof(double) * nq[r]);
    }
  }
}

void pixels_to_grid_f64(const double *pixels, double *grid,
                        const int64_t *start, const int64_t *nq, int64_t nring,
                        int64_t width, int64_t npix, int64_t nmap) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t m = 0; m < nmap; ++m) {
    for (int64_t r = 0; r < nring; ++r) {
      double *dst = grid + (m * nring + r) * width;
      const double *src = pixels + m * npix + start[r];
      std::memcpy(dst, src, sizeof(double) * nq[r]);
      if (nq[r] < width)
        std::memset(dst + nq[r], 0, sizeof(double) * (width - nq[r]));
    }
  }
}

// ---------------------------------------------------------------------------
// Catalogue painting: sky[f, pix[i]] += spectra[i, f]
// ---------------------------------------------------------------------------

void paint_sources(const int64_t *pix, const double *spectra, double *sky,
                   int64_t nsrc, int64_t nfreq, int64_t npix) {
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < nfreq; ++f) {
    double *row = sky + f * npix;
    for (int64_t i = 0; i < nsrc; ++i) {
      row[pix[i]] += spectra[i * nfreq + f];
    }
  }
}


// --- natural cubic spline evaluation (reference cubicspline.pyx:107-175):
// binary search per point, linear extrapolation at both ends.  This is the
// inner loop of every host-side physics-table evaluation (P(k) grids etc.)
static inline int64_t bisect_right(const double *xg, int64_t n, double v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (v < xg[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
}

void spline_eval_f64(const double *xg, const double *yg, const double *y2,
                     const double *pts, double *out, int64_t n, int64_t npts) {
  const double h0 = xg[1] - xg[0];
  const double s0 = (yg[1] - yg[0]) / h0 - h0 * y2[1] / 6.0;
  const double h1 = xg[n - 1] - xg[n - 2];
  const double s1 = (yg[n - 1] - yg[n - 2]) / h1 + h1 * y2[n - 2] / 6.0;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < npts; ++i) {
    const double x = pts[i];
    if (x < xg[0]) {
      out[i] = s0 * (x - xg[0]) + yg[0];
    } else if (x >= xg[n - 1]) {
      out[i] = s1 * (x - xg[n - 1]) + yg[n - 1];
    } else {
      int64_t kl = bisect_right(xg, n, x) - 1;
      if (kl < 0) kl = 0;
      if (kl > n - 2) kl = n - 2;
      const int64_t kh = kl + 1;
      const double h = xg[kh] - xg[kl];
      const double a = (xg[kh] - x) / h;
      const double b = (x - xg[kl]) / h;
      const double c = (a * a * a - a) * h * h / 6.0;
      const double d = (b * b * b - b) * h * h / 6.0;
      out[i] = a * yg[kl] + b * yg[kh] + c * y2[kl] + d * y2[kh];
    }
  }
}

// log-space variant: exp(spline(log x)), with x<=0 -> 0 (LogSpline semantics)
void spline_eval_log_f64(const double *xg, const double *yg, const double *y2,
                         const double *pts, double *out, int64_t n,
                         int64_t npts) {
  const double h0 = xg[1] - xg[0];
  const double s0 = (yg[1] - yg[0]) / h0 - h0 * y2[1] / 6.0;
  const double h1 = xg[n - 1] - xg[n - 2];
  const double s1 = (yg[n - 1] - yg[n - 2]) / h1 + h1 * y2[n - 2] / 6.0;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < npts; ++i) {
    const double xin = pts[i];
    if (!(xin > 0.0)) { out[i] = 0.0; continue; }
    const double x = log(xin);
    double v;
    if (x < xg[0]) {
      v = s0 * (x - xg[0]) + yg[0];
    } else if (x >= xg[n - 1]) {
      v = s1 * (x - xg[n - 1]) + yg[n - 1];
    } else {
      int64_t kl = bisect_right(xg, n, x) - 1;
      if (kl < 0) kl = 0;
      if (kl > n - 2) kl = n - 2;
      const int64_t kh = kl + 1;
      const double h = xg[kh] - xg[kl];
      const double a = (xg[kh] - x) / h;
      const double b = (x - xg[kl]) / h;
      const double c = (a * a * a - a) * h * h / 6.0;
      const double d = (b * b * b - b) * h * h / 6.0;
      v = a * yg[kl] + b * yg[kh] + c * y2[kl] + d * y2[kh];
    }
    out[i] = exp(v);
  }
}

}  // extern "C"
