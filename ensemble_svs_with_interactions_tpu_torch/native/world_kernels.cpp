// First-party native kernels for the WORLD-style analysis stack.
//
// These are fused per-frame C++ implementations of the hot loops in
// ops/world/analysis.py (the Python file documents the algorithms and the
// reference call sites; this file matches its NumPy semantics to float64
// rounding).  The reference gets the same job done by pyworld's C++
// (nnsvs/data/data_source.py:339-369); here the native
// layer is first-party and parity-tested against the NumPy path.
//
// Everything is single-threaded (the data-prep CLIs parallelize across
// utterances at the process level) and allocation-free inside the frame
// loops.  All FFT sizes used by the callers are powers of two.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC world_kernels.cpp -o _world_kernels.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <utility>
#include <vector>

namespace {

constexpr double kEps = 1e-12;
constexpr double kPi = 3.141592653589793238462643383279502884;

// ------------------------------------------------------------------------
// Iterative radix-2 complex FFT (decimation in time), double precision.
// ------------------------------------------------------------------------

struct FFTPlan {
  int n = 0;
  std::vector<int> rev;      // bit-reversal permutation
  std::vector<double> wr, wi;  // twiddles exp(-2*pi*i*j/n), j < n/2

  explicit FFTPlan(int size) : n(size), rev(size), wr(size / 2), wi(size / 2) {
    int logn = 0;
    while ((1 << logn) < n) ++logn;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < logn; ++b) r |= ((i >> b) & 1) << (logn - 1 - b);
      rev[i] = r;
    }
    for (int j = 0; j < n / 2; ++j) {
      wr[j] = std::cos(-2.0 * kPi * j / n);
      wi[j] = std::sin(-2.0 * kPi * j / n);
    }
  }

  // forward transform, in place
  void fwd(double* re, double* im) const {
    for (int i = 0; i < n; ++i) {
      int r = rev[i];
      if (r > i) {
        std::swap(re[i], re[r]);
        std::swap(im[i], im[r]);
      }
    }
    for (int len = 2; len <= n; len <<= 1) {
      int half = len >> 1;
      int stride = n / len;
      for (int base = 0; base < n; base += len) {
        for (int j = 0; j < half; ++j) {
          double twr = wr[j * stride], twi = wi[j * stride];
          int a = base + j, b = a + half;
          double xr = re[b] * twr - im[b] * twi;
          double xi = re[b] * twi + im[b] * twr;
          re[b] = re[a] - xr;
          im[b] = im[a] - xi;
          re[a] += xr;
          im[a] += xi;
        }
      }
    }
  }

  // inverse transform (with 1/n scaling), in place
  void inv(double* re, double* im) const {
    for (int i = 0; i < n; ++i) im[i] = -im[i];
    fwd(re, im);
    double s = 1.0 / n;
    for (int i = 0; i < n; ++i) {
      re[i] *= s;
      im[i] *= -s;
    }
  }
};

const FFTPlan& plan(int n) {
  static std::map<int, std::unique_ptr<FFTPlan>> cache;
  auto it = cache.find(n);
  if (it == cache.end())
    it = cache.emplace(n, std::make_unique<FFTPlan>(n)).first;
  return *it->second;
}

// Scratch pair of complex buffers.
struct CBuf {
  std::vector<double> re, im;
  void resize(int n) {
    re.assign(n, 0.0);
    im.assign(n, 0.0);
  }
};

// rfft of a real signal (first `len` entries of buf.re are the signal,
// rest must be zero): leaves the full complex transform in buf.
void rfft(CBuf& buf, int n) { plan(n).fwd(buf.re.data(), buf.im.data()); }

// Gather a window of x centered at `center` into out[0..length), with
// zeros outside the signal (matches analysis._gather_frames).
void gather(const double* x, int64_t n, int64_t center, int length,
            double* out) {
  int half = length / 2;
  int64_t start = center - half;
  for (int i = 0; i < length; ++i) {
    int64_t idx = start + i;
    out[i] = (idx >= 0 && idx < n) ? x[idx] : 0.0;
  }
}

int next_pow2(double v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// ==========================================================================
// CheapTrick spectral envelope (analysis.cheaptrick body)
// ==========================================================================
void esvs_cheaptrick(const double* x, int64_t n, const double* f0_safe,
                     const int64_t* centers, int64_t T, int64_t fs,
                     int64_t fft_size, double q1, double noise_calibration,
                     double* env_out) {
  const int N = (int)fft_size;
  const int half = N / 2;
  const double freq_per_bin = (double)fs / N;
  CBuf buf;
  std::vector<double> seg(N), win(N), ps(half + 1), ps0(half + 1),
      cum(half + 3), logs(half + 1);
  buf.resize(N);

  for (int64_t t = 0; t < T; ++t) {
    const double f0 = f0_safe[t];
    const double half_win = 1.5 * fs / f0;

    // 1. pitch-adaptive Hann window + window-weighted DC removal
    gather(x, n, centers[t], N, seg.data());
    double wsum = 0.0, w2sum = 0.0, dsum = 0.0;
    for (int i = 0; i < N; ++i) {
      double rel = (i - N / 2) / half_win;
      double w = (std::fabs(rel) <= 1.0) ? 0.5 + 0.5 * std::cos(kPi * rel) : 0.0;
      win[i] = w;
      wsum += w;
      w2sum += w * w;
      dsum += seg[i] * w;
    }
    const double dc = dsum / std::max(wsum, kEps);
    w2sum = std::max(w2sum, kEps);

    // 2. power spectrum (PSD normalization) + sub-f0 mirror correction
    for (int i = 0; i < N; ++i) {
      buf.re[i] = (seg[i] - dc) * win[i];
      buf.im[i] = 0.0;
    }
    rfft(buf, N);
    const double norm = 1.0 / (w2sum * noise_calibration);
    for (int k = 0; k <= half; ++k)
      ps0[k] = (buf.re[k] * buf.re[k] + buf.im[k] * buf.im[k]) * norm;
    const double f0_bin = f0 / freq_per_bin;
    for (int k = 0; k <= half; ++k) {
      ps[k] = ps0[k];
      if (k < f0_bin) {
        long m = std::lrint(std::nearbyint(2.0 * f0_bin - k));
        if (m < 0) m = 0;
        if (m > half) m = half;
        ps[k] += ps0[m];
      }
    }

    // 3. rectangular smoothing of width 2*f0/3 via an interpolated
    //    cumulative integral with reflected boundaries
    cum[0] = ps[1];
    for (int k = 0; k <= half; ++k) cum[k + 1] = cum[k] + ps[k];
    cum[half + 2] = cum[half + 1] + ps[half - 1];
    const double wb = (2.0 * f0 / 3.0) / freq_per_bin;
    auto interp_cum = [&](double p) {
      if (p < 0.0) p = 0.0;
      if (p > half + 2.0) p = half + 2.0;
      int i0 = (int)std::floor(p);
      int i1 = i0 + 1 < half + 3 ? i0 + 1 : half + 2;
      double w = p - i0;
      return cum[i0] * (1.0 - w) + cum[i1] * w;
    };
    for (int k = 0; k <= half; ++k) {
      double c = k + 1.0;
      double s = (interp_cum(c + wb / 2.0) - interp_cum(c - wb / 2.0)) / wb;
      logs[k] = std::log(std::max(s, kEps));
    }

    // 4. cepstral liftering (smoothing-recovery + q1 compensation)
    for (int i = 0; i <= half; ++i) {
      buf.re[i] = logs[i];
      buf.im[i] = 0.0;
    }
    for (int i = half + 1; i < N; ++i) {  // Hermitian ext. of a real spectrum
      buf.re[i] = logs[N - i];
      buf.im[i] = 0.0;
    }
    plan(N).inv(buf.re.data(), buf.im.data());
    for (int i = 0; i < N; ++i) {
      int qi = i < N - i ? i : N - i;
      double quef = (double)qi / fs;
      double arg = kPi * f0 * quef;
      double sl = arg < kEps ? 1.0 : std::sin(arg) / std::max(arg, kEps);
      double cl = (1.0 - 2.0 * q1) + 2.0 * q1 * std::cos(2.0 * arg);
      buf.re[i] = buf.re[i] * sl * cl;
      buf.im[i] = 0.0;
    }
    rfft(buf, N);
    double* out = env_out + t * (half + 1);
    for (int k = 0; k <= half; ++k) out[k] = std::exp(buf.re[k]);
  }
}

// ==========================================================================
// NCCF candidate generation (analysis._nccf_candidates)
// ==========================================================================
void esvs_nccf(const double* x, int64_t n, const int64_t* centers, int64_t T,
               int64_t fs, double f0_floor, double f0_ceil, int64_t K,
               double* f0_cand, double* score_out, double* energy) {
  const int max_lag = (int)(fs / f0_floor);
  const int win_len = next_pow2(2.0 * max_lag + 1.0);
  const int L = 2 * win_len;
  int min_lag = (int)(fs / f0_ceil);
  if (min_lag < 2) min_lag = 2;

  CBuf buf;
  buf.resize(L);
  std::vector<double> frame(win_len), nccf(max_lag + 1);
  std::vector<std::pair<double, int>> peaks;  // (score, lag)
  peaks.reserve(max_lag);

  for (int64_t t = 0; t < T; ++t) {
    gather(x, n, centers[t], win_len, frame.data());
    double mean = 0.0;
    for (int i = 0; i < win_len; ++i) mean += frame[i];
    mean /= win_len;
    for (int i = 0; i < win_len; ++i) {
      buf.re[i] = frame[i] - mean;
      buf.im[i] = 0.0;
    }
    for (int i = win_len; i < L; ++i) buf.re[i] = buf.im[i] = 0.0;
    rfft(buf, L);
    for (int i = 0; i < L; ++i) {  // power spectrum -> autocorrelation
      buf.re[i] = buf.re[i] * buf.re[i] + buf.im[i] * buf.im[i];
      buf.im[i] = 0.0;
    }
    plan(L).inv(buf.re.data(), buf.im.data());
    const double r0 = std::max(buf.re[0], kEps);
    for (int l = 0; l <= max_lag; ++l) nccf[l] = buf.re[l] / r0;
    energy[t] = r0 / win_len;

    // local maxima in [min_lag, max_lag] (strict left, >= right; the
    // first/last region entries compare against -inf pads)
    peaks.clear();
    for (int l = min_lag; l <= max_lag; ++l) {
      double v = nccf[l];
      bool gl = (l == min_lag) || (v > nccf[l - 1]);
      bool ge = (l == max_lag) || (v >= nccf[l + 1]);
      if (gl && ge) peaks.emplace_back(v, l);
    }
    // top-K best-first (ties: larger lag first, matching the NumPy
    // reversed-stable-argsort order)
    std::stable_sort(peaks.begin(), peaks.end(),
                     [](const std::pair<double, int>& a,
                        const std::pair<double, int>& b) {
                       if (a.first != b.first) return a.first > b.first;
                       return a.second > b.second;
                     });
    double* fc = f0_cand + t * K;
    double* sc = score_out + t * K;
    for (int k = 0; k < K; ++k) {
      if (k < (int)peaks.size()) {
        int lag = peaks[k].second;
        int li = lag;
        if (li < min_lag + 1) li = min_lag + 1;
        if (li > max_lag - 1) li = max_lag - 1;
        double ym1 = nccf[li - 1], y0 = nccf[li], yp1 = nccf[li + 1];
        double denom = ym1 - 2.0 * y0 + yp1;
        double delta =
            std::fabs(denom) > kEps ? 0.5 * (ym1 - yp1) / denom : 0.0;
        if (delta > 1.0) delta = 1.0;
        if (delta < -1.0) delta = -1.0;
        fc[k] = fs / (li + delta);
        double s = peaks[k].first;
        sc[k] = s < 0.0 ? 0.0 : (s > 1.0 ? 1.0 : s);
      } else {
        fc[k] = f0_floor;
        sc[k] = 0.0;
      }
    }
  }
}

// ==========================================================================
// Instantaneous-frequency F0 refinement (analysis._refine_f0_if)
// ==========================================================================
void esvs_refine_if(const double* x, int64_t n, double* est,
                    const int64_t* centers, int64_t T, int64_t fs,
                    double periods, int64_t n_harm, int64_t iters) {
  CBuf b0, b1;
  std::vector<double> seg0, seg1, win;

  for (int64_t it = 0; it < iters; ++it) {
    double max_win = 0.0;
    for (int64_t t = 0; t < T; ++t)
      max_win = std::max(max_win, periods * fs / est[t]);
    const int L = next_pow2(max_win + 2.0);
    const int half = L / 2;
    const double freq_per_bin = (double)fs / L;
    b0.resize(L);
    b1.resize(L);
    seg0.resize(L);
    seg1.resize(L);
    win.resize(L);

    for (int64_t t = 0; t < T; ++t) {
      const double wlen = periods * fs / est[t];
      gather(x, n, centers[t], L, seg0.data());
      gather(x, n, centers[t] + 1, L, seg1.data());
      for (int i = 0; i < L; ++i) {
        double rel = (i - L / 2) / (wlen / 2.0);
        win[i] =
            (std::fabs(rel) <= 1.0) ? 0.5 + 0.5 * std::cos(kPi * rel) : 0.0;
        b0.re[i] = seg0[i] * win[i];
        b0.im[i] = 0.0;
        b1.re[i] = seg1[i] * win[i];
        b1.im[i] = 0.0;
      }
      rfft(b0, L);
      rfft(b1, L);

      double num = 0.0, den = 0.0;
      for (int k = 1; k <= (int)n_harm; ++k) {
        long bin = std::lrint(std::nearbyint(k * est[t] / freq_per_bin));
        if (bin < 0) bin = 0;
        if (bin > half) bin = half;
        // cross-spectrum phase advance over one sample -> IF in Hz
        double cr = b0.re[bin] * b1.re[bin] + b0.im[bin] * b1.im[bin];
        double ci = b0.re[bin] * b1.im[bin] - b0.im[bin] * b1.re[bin];
        double inst = std::atan2(ci, cr) / (2.0 * kPi) * fs / k;
        double power = b0.re[bin] * b0.re[bin] + b0.im[bin] * b0.im[bin];
        bool ok = inst > 0.0 && std::isfinite(inst) &&
                  (k * est[t] < 0.95 * fs / 2.0);
        if (ok) {
          num += power * inst;
          den += power;
        }
      }
      double refined = den > kEps ? num / std::max(den, kEps) : est[t];
      if (std::fabs(refined - est[t]) / est[t] < 0.2) est[t] = refined;
    }
  }
}

// ==========================================================================
// D4C comb-cancellation band aperiodicity (analysis.d4c main loop)
// ==========================================================================
void esvs_d4c_coarse(const double* x, int64_t n, const double* period,
                     const int64_t* centers, int64_t T, int64_t fft_size,
                     int64_t L_long, int64_t fs, double freq_interval,
                     int64_t n_bands, double* coarse_out) {
  const int L = (int)L_long;
  const int N = (int)fft_size;
  const int half = N / 2;
  const int lo = (L - N) / 2;
  const double comb_gain = 1.0 + 1.0 / 4.0;

  CBuf sb, rb, ob;
  sb.resize(L);
  rb.resize(L);
  ob.resize(N);
  std::vector<double> seg(L), hann(N), pr(half + 1), px(half + 1);
  for (int i = 0; i < N; ++i)
    hann[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / (N - 1));

  // band bin ranges over the fft_size spectrum
  std::vector<int> b_lo(n_bands), b_hi(n_bands);  // [lo, hi)
  {
    const double bin_hz = (double)fs / N;
    for (int b = 0; b < (int)n_bands; ++b) {
      double f_lo = freq_interval * (b + 0.5), f_hi = freq_interval * (b + 1.5);
      int klo = 0;
      while (klo <= half && klo * bin_hz < f_lo) ++klo;
      int khi = klo;
      while (khi <= half && khi * bin_hz < f_hi) ++khi;
      b_lo[b] = klo;
      b_hi[b] = khi;
    }
  }

  for (int64_t t = 0; t < T; ++t) {
    gather(x, n, centers[t], L, seg.data());
    for (int i = 0; i < L; ++i) {
      sb.re[i] = seg[i];
      sb.im[i] = 0.0;
    }
    rfft(sb, L);

    // residual spectrum: S * (1 - comb), comb real by shift symmetry
    const double p = period[t];
    for (int j = 0; j <= L / 2; ++j) {
      double f = (double)j / L;
      double comb =
          0.5 * (std::cos(2.0 * kPi * p * f) + std::cos(2.0 * kPi * p * 2.0 * f));
      double g = 1.0 - comb;
      rb.re[j] = sb.re[j] * g;
      rb.im[j] = sb.im[j] * g;
    }
    for (int j = L / 2 + 1; j < L; ++j) {  // Hermitian mirror
      rb.re[j] = rb.re[L - j];
      rb.im[j] = -rb.im[L - j];
    }
    plan(L).inv(rb.re.data(), rb.im.data());

    // windowed power spectra of residual and original
    for (int i = 0; i < N; ++i) {
      ob.re[i] = rb.re[lo + i] * hann[i];
      ob.im[i] = 0.0;
    }
    rfft(ob, N);
    for (int k = 0; k <= half; ++k)
      pr[k] = ob.re[k] * ob.re[k] + ob.im[k] * ob.im[k];
    for (int i = 0; i < N; ++i) {
      ob.re[i] = seg[lo + i] * hann[i];
      ob.im[i] = 0.0;
    }
    rfft(ob, N);
    for (int k = 0; k <= half; ++k)
      px[k] = ob.re[k] * ob.re[k] + ob.im[k] * ob.im[k];

    double* out = coarse_out + t * n_bands;
    for (int b = 0; b < (int)n_bands; ++b) {
      if (b_lo[b] >= b_hi[b] || b_lo[b] > half) {
        out[b] = 1.0;
        continue;
      }
      double sr = 0.0, sx = 0.0;
      int hi = b_hi[b] <= half + 1 ? b_hi[b] : half + 1;
      for (int k = b_lo[b]; k < hi; ++k) {
        sr += pr[k];
        sx += px[k];
      }
      double r = sr / (comb_gain * std::max(sx, kEps));
      double v = std::sqrt(r);
      out[b] = v < 0.001 ? 0.001 : (v > 1.0 ? 1.0 : v);
    }
  }
}

// ==========================================================================
// Normalized autocorrelation periodicity at the f0 lag (D4C LoveTrain gate)
// ==========================================================================
void esvs_periodicity(const double* x, int64_t n, const double* f0_safe,
                      const int64_t* centers, int64_t T, int64_t fs,
                      int64_t max_lag, double* out) {
  const int ac_len = next_pow2(2.0 * max_lag + 1.0);
  const int L = 2 * ac_len;
  CBuf buf;
  buf.resize(L);
  std::vector<double> frame(ac_len);

  for (int64_t t = 0; t < T; ++t) {
    gather(x, n, centers[t], ac_len, frame.data());
    double mean = 0.0;
    for (int i = 0; i < ac_len; ++i) mean += frame[i];
    mean /= ac_len;
    for (int i = 0; i < ac_len; ++i) {
      buf.re[i] = frame[i] - mean;
      buf.im[i] = 0.0;
    }
    for (int i = ac_len; i < L; ++i) buf.re[i] = buf.im[i] = 0.0;
    rfft(buf, L);
    for (int i = 0; i < L; ++i) {
      buf.re[i] = buf.re[i] * buf.re[i] + buf.im[i] * buf.im[i];
      buf.im[i] = 0.0;
    }
    plan(L).inv(buf.re.data(), buf.im.data());
    long lag = std::lrint(std::nearbyint(fs / f0_safe[t]));
    if (lag < 2) lag = 2;
    if (lag > max_lag) lag = (long)max_lag;
    out[t] = buf.re[lag] / std::max(buf.re[0], kEps);
  }
}

}  // extern "C"
