// K5: the LMS and STA tracking equalizers for Hopper (sm_90a): a padded
// batch of frames, every OFDM symbol of each, in one launch.
//
// Replaces no TPU kernel: the JAX package runs the trackers as a lax.scan
// that XLA compiles (phy/equalizer.py), and the port ran them as a Python
// loop of about 35 small torch ops a symbol, which a stage-B CUDA graph
// unrolled into thousands of nodes. The kernel computes what that loop
// computes (phy/equalizer.py, whose CPU path it still is), per frame:
//
//   for each symbol s, with h the carried estimate on the 52 used carriers
//     c      = sum over the 4 pilots of y[p] conj(h[p]) pol[s] pattern[p]
//     yc     = y conj(c / max(|c|, 1e-12))            (common pilot phase)
//     eq     = yc / h  (h replaced by 1e-9 where |h| <= 1e-9)
//     x      = nearest constellation point of eq (ties to the first
//              point, mapping._nearest), BPSK for a leading SIGNAL symbol,
//              eq / max(|eq|, 1e-9) without a constellation; the pilots
//              pol[s] pattern[p]
//     csi    = |h|^2 on the 48 data carriers, before the update
//     LMS:  h += mu (yc - h x) conj(x) / max(|x|^2, 1e-9)
//     STA:  hi = yc conj(x) / max(|x|^2, 1e-9)
//           nb = (hi[k-1] + hi[k+1] + hi[k-2] + hi[k+2] + hi[k]) / 5,
//                wrapping over the 52 used carriers (torch.roll)
//           h  = (1 - alpha) h + alpha ((1 - beta) hi + beta nb)
//
// Bound: each symbol reads its 52 used bins (416 bytes) and writes 48
// equalized symbols and 48 weights (576 bytes), about 4 000 float32
// operations (ops/track_eq.py K5_OPS_PER_STEP): the card's bound is the
// bytes, well under a microsecond for a whole bucket. The recursion is
// serial in the symbols, so the kernel is latency bound by the chain of
// dependent steps of one frame (the pilot phase needs the estimate that
// the previous symbol's update produced).
//
// Design, for that chain:
// - One warp a frame; lane l < 26 owns used carriers 2 l and 2 l + 1, and
//   keeps their estimate in registers for the whole frame.
// - Symbol s + 1's two bins are loaded into registers before symbol s is
//   computed, so the load's latency is off the chain.
// - The 4 pilots (used carriers 5, 19, 32, 46: lanes 2, 9, 16, 23) form
//   their products, and every lane reads all four with 8 independent
//   shuffles and sums them in one fixed order, so every lane holds the
//   same phase without a reduction tree.
// - STA's +-2-carrier average takes both carriers of the lanes left and
//   right (wrapping from lane 25 to lane 0): 8 independent shuffles.
// - The update (LMS or STA) is a template parameter, the decision a
//   branch that is uniform over the launch.
// - The library is built with --fmad=false; complex division is Smith's,
//   as c10::complex divides, so the kernel rounds near the torch ops it
//   replaces (within float32 tolerances, not bit for bit).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 26;          // lanes holding carriers
constexpr int kWarps = 4;           // frames a block
constexpr int kMaxLevels = 8;

enum Algo { kLms = 1, kSta = 3 };   // config.ChannelEstimator values
enum Decide { kProxy = 0, kBpsk = 1, kQam = 2 };

struct TrackArgs {
  const float2* spectra;   // (rows, S, 64) shifted spectra
  const float2* h0;        // (rows, 52) LS estimate
  const float* pol;        // (S,) pilot polarity of each symbol
  float2* eq;              // (rows, S, 48)
  float* csi;              // (rows, S, 48)
  int64_t rows;
  int symbols;
  int decide;              // Decide
  int sig_first;           // symbol 0 is SIGNAL, decided as BPSK
  int levels;              // per-axis levels (kQam), 2 (kBpsk)
  float level[kMaxLevels]; // per-axis amplitudes in point-index order
  float bpsk[2];           // BPSK points (real), index order
  float mu, alpha, beta;
};

__device__ __forceinline__ int bin_of(int u) { return u < 26 ? u + 6 : u + 7; }

// pilot pattern entry of used carrier u (0 where u is no pilot)
__device__ __forceinline__ float pilot_pattern(int u) {
  return u == 5 || u == 19 || u == 32 ? 1.0f : (u == 46 ? -1.0f : 0.0f);
}

__device__ __forceinline__ int data_index(int u) {
  return u - (u > 5) - (u > 19) - (u > 32) - (u > 46);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {   // a conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// a / b by Smith's method, as c10::complex's operator/
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float ac = fabsf(b.x), ad = fabsf(b.y);
  if (ac >= ad) {
    const float rat = b.y / b.x, scl = 1.0f / (b.x + b.y * rat);
    return make_float2((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const float rat = b.x / b.y, scl = 1.0f / (b.y + b.x * rat);
  return make_float2((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

// a complex divided by a real: torch promotes it to (r, 0)
__device__ __forceinline__ float2 cdiv_real(float2 a, float r) {
  const float scl = 1.0f / r;
  return make_float2(a.x * scl, a.y * scl);
}

__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

// nearest level of v on one axis, ties to the first index
__device__ __forceinline__ float nearest_level(float v, const float* level, int n) {
  float best = level[0], bd = (v - level[0]) * (v - level[0]);
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < n) {
      const float d = (v - level[i]) * (v - level[i]);
      if (d < bd) {
        bd = d;
        best = level[i];
      }
    }
  }
  return best;
}

__device__ __forceinline__ float2 decide(float2 e, const TrackArgs& a, bool bpsk) {
  if (bpsk) return make_float2(nearest_level(e.x, a.bpsk, 2), 0.0f);
  if (a.decide == kQam)
    return make_float2(nearest_level(e.x, a.level, a.levels),
                       nearest_level(e.y, a.level, a.levels));
  return cdiv_real(e, fmaxf(hypotf(e.x, e.y), 1e-9f));
}

template <int kAlgo>
__global__ void __launch_bounds__(32 * kWarps) track_eq_kernel(TrackArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;                         // a whole warp leaves together
  const bool live = lane < kLanes;
  const int u0 = 2 * lane, u1 = 2 * lane + 1;
  const int left = (lane + kLanes - 1) % kLanes, right = (lane + 1) % kLanes;
  const float pat0 = live ? pilot_pattern(u0) : 0.0f, pat1 = live ? pilot_pattern(u1) : 0.0f;
  const int d0 = data_index(u0), d1 = data_index(u1);
  const float2 zero = make_float2(0.0f, 0.0f);

  const float2* spec = a.spectra + row * a.symbols * 64;
  float2 h0 = live ? a.h0[row * 52 + u0] : zero;
  float2 h1 = live ? a.h0[row * 52 + u1] : zero;
  float2 y0 = live ? spec[bin_of(u0)] : zero;
  float2 y1 = live ? spec[bin_of(u1)] : zero;
  float pol = a.pol[0];
  float2* eq = a.eq + row * a.symbols * 48;
  float* csi = a.csi + row * a.symbols * 48;
  const float one_beta = 1.0f - a.beta, one_alpha = 1.0f - a.alpha;

  for (int s = 0; s < a.symbols; ++s) {
    // the next symbol's bins and polarity, in flight while this one is
    // computed
    float2 n0 = zero, n1 = zero;
    float next_pol = 0.0f;
    if (s + 1 < a.symbols) {
      next_pol = a.pol[s + 1];
      if (live) {
        n0 = spec[(s + 1) * 64 + bin_of(u0)];
        n1 = spec[(s + 1) * 64 + bin_of(u1)];
      }
    }

    // common pilot phase
    float2 pp = zero;
    if (pat0 != 0.0f) pp = cscale(cmul_conj(y0, h0), pol * pat0);
    if (pat1 != 0.0f) pp = cscale(cmul_conj(y1, h1), pol * pat1);
    const float2 p2 = shfl(pp, 2), p9 = shfl(pp, 9), p16 = shfl(pp, 16), p23 = shfl(pp, 23);
    const float2 c = cadd(cadd(cadd(p2, p9), p16), p23);
    const float2 ph = cdiv_real(c, fmaxf(hypotf(c.x, c.y), 1e-12f));
    const float2 yc0 = cmul_conj(y0, ph), yc1 = cmul_conj(y1, ph);

    // equalize, weigh, decide
    const float m0 = hypotf(h0.x, h0.y), m1 = hypotf(h1.x, h1.y);
    const float2 e0 = cdiv(yc0, m0 > 1e-9f ? h0 : make_float2(1e-9f, 0.0f));
    const float2 e1 = cdiv(yc1, m1 > 1e-9f ? h1 : make_float2(1e-9f, 0.0f));
    if (live) {
      if (pat0 == 0.0f) {
        eq[s * 48 + d0] = e0;
        csi[s * 48 + d0] = m0 * m0;
      }
      if (pat1 == 0.0f) {
        eq[s * 48 + d1] = e1;
        csi[s * 48 + d1] = m1 * m1;
      }
    }
    const bool bpsk = a.decide == kBpsk || (a.sig_first && s == 0);
    const float2 x0 = pat0 != 0.0f ? make_float2(pol * pat0, 0.0f) : decide(e0, a, bpsk);
    const float2 x1 = pat1 != 0.0f ? make_float2(pol * pat1, 0.0f) : decide(e1, a, bpsk);
    const float q0 = hypotf(x0.x, x0.y), q1 = hypotf(x1.x, x1.y);
    const float nrm0 = fmaxf(q0 * q0, 1e-9f), nrm1 = fmaxf(q1 * q1, 1e-9f);

    if (kAlgo == kLms) {
      const float2 r0 = make_float2(yc0.x - cmul(h0, x0).x, yc0.y - cmul(h0, x0).y);
      const float2 r1 = make_float2(yc1.x - cmul(h1, x1).x, yc1.y - cmul(h1, x1).y);
      h0 = cadd(h0, cdiv_real(cmul_conj(cscale(r0, a.mu), x0), nrm0));
      h1 = cadd(h1, cdiv_real(cmul_conj(cscale(r1, a.mu), x1), nrm1));
    } else {
      const float2 i0 = cdiv_real(cmul_conj(yc0, x0), nrm0);
      const float2 i1 = cdiv_real(cmul_conj(yc1, x1), nrm1);
      const float2 l0 = shfl(i0, left), l1 = shfl(i1, left);
      const float2 r0 = shfl(i0, right), r1 = shfl(i1, right);
      // torch.roll order: k-1, k+1, k-2, k+2, then k
      const float2 nb0 = cdiv_real(cadd(cadd(cadd(cadd(l1, i1), l0), r0), i0), 5.0f);
      const float2 nb1 = cdiv_real(cadd(cadd(cadd(cadd(i0, r0), l1), r1), i1), 5.0f);
      const float2 f0 = cadd(cscale(i0, one_beta), cscale(nb0, a.beta));
      const float2 f1 = cadd(cscale(i1, one_beta), cscale(nb1, a.beta));
      h0 = cadd(cscale(h0, one_alpha), cscale(f0, a.alpha));
      h1 = cadd(cscale(h1, one_alpha), cscale(f1, a.alpha));
    }
    y0 = n0;
    y1 = n1;
    pol = next_pol;
  }
}

}  // namespace

extern "C" int gwt_track_eq_max_levels() { return kMaxLevels; }

// spectra (rows, symbols, 64) complex64, h0 (rows, 52) complex64, pol
// (symbols,) float32, eq (rows, symbols, 48) complex64, csi (rows,
// symbols, 48) float32: device pointers, contiguous. algo 1 (LMS) or 3
// (STA); decision 0 (unit-modulus proxy), 1 (BPSK) or 2 (square QAM with
// `levels` per-axis amplitudes `level`); bpsk the two BPSK points. One
// launch. Returns cudaGetLastError().
extern "C" int gwt_track_eq(const void* spectra, const void* h0, const void* pol, void* eq,
                            void* csi, int64_t rows, int symbols, int algo, int decision,
                            int sig_first, int levels, const float* level, const float* bpsk,
                            float mu, float alpha, float beta, void* stream) {
  if (rows <= 0 || symbols <= 0) return 0;
  if ((algo != kLms && algo != kSta) || decision < kProxy || decision > kQam
      || (decision == kQam && (levels < 2 || levels > kMaxLevels)))
    return static_cast<int>(cudaErrorInvalidValue);
  TrackArgs a;
  a.spectra = static_cast<const float2*>(spectra);
  a.h0 = static_cast<const float2*>(h0);
  a.pol = static_cast<const float*>(pol);
  a.eq = static_cast<float2*>(eq);
  a.csi = static_cast<float*>(csi);
  a.rows = rows;
  a.symbols = symbols;
  a.decide = decision;
  a.sig_first = sig_first;
  a.levels = decision == kQam ? levels : 2;
  for (int i = 0; i < kMaxLevels; ++i)
    a.level[i] = decision == kQam && i < levels ? level[i] : 0.0f;
  a.bpsk[0] = bpsk[0];
  a.bpsk[1] = bpsk[1];
  a.mu = mu;
  a.alpha = alpha;
  a.beta = beta;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (algo == kLms)
    track_eq_kernel<kLms><<<blocks, 32 * kWarps, 0, st>>>(a);
  else
    track_eq_kernel<kSta><<<blocks, 32 * kWarps, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
