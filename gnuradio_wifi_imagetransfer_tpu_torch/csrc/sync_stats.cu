// 802.11a STF detector for Hopper (sm_90a): dense statistics and a fused
// detector.
//
// Replaces the TPU kernel ops/pallas_sync.py (_kernel, reached from
// _stats_1d through pl.pallas_call at line 104) of the JAX package. For
// every sample of every row:
//
//     m[n] = x[n] * conj(x[n-16])
//     a[n] = sum_{k=n-47..n} m[k]          (moving_average_cc(48))
//     p[n] = sum_{k=n-63..n} |x[k]|^2      (moving_average_ff(64))
//     c[n] = |a[n]| / max(p[n], 1e-12)
//
// with zero history before each row's start (phy/sync.py sync_stats).
//
// Two entry points share one window routine (window_sums):
//
//   gwt_sync_stats   dense a, p and c for every sample (ops.sync_stats).
//     Bound: memory. 8 bytes in and 16 bytes out a sample; at the
//     executor's step (64 rows x 263 840 samples) 405 MB, 0.121 ms at the
//     H100's 3.35 TB/s.
//   gwt_sync_detect  the detection of phy/sync.py detect in two launches,
//     writing no dense statistic: the first pass forms c per tile, the
//     plateau and rising-edge flags, and keeps each tile's first K edges
//     with a[trigger] and c[trigger]; the second, one warp a row, merges
//     the tiles in order into the first K edges of the row.
//     Bound: memory. 8 bytes read a sample, 0.040 ms at the step's shape;
//     the operations, about 43 float32 a sample in the addition-only form
//     below (m 6, |x|^2 3, the window sums 28, c 5, the threshold 1), take
//     0.011 ms at 67 TFLOP/s.
//
// Design. One block per (tile, row), rows looped past 65 535: 1024
// outputs a dense tile; 1024 values of c a detector tile, of which the
// first 32 are look-back for the plateau, so a detector tile owns 992
// samples. The tile and its history are staged in shared memory with
// 16-byte loads; m and |x|^2 are formed there once. Each thread then
// computes R = 8 consecutive outputs (16 was slower on the H100: half
// the threads a block and twice the registers; PERF.md): it sums once
// the core of samples that all R windows share, extends it to the right
// with a forward running addition and covers the samples on the left
// with a suffix sum. No term
// is ever subtracted, so a window over silence is exactly 0 (a running sum
// that subtracts leaves residue there, and that residue produced false
// sync edges: phy/sync.py:95-105 of the JAX package), and each window sum
// is off by a few ulps of its own energy at most. That takes about
// 2 (47 + R) / R + (63 + R) / R shared-memory loads an output instead of
// the 112 of direct sums. The shared arrays hold one pad word every R
// words, so the threads' strided reads fall in distinct banks. Dense
// outputs go back through shared memory so the stores are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // outputs per block
constexpr int kLag = 16;             // STF period
constexpr int kWinA = 48;            // autocorrelation window
constexpr int kWinP = 64;            // power window
constexpr int R = 8;                 // outputs a thread
constexpr int kStatsPre = 64;        // staged history of the dense pass (>= 63)
constexpr int kLookBack = 32;        // largest min_plateau of the detector
constexpr int kDetectTile = kTile - kLookBack;   // edges a detector block searches
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pad(int i) { return i + i / R; }     // i >= 0

// floor(c / R) for a compile-time c of either sign, added to c
__device__ constexpr int pad_off(int c) {
  return c + (c >= 0 ? c / R : -((-c + R - 1) / R));
}

// Stage x[s0 .. s0 + cnt) of one row into xs, zeros outside [0, n).
// s0 and cnt are even; with vec, the row starts 16-byte aligned.
__device__ __forceinline__ void stage(float2* xs, const float2* __restrict__ xr,
                                      int64_t s0, int cnt, int64_t n, bool vec) {
  for (int q = threadIdx.x; q < cnt / 2; q += blockDim.x) {
    const int64_t k = s0 + 2 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && k >= 0 && k + 1 < n) {
      v = __ldg(reinterpret_cast<const float4*>(xr + k));
    } else {
      if (k >= 0 && k < n) { const float2 u = xr[k]; v.x = u.x; v.y = u.y; }
      if (k + 1 >= 0 && k + 1 < n) { const float2 u = xr[k + 1]; v.z = u.x; v.w = u.y; }
    }
    reinterpret_cast<float4*>(xs)[q] = v;
  }
}

// m = x * conj(x[-16]) (real and imaginary part) and |x|^2 of the staged
// samples, stored at padded indices. m is 0 where x[-16] is not staged.
__device__ __forceinline__ void form(const float2* xs, int cnt, float* mr, float* mi,
                                     float* e) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float2 u = xs[i];
    float re = 0.f, im = 0.f;
    if (i >= kLag) {
      const float2 v = xs[i - kLag];
      re = u.x * v.x + u.y * v.y;
      im = u.y * v.x - u.x * v.y;
    }
    mr[pad(i)] = re;
    mi[pad(i)] = im;
    e[pad(i)] = u.x * u.x + u.y * u.y;
  }
}

// a (ar, ai) and p of the R outputs at staged indices i0 .. i0 + R - 1 (i0
// a multiple of R and >= 63 + 16), by additions only (see the note above).
__device__ __forceinline__ void window_sums(const float* mr, const float* mi, const float* e,
                                            int i0, float (&ar)[R], float (&ai)[R],
                                            float (&pp)[R]) {
  const int base = pad(i0);
  const float* br = mr + base;
  const float* bi = mi + base;
  const float* be = e + base;
  // the cores, offsets relative to i0: R-48 .. 0 and R-64 .. 0
  float cr = 0.f, ci = 0.f, cp = 0.f;
#pragma unroll
  for (int c = R - kWinA; c <= 0; ++c) {
    cr += br[pad_off(c)];
    ci += bi[pad_off(c)];
  }
#pragma unroll
  for (int c = R - kWinP; c <= 0; ++c) cp += be[pad_off(c)];
  // output r also takes r-47 .. R-49 (resp. r-63 .. R-65) on the left:
  // suffix sums, built from r = R-1 (empty) down
  float sr[R], si[R], sp[R];
  sr[R - 1] = 0.f;
  si[R - 1] = 0.f;
  sp[R - 1] = 0.f;
#pragma unroll
  for (int r = R - 2; r >= 0; --r) {
    sr[r] = br[pad_off(r - (kWinA - 1))] + sr[r + 1];
    si[r] = bi[pad_off(r - (kWinA - 1))] + si[r + 1];
    sp[r] = be[pad_off(r - (kWinP - 1))] + sp[r + 1];
  }
  // ... and 1 .. r on the right: a running addition
  float er = 0.f, ei = 0.f, ep = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r > 0) {
      er += br[pad_off(r)];
      ei += bi[pad_off(r)];
      ep += be[pad_off(r)];
    }
    ar[r] = (sr[r] + cr) + er;
    ai[r] = (si[r] + ci) + ei;
    pp[r] = (sp[r] + cp) + ep;
  }
}

__device__ __forceinline__ float ratio(float ar, float ai, float pp) {
  return sqrtf(ar * ar + ai * ai) / fmaxf(pp, 1e-12f);
}

__global__ void __launch_bounds__(kTile / R)
sync_stats_kernel(const float2* __restrict__ x, float2* __restrict__ a,
                  float* __restrict__ p, float* __restrict__ c, int64_t rows, int64_t n,
                  bool vec) {
  constexpr int kStaged = kStatsPre + kTile;
  constexpr int kXs = kStaged > pad(kTile) ? kStaged : pad(kTile);
  __shared__ __align__(16) float2 xs[kXs];          // staged x, then the a outputs
  __shared__ float mr[pad(kStaged)], mi[pad(kStaged)], e[pad(kStaged)];
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int t = threadIdx.x;

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    __syncthreads();                         // previous row's outputs copied out
    stage(xs, x + row * n, n0 - kStatsPre, kStaged, n, vec);
    __syncthreads();
    form(xs, kStaged, mr, mi, e);
    __syncthreads();
    float ar[R], ai[R], pp[R];
    window_sums(mr, mi, e, kStatsPre + t * R, ar, ai, pp);
    __syncthreads();                         // every thread has read mr, mi, e
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = pad(t * R + r);
      xs[j] = make_float2(ar[r], ai[r]);
      mr[j] = pp[r];
      mi[j] = ratio(ar[r], ai[r], pp[r]);
    }
    __syncthreads();
    for (int j = t; j < kTile; j += blockDim.x) {
      const int64_t k = n0 + j;
      if (k >= n) break;
      const int64_t o = row * n + k;
      a[o] = xs[pad(j)];
      p[o] = mr[pad(j)];
      c[o] = mi[pad(j)];
    }
  }
}

// Scratch of the detector's first pass, per (row, tile): the count of
// edges kept (at most K) and, for each, the edge index, a and c at its
// trigger; per row, c at the trigger of the slots left invalid.
struct DetectScratch {
  float2* ea;       // (rows, tiles, K)
  float* ec;        // (rows, tiles, K)
  int* eidx;        // (rows, tiles, K)
  int* cnt;         // (rows, tiles)
  float* tail_c;    // (rows,)
};

__host__ __device__ inline DetectScratch carve(void* base, int64_t rows, int64_t tiles,
                                               int64_t k) {
  const int64_t m = rows * tiles * k;
  char* b = static_cast<char*>(base);
  DetectScratch s;
  s.ea = reinterpret_cast<float2*>(b);
  s.ec = reinterpret_cast<float*>(b + 8 * m);
  s.eidx = reinterpret_cast<int*>(b + 12 * m);
  s.cnt = reinterpret_cast<int*>(b + 16 * m);
  s.tail_c = reinterpret_cast<float*>(b + 16 * m + 4 * rows * tiles);
  return s;
}

// First pass of the detector. A block computes c (and a) for the 1024
// samples n0-32 .. n0+991 with the same routine as the dense pass, packs
// "c >= threshold" into 32-bit words, and one warp forms the plateau and
// rising-edge words of the tile's 992 samples n0 .. n0+991 by shifts and
// ANDs (the 32 samples of look-back cover min_plateau <= 32), masks them
// to the search range and keeps the first K edges with prefix popcounts.
__global__ void __launch_bounds__(kTile / R)
sync_detect_kernel(const float2* __restrict__ x, int64_t rows, int64_t n, float thr, int mp,
                   int64_t lo, int64_t hi, int k_max, DetectScratch s, bool vec) {
  constexpr int kStaged = kStatsPre + kTile;          // x from n0-96
  __shared__ __align__(16) float2 xs[kStaged];
  __shared__ float mr[pad(kStaged)], mi[pad(kStaged)], e[pad(kStaged)];
  __shared__ unsigned aw[kTile / 32];                 // above, bit j: sample n0-32+j
  static_assert(R == 8, "a thread packs its R threshold flags into one byte");
  const int64_t tile = blockIdx.x, tiles = gridDim.x;
  const int64_t n0 = tile * kDetectTile;
  const int64_t c0 = n0 - kLookBack;                  // sample of output 0
  const int t = threadIdx.x, lane = t & 31;

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    __syncthreads();                                    // previous row's edges taken
    stage(xs, x + row * n, c0 - kStatsPre, kStaged, n, vec);
    __syncthreads();
    form(xs, kStaged, mr, mi, e);
    __syncthreads();
    float ar[R], ai[R], pp[R];
    window_sums(mr, mi, e, kStatsPre + t * R, ar, ai, pp);
    __syncthreads();                                    // every thread has read mr, mi, e
    unsigned bits = 0;                                  // c is 0 before the row's start
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = pad(t * R + r);
      const float c = ratio(ar[r], ai[r], pp[r]);
      mr[j] = ar[r];
      mi[j] = ai[r];
      e[j] = c;
      bits |= static_cast<unsigned>(c >= thr) << r;
    }
    reinterpret_cast<uint8_t*>(aw)[t] = static_cast<uint8_t>(bits);
    const int64_t t_end = n > mp ? n - mp : 0;          // trigger of an invalid slot
    __syncthreads();
    if (t == 0 && t_end >= n0 && t_end < n0 + kDetectTile)
      s.tail_c[row] = e[pad(static_cast<int>(t_end - c0))];

    // lane i >= 1 owns samples n0 + 32 (i-1) .. + 31: above words i-1 and i
    if (t < 32) {
      unsigned w = 0;
      if (lane > 0) {
        const uint64_t both = (static_cast<uint64_t>(aw[lane]) << 32) | aw[lane - 1];
        uint64_t cur = ~0ull, prev = ~0ull;             // plateau at k and at k-1
        for (int d = 0; d <= mp; ++d) {
          const unsigned sh = static_cast<unsigned>(both >> (32 - d));
          if (d < mp) cur &= sh;
          if (d > 0) prev &= sh;
        }
        const int64_t base = n0 + 32 * (lane - 1);
        const int64_t b_lo = lo - base < 0 ? 0 : (lo - base > 32 ? 32 : lo - base);
        const int64_t b_hi = hi - base < 0 ? 0 : (hi - base > 32 ? 32 : hi - base);
        const uint64_t range = ((1ull << b_hi) - 1) & ~((1ull << b_lo) - 1);
        w = static_cast<unsigned>(cur & ~prev & range);
      }
      const int c = __popc(w);
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int64_t slot0 = (row * tiles + tile) * k_max;
      for (int rank = incl - c; w != 0 && rank < k_max; ++rank) {
        const int b = __ffs(w) - 1;
        w &= w - 1;
        const int64_t edge = n0 + 32 * (lane - 1) + b;
        const int64_t trig = edge - (mp - 1) > 0 ? edge - (mp - 1) : 0;
        const int j = pad(static_cast<int>(trig - c0));
        s.eidx[slot0 + rank] = static_cast<int>(edge);
        s.ea[slot0 + rank] = make_float2(mr[j], mi[j]);
        s.ec[slot0 + rank] = e[j];
      }
      if (lane == 0) s.cnt[row * tiles + tile] = total < k_max ? total : k_max;
    }
  }
}

// One warp a row: the tiles' edges in tile order, the first K kept.
__global__ void __launch_bounds__(32)
sync_merge_kernel(DetectScratch s, int64_t tiles, int k_max, int mp, int* __restrict__ starts,
                  uint8_t* __restrict__ valid, float2* __restrict__ a_out,
                  float* __restrict__ ratio_out) {
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t out0 = row * k_max;
  int run = 0;
  for (int64_t t0 = 0; t0 < tiles && run < k_max; t0 += 32) {
    const int64_t tile = t0 + lane;
    const int c = tile < tiles ? s.cnt[row * tiles + tile] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    for (int j = 0; j < c; ++j) {
      const int rank = run + incl - c + j;
      if (rank >= k_max) break;
      const int64_t src = (row * tiles + tile) * k_max + j;
      const int edge = s.eidx[src];
      starts[out0 + rank] = edge - (mp - 1) > 0 ? edge - (mp - 1) : 0;
      valid[out0 + rank] = 1;
      a_out[out0 + rank] = s.ea[src];
      ratio_out[out0 + rank] = s.ec[src];
    }
    run += total;
  }
  for (int rank = (run < k_max ? run : k_max) + lane; rank < k_max; rank += 32) {
    starts[out0 + rank] = 0;
    valid[out0 + rank] = 0;
    a_out[out0 + rank] = make_float2(0.f, 0.f);
    ratio_out[out0 + rank] = s.tail_c[row];
  }
}

bool aligned16(const void* p, int64_t n) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && n % 2 == 0;
}

int launch_stats(const void* x, void* a, void* p, void* c, int64_t rows, int64_t n,
                 cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  sync_stats_kernel<<<grid, kTile / R, 0, stream>>>(
      static_cast<const float2*>(x), static_cast<float2*>(a), static_cast<float*>(p),
      static_cast<float*>(c), rows, n, aligned16(x, n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, n) complex64 as float2; a: (rows, n) complex64; p, c: (rows, n)
// float32. All device pointers, contiguous. Returns cudaGetLastError().
extern "C" int gwt_sync_stats(const void* x, void* a, void* p, void* c,
                              int64_t rows, int64_t n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return launch_stats(x, a, p, c, rows, n, static_cast<cudaStream_t>(stream));
}

// Bytes of the detector's scratch for (rows, n) and K candidates a row.
extern "C" int64_t gwt_sync_detect_scratch_bytes(int64_t rows, int64_t n, int64_t k) {
  const int64_t tiles = (n + kDetectTile - 1) / kDetectTile;
  return 16 * rows * tiles * k + 4 * rows * tiles + 4 * rows;
}

// x: (rows, n) complex64; scratch: gwt_sync_detect_scratch_bytes bytes;
// outputs (rows, K): starts int32, valid uint8, a complex64, ratio float32.
// Edges are searched in [lo, hi) with 0 <= lo, hi <= n; 1 <= mp <= 32.
// Two launches on the stream. Returns cudaGetLastError().
extern "C" int gwt_sync_detect(const void* x, int64_t rows, int64_t n, float thr, int mp,
                               int64_t lo, int64_t hi, int k, void* scratch, void* starts,
                               void* valid, void* a_out, void* ratio_out, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0) return 0;
  if (mp < 1 || mp > kLookBack) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kDetectTile - 1) / kDetectTile;
  const DetectScratch s = carve(scratch, rows, tiles, k);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  sync_detect_kernel<<<grid, kTile / R, 0, st>>>(
      static_cast<const float2*>(x), rows, n, thr, mp, lo, hi, k, s, aligned16(x, n));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sync_merge_kernel<<<static_cast<unsigned>(rows), 32, 0, st>>>(
      s, tiles, k, mp, static_cast<int*>(starts), static_cast<uint8_t*>(valid),
      static_cast<float2*>(a_out), static_cast<float*>(ratio_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
