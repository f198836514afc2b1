// Fused 802.11a STF detector statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_sync.py (_kernel, reached from
// _stats_1d through pl.pallas_call) of the JAX package. For every sample
// of every row:
//
//     m[n] = x[n] * conj(x[n-16])
//     a[n] = sum_{k=n-47..n} m[k]          (moving_average_cc(48))
//     p[n] = sum_{k=n-63..n} |x[k]|^2      (moving_average_ff(64))
//     c[n] = |a[n]| / max(p[n], 1e-12)
//
// with zero history before each row's start (phy/sync.py sync_stats).
//
// Bound: memory. The function reads 8 bytes (complex64) and writes 16
// bytes (a complex64, p and c float32) per sample; at the executor's step
// (64 rows x 263 840 samples) that is 405 MB, 0.121 ms at the H100's
// 3.35 TB/s. The arithmetic (about 160 flops a sample) is far below the
// card's float32 rate.
//
// Design: one launch for the whole (rows, N) batch (the Pallas wrapper
// loops over rows in Python). One block per (tile of 1024 outputs, row):
// the tile plus 63 samples of history is staged in shared memory, m and
// |x|^2 are formed there once, and each thread then sums its 48- and
// 64-term windows directly. Direct sums keep every window exact to a few
// ulps of its own energy (no cumsum cancellation) and make a silent
// window exactly 0, so padding never produces false sync edges. Each
// output costs 112 shared-memory loads: that, not device memory, bounds
// this first version (a later version can share partial sums across
// neighbouring outputs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // outputs per block
constexpr int kThreads = 256;
constexpr int kLag = 16;             // STF period
constexpr int kWinA = 48;            // autocorrelation window
constexpr int kWinP = 64;            // power window
constexpr int kHist = kWinP - 1;     // = (kWinA - 1) + kLag: history samples

__global__ void __launch_bounds__(kThreads)
sync_stats_kernel(const float2* __restrict__ x, float2* __restrict__ a,
                  float* __restrict__ p, float* __restrict__ c,
                  int64_t rows, int64_t n) {
  __shared__ float2 xs[kTile + kHist];       // x[n0-63 .. n0+kTile-1]
  __shared__ float2 ms[kTile + kWinA - 1];   // m[n0-47 .. n0+kTile-1]
  __shared__ float es[kTile + kWinP - 1];    // |x|^2[n0-63 .. n0+kTile-1]
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float2* xr = x + row * n;
    __syncthreads();                         // previous row's tile consumed
    for (int i = threadIdx.x; i < kTile + kHist; i += kThreads) {
      const int64_t k = n0 - kHist + i;
      xs[i] = (k >= 0 && k < n) ? xr[k] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    // ms[i] is m at sample n0-47+i: x at xs[i+16] times conj(x at xs[i])
    for (int i = threadIdx.x; i < kTile + kWinA - 1; i += kThreads) {
      const float2 u = xs[i + kLag], v = xs[i];
      ms[i] = make_float2(u.x * v.x + u.y * v.y, u.y * v.x - u.x * v.y);
    }
    for (int i = threadIdx.x; i < kTile + kWinP - 1; i += kThreads) {
      const float2 u = xs[i];
      es[i] = u.x * u.x + u.y * u.y;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int64_t k = n0 + j;
      if (k >= n) break;
      float ar = 0.f, ai = 0.f, pp = 0.f;
#pragma unroll 8
      for (int t = 0; t < kWinA; ++t) {
        const float2 v = ms[j + t];
        ar += v.x;
        ai += v.y;
      }
#pragma unroll 8
      for (int t = 0; t < kWinP; ++t) pp += es[j + t];
      const int64_t o = row * n + k;
      a[o] = make_float2(ar, ai);
      p[o] = pp;
      c[o] = sqrtf(ar * ar + ai * ai) / fmaxf(pp, 1e-12f);
    }
  }
}

}  // namespace

// x: (rows, n) complex64 as float2; a: (rows, n) complex64; p, c: (rows, n)
// float32. All device pointers, contiguous. Returns cudaGetLastError().
extern "C" int gwt_sync_stats(const void* x, void* a, void* p, void* c,
                              int64_t rows, int64_t n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  sync_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(a),
      static_cast<float*>(p), static_cast<float*>(c), rows, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
