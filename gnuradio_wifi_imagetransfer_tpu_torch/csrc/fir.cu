// Causal FIR filter (K3) and polyphase rational resampler (K4) for Hopper
// (sm_90a).
//
// Both replace TPU kernels of the JAX package's ops/pallas_fir.py, which
// cast the convolutions as banded matmuls for the TPU's matrix unit. Here
// they are stencils. Samples are float32 (real) or complex64 read as
// interleaved float2; taps are real float32. One launch covers all rows.
// The multiply-adds are spelled __fmaf_rn: the library is built with
// --fmad=false, which would otherwise split each into two instructions.
//
// K3, gwt_fir: y[n] = sum_{t<K} h[t] x[n-t], zeros before each row's start.
//   Replaces _fir_kernel, reached from _fir_real through pl.pallas_call
//   (two banded 128x128 matmuls a 128-sample tile, K <= 129).
//   Bound: device memory or float32 rate. A complex sample moves 16 bytes
//   (read once, written once) and costs 4K flops: at K = 65 the two are
//   about balanced on an H100 (3.35 TB/s, 67 TFLOP/s), above that the
//   arithmetic bounds it.
//   Design: a block takes a tile of 1024 outputs of one row. Taps go
//   through shared memory in chunks of at most 256, each chunk with the
//   window of samples it needs (the tile plus the chunk's history, zeros
//   before the row start), so any K fits. A thread owns 8 consecutive
//   outputs and slides a register window over the staged samples: one
//   shared-memory load of a sample and one of a tap feed 8 multiply-adds.
//   The window is stored interleaved by 8 so those loads are free of bank
//   conflicts. Taps are summed in order t = 0..K-1, as the plain version
//   does.
//
// K4, gwt_polyphase_resample: rational L/M resampling in the direct form
//   of the oracle (ops/resampler.py polyphase_resample of the JAX package).
//   For output j, with c = (n_taps-1)/2:
//       t0 = (j*M + c) mod L,  base = (j*M + c - t0) / L,
//       y[j] = sum_{k < ceil(n_taps/L)} h[t0 + k*L] x[base - k]
//   over the terms with t0 + k*L < n_taps and 0 <= base - k < N.
//   Replaces _resample_kernel, reached from _resample_real through
//   pl.pallas_call (static (L, M+2, 128, 128) tables, L <= 64, M <= 96).
//   Index arithmetic is 64-bit: j*M passes 2^31 after 85 900 outputs at
//   L/M = 25001/25000 (40 ppm), where the JAX path's int32 index wraps.
//   Bound: device memory, 8 (N + n_out) bytes a complex row; the taps
//   (L * 12 of them, 1.2 MB at 25001/25000) stay in L2 and are read
//   through __ldg, as are the samples, which neighbouring outputs share.
//   Design: one thread per output, consecutive outputs on consecutive
//   threads, the rows of one block looped over with the index arithmetic
//   done once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ float fma_s(float h, float v, float acc) {
  return __fmaf_rn(h, v, acc);
}
__device__ __forceinline__ float2 fma_s(float h, float2 v, float2 acc) {
  return make_float2(__fmaf_rn(h, v.x, acc.x), __fmaf_rn(h, v.y, acc.y));
}

// ---------------------------------------------------------------- K3: FIR

constexpr int kR = 8;                          // consecutive outputs a thread
constexpr int kFirThreads = 128;
constexpr int kFirTile = kR * kFirThreads;     // outputs a block
constexpr int kChunk = 256;                    // taps staged a pass (multiple of kR)
// row pitch of the interleaved window: window sample i sits at
// xs[(i % kR) * kPitch + i / kR]; the +1 spreads the staging stores
constexpr int kPitch = (kFirTile + kChunk) / kR + 1;

template <typename T>
__global__ void __launch_bounds__(kFirThreads)
fir_kernel(const T* __restrict__ x, const float* __restrict__ h, T* __restrict__ y,
           int64_t rows, int64_t n, int64_t k) {
  __shared__ T xs[kR * kPitch];
  __shared__ float hs[kChunk];
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kFirTile;
  const int j0 = threadIdx.x * kR;             // first of this thread's outputs

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * n;
    T acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = zero<T>();

    for (int64_t c0 = 0; c0 < k; c0 += kChunk) {
      const int cv = static_cast<int>(k - c0 < kChunk ? k - c0 : kChunk);
      const int p = (cv + kR - 1) / kR * kR;   // history staged, taps padded to it
      __syncthreads();                         // previous chunk consumed
      // window sample i is x[n0 - c0 - p + i], i < kFirTile + p
      for (int i = threadIdx.x; i < kFirTile + p; i += kFirThreads) {
        const int64_t s = n0 - c0 - p + i;
        xs[(i % kR) * kPitch + i / kR] = (s >= 0 && s < n) ? xr[s] : zero<T>();
      }
      for (int i = threadIdx.x; i < p; i += kFirThreads)
        hs[i] = i < cv ? h[c0 + i] : 0.f;
      __syncthreads();

      // output j0 + r with chunk tap t = g*kR + u reads window sample
      // j0 + p + r - t. cur[r] holds window sample (q0 - g)*kR + r and
      // nxt[r] window sample (q0 - g - 1)*kR + r.
      const int q0 = threadIdx.x + p / kR;
      T cur[kR], nxt[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) cur[r] = xs[r * kPitch + q0];
      for (int g = 0; g < p / kR; ++g) {
#pragma unroll
        for (int r = 0; r < kR; ++r) nxt[r] = xs[r * kPitch + q0 - g - 1];
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          const float hv = hs[g * kR + u];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[r] = fma_s(hv, r >= u ? cur[r - u] : nxt[kR + r - u], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) cur[r] = nxt[r];
      }
    }

    T* yr = y + row * n;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int64_t o = n0 + j0 + r;
      if (o < n) yr[o] = acc[r];
    }
  }
}

// ------------------------------------------------------ K4: resampler

constexpr int kRsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRsThreads)
resample_kernel(const T* __restrict__ x, const float* __restrict__ h,
                T* __restrict__ y, int64_t rows, int64_t n, int64_t n_out,
                int64_t n_taps, int64_t interp, int64_t decim) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kRsThreads + threadIdx.x;
  if (j >= n_out) return;
  const int64_t up = j * decim + (n_taps - 1) / 2;   // 64-bit, see the note
  const int64_t t0 = up % interp;
  const int64_t base = (up - t0) / interp;
  const int64_t kp = (n_taps + interp - 1) / interp;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * n;
    T acc = zero<T>();
    for (int64_t kk = 0; kk < kp; ++kk) {
      const int64_t tap = t0 + kk * interp, src = base - kk;
      if (tap < n_taps && src >= 0 && src < n)
        acc = fma_s(__ldg(h + tap), __ldg(xr + src), acc);
    }
    y[row * n_out + j] = acc;
  }
}

unsigned grid_rows(int64_t rows) {
  return static_cast<unsigned>(rows < 65535 ? rows : 65535);
}

}  // namespace

// x, y: (rows, n) float32, or complex64 as float2 when is_complex; h: (k,)
// float32. All device pointers, contiguous. Returns cudaGetLastError().
extern "C" int gwt_fir(const void* x, const void* h, void* y, int64_t rows,
                       int64_t n, int64_t k, int is_complex, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kFirTile - 1) / kFirTile), grid_rows(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  if (is_complex)
    fir_kernel<float2><<<grid, kFirThreads, 0, s>>>(
        static_cast<const float2*>(x), hf, static_cast<float2*>(y), rows, n, k);
  else
    fir_kernel<float><<<grid, kFirThreads, 0, s>>>(
        static_cast<const float*>(x), hf, static_cast<float*>(y), rows, n, k);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, n), y: (rows, n_out), float32 or complex64 as float2 when
// is_complex; h: (n_taps,) float32. All device pointers, contiguous.
// Returns cudaGetLastError().
extern "C" int gwt_polyphase_resample(const void* x, const void* h, void* y,
                                      int64_t rows, int64_t n, int64_t n_out,
                                      int64_t n_taps, int64_t interp, int64_t decim,
                                      int is_complex, void* stream) {
  if (rows <= 0 || n <= 0 || n_out <= 0 || n_taps <= 0 || interp <= 0 || decim <= 0)
    return 0;
  const dim3 grid(static_cast<unsigned>((n_out + kRsThreads - 1) / kRsThreads),
                  grid_rows(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  if (is_complex)
    resample_kernel<float2><<<grid, kRsThreads, 0, s>>>(
        static_cast<const float2*>(x), hf, static_cast<float2*>(y), rows, n, n_out,
        n_taps, interp, decim);
  else
    resample_kernel<float><<<grid, kRsThreads, 0, s>>>(
        static_cast<const float*>(x), hf, static_cast<float*>(y), rows, n, n_out,
        n_taps, interp, decim);
  return static_cast<int>(cudaGetLastError());
}
