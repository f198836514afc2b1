// Causal FIR filter (K3) and polyphase rational resampler (K4) for Hopper
// (sm_90a).
//
// Both replace TPU kernels of the JAX package's ops/pallas_fir.py, which
// cast the convolutions as banded matmuls for the TPU's matrix unit. Here
// they are stencils on the CUDA cores. Samples are float32 (real) or
// complex64 read as interleaved float2; taps are real float32. One launch
// covers all rows. The multiply-adds are spelled __fmaf_rn: the library
// is built with --fmad=false, which would otherwise split each into two
// instructions. Samples are staged with 16-byte cp.async copies (zeros
// outside the row, so no term tests a bound); a row whose start is not
// 16-byte aligned, and the elements at a row's ends, take copies of one
// element.
//
// K3, gwt_fir: y[n] = sum_{t<K} h[t] x[n-t], zeros before each row's start.
//   Replaces _fir_kernel, reached from _fir_real through pl.pallas_call
//   (two banded 128x128 matmuls a 128-sample tile, K <= 129).
//   Bound: device memory, then the float32 rate close behind. A complex
//   sample moves 16 bytes (read once, written once) and costs 2K FFMA: at
//   K = 65 on an H100 (3.35 TB/s, 67 TFLOP/s) the bytes take 0.080 ms for
//   4 x 4 194 304 samples and the FFMA 0.065 ms, so FFMA has to run near
//   full issue while the loads hide behind it.
//   Design: a persistent block (128 threads, a thread 16 consecutive
//   outputs, 2048 a tile) walks tiles of all rows. Its tiles are staged in
//   a two-buffer ring: tile i+1's window (the tile and its history) is in
//   flight while tile i computes. The window is laid out with V pad
//   elements after every 16 (V = 16 bytes of samples), so each thread's
//   8-sample bank is two or four 16-byte shared loads free of bank
//   conflicts. Taps come in groups of 8 (the last cut to the taps there
//   are); three banks of registers rotate by name through an unrolled
//   loop, so a group is one bank load feeding 128 (real) or 256 (complex)
//   FFMA and no register moves. Taps go in chunks of up to 256 through
//   shared memory beside the window, each chunk one more item of the same
//   ring; a group's 8 taps are two broadcast 16-byte loads. Outputs are
//   written back into the consumed window and stored with coalesced
//   16-byte stores. A thread is held to 96 registers so 5 blocks share an
//   SM (at 4, K3 measured 3 % slower on an H100 80GB HBM3 at 700 W).
//   Taps are summed in order t = 0..K-1, as the plain version does.
//
// K4, gwt_polyphase_resample: rational L/M resampling in the direct form
//   of the oracle (ops/resampler.py polyphase_resample of the JAX package).
//   For output j, with c = (n_taps-1)/2:
//       t0 = (j*M + c) mod L,  base = (j*M + c - t0) / L,
//       y[j] = sum_{k < kp} hp[t0][k] x[base - k],   kp = ceil(n_taps/L),
//   where hp[p][k] = h[p + k*L], zero past n_taps (the phase-major table,
//   built once per (taps, L) on the host), and x is zero outside [0, N).
//   Replaces _resample_kernel, reached from _resample_real through
//   pl.pallas_call (static (L, M+2, 128, 128) tables, L <= 64, M <= 96).
//   Bound: device memory, 8 (N + n_out) bytes a complex row; the
//   arithmetic is a tenth of it at 3/4.
//   Design: a block takes a tile of up to 2048 consecutive outputs of one
//   row (fewer where M/L is large, so the span fits). One 64-bit division
//   gives the tile's origin q0 = (j0*M + c) / L and r0; a thread's first
//   output takes one more, and every later output of the thread (256 on)
//   steps (q, r) by the precomputed (256*M / L, 256*M mod L) in 32 bits.
//   The tile's input span, about T*M/L + kp samples, is staged in shared
//   memory; the phase table too when L*kp floats fit in 16 KB, else each
//   output reads its phase's row through L2 (1.2 MB at 25001/25000).
//   Neighbouring threads own neighbouring outputs, so stores coalesce.
//   kp = 12 (design_lowpass's default) is an unrolled instance with the
//   taps read as three float4. Each output is stored when its terms are
//   summed (no accumulator array), so a thread fits 64 registers and 4
//   blocks of 256 share an SM: while one block computes, the others'
//   spans are in flight. (A persistent block with a two-span ring, and
//   caps of 40 or 32 registers, measured slower on the H100.) A phase row
//   longer than half the span's room is taken in passes, each restaged, a
//   pass adding to what the last stored. Indices are 64-bit where they
//   pass 2^31: j*M does after 85 900 outputs at L/M = 25001/25000 (40
//   ppm), where the JAX path's int32 index wraps.
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

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// one element of B bytes (4 or 8); ok == false writes zeros and reads nothing
template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(B), "r"(ok ? B : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage samples xr[s0 + i], i < count (count a multiple of V), zeros
// outside [0, n), into dst[at(i)] where at() keeps V-groups contiguous and
// 16-byte aligned. xr + s0 must sit on a 16-byte boundary for the vector
// copies; `aligned` says whether it does.
template <typename T, int NT, typename At>
__device__ __forceinline__ void stage(T* dst, const T* xr, int64_t s0, int count, int64_t n,
                                      bool aligned, At at) {
  constexpr int V = 16 / sizeof(T);
  for (int v = threadIdx.x; v < count / V; v += NT) {
    const int64_t s = s0 + static_cast<int64_t>(v) * V;
    T* d = dst + at(v * V);
    if (aligned && s >= 0 && s + V <= n) {
      cp_async16(d, xr + s);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool ok = s + e >= 0 && s + e < n;
        cp_async_elem<sizeof(T)>(d + e, ok ? xr + s + e : xr, ok);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- K3: FIR

constexpr int kFirR = 16;                       // consecutive outputs a thread
constexpr int kFirThreads = 128;
constexpr int kFirTile = kFirR * kFirThreads;   // outputs a tile
constexpr int kFirG = 8;                        // taps a group (a register bank)
constexpr int kFirChunk = 256;                  // taps a pass
constexpr int kFirMinBlocks = 5;                // 96 registers a thread at most

// window sample i of a tile sits at pad<T>(i): V pad elements after every
// 16, so a thread's 16-sample stride lands on distinct banks
template <typename T>
__device__ __forceinline__ int pad(int i) {
  return i + (16 / static_cast<int>(sizeof(T))) * (i >> 4);
}
template <typename T>
__host__ __device__ constexpr int fir_buf_elems() {   // the largest window, padded
  return (kFirTile + kFirChunk) + (16 / sizeof(T)) * ((kFirTile + kFirChunk) / 16);
}

// 16 bytes of samples to and from a float4, element by element, so the
// register arrays never need an address
__device__ __forceinline__ void unpack(float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(float4 v, float2* o) {
  o[0] = make_float2(v.x, v.y); o[1] = make_float2(v.z, v.w);
}
__device__ __forceinline__ float4 pack(const float* a) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ float4 pack(const float2* a) {
  return make_float4(a[0].x, a[0].y, a[1].x, a[1].y);
}

// 8 window samples from index p (a multiple of 8), as 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const T* win, int p, T (&out)[8]) {
  constexpr int V = 16 / sizeof(T);
  const float4* src = reinterpret_cast<const float4*>(win + pad<T>(p));
#pragma unroll
  for (int i = 0; i < 8 / V; ++i) unpack(src[i], out + i * V);
}

// taps hg[0 .. nv-1] (nv <= 8; hg 16-byte aligned, zeros to 8) on outputs
// r = 0..15: output r with tap v reads the sample e = r - v banks up: hi
// holds e in [8, 16), mid [0, 8), lo [-8, 0)
template <typename T>
__device__ __forceinline__ void fir_group(T (&acc)[kFirR], const T (&hi)[8], const T (&mid)[8],
                                          const T (&lo)[8], const float* hg, int nv) {
  float hv[kFirG];                              // two broadcast 16-byte loads
  unpack(reinterpret_cast<const float4*>(hg)[0], hv);
  unpack(reinterpret_cast<const float4*>(hg)[1], hv + 4);
#pragma unroll
  for (int v = 0; v < kFirG; ++v) {
    if (v < nv) {
#pragma unroll
      for (int r = 0; r < kFirR; ++r) {
        const int e = r - v;
        const T s = e >= 8 ? hi[e - 8] : (e >= 0 ? mid[e] : lo[e + 8]);
        acc[r] = fma_s(hv[v], s, acc[r]);
      }
    }
  }
}

// One chunk of cv taps on this thread's 16 outputs, in groups of 8, the
// last group cut to the taps there are. The window starts hc samples
// before the tile (hc >= cv rounded up to 8, a multiple of 16); the
// chunk's taps are hs, zeros to a multiple of 8.
template <typename T>
__device__ __forceinline__ void fir_chunk(T (&acc)[kFirR], const T* win, int cv, int hc,
                                          const float* hs) {
  const int b = kFirR * threadIdx.x + hc;       // window index of output 0
  const int ng = (cv + kFirG - 1) / kFirG;
  const int tail = cv - kFirG * (ng - 1);       // taps in the last group
  T A[8], B[8], C[8];
  load8(win, b + 8, A);
  load8(win, b, B);
  int g = 0;
  for (; g + 3 < ng; g += 3) {                  // whole groups, the last kept back
    load8(win, b - 8 * (g + 1), C);
    fir_group(acc, A, B, C, hs + 8 * g, kFirG);
    load8(win, b - 8 * (g + 2), A);
    fir_group(acc, B, C, A, hs + 8 * (g + 1), kFirG);
    load8(win, b - 8 * (g + 3), B);
    fir_group(acc, C, A, B, hs + 8 * (g + 2), kFirG);
  }
  const int left = ng - g;                      // 1 to 3 groups, the last cut
  load8(win, b - 8 * (g + 1), C);
  fir_group(acc, A, B, C, hs + 8 * g, left == 1 ? tail : kFirG);
  if (left >= 2) {
    load8(win, b - 8 * (g + 2), A);
    fir_group(acc, B, C, A, hs + 8 * (g + 1), left == 2 ? tail : kFirG);
  }
  if (left == 3) {
    load8(win, b - 8 * (g + 3), B);
    fir_group(acc, C, A, B, hs + 8 * (g + 2), tail);
  }
}

struct FirGeom {
  int64_t rows, n, k;
  int64_t tiles_per_row, tiles;
  int chunks;
};

template <typename T>
__global__ void __launch_bounds__(kFirThreads, kFirMinBlocks)
fir_kernel(const T* __restrict__ x, const float* __restrict__ h, T* __restrict__ y,
           const FirGeom g) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kBuf = fir_buf_elems<T>();
  __shared__ __align__(16) T buf[2][kBuf];
  __shared__ __align__(16) float hs[2][kFirChunk];

  // this block's items: tiles blockIdx.x, + gridDim.x, ..., each in g.chunks
  const int64_t n_items = blockIdx.x < g.tiles
      ? ((g.tiles - 1 - blockIdx.x) / gridDim.x + 1) * g.chunks : 0;
  auto tile_of = [&](int64_t it) { return blockIdx.x + (it / g.chunks) * gridDim.x; };
  auto chunk_len = [&](int c) {
    const int64_t left = g.k - static_cast<int64_t>(c) * kFirChunk;
    return static_cast<int>(left < kFirChunk ? left : kFirChunk);
  };
  auto hist = [](int cv) { return ((cv + kFirG - 1) / kFirG * kFirG + 15) / 16 * 16; };

  auto issue = [&](int64_t it) {
    const int64_t tile = tile_of(it);
    const int c = static_cast<int>(it % g.chunks);
    const int64_t row = tile / g.tiles_per_row;
    const int64_t n0 = (tile - row * g.tiles_per_row) * kFirTile;
    const int cv = chunk_len(c), hc = hist(cv);
    const T* xr = x + row * g.n;
    stage<T, kFirThreads>(buf[it & 1], xr, n0 - static_cast<int64_t>(c) * kFirChunk - hc,
                          kFirTile + hc, g.n, aligned16(xr), [](int i) { return pad<T>(i); });
    const float* hc0 = h + static_cast<int64_t>(c) * kFirChunk;
    for (int i = threadIdx.x; i < (cv + kFirG - 1) / kFirG * kFirG; i += kFirThreads)
      cp_async_elem<4>(&hs[it & 1][i], i < cv ? hc0 + i : h, i < cv);
    cp_async_commit();
  };

  if (n_items == 0) return;
  issue(0);
  T acc[kFirR];
  for (int64_t it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) issue(it + 1);
    else cp_async_commit();                     // an empty group keeps the count
    cp_async_wait<1>();
    __syncthreads();

    const int c = static_cast<int>(it % g.chunks);
    const int cv = chunk_len(c);
    T* win = buf[it & 1];
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < kFirR; ++r) acc[r] = zero<T>();
    }
    fir_chunk(acc, win, cv, hist(cv), hs[it & 1]);

    if (c == g.chunks - 1) {                    // the tile's last chunk: store it
      const int64_t tile = tile_of(it);
      const int64_t row = tile / g.tiles_per_row;
      const int64_t n0 = (tile - row * g.tiles_per_row) * kFirTile;
      __syncthreads();                          // the window is consumed
      // a thread's 16 outputs are one padded group: contiguous, aligned
      float4* o = reinterpret_cast<float4*>(win + pad<T>(kFirR * threadIdx.x));
#pragma unroll
      for (int i = 0; i < kFirR / V; ++i) o[i] = pack(acc + i * V);
      __syncthreads();
      T* yr = y + row * g.n;
      const bool al = aligned16(yr);
      for (int v = threadIdx.x; v < kFirTile / V; v += kFirThreads) {
        const int64_t s = n0 + static_cast<int64_t>(v) * V;
        const T* src = win + pad<T>(v * V);
        if (al && s + V <= g.n) {
          *reinterpret_cast<float4*>(yr + s) = *reinterpret_cast<const float4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (s + e < g.n) yr[s + e] = src[e];
        }
      }
    }
    __syncthreads();                            // buffer it & 1 free for item it + 2
  }
}

// persistent grid: the blocks that fit on the card at once, at most one a tile
template <typename K>
int64_t resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFirThreads, 0);
  return static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
}

template <typename T>
void launch_fir(const void* x, const float* h, void* y, FirGeom g, cudaStream_t s) {
  auto kernel = fir_kernel<T>;
  const int64_t fit = resident_blocks(kernel);
  const int64_t blocks = g.tiles < fit ? g.tiles : fit;
  kernel<<<static_cast<unsigned>(blocks), kFirThreads, 0, s>>>(
      static_cast<const T*>(x), h, static_cast<T*>(y), g);
}

// ------------------------------------------------------ K4: resampler

constexpr int kRsThreads = 256;
constexpr int kRsMaxR = 8;                      // outputs a thread: tiles <= 2048
constexpr int kRsMinBlocks = 4;

struct RsGeom {
  int64_t rows, n, n_out, c;                    // c = (n_taps - 1) / 2
  int interp, decim, kp, kc;                    // kc: phase-row taps a pass
  int tile;                                     // outputs a block
  int step_q, step_r;                           // (256 M) / L, (256 M) mod L
  int span_bytes;                               // shared room for the samples
  int taps_in_smem;                             // the L x kp table in shared memory
};

// KP: taps a phase when it is a compile-time 12 (kc == kp), else 0
template <typename T, int KP>
__global__ void __launch_bounds__(kRsThreads, kRsMinBlocks)
resample_kernel(const T* __restrict__ x, const float* __restrict__ hp, T* __restrict__ y,
                const RsGeom g) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* hs = reinterpret_cast<float*>(smem + g.span_bytes);
  const int kp = KP ? KP : g.kp;
  const float* taps = hp;
  if (g.taps_in_smem) {                         // made visible by the first sync
    for (int i = threadIdx.x; i < g.interp * kp; i += kRsThreads) hs[i] = hp[i];
    taps = hs;
  }

  // the tile's origin: one 64-bit division; the thread's first output: one
  // more; its later outputs step in 32 bits
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * g.tile;
  const int cnt = static_cast<int>(g.n_out - j0 < g.tile ? g.n_out - j0 : g.tile);
  const int64_t up0 = j0 * g.decim + g.c;
  const int64_t q0 = up0 / g.interp;
  const int64_t r0 = up0 - q0 * g.interp;
  const int span = static_cast<int>(((j0 + cnt - 1) * g.decim + g.c) / g.interp - q0);
  const int64_t u = r0 + static_cast<int64_t>(threadIdx.x) * g.decim;
  const int q_t = static_cast<int>(u / g.interp);
  const int r_t = static_cast<int>(u - static_cast<int64_t>(q_t) * g.interp);

  for (int64_t row = blockIdx.y; row < g.rows; row += gridDim.y) {
    const T* xr = x + row * g.n;
    T* yr = y + row * g.n_out + j0;
    for (int k0 = 0; k0 < kp; k0 += g.kc) {
      const int kc = KP ? KP : (g.kc < kp - k0 ? g.kc : kp - k0);
      // samples base(j0) - k0 - kc + 1 .. base(last) - k0, from the
      // 16-byte boundary at or before the first (mis elements earlier)
      const int64_t s0 = q0 - k0 - kc + 1;
      const int mis = static_cast<int>(
          (reinterpret_cast<uintptr_t>(xr) / sizeof(T) + static_cast<uint64_t>(s0)) & (V - 1));
      const int count = (mis + span + kc + V - 1) / V * V;
      stage<T, kRsThreads>(xs, xr, s0 - mis, count, g.n, true, [](int i) { return i; });
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // output base - k0 - kk sits at xw[q - kk]; each output is stored
      // when its pass ends, and a later pass (a phase row in chunks) adds
      // to what this thread stored
      const T* xw = xs + mis + kc - 1;
      int q = q_t, r = r_t;
#pragma unroll
      for (int i = 0; i < kRsMaxR; ++i) {
        const int d = threadIdx.x + i * kRsThreads;
        if (d < cnt) {
          const float* hrow = taps + r * kp + k0;
          const T* xq = xw + q;
          T a = k0 == 0 ? zero<T>() : yr[d];
          if constexpr (KP != 0) {
            static_assert(KP % 4 == 0, "taps are read as float4");
#pragma unroll
            for (int kk = 0; kk < KP; kk += 4) {
              const float4 h4 = *reinterpret_cast<const float4*>(hrow + kk);
              a = fma_s(h4.x, xq[-kk], a);
              a = fma_s(h4.y, xq[-kk - 1], a);
              a = fma_s(h4.z, xq[-kk - 2], a);
              a = fma_s(h4.w, xq[-kk - 3], a);
            }
          } else {
            for (int kk = 0; kk < kc; ++kk) a = fma_s(hrow[kk], xq[-kk], a);
          }
          yr[d] = a;
        }
        q += g.step_q;
        r += g.step_r;
        if (r >= g.interp) {
          r -= g.interp;
          ++q;
        }
      }
      __syncthreads();                          // the span is consumed
    }
  }
}

template <typename T, int KP>
int launch_resample(const void* x, const float* hp, void* y, const RsGeom& g,
                    cudaStream_t s) {
  auto kernel = resample_kernel<T, KP>;
  const int bytes = g.span_bytes + (g.taps_in_smem ? g.interp * g.kp * 4 : 0);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((g.n_out + g.tile - 1) / g.tile),
                  static_cast<unsigned>(g.rows < 65535 ? g.rows : 65535));
  kernel<<<grid, kRsThreads, bytes, s>>>(static_cast<const T*>(x), hp, static_cast<T*>(y), g);
  return 0;
}

}  // namespace

// x, y: (rows, n) float32, or complex64 as float2 when is_complex; h: (k,)
// float32 taps. All device pointers, contiguous. Returns
// cudaGetLastError().
extern "C" int gwt_fir(const void* x, const void* h, void* y, int64_t rows, int64_t n,
                       int64_t k, int is_complex, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0) return 0;
  FirGeom g;
  g.rows = rows;
  g.n = n;
  g.k = k;
  g.tiles_per_row = (n + kFirTile - 1) / kFirTile;
  g.tiles = rows * g.tiles_per_row;
  g.chunks = static_cast<int>((k + kFirChunk - 1) / kFirChunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hd = static_cast<const float*>(h);
  if (is_complex) launch_fir<float2>(x, hd, y, g, s);
  else launch_fir<float>(x, hd, y, g, s);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, n), y: (rows, n_out), float32 or complex64 as float2 when
// is_complex; hp: the (interp, kp) phase-major tap table, float32. All
// device pointers, contiguous. tile, kc, span_bytes and taps_in_smem come
// from ops/fir.py's resample geometry. Returns cudaGetLastError().
extern "C" int gwt_polyphase_resample(const void* x, const void* hp, void* y, int64_t rows,
                                      int64_t n, int64_t n_out, int64_t n_taps,
                                      int64_t interp, int64_t decim, int64_t kp, int64_t kc,
                                      int64_t tile, int64_t span_bytes,
                                      int taps_in_smem, int is_complex, void* stream) {
  if (rows <= 0 || n <= 0 || n_out <= 0 || n_taps <= 0 || interp <= 0 || decim <= 0)
    return 0;
  RsGeom g;
  g.rows = rows;
  g.n = n;
  g.n_out = n_out;
  g.c = (n_taps - 1) / 2;
  g.interp = static_cast<int>(interp);
  g.decim = static_cast<int>(decim);
  g.kp = static_cast<int>(kp);
  g.kc = static_cast<int>(kc);
  g.tile = static_cast<int>(tile);
  g.step_q = static_cast<int>(kRsThreads * decim / interp);
  g.step_r = static_cast<int>(kRsThreads * decim % interp);
  g.span_bytes = static_cast<int>(span_bytes);
  g.taps_in_smem = taps_in_smem;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hp);
  int err;
  const bool k12 = kp == 12 && kc == 12;
  if (is_complex)
    err = k12 ? launch_resample<float2, 12>(x, h, y, g, s)
              : launch_resample<float2, 0>(x, h, y, g, s);
  else
    err = k12 ? launch_resample<float, 12>(x, h, y, g, s)
              : launch_resample<float, 0>(x, h, y, g, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
