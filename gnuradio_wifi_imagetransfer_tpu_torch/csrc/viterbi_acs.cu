// K=7 soft-decision Viterbi decoder (forward ACS + traceback) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ops/pallas_viterbi.py (_make_acs_kernel, reached
// from acs_forward through pl.pallas_call) of the JAX package, plus the
// traceback that the JAX package runs in XLA (pallas_viterbi.decode).
//
// It is bit-exact against the JAX XLA path (phy/viterbi.py:82-110): per
// trellis step and new state ns, over its two predecessor edges k,
//     gain[k] = llr_a * out_a[ns,k] + llr_b * out_b[ns,k]
//     cand[k] = pm[prev_state[ns,k]] + gain[k]
//     dec     = cand[1] > cand[0]           (ties go to k = 0)
//     pm'     = max(cand) - max over states of max(cand)
// starting from pm = 0 in state 0 and -1e30 elsewhere. Every add and
// multiply is written with __fadd_rn/__fmul_rn (and the library is built
// with --fmad=false), so nvcc cannot fuse them into FMAs that would round
// differently and break ties another way.
//
// Bound: the recursion is serial in the trellis steps; per frame and step
// it does about 700 float32 operations and the data are tiny (8 bytes of
// LLRs in, 1 byte out per step). At the executor's step (256 frames x 422
// steps, plus 256 x 24 for SIGNAL) the operation bound is about 1.1 us and
// the byte bound 0.3 us; the kernel is latency bound by the step chain.
//
// Design: one warp per frame (one block of 32 threads). Lane j owns the
// states j and j+32, whose predecessors are both 2j and 2j+1 (the trellis
// butterfly). The frame's LLRs are staged in shared memory first, path
// metrics live in shared memory, the per-step max is a warp shuffle
// reduction, and the step's 64 survivor decisions are one 64-bit word
// built with two __ballot_sync and kept in shared memory (n x 8 bytes, no
// device-memory scratch). Lane 0 then traces back from state 0
// (terminated) or from the first state of the largest final metric
// (unterminated), reading the decision words from shared memory. The
// trellis tables come from the port's params.conv_tables() and sit in
// __constant__ memory (gwt_viterbi_set_tables).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr unsigned kFull = 0xffffffffu;

__constant__ int c_prev_state[kStates][2];
__constant__ int c_prev_bit[kStates][2];
__constant__ float c_out_a[kStates][2];
__constant__ float c_out_b[kStates][2];

__global__ void __launch_bounds__(32)
viterbi_kernel(const float2* __restrict__ llr, uint8_t* __restrict__ bits,
               int n, int terminated) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* dec = smem;                         // n decision words
  float2* lv = reinterpret_cast<float2*>(smem + n);       // n LLR pairs
  __shared__ float pm[kStates];

  const int lane = threadIdx.x;
  const int64_t f = blockIdx.x;
  const float2* lf = llr + f * n;
  for (int t = lane; t < n; t += 32) lv[t] = lf[t];

  const int s0 = lane, s1 = lane + 32;
  const int p00 = c_prev_state[s0][0], p01 = c_prev_state[s0][1];
  const int p10 = c_prev_state[s1][0], p11 = c_prev_state[s1][1];
  const float a00 = c_out_a[s0][0], a01 = c_out_a[s0][1];
  const float b00 = c_out_b[s0][0], b01 = c_out_b[s0][1];
  const float a10 = c_out_a[s1][0], a11 = c_out_a[s1][1];
  const float b10 = c_out_b[s1][0], b11 = c_out_b[s1][1];
  pm[s0] = s0 == 0 ? 0.f : -1e30f;
  pm[s1] = -1e30f;
  __syncwarp();

  for (int t = 0; t < n; ++t) {
    const float2 v = lv[t];
    const float c00 = __fadd_rn(pm[p00], __fadd_rn(__fmul_rn(v.x, a00), __fmul_rn(v.y, b00)));
    const float c01 = __fadd_rn(pm[p01], __fadd_rn(__fmul_rn(v.x, a01), __fmul_rn(v.y, b01)));
    const float c10 = __fadd_rn(pm[p10], __fadd_rn(__fmul_rn(v.x, a10), __fmul_rn(v.y, b10)));
    const float c11 = __fadd_rn(pm[p11], __fadd_rn(__fmul_rn(v.x, a11), __fmul_rn(v.y, b11)));
    const bool d0 = c01 > c00, d1 = c11 > c10;
    const float n0 = d0 ? c01 : c00, n1 = d1 ? c11 : c10;
    float m = fmaxf(n0, n1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const unsigned lo = __ballot_sync(kFull, d0), hi = __ballot_sync(kFull, d1);
    __syncwarp();                      // every lane has read pm for this step
    pm[s0] = __fsub_rn(n0, m);
    pm[s1] = __fsub_rn(n1, m);
    if (lane == 0) dec[t] = static_cast<unsigned long long>(lo)
                            | (static_cast<unsigned long long>(hi) << 32);
    __syncwarp();
  }

  int state = 0;
  if (!terminated) {                   // first state holding the largest metric
    const float q0 = pm[s0], q1 = pm[s1];
    float m = fmaxf(q0, q1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const unsigned lo = __ballot_sync(kFull, q0 == m), hi = __ballot_sync(kFull, q1 == m);
    state = __ffsll(static_cast<long long>(
                static_cast<unsigned long long>(lo)
                | (static_cast<unsigned long long>(hi) << 32))) - 1;
  }
  if (lane == 0) {
    uint8_t* out = bits + f * n;
    for (int t = n - 1; t >= 0; --t) {
      const int k = static_cast<int>((dec[t] >> state) & 1ull);
      out[t] = static_cast<uint8_t>(c_prev_bit[state][k]);
      state = c_prev_state[state][k];
    }
  }
}

}  // namespace

// Trellis tables, host pointers to (64, 2) arrays. Copies them into the
// current device's constant memory. Returns cudaGetLastError().
extern "C" int gwt_viterbi_set_tables(const int* prev_state, const int* prev_bit,
                                      const float* out_a, const float* out_b) {
  const size_t ib = sizeof(int) * kStates * 2, fb = sizeof(float) * kStates * 2;
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_prev_state, prev_state, ib)) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_prev_bit, prev_bit, ib)) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_out_a, out_a, fb)) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_out_b, out_b, fb)) != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory one frame needs: n decision words + n LLR pairs.
extern "C" int64_t gwt_viterbi_smem_bytes(int64_t n) { return n * 16; }

// llr: (batch, n) float2 pairs (llr_a, llr_b) per trellis step; bits:
// (batch, n) uint8. Device pointers, contiguous. Returns cudaGetLastError().
extern "C" int gwt_viterbi_decode(const void* llr, void* bits, int64_t batch,
                                  int64_t n, int terminated, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = static_cast<size_t>(gwt_viterbi_smem_bytes(n));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  viterbi_kernel<<<static_cast<unsigned>(batch), 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(llr), static_cast<uint8_t*>(bits),
      static_cast<int>(n), terminated);
  return static_cast<int>(cudaGetLastError());
}
