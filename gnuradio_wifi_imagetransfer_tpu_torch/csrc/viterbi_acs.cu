// K=7 soft-decision Viterbi decoder (forward ACS + traceback) for Hopper
// (sm_90a), for several trellis segments in one launch.
//
// Replaces the TPU kernel ops/pallas_viterbi.py (_make_acs_kernel, reached
// from acs_forward through pl.pallas_call at line 125) of the JAX package,
// plus the traceback that the JAX package runs in XLA
// (pallas_viterbi.decode).
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
// differently and break ties another way. The max is exact in any order.
//
// Bound: the recursion is serial in the trellis steps; per frame and step
// it does about 330 float32 operations in the form below (4 gains, 128
// adds, 64 selects, the max and 64 subtracts) and the data are tiny (8
// bytes of LLRs in, 1 byte out per step). At the executor's step (256
// frames x 422 steps for the payloads plus 256 x 24 for SIGNAL) the
// operation bound is about 0.56 us and the byte bound 0.31 us; the kernel
// is latency bound by the chain of 422 dependent steps.
//
// Design, for that chain:
// - One launch decodes a table of segments (SIGNAL and payload trellises
//   of a step together), one warp a block; a warp holds F frames of one
//   segment (4 at 8 lanes a frame, fewer when a long trellis needs the
//   shared memory). 16 lanes a frame was 3 % faster on the H100 at 422
//   steps but takes trellises of 9 600 steps at most against 14 400
//   (PERF.md), so 8 stays.
// - A terminated segment may give each frame its own trellis length (a
//   stage-B bucket holds frames of one length class): the warp's chain is
//   its longest frame's, not the segment's padded n, and each frame traces
//   back from state 0 at its own last step.
// - The trellis is a butterfly (params.conv_tables(): prev_state[ns][k] =
//   2 (ns mod 32) + k, prev_bit[ns][k] = ns / 32; gwt_viterbi_check_tables
//   checks the port's tables against it and the generators). Lane l of a
//   frame's group owns the new states 4 l .. 4 l + 3 and 32 + 4 l .. 32 +
//   4 l + 3, whose predecessors are exactly 8 l .. 8 l + 7: a lane reads
//   its predecessors as two float4s and writes its new metrics as two.
// - Path metrics are double-buffered in shared memory, so a step needs one
//   __syncwarp, after its stores. They are stored before the step's max
//   is subtracted; the reader subtracts it, so the max travels through
//   the shuffles while the metrics go through shared memory.
// - The step's max is an in-lane max of 8 values, then 3 shuffles inside
//   the group of 8 lanes (against 5 over a warp).
// - The code is linear over GF(2), so an edge's output pair is a lane
//   constant XOR a compile-time slot: a step forms its 4 gains once,
//   permutes them by the lane constant (8 selects) and indexes them
//   statically. They do not depend on the metrics, so they sit off the
//   chain. Survivor decisions are one byte a lane a step in shared memory:
//   state s is byte (s mod 32) / 4, bit (s mod 4) + 4 (s >= 32). The first
//   lane of each group traces back in the same launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kMaxSegments = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int LPF = 8;               // lanes a frame
constexpr int kDescWords = 6;        // int64 words a segment's descriptor

// the 802.11a generators (phy/params.py G0, G1); out_a is the G0 bit
constexpr unsigned kG0 = 0133, kG1 = 0171;

__host__ __device__ constexpr int parity(unsigned v) {
  int p = 0;
  for (; v; v >>= 1) p ^= static_cast<int>(v & 1);
  return p;
}

// 2 out_a + out_b of the 7-bit encoder register reg (newest bit 6). It is
// linear over GF(2): code(a ^ b) = code(a) ^ code(b).
__host__ __device__ constexpr int code_of(unsigned reg) {
  return 2 * parity(reg & kG0) + parity(reg & kG1);
}

struct Segment {
  const float2* llr;     // (batch, n) LLR pairs
  uint8_t* bits;         // (batch, n)
  const int32_t* lens;   // (batch,) each frame's own trellis steps, or null: n each
  int64_t batch;
  int n;
  int terminated;
  int frames;            // frames a warp
  int block0;            // first block of the segment
};

struct SegmentTable {
  Segment seg[kMaxSegments];
  int count;
};

__host__ __device__ constexpr int shared_bytes(int frames, int n) {
  return frames * n * (8 + LPF);       // staged LLRs + decision bytes
}

// path metric of state s in a padded buffer: 4 floats between the halves
// keep the lanes' 16-byte loads and stores free of bank conflicts
__device__ __forceinline__ int pm_at(int s) { return s + (s >= 32 ? 4 : 0); }
constexpr int kPmStride = kStates + 4;

// Stage cnt LLR pairs into shared memory, 16 bytes a load where aligned,
// several loads in flight.
__device__ __forceinline__ void stage_llrs(float2* dst, const float2* __restrict__ src,
                                           int cnt) {
  const int lane = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 8
    for (int i = lane; i < cnt / 2; i += 32) d4[i] = __ldg(s4 + i);
    if (lane == 0 && (cnt & 1)) dst[cnt - 1] = src[cnt - 1];
  } else {
#pragma unroll 8
    for (int i = lane; i < cnt; i += 32) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(32) viterbi_kernel(SegmentTable tab) {
  constexpr int SPL = kStates / LPF;   // states a lane owns
  constexpr int H = SPL / 2;           // ... in each half of the state space
  constexpr int G = 32 / LPF;          // frame groups a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float pm[G][2][kPmStride];

  int si = 0;
  while (si + 1 < tab.count && static_cast<int>(blockIdx.x) >= tab.seg[si + 1].block0) ++si;
  const Segment sg = tab.seg[si];
  const int n = sg.n, frames = sg.frames;
  const int lane = threadIdx.x, g = lane / LPF, l = lane % LPF;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x - sg.block0) * frames;
  const int nf = static_cast<int>(sg.batch - f0 < frames ? sg.batch - f0 : frames);
  const bool active = g < nf;
  float2* lv = reinterpret_cast<float2*>(smem);                 // nf x n LLR pairs
  uint8_t* dec = smem + static_cast<size_t>(frames) * n * 8;    // n x (frames x LPF)
  const int dstride = frames * LPF;

  // A frame's own trellis is its first len steps (1 <= len <= n). The warp
  // runs the forward recursion to the longest of its frames, and each frame
  // traces back from state 0 at its own last step: the decisions of steps
  // below len depend on nothing after them, so a frame decodes bit for bit
  // as it does alone on a trellis of len steps.
  int len = n;
  if (sg.lens != nullptr && active) {
    const int want = sg.lens[f0 + g];
    len = want < 1 ? 1 : (want > n ? n : want);
  }
  const int n_run = sg.lens == nullptr ? n : __reduce_max_sync(kFull, active ? len : 0);

  stage_llrs(lv, sg.llr + f0 * n, nf * n);
  for (int i = l; i < kStates; i += LPF) pm[g][0][pm_at(i)] = i == 0 ? 0.f : -1e30f;
  // The lane's edges: j < H is new state H l + j, j >= H is 32 + H l + j - H,
  // from predecessor s = 2 (H l + j mod H) + k, register (ns / 32) << 6 | s.
  // Its code is code(2 H l) ^ slot(j, k): a lane constant and a constant.
  const int x_l = code_of(2 * H * l);
  const float2* mine = lv + static_cast<int64_t>(active ? g : 0) * n;
  const int lo_at = pm_at(H * l), hi_at = pm_at(32 + H * l), q_at = pm_at(SPL * l);
  __syncwarp();

  // A step has 4 gains, one a code: g[c] = llr_a * (c >> 1) + llr_b * (c & 1),
  // the same operations as per edge. p[y] = g[y ^ x_l], so edge (j, k) takes
  // p[slot(j, k)] with a compile-time index. The gains do not depend on the
  // metrics: step t+1's are formed while step t's max is in the shuffles.
  const bool swap0 = x_l & 1, swap1 = x_l & 2;
  auto gains = [&](float2 v, float (&p)[4]) {
    const float a0 = __fmul_rn(v.x, 0.f), a1 = __fmul_rn(v.x, 1.f);
    const float b0 = __fmul_rn(v.y, 0.f), b1 = __fmul_rn(v.y, 1.f);
    const float g0 = __fadd_rn(a0, b0), g1 = __fadd_rn(a0, b1);
    const float g2 = __fadd_rn(a1, b0), g3 = __fadd_rn(a1, b1);
    const float t0 = swap0 ? g1 : g0, t1 = swap0 ? g0 : g1;
    const float t2 = swap0 ? g3 : g2, t3 = swap0 ? g2 : g3;
    p[0] = swap1 ? t2 : t0;
    p[1] = swap1 ? t3 : t1;
    p[2] = swap1 ? t0 : t2;
    p[3] = swap1 ? t1 : t3;
  };
  float p[4];
  gains(mine[0], p);
  // The buffers hold each step's metrics before the max is subtracted; the
  // reader subtracts it (the same __fsub_rn), so the max's shuffles run
  // while the metrics go through shared memory.
  float m_prev = 0.f;                              // x - 0 = x: step 0 as is
  for (int t = 0; t < n_run; ++t) {
    const float* cur = pm[g][t & 1];
    float* nxt = pm[g][(t + 1) & 1];
    float q[SPL];                                  // metrics of states SPL l ..
#pragma unroll
    for (int i = 0; i < SPL / 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(cur + q_at)[i];
      q[4 * i] = __fsub_rn(w.x, m_prev);
      q[4 * i + 1] = __fsub_rn(w.y, m_prev);
      q[4 * i + 2] = __fsub_rn(w.z, m_prev);
      q[4 * i + 3] = __fsub_rn(w.w, m_prev);
    }
    float nv[SPL];
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int i = j % H;                         // predecessors 2i, 2i+1 of q
      const int slot = code_of(2 * i) ^ (j < H ? 0 : code_of(1u << 6));
      const float c0 = __fadd_rn(q[2 * i], p[slot]);
      const float c1 = __fadd_rn(q[2 * i + 1], p[slot ^ code_of(1)]);
      const bool d = c1 > c0;
      nv[j] = d ? c1 : c0;
      byte |= static_cast<unsigned>(d) << j;
    }
    *reinterpret_cast<float4*>(nxt + lo_at) = make_float4(nv[0], nv[1], nv[2], nv[3]);
    *reinterpret_cast<float4*>(nxt + hi_at) = make_float4(nv[4], nv[5], nv[6], nv[7]);
    if (active) dec[t * dstride + g * LPF + l] = static_cast<uint8_t>(byte);
    gains(mine[t + 1 < n ? t + 1 : t], p);
    float m = nv[0];
#pragma unroll
    for (int j = 1; j < SPL; ++j) m = fmaxf(m, nv[j]);
#pragma unroll
    for (int o = LPF / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    m_prev = m;
    __syncwarp();                 // metrics and decisions of step t are visible
  }

  int state = 0;
  if (!sg.terminated) {           // first state holding the largest metric
    // (before the last max is subtracted: x - m == 0 exactly when x == m)
    const float* fin = pm[g][n_run & 1];
    float q[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) q[j] = fin[pm_at((j < H ? 0 : 32) + H * l + (j % H))];
    float m = q[0];
#pragma unroll
    for (int j = 1; j < SPL; ++j) m = fmaxf(m, q[j]);
#pragma unroll
    for (int o = LPF / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    int first = kStates;
#pragma unroll
    for (int j = SPL - 1; j >= 0; --j)
      if (q[j] == m) first = (j < H ? 0 : 32) + H * l + (j % H);
#pragma unroll
    for (int o = LPF / 2; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kFull, first, o));
    state = first;
  }
  // traceback: a step's decision bytes of the frame are read as whole
  // 64-bit words (they do not depend on the state, so the loads run
  // ahead); the state then picks its bit by shifts alone
  if (active && len < n) {        // past its own trellis a frame's bits are 0
    uint8_t* out = sg.bits + (f0 + g) * n;
    for (int t = len + l; t < n; t += LPF) out[t] = 0;
  }
  if (active && l == 0) {
    uint8_t* out = sg.bits + (f0 + g) * n;
    const uint64_t* dg = reinterpret_cast<const uint64_t*>(dec + g * LPF);
    const int wstride = dstride / 8;
#pragma unroll 8
    for (int t = len - 1; t >= 0; --t) {
      const int byte = (state & 31) / H;                  // lane of the state
      const uint64_t w = dg[t * wstride];
      const int k = static_cast<int>(
          (w >> ((byte % 8) * 8 + (state % H) + (state >= 32 ? H : 0))) & 1);
      out[t] = static_cast<uint8_t>(state >> 5);          // prev_bit[state][k]
      state = ((state & 31) << 1) | k;                    // prev_state[state][k]
    }
  }
}

int launch(const int64_t* desc, int count, int64_t max_smem, cudaStream_t stream) {
  constexpr int G = 32 / LPF;
  SegmentTable tab{};
  int blocks = 0, smem = 0;
  for (int i = 0; i < count; ++i) {
    Segment& s = tab.seg[tab.count];
    const int64_t* d = desc + kDescWords * i;
    s.llr = reinterpret_cast<const float2*>(d[0]);
    s.bits = reinterpret_cast<uint8_t*>(d[1]);
    s.batch = d[2];
    s.n = static_cast<int>(d[3]);
    s.terminated = static_cast<int>(d[4]);
    s.lens = reinterpret_cast<const int32_t*>(d[5]);
    if (s.batch <= 0 || s.n <= 0) continue;
    // a frame shorter than the segment ends in state 0 at its own last step
    if (s.lens != nullptr && !s.terminated) return cudaErrorInvalidValue;
    s.frames = G;
    while (s.frames > 1 && shared_bytes(s.frames, s.n) > max_smem) s.frames /= 2;
    if (shared_bytes(s.frames, s.n) > max_smem) return cudaErrorInvalidValue;
    s.block0 = blocks;
    blocks += static_cast<int>((s.batch + s.frames - 1) / s.frames);
    const int b = shared_bytes(s.frames, s.n);
    smem = b > smem ? b : smem;
    ++tab.count;
  }
  if (blocks == 0) return 0;
  if (smem > 48 * 1024) {
    // always the largest size: a smaller launch must not lower the limit
    // below what a CUDA graph captured from a larger one replays with
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(max_smem));
    if (e != cudaSuccess) return e;
  }
  viterbi_kernel<<<blocks, 32, smem, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a block may take: the card's 227 KB less the
// static path metrics
constexpr int64_t kMaxDynamicSmem = 232448 - 4 * 2 * (kStates + 4) * 4;

}  // namespace

// Trellis tables, host pointers to (64, 2) arrays (params.conv_tables():
// prev_state, prev_bit, prev_out0, prev_out1). Returns 0 if they are the
// butterfly and the generators the kernel is built for, else
// cudaErrorInvalidValue.
extern "C" int gwt_viterbi_check_tables(const int* prev_state, const int* prev_bit,
                                        const float* out_a, const float* out_b) {
  for (int ns = 0; ns < kStates; ++ns)
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * ns + k, s = 2 * (ns & 31) + k;
      const int code = code_of(static_cast<unsigned>((ns >> 5) << 6 | s));
      if (prev_state[i] != s || prev_bit[i] != (ns >> 5)
          || out_a[i] != static_cast<float>(code >> 1) || out_b[i] != static_cast<float>(code & 1))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  return 0;
}

// Longest trellis one launch takes (one frame a warp at 8 lanes a frame).
extern "C" int64_t gwt_viterbi_max_steps() {
  return kMaxDynamicSmem / shared_bytes(1, 1);
}

extern "C" int gwt_viterbi_max_segments() { return kMaxSegments; }

// desc: count x (llr pointer, bits pointer, batch, n, terminated, lens
// pointer) as int64, host memory; llr (batch, n) float2 pairs (llr_a,
// llr_b) per trellis step and bits (batch, n) uint8 are device pointers,
// contiguous; lens is 0 or a device pointer to (batch,) int32 trellis
// lengths, one a frame (a terminated segment only): frame f decodes its
// first lens[f] steps, from state 0 at its last one, and its bits past them
// are 0. One launch. Returns cudaGetLastError().
extern "C" int gwt_viterbi_decode_segments(const int64_t* desc, int count, void* stream) {
  if (count < 0 || count > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  return launch(desc, count, kMaxDynamicSmem, static_cast<cudaStream_t>(stream));
}
