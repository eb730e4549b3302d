// Fused BP message update, edge-major, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the JAX package's "triton" backend:
//   src/repro/kernels/triton_update.py:103  _sum_kernel  (sum-product)
//   src/repro/kernels/triton_update.py:125  _max_kernel  (max-product)
// Per directed edge e with S states (layout [e, x_src, x_dst]):
//   cand[xj] = LSE_xi(logpsi[e,xi,xj] + pre[e,xi])   (sum; max_xi for max)
//   cand     = dmask ? cand : NEG_INF
//   new      = dmask ? cand - z : NEG_INF   z = LSE_xj cand (sum) / max (max)
//   resid[e] = max_xj (dmask ? |new - logm| : 0)
// The plain torch version is repro_torch/kernels/ref.py::fused_update_e_ref.
//
// Bound: memory. Each edge reads its (S,S) table, pre, logm and the int8
// mask and writes new and resid once: (S^2 + 3S + 1) * 4 + S bytes, the
// 3-read/2-write contract of repro/roofline/kernel_model.py. At the main
// path's shape (E = 3,996,032, S = 2) that is 46 B/edge, 183.8 MB per
// launch; at about 5 S^2 flops per edge the arithmetic is far below the
// card's ridge point.
//
// Design. No state padding: S is any count from 1 to kMaxStates and the
// kernel masks its own ragged edge (Triton tiles are powers of two, so the
// reference padded S = 81 to 128). No edge padding either: the last block
// masks edges >= E.
//   * S <= 8: one thread owns one edge, S is a template parameter and the
//     edge's rows live in registers. Neighbouring threads own neighbouring
//     edges, so a warp's loads walk contiguous memory.
//   * S > 8: one warp owns one edge; lane l owns destination states
//     xj = l, l+32, ... For each source state the warp reads one table row,
//     coalesced along xj. The per-edge normalizer and residual are warp
//     reductions by shuffles.
// Numerics: build without fast math (no -use_fast_math, no -ftz). 1e-38 is
// below FLT_MIN; flushed to zero, log() of an all-masked row's sum would
// give -inf. expf/logf are the accurate CUDA math functions. Max-product
// uses only add, max, subtract and abs, so it is bitwise equal to the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kTiny = 1.0e-38f;   // subnormal on purpose, as the reference
constexpr int kThreads = 256;
constexpr int kMaxStates = 128;     // S > 8 path: 4 destination states a
                                    // lane (MAX_STATES in triton_update.py)
constexpr int kPerLane = kMaxStates / 32;

enum Semiring { kSum = 0, kMax = 1 };

// ---------------------------------------------------------- thread/edge --

template <int S, int SEMI>
__global__ void __launch_bounds__(kThreads)
edge_thread_kernel(const float* __restrict__ logpsi,
                   const float* __restrict__ pre,
                   const float* __restrict__ logm,
                   const int8_t* __restrict__ dmask,
                   float* __restrict__ out, float* __restrict__ resid,
                   long long n_edges) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= n_edges) return;
  const float* psi = logpsi + e * (S * S);
  float p[S];
#pragma unroll
  for (int i = 0; i < S; ++i) p[i] = __ldg(pre + e * S + i);

  float cand[S];
  bool valid[S];
  float zm = kNegInf;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float sc[S];
    float m = __ldg(psi + j) + p[0];
    sc[0] = m;
#pragma unroll
    for (int i = 1; i < S; ++i) {
      sc[i] = __ldg(psi + i * S + j) + p[i];
      m = fmaxf(m, sc[i]);
    }
    float c;
    if (SEMI == kMax) {
      c = m;
    } else {
      m = fmaxf(m, kNegInf);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s += expf(sc[i] - m);
      c = m + logf(fmaxf(s, kTiny));
    }
    valid[j] = __ldg(dmask + e * S + j) != 0;
    cand[j] = valid[j] ? c : kNegInf;
    zm = fmaxf(zm, cand[j]);
  }

  float z = zm;
  if (SEMI == kSum) {
    float zs = 0.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) zs += valid[j] ? expf(cand[j] - zm) : 0.0f;
    z = zm + logf(fmaxf(zs, kTiny));
  }
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float v = valid[j] ? cand[j] - z : kNegInf;
    out[e * S + j] = v;
    if (valid[j]) r = fmaxf(r, fabsf(v - __ldg(logm + e * S + j)));
  }
  resid[e] = r;
}

// ------------------------------------------------------------ warp/edge --

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int SEMI>
__global__ void __launch_bounds__(kThreads)
edge_warp_kernel(const float* __restrict__ logpsi,
                 const float* __restrict__ pre,
                 const float* __restrict__ logm,
                 const int8_t* __restrict__ dmask,
                 float* __restrict__ out, float* __restrict__ resid,
                 long long n_edges, int S) {
  const int lane = threadIdx.x & 31;
  const long long e = (blockIdx.x * static_cast<long long>(blockDim.x)
                       + threadIdx.x) >> 5;
  if (e >= n_edges) return;          // uniform across the warp
  const float* psi = logpsi + e * static_cast<long long>(S) * S;
  const float* pe = pre + e * S;

  // Pass 1: max over source states of every owned destination state.
  float m[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) m[k] = -__int_as_float(0x7f800000);  // -inf
  for (int i = 0; i < S; ++i) {
    const float pi = __ldg(pe + i);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < S) m[k] = fmaxf(m[k], __ldg(psi + i * S + j) + pi);
    }
  }
  float cand[kPerLane];
  if (SEMI == kMax) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) cand[k] = m[k];
  } else {
    // Pass 2: shifted exp-sum; the rows come back from L1.
    float s[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      m[k] = fmaxf(m[k], kNegInf);
      s[k] = 0.0f;
    }
    for (int i = 0; i < S; ++i) {
      const float pi = __ldg(pe + i);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < S) s[k] += expf(__ldg(psi + i * S + j) + pi - m[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      cand[k] = m[k] + logf(fmaxf(s[k], kTiny));
  }

  bool valid[kPerLane];
  float zm = kNegInf;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    valid[k] = j < S && __ldg(dmask + e * S + j) != 0;
    cand[k] = valid[k] ? cand[k] : kNegInf;
    zm = fmaxf(zm, cand[k]);
  }
  zm = warp_max(zm);
  float z = zm;
  if (SEMI == kSum) {
    float zs = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      zs += valid[k] ? expf(cand[k] - zm) : 0.0f;
    zs = warp_sum(zs);
    z = zm + logf(fmaxf(zs, kTiny));
  }
  float r = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      const float v = valid[k] ? cand[k] - z : kNegInf;
      out[e * S + j] = v;
      if (valid[k]) r = fmaxf(r, fabsf(v - __ldg(logm + e * S + j)));
    }
  }
  r = warp_max(r);
  if (lane == 0) resid[e] = r;
}

template <int SEMI>
void launch_thread(int s, unsigned blocks, cudaStream_t st,
                   const float* logpsi, const float* pre, const float* logm,
                   const int8_t* dmask, float* out, float* resid,
                   long long n) {
#define FUE_CASE(S_)                                                        \
  case S_:                                                                  \
    edge_thread_kernel<S_, SEMI><<<blocks, kThreads, 0, st>>>(              \
        logpsi, pre, logm, dmask, out, resid, n);                           \
    break;
  switch (s) {
    FUE_CASE(1) FUE_CASE(2) FUE_CASE(3) FUE_CASE(4)
    FUE_CASE(5) FUE_CASE(6) FUE_CASE(7) FUE_CASE(8)
  }
#undef FUE_CASE
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// n_edges == 0 launches nothing. semiring: 0 = sum-product, 1 = max-product.
int fused_update_e_launch(const float* logpsi, const float* pre,
                          const float* logm, const int8_t* dmask, float* out,
                          float* resid, long long n_edges, int n_states,
                          int semiring, void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaSuccess);
  if (n_states < 1 || n_states > kMaxStates || (semiring != kSum &&
                                                semiring != kMax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_states <= 8) {
    const unsigned blocks =
        static_cast<unsigned>((n_edges + kThreads - 1) / kThreads);
    if (semiring == kSum)
      launch_thread<kSum>(n_states, blocks, st, logpsi, pre, logm, dmask,
                          out, resid, n_edges);
    else
      launch_thread<kMax>(n_states, blocks, st, logpsi, pre, logm, dmask,
                          out, resid, n_edges);
  } else {
    const long long threads = n_edges * 32;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    if (semiring == kSum)
      edge_warp_kernel<kSum><<<blocks, kThreads, 0, st>>>(
          logpsi, pre, logm, dmask, out, resid, n_edges, n_states);
    else
      edge_warp_kernel<kMax><<<blocks, kThreads, 0, st>>>(
          logpsi, pre, logm, dmask, out, resid, n_edges, n_states);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
