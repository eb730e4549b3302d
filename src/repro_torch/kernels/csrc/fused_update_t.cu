// Fused BP message update in the transposed (states, edges) layout, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's "pallas" backend:
//   src/repro/kernels/message_update.py:59  _fused_kernel  (sum-product)
// Operands, edges last (the TPU's lane layout):
//   logpsi_t (S, S, E) [x_src, x_dst, e]; pre_t, logm_t, out_t (S, E);
//   dmask_t (S, E) int8; resid (E,).
// Per directed edge e:
//   cand[xj] = LSE_xi(logpsi_t[xi,xj,e] + pre_t[xi,e]);  masked to NEG_INF
//   out_t[:, e] = cand - LSE_xj(cand) on valid states, NEG_INF elsewhere
//   resid[e]    = max_xj (valid ? |out - logm| : 0)
// The plain torch version is repro_torch/kernels/ref.py::fused_update_t_ref.
//
// Bound: memory. Each edge reads its S*S table column, pre, logm and the
// int8 mask and writes out and resid once: (S^2 + 3S + 1) * 4 + S bytes.
// At the stereo bucket's shape (E = 1,764,352, S = 16) that is 1,236 B/edge,
// 2.18 GB per launch; about 5 S^2 flops per edge stay far below the card's
// ridge point.
//
// Design. One thread per edge, the paper's mapping: with edges last,
// thread e reads element [.., e] of every row, so a warp's 32 loads of one
// row are 32 consecutive floats -- every load is coalesced, with no
// shared memory and no shuffles. For each destination state the thread
// takes a max over source states, then a sum of exp(score - max) (the
// table column comes back from L1 for the second pass), and writes the
// masked candidate to out_t. It then reads its own candidates back for the
// normalizer and overwrites them with the normalized messages, so nothing
// per state is held in registers and any S works (the zoo reaches 81).
// The TPU's 128-lane edge blocks, VMEM budget and edge padding are gone:
// the last block masks edges >= E. Indices are 64-bit (S*S*E passes 2^31
// at S = 16 once E > 8.4 M).
// Numerics: build without fast math (no -use_fast_math, no -ftz): 1e-38 is
// below FLT_MIN and must survive, or log() of an all-masked row gives -inf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kTiny = 1.0e-38f;   // subnormal on purpose, as the reference
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
edge_t_kernel(const float* __restrict__ logpsi_t,
              const float* __restrict__ pre_t,
              const float* __restrict__ logm_t,
              const int8_t* __restrict__ dmask_t,
              float* __restrict__ out_t, float* __restrict__ resid,
              long long n_edges, int S) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= n_edges) return;
  const long long E = n_edges;
  const long long row = static_cast<long long>(S) * E;  // xi -> xi + 1

  float zm = kNegInf;
  for (int j = 0; j < S; ++j) {
    const float* col = logpsi_t + j * E + e;             // [0, j, e]
    float m = -__int_as_float(0x7f800000);               // -inf
    for (int i = 0; i < S; ++i)
      m = fmaxf(m, __ldg(col + i * row) + __ldg(pre_t + i * E + e));
    m = fmaxf(m, kNegInf);
    float s = 0.0f;
    for (int i = 0; i < S; ++i)
      s += expf(__ldg(col + i * row) + __ldg(pre_t + i * E + e) - m);
    float c = m + logf(fmaxf(s, kTiny));
    c = __ldg(dmask_t + j * E + e) != 0 ? c : kNegInf;
    out_t[j * E + e] = c;
    zm = fmaxf(zm, c);
  }

  float zs = 0.0f;
  for (int j = 0; j < S; ++j)
    if (__ldg(dmask_t + j * E + e) != 0) zs += expf(out_t[j * E + e] - zm);
  const float z = zm + logf(fmaxf(zs, kTiny));

  float r = 0.0f;
  for (int j = 0; j < S; ++j) {
    const long long k = j * E + e;
    const bool valid = __ldg(dmask_t + k) != 0;
    const float v = valid ? out_t[k] - z : kNegInf;
    out_t[k] = v;
    if (valid) r = fmaxf(r, fabsf(v - __ldg(logm_t + k)));
  }
  resid[e] = r;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// n_edges == 0 launches nothing.
int fused_update_t_launch(const float* logpsi_t, const float* pre_t,
                          const float* logm_t, const int8_t* dmask_t,
                          float* out_t, float* resid, long long n_edges,
                          int n_states, void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaSuccess);
  if (n_states < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((n_edges + kThreads - 1) / kThreads);
  edge_t_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logpsi_t, pre_t, logm_t, dmask_t, out_t, resid, n_edges, n_states);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
