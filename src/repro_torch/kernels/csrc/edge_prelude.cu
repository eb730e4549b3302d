// Edge prelude of a BP round, vertex-major, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's prelude is plain jnp
// (src/repro/core/messages.py: vertex_logprod, edge_prelude), and the port
// ran it as a chain of torch gathers (repro_torch/core/messages.py:
// fold_in_edges, edge_prelude). It was added because that chain took most
// of the device time of every stereo round: a 64-byte row per index, each
// message read twice, per-vertex rows expanded to per-edge ones. Per
// directed edge e = (u -> w) with S states:
//   vsum[u] = the sum of logm over u's in-edge table, fold_in_edges' order
//   pre[e]  = state_mask[u] ? (log_psi_v[u] + vsum[u]) - logm[rev(e)]
//                           : NEG_INF
// The plain torch version is repro_torch/kernels/edge_prelude.py::
// edge_prelude_ref; the kernel is bitwise it and messages.edge_prelude.
//
// Bound: memory. Each message row is read once and each pre row written
// once, plus the per-vertex potentials and masks and the index tables:
// 8*S + 5 bytes an edge and 5*S + 5*D a vertex, D the in-edge table's
// width (69.7 MB for a Tsukuba frame at S = 16, 21 us at 3.35 TB/s;
// kernel_model.edge_prelude_cost). edge_src is read for padded edges
// alone.
// There is one add or subtract per byte or two: no arithmetic bound.
//
// Design. The layout (core/graph.py) pairs every real edge with its
// reverse, so the real in-edges of a vertex v are exactly the reverses of
// its real out-edges: for each real in-edge e_in of v,
//   pre[rev(e_in)] = state_mask[v] ? (log_psi_v[v] + vsum[v]) - logm[e_in]
//                                  : NEG_INF.
// One pass over the vertices therefore does the whole prelude: lanes of v
// load its in-edge rows once, fold them into vsum in registers, and write
// every out-edge's row from the same registers; vsum is never stored.
//   * Lanes per vertex follow S: each lane moves VEC floats at a time
//     (16-byte loads where S and the pointers allow, else 8 or 4 bytes),
//     and next_pow2(S / VEC) lanes share a row, at most 32, looping over
//     wider rows: four lanes a row at S = 16 (a warp covers 8 vertices),
//     one at S = 2. The first CACHED in-edge rows stay in registers; a
//     wider table's further rows are read again for their writes.
//   * The fold is fold_in_edges' exactly: column 0 (or 0.0 where it is
//     masked), then acc + (mask ? logm : 0.0f) column by column. The
//     + 0.0f on masked columns turns -0.0 into 0.0 as the torch fold does;
//     IEEE forbids dropping it without fast math, which the build leaves
//     off.
//   * Padded edges (edge_mask false) are in no in-edge table, so the walk
//     never reaches their rows: blocks after the vertex blocks scan
//     edge_mask, four edges a thread, and compute each padded row the
//     plain way, folding its source's in-edge table in the same order.
//     Every row of pre is written exactly once, in one launch.
// The int32 index tables are read as they are; nothing is widened.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;
constexpr int kEdgesPerThread = 4;
constexpr int kMaxLanesLog2 = 5;

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_mask(const uint8_t* p, bool (&m)[VEC]) {
  if constexpr (VEC == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    m[0] = t.x != 0;
    m[1] = t.y != 0;
    m[2] = t.z != 0;
    m[3] = t.w != 0;
  } else if constexpr (VEC == 2) {
    const uchar2 t = *reinterpret_cast<const uchar2*>(p);
    m[0] = t.x != 0;
    m[1] = t.y != 0;
  } else {
    m[0] = p[0] != 0;
  }
}

// Every out-edge row of vertex v, from its in-edge rows (lane `lane` of
// `lanes` takes columns lane*VEC, (lane + lanes)*VEC, ...).
template <int VEC, int CACHED>
__device__ __forceinline__ void vertex_rows(
    const float* __restrict__ logm, const float* __restrict__ log_psi_v,
    const uint8_t* __restrict__ state_mask,
    const int32_t* __restrict__ in_edges, const uint8_t* __restrict__ in_mask,
    const int32_t* __restrict__ edge_rev, float* __restrict__ pre,
    long long v, int lane, int lanes, int s, int d) {
  const int32_t* ie = in_edges + v * d;
  const uint8_t* im = in_mask + v * d;
  bool ok[CACHED];
  long long row[CACHED];   // in-edge rows' offsets in logm
  long long out[CACHED];   // their reverses' rows in pre
  bool any = false;
#pragma unroll
  for (int k = 0; k < CACHED; ++k) {
    ok[k] = k < d && im[k] != 0;
    const int32_t e = ok[k] ? __ldg(ie + k) : 0;
    row[k] = static_cast<long long>(e) * s;
    out[k] = ok[k] ? static_cast<long long>(__ldg(edge_rev + e)) * s : 0;
    any = any || ok[k];
  }
  for (int k = CACHED; k < d && !any; ++k) any = im[k] != 0;
  if (!any) return;   // a padding or dummy vertex: no row is its to write

  const long long vrow = v * s;
  const int chunks = s / VEC;
  for (int c = lane; c < chunks; c += lanes) {
    const int col = c * VEC;
    float rows[CACHED][VEC];
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < CACHED; ++k) {
      if (k < d) {
        if (ok[k]) {
          load_row<VEC>(logm + row[k] + col, rows[k]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) rows[k][j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = k == 0 ? rows[k][j] : acc[j] + rows[k][j];
      }
    }
    for (int k = CACHED; k < d; ++k) {
      float x[VEC];
      if (im[k] != 0) {
        load_row<VEC>(logm + static_cast<long long>(__ldg(ie + k)) * s + col,
                      x);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = acc[j] + x[j];
    }
    float base[VEC];
    bool valid[VEC];
    load_row<VEC>(log_psi_v + vrow + col, base);
    load_mask<VEC>(state_mask + vrow + col, valid);
#pragma unroll
    for (int j = 0; j < VEC; ++j) base[j] = base[j] + acc[j];
#pragma unroll
    for (int k = 0; k < CACHED; ++k) {
      if (ok[k]) {
        float y[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          y[j] = valid[j] ? base[j] - rows[k][j] : kNegInf;
        store_row<VEC>(pre + out[k] + col, y);
      }
    }
    for (int k = CACHED; k < d; ++k) {
      if (im[k] == 0) continue;
      const int32_t e = __ldg(ie + k);
      float x[VEC], y[VEC];
      load_row<VEC>(logm + static_cast<long long>(e) * s + col, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        y[j] = valid[j] ? base[j] - x[j] : kNegInf;
      store_row<VEC>(pre + static_cast<long long>(__ldg(edge_rev + e)) * s
                         + col, y);
    }
  }
}

// The row of padded edge e, the plain way: its source's in-edge table
// folded in the same order, then the same add, subtract and select.
__device__ void padded_row(
    const float* __restrict__ logm, const float* __restrict__ log_psi_v,
    const uint8_t* __restrict__ state_mask,
    const int32_t* __restrict__ in_edges, const uint8_t* __restrict__ in_mask,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ edge_rev,
    float* __restrict__ pre, long long e, int s, int d) {
  const long long u = __ldg(edge_src + e);
  const long long r = __ldg(edge_rev + e);
  const int32_t* ie = in_edges + u * d;
  const uint8_t* im = in_mask + u * d;
  for (int j = 0; j < s; ++j) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float x = im[k] != 0
          ? __ldg(logm + static_cast<long long>(__ldg(ie + k)) * s + j)
          : 0.0f;
      acc = k == 0 ? x : acc + x;
    }
    const float b = __ldg(log_psi_v + u * s + j) + acc;
    pre[e * s + j] = state_mask[u * s + j] != 0
        ? b - __ldg(logm + r * s + j) : kNegInf;
  }
}

template <int VEC, int CACHED>
__global__ void __launch_bounds__(kThreads)
edge_prelude_kernel(const float* __restrict__ logm,
                    const float* __restrict__ log_psi_v,
                    const uint8_t* __restrict__ state_mask,
                    const int32_t* __restrict__ in_edges,
                    const uint8_t* __restrict__ in_mask,
                    const int32_t* __restrict__ edge_src,
                    const int32_t* __restrict__ edge_rev,
                    const uint8_t* __restrict__ edge_mask,
                    float* __restrict__ pre, long long n_vertices,
                    long long n_edges, int s, int d, int lanes_log2,
                    long long vertex_blocks) {
  const long long b = blockIdx.x;
  if (b < vertex_blocks) {
    const long long t = b * kThreads + threadIdx.x;
    const long long v = t >> lanes_log2;
    if (v >= n_vertices) return;
    const int lanes = 1 << lanes_log2;
    const int lane = static_cast<int>(t) & (lanes - 1);
    vertex_rows<VEC, CACHED>(logm, log_psi_v, state_mask, in_edges, in_mask,
                             edge_rev, pre, v, lane, lanes, s, d);
    return;
  }
  const long long first =
      ((b - vertex_blocks) * kThreads + threadIdx.x) * kEdgesPerThread;
#pragma unroll
  for (int k = 0; k < kEdgesPerThread; ++k) {
    const long long e = first + k;
    if (e < n_edges && edge_mask[e] == 0)
      padded_row(logm, log_psi_v, state_mask, in_edges, in_mask, edge_src,
                 edge_rev, pre, e, s, d);
  }
}

template <int VEC, int CACHED>
int launch(unsigned grid, cudaStream_t st, const float* logm,
           const float* log_psi_v, const uint8_t* state_mask,
           const int32_t* in_edges, const uint8_t* in_mask,
           const int32_t* edge_src, const int32_t* edge_rev,
           const uint8_t* edge_mask, float* pre, long long n_vertices,
           long long n_edges, int s, int d, int lanes_log2,
           long long vertex_blocks) {
  edge_prelude_kernel<VEC, CACHED><<<grid, kThreads, 0, st>>>(
      logm, log_psi_v, state_mask, in_edges, in_mask, edge_src, edge_rev,
      edge_mask, pre, n_vertices, n_edges, s, d, lanes_log2, vertex_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// logm and pre are (E, S) float32, log_psi_v (V, S) float32, state_mask
// (V, S) bool, in_edges (V, D) int32, in_mask (V, D) bool, edge_src and
// edge_rev (E,) int32, edge_mask (E,) bool, all contiguous. vec (1, 2 or
// 4 floats a load, dividing S) and lanes_log2 (lanes a vertex row, as a
// power of two up to 32) are edge_prelude.plan_prelude's; a plan that does
// not fit is refused with cudaErrorInvalidValue. Nothing to do launches
// nothing.
int edge_prelude_launch(const float* logm, const float* log_psi_v,
                        const uint8_t* state_mask, const int32_t* in_edges,
                        const uint8_t* in_mask, const int32_t* edge_src,
                        const int32_t* edge_rev, const uint8_t* edge_mask,
                        float* pre, long long n_vertices, long long n_edges,
                        int n_states, int in_width, int vec, int lanes_log2,
                        void* stream) {
  if (n_states < 1 || in_width < 1 || n_vertices < 0 || n_edges < 0 ||
      (vec != 1 && vec != 2 && vec != 4) || n_states % vec != 0 ||
      lanes_log2 < 0 || lanes_log2 > kMaxLanesLog2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vertex_blocks =
      ((n_vertices << lanes_log2) + kThreads - 1) / kThreads;
  const long long edge_threads =
      (n_edges + kEdgesPerThread - 1) / kEdgesPerThread;
  const long long edge_blocks = (edge_threads + kThreads - 1) / kThreads;
  const long long grid = vertex_blocks + edge_blocks;
  if (grid == 0) return static_cast<int>(cudaSuccess);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = vec == 4 ? launch<4, 4> : vec == 2 ? launch<2, 8> : launch<1, 8>;
  return go(static_cast<unsigned>(grid), st, logm, log_psi_v, state_mask,
            in_edges, in_mask, edge_src, edge_rev, edge_mask, pre,
            n_vertices, n_edges, n_states, in_width, lanes_log2,
            vertex_blocks);
}

}  // extern "C"
