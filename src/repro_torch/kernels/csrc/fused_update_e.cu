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
// card's ridge point, so tensor cores would not help: each table is used
// by one edge against one vector.
//
// Design. No state padding: S is any count from 1 to kMaxStates and the
// kernel masks its own ragged edge (Triton tiles are powers of two, so the
// reference padded S = 81 to 128). No edge padding either. The launch plan
// (variant, lanes per edge, xi split, edges per tile, threads, shared
// memory, grid) is computed by the wrapper, triton_update.plan_e, and
// passed in; the launcher checks it.
//   * S <= 8 ("thread"): one thread owns one edge, S is a template
//     parameter and the edge's rows live in registers. Neighbouring threads
//     own neighbouring edges, so a warp's loads walk contiguous memory.
//   * S > 8 ("tile"): the tables of a tile of consecutive edges -- one
//     contiguous run of T*S^2*4 bytes -- are staged in shared memory by a
//     TMA bulk copy (cp.async.bulk completing on an mbarrier), two stages:
//     a persistent block (the grid is the SM count times the kernel's
//     occupancy) walks tiles b, b + grid, ... and copies the next tile
//     while it computes this one; the tile's pre rows come by 4-byte
//     cp.async in the same step, and the mask and message bytes the
//     normalizing lanes need are loaded before the passes, so no load waits
//     in the loop. Each table byte is read from device memory once; both
//     passes of the two-pass LSE (max over xi, then the shifted exp-sum)
//     read shared memory (registers for S <= 32). Bulk copies need 16-byte
//     addresses and sizes, and S^2*4 is not a multiple of 16 for odd S: the
//     aligned body of a tile goes by TMA, its ragged head and tail (at most
//     3 floats each) by cp.async, and the shared buffer is shifted by the
//     tile's start mod 16 so that both sides stay aligned.
//     - S in 9..32: next_pow2(S) lanes per edge (lane j owns xj = j), 256/
//       lanes edges per tile, several edges per warp; the normalizer and
//       residual are width-limited shuffle reductions. No idle half-warps.
//     - S in 33..128: one edge per 128-thread block tile. Lane j of warp k
//       owns xj = j, j+32, ... over the source states of part k of 4; the
//       parts' maxima and then their sums are combined in shared memory in
//       the order k = 0..3, and warp 0 normalizes. Small E (1,024 edges at
//       S = 81) still puts 4 warps and a 26 KB copy in flight per edge.
//     An edge's order of arithmetic depends on S and the semiring only --
//     never on E or on where the edge sits in the launch -- so a graph's
//     edges give bitwise the same output alone or inside a bucket's fold.
//     Every table entry is read, masked source states too.
// `-Xptxas -v` (nvcc 12.8, sm_90a, printed by chip_smoke.py's build phase):
// edge_tile_kernel uses 32 registers (max, S <= 32), 64 (sum, S <= 32),
// 64 (max, S > 32) and 61 (sum, S > 32), no spills, no static shared
// memory; its dynamic shared memory is the plan's (triton_update.plan_e:
// 11-68 KB for S = 9..32, 9-134 KB for S = 33..128).
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

// ------------------------------------------------------------ tile/edge --

constexpr int kTileThreads = 256;   // largest block of the tile variant
constexpr int kStages = 2;
constexpr int kBarrierBytes = 16;   // two 8-byte mbarriers, one per stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// A tile's table run: floats [f0, f0 + n) of logpsi. The aligned body
// [f0 + head, f0 + head + body) goes by bulk copy; head and tail (< 4 floats
// each) by ordinary loads. In shared memory float f0 + i sits at
// stage[shift + i], shift = f0 mod 4, so both ends of the copy are 16-byte
// aligned (the table's base is; the wrapper checks).
struct TileRun {
  long long f0;
  int n, shift, head, body, tail;
};

__device__ __forceinline__ TileRun tile_run(long long e0, int live, int s2) {
  TileRun r;
  r.f0 = e0 * s2;
  r.n = live * s2;
  r.shift = static_cast<int>(r.f0 & 3);
  r.head = min((4 - r.shift) & 3, r.n);
  r.body = ((r.n - r.head) >> 2) << 2;
  r.tail = r.n - r.head - r.body;
  return r;
}

// One thread: arm the stage's barrier with the body's bytes and start the
// bulk copy. The fence orders the block's earlier generic-proxy accesses of
// this buffer before the async proxy's writes.
__device__ __forceinline__ void issue_bulk(const float* logpsi, float* stage,
                                           uint64_t* bar, const TileRun& r) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive_expect_tx(bar, static_cast<uint32_t>(r.body) * 4u);
  if (r.body > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage + r.shift + r.head)),
           "l"(logpsi + r.f0 + r.head),
           "r"(static_cast<uint32_t>(r.body) * 4u), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Floats of one stage buffer: the largest tile's run, 3 floats of shift,
// rounded up to 16 bytes (mirrored by triton_update.plan_e).
__host__ __device__ __forceinline__ int stage_floats(int s, int tile_edges) {
  return ((tile_edges * s * s + 3 + 3) >> 2) << 2;
}

// Barriers, two table stages, two pre stages, and the parts' partials.
__host__ __device__ __forceinline__ long long tile_smem_bytes(
    int s, int tile_edges, int xi_split) {
  return kBarrierBytes + 4LL * (kStages * stage_floats(s, tile_edges)
                                + kStages * tile_edges * s
                                + (xi_split > 1 ? xi_split * s : 0));
}

// PER_LANE: destination states a lane owns, 1 for S <= 32 (lanes >= S),
// 4 for S in 33..128 (32 lanes).
template <int SEMI, int PER_LANE>
__global__ void __launch_bounds__(kTileThreads)
edge_tile_kernel(const float* __restrict__ logpsi,
                 const float* __restrict__ pre,
                 const float* __restrict__ logm,
                 const int8_t* __restrict__ dmask,
                 float* __restrict__ out, float* __restrict__ resid,
                 long long n_edges, int S, int lanes, int xi_split,
                 int tile_edges) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s2 = S * S;
  const int sf = stage_floats(S, tile_edges);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* stages = reinterpret_cast<float*>(smem + kBarrierBytes);
  float* pres = stages + kStages * sf;         // 2 x (tile_edges, S)
  float* red = pres + kStages * tile_edges * S;   // (xi_split, S) partials

  const int tid = threadIdx.x;
  const int per_edge = lanes * xi_split;
  const int g = tid / per_edge;                // edge slot in the tile
  const int k = (tid % per_edge) / lanes;      // part of the source states
  const int j = tid % lanes;                   // first owned xj
  const int part = (S + xi_split - 1) / xi_split;
  const int i0 = k * part, i1 = min(S, i0 + part);
  const long long n_tiles = (n_edges + tile_edges - 1) / tile_edges;

  if (tid == 0) {
    mbar_init(&bar[0], 1);   // one arrival: the thread that issues
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto live_of = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(tile_edges),
                                n_edges - tile * tile_edges));
  };
  // Stage `st` gets tile `tile`: the table's body by one bulk copy, its
  // ragged ends and the tile's pre rows by 4-byte cp.async, one group.
  auto issue = [&](long long tile, int st) {
    const long long e0 = tile * tile_edges;
    const int live = live_of(tile);
    const TileRun r = tile_run(e0, live, s2);
    float* stage = stages + st * sf;
    if (tid == 0) issue_bulk(logpsi, stage, &bar[st], r);
    if (tid < r.head) {
      cp_async4(stage + r.shift + tid, logpsi + r.f0 + tid);
    } else if (tid < r.head + r.tail) {
      const int i = r.head + r.body + (tid - r.head);
      cp_async4(stage + r.shift + i, logpsi + r.f0 + i);
    }
    float* pre_s = pres + st * tile_edges * S;
    for (int x = tid; x < live * S; x += blockDim.x)
      cp_async4(pre_s + x, pre + e0 * S + x);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  long long t = blockIdx.x;
  if (t < n_tiles) issue(t, 0);
  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    const long long tn = t + gridDim.x;
    if (tn < n_tiles) {                       // next tile, other stage
      issue(tn, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const long long e0 = t * tile_edges;
    const long long e = e0 + g;
    const int live = live_of(t);
    const bool edge_live = g < live;
    // The normalizing lanes load their mask and messages now, so the
    // loads are in flight while the passes run.
    int8_t dm[PER_LANE];
    float lm[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int xj = j + q * lanes;
      const bool mine = k == 0 && edge_live && xj < S;
      dm[q] = mine ? __ldg(dmask + e * S + xj) : int8_t(0);
      lm[q] = mine ? __ldg(logm + e * S + xj) : 0.0f;
    }
    mbar_wait(&bar[st], static_cast<uint32_t>((it >> 1) & 1));
    __syncthreads();

    const TileRun r = tile_run(e0, live, s2);
    const float* psi = stages + st * sf + r.shift + g * s2;
    const float* pg = pres + st * tile_edges * S + g * S;

    // Pass 1: max over this part's source states, per owned xj. With one
    // xj a lane (S <= 32) the lane keeps its column's scores in registers
    // for pass 2; the arithmetic is the same either way.
    float m[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) m[q] = -__int_as_float(0x7f800000);
    float x[PER_LANE == 1 ? 32 : 1];
    if (PER_LANE == 1) {
      if (edge_live && j < S) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (i < S) {
            x[i] = psi[i * S + j] + pg[i];
            m[0] = fmaxf(m[0], x[i]);
          }
      }
    } else if (edge_live) {
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float pi = pg[i];
        const float* row = psi + i * S;
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
          const int xj = j + q * lanes;
          if (xj < S) m[q] = fmaxf(m[q], row[xj] + pi);
        }
      }
    }
    if (xi_split > 1) {                      // parts' maxima, k = 0..K-1
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const int xj = j + q * lanes;
        if (xj < S) red[k * S + xj] = m[q];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const int xj = j + q * lanes;
        if (xj < S) {
          float v = red[xj];
          for (int kk = 1; kk < xi_split; ++kk) v = fmaxf(v, red[kk * S + xj]);
          m[q] = v;
        }
      }
      __syncthreads();
    }

    float cand[PER_LANE];
    if (SEMI == kMax) {
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) cand[q] = m[q];
    } else {
      // Pass 2: shifted exp-sum, again from shared memory.
      float s[PER_LANE];
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        m[q] = fmaxf(m[q], kNegInf);
        s[q] = 0.0f;
      }
      if (PER_LANE == 1) {
        if (edge_live && j < S) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (i < S) s[0] += expf(x[i] - m[0]);
        }
      } else if (edge_live) {
#pragma unroll 4
        for (int i = i0; i < i1; ++i) {
          const float pi = pg[i];
          const float* row = psi + i * S;
#pragma unroll
          for (int q = 0; q < PER_LANE; ++q) {
            const int xj = j + q * lanes;
            if (xj < S) s[q] += expf(row[xj] + pi - m[q]);
          }
        }
      }
      if (xi_split > 1) {                    // parts' sums, k = 0..K-1
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
          const int xj = j + q * lanes;
          if (xj < S) red[k * S + xj] = s[q];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
          const int xj = j + q * lanes;
          if (xj < S) {
            float v = red[xj];
            for (int kk = 1; kk < xi_split; ++kk) v += red[kk * S + xj];
            s[q] = v;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q)
        cand[q] = m[q] + logf(fmaxf(s[q], kTiny));
    }

    if (k == 0) {   // the edge's part-0 lanes normalize (a width-`lanes`
                    // group: a warp segment, or warp 0 when xi_split > 1)
      bool valid[PER_LANE];
      float zm = kNegInf;
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        valid[q] = dm[q] != 0;
        cand[q] = valid[q] ? cand[q] : kNegInf;
        zm = fmaxf(zm, cand[q]);
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        zm = fmaxf(zm, __shfl_xor_sync(0xffffffffu, zm, o, lanes));
      float z = zm;
      if (SEMI == kSum) {
        float zs = 0.0f;
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q)
          zs += valid[q] ? expf(cand[q] - zm) : 0.0f;
        for (int o = lanes >> 1; o > 0; o >>= 1)
          zs += __shfl_xor_sync(0xffffffffu, zs, o, lanes);
        z = zm + logf(fmaxf(zs, kTiny));
      }
      float rr = 0.0f;
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const int xj = j + q * lanes;
        if (edge_live && xj < S) {
          const float v = valid[q] ? cand[q] - z : kNegInf;
          out[e * S + xj] = v;
          if (valid[q]) rr = fmaxf(rr, fabsf(v - lm[q]));
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        rr = fmaxf(rr, __shfl_xor_sync(0xffffffffu, rr, o, lanes));
      if (edge_live && j == 0) resid[e] = rr;
    }
    // Every thread orders its generic accesses of this stage before the
    // async proxy's next bulk write into it; then the buffers are free.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

template <int SEMI, int PER_LANE>
cudaError_t launch_tile(dim3 grid, int threads, int smem, cudaStream_t st,
                        const float* logpsi, const float* pre,
                        const float* logm, const int8_t* dmask, float* out,
                        float* resid, long long n, int s, int lanes,
                        int xi_split, int tile_edges) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_tile_kernel<SEMI, PER_LANE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  edge_tile_kernel<SEMI, PER_LANE><<<grid, threads, smem, st>>>(
      logpsi, pre, logm, dmask, out, resid, n, s, lanes, xi_split,
      tile_edges);
  return cudaGetLastError();
}

template <int SEMI, int PER_LANE>
int tile_occupancy(int threads, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(edge_tile_kernel<SEMI, PER_LANE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, edge_tile_kernel<SEMI, PER_LANE>, threads, smem)
      != cudaSuccess)
    return -1;
  return blocks;
}

// The plan's shape for S > 8, as triton_update.plan_e makes it.
bool tile_plan_ok(int s, int lanes, int xi_split, int tile_edges,
                  int threads, int smem, int grid) {
  const int per_edge = lanes * xi_split;
  const bool wide = s > 32;
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
         lanes * (wide ? kPerLane : 1) >= s && xi_split >= 1 &&
         xi_split <= s && (wide == (lanes == 32 && xi_split > 1)) &&
         tile_edges >= 1 && threads == tile_edges * per_edge &&
         threads <= kTileThreads && (per_edge <= 32 || tile_edges == 1) &&
         grid >= 1 && smem >= tile_smem_bytes(s, tile_edges, xi_split) &&
         smem <= 232448;
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
// variant, lanes, xi_split, tile_edges, threads, smem and grid are the
// launch plan of triton_update.plan_e (variant 0 = "thread" for S <= 8,
// 1 = "tile" for S > 8); a plan that does not fit S is refused with
// cudaErrorInvalidValue.
int fused_update_e_launch(const float* logpsi, const float* pre,
                          const float* logm, const int8_t* dmask, float* out,
                          float* resid, long long n_edges, int n_states,
                          int semiring, int variant, int lanes, int xi_split,
                          int tile_edges, int threads, int smem, int grid,
                          void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaSuccess);
  if (n_states < 1 || n_states > kMaxStates || (semiring != kSum &&
                                                semiring != kMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant != (n_states <= 8 ? 0 : 1))
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
    if (!tile_plan_ok(n_states, lanes, xi_split, tile_edges, threads, smem,
                      grid))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool wide = n_states > 32;
    auto go = semiring == kSum
                  ? (wide ? launch_tile<kSum, kPerLane> : launch_tile<kSum, 1>)
                  : (wide ? launch_tile<kMax, kPerLane> : launch_tile<kMax, 1>);
    return static_cast<int>(go(dim3(grid), threads, smem, st, logpsi, pre,
                               logm, dmask, out, resid, n_edges, n_states,
                               lanes, xi_split, tile_edges));
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the S > 8 kernel for this state count,
// semiring, block size and shared memory (the plan's grid is this times
// the SM count); -1 when the query fails.
int fused_update_e_occupancy(int n_states, int semiring, int threads,
                             int smem) {
  const bool wide = n_states > 32;
  if (semiring == kSum)
    return wide ? tile_occupancy<kSum, kPerLane>(threads, smem)
                : tile_occupancy<kSum, 1>(threads, smem);
  return wide ? tile_occupancy<kMax, kPerLane>(threads, smem)
              : tile_occupancy<kMax, 1>(threads, smem);
}

}  // extern "C"
