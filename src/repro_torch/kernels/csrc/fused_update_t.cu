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
// ridge point (one table per edge, against one vector: no tensor cores).
//
// Design ("staged", S <= 256). A block owns a tile of EB consecutive edges
// (EB >= 8: every row load is at least one 32-byte sector) and walks the
// destination states in chunks of C (C depends on S alone: up to 32). For
// each chunk it stages the (S x C rows, EB edges) slice of the table in
// shared memory with cp.async (16-byte pieces when E % 4 == 0, else 4-byte;
// rows padded by 4 floats, so they stay 16-byte aligned and C lanes of a
// warp fall on different banks), two stages deep, so the next chunk -- or
// the next tile's first chunk, with its pre_t, logm_t and mask rows -- is
// in flight while this one is computed. A persistent grid (the SM count
// times the kernel's occupancy) walks tiles b, b + grid, ... C lanes of a
// warp own one edge: lane c computes candidate xj = chunk*C + c, the max
// over source states, then the shifted exp-sum, both from shared memory
// (from registers for S <= 16), so each table entry is read from device
// memory once and pre_t once per edge. The masked candidates stay in shared
// memory (no write and read-back of out_t). After the last chunk lane c
// takes xj = c, c + C, ... and the lanes meet in xor-shuffle trees of width
// C for the maxima (exact in any order), while lane 0 sums the normalizer
// over xj in order; the block then writes out_t from shared memory,
// coalesced along edges. An edge's order of arithmetic is the walk's --
// xi in order for each xj, xj in order for the normalizer -- so it depends
// on S only, never on E, EB or the edge's place in the launch, and the
// messages are bitwise those of the one-thread-per-edge walk.
// Measured (chip_smoke.py on an H100, PERF.md): at small E (the zoo's and
// the protein MRF's buckets) it is over 20x faster than the one-thread-per-
// edge walk it replaces; at the stereo bucket's shape (E = 1.76 M, S = 16)
// it is slower than the walk: issue-bound, with four barriers and the
// cp.async bookkeeping for every tile of 32 edges.
// Variant "walk" (S > 256, where a chunk of even one state per lane would
// not fit in shared memory): one thread per edge walks its column twice,
// writes its candidates to out_t and reads them back, as before.
// The launch plan (variant, C, EB, copy width, threads, shared
// memory, grid) comes from message_update.plan_t; the launcher checks it.
// `-Xptxas -v` (nvcc 12.8, sm_90a, printed by chip_smoke.py's build phase):
// edge_t_staged_kernel uses 40 registers in both instances (columns in
// registers for S <= 16, and not), the walk 32; no spills, no static shared
// memory; the staged kernel's dynamic shared memory is the plan's
// (message_update.plan_t, at most 200 KB).
// Numerics: build without fast math (no -use_fast_math, no -ftz): 1e-38 is
// below FLT_MIN and must survive, or log() of an all-masked row gives -inf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kTiny = 1.0e-38f;   // subnormal on purpose, as the reference
constexpr int kThreads = 256;
constexpr int kStagedThreads = 512;  // largest block of the staged variant
constexpr int kStagedMaxStates = 256;
constexpr int kStages = 2;       // copies in flight per block, this one too

// ---------------------------------------------------------------- walk --

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


// -------------------------------------------------------------- staged --

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// Shared bytes of the staged variant (mirrored by message_update.plan_t):
// floats for two stages of (S*C, EB + 4) table rows (4 floats of padding
// keep the rows 16-byte aligned and spread the banks) with a pre_t and a
// logm_t buffer of (S, EB) each, and the (S, EB + 1) candidates and
// normalizer terms; then two (S, EB) int8 mask buffers.
__host__ __device__ __forceinline__ long long staged_smem_bytes(
    int s, int c, int eb) {
  return 4LL * (kStages * (1LL * s * c * (eb + 4) + 2LL * s * eb)
                + 2LL * s * (eb + 1))
         + 1LL * kStages * s * eb;
}

// NREG > 0 (S <= NREG): each thread keeps its column's scores in registers
// between the two passes; NREG == 0: both passes read shared memory. The
// arithmetic is the same.
template <int NREG>
__global__ void __launch_bounds__(kStagedThreads, 3)
edge_t_staged_kernel(const float* __restrict__ logpsi_t,
                     const float* __restrict__ pre_t,
                     const float* __restrict__ logm_t,
                     const int8_t* __restrict__ dmask_t,
                     float* __restrict__ out_t, float* __restrict__ resid,
                     long long n_edges, int S, int C, int EB, int vec) {
  extern __shared__ __align__(16) float sm[];
  const long long E = n_edges;
  const int ROW = EB + 4, CROW = EB + 1;
  const int stage_f = S * C * ROW;
  float* stages = sm;                          // 2 x (S*C rows, ROW)
  float* pres = sm + kStages * stage_f;        // 2 x (S, EB) pre_t
  float* lms = pres + kStages * S * EB;        // 2 x (S, EB) logm_t
  float* cand_s = lms + kStages * S * EB;      // (S, CROW)
  float* term_s = cand_s + S * CROW;           // (S, CROW)
  int8_t* msks = reinterpret_cast<int8_t*>(term_s + S * CROW);  // 2 x (S, EB)
  const int tid = threadIdx.x;
  const int c_shift = __ffs(C) - 1;
  // C lanes per edge; the block's threads / C edge slots walk the tile's EB
  // edges in EB / (threads / C) passes.
  const int el0 = tid >> c_shift, c = tid & (C - 1);
  const int le = blockDim.x >> c_shift;
  const int nch = (S + C - 1) / C;
  const long long n_tiles = (E + EB - 1) / EB;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  const long long n_items = my_tiles * nch;

  // Item `it` is chunk it % nch of the block's tile it / nch; its copy
  // goes to stage it % 2, and a first chunk also brings the tile's pre_t,
  // logm_t and mask rows (buffers lt % 2: at most two tiles are in
  // flight). Copy pieces are numbered row by row, EB / vec pieces a row,
  // and thread tid takes pieces tid, tid + threads, ... -- shifts only, as
  // EB, vec and C are powers of two. Mask rows go in 4-byte pieces when
  // E % 4 == 0; otherwise the first chunk's compute loads them.
  const int row_shift = (__ffs(EB) - 1) - (vec == 4 ? 2 : 0);
  const int mrow_shift = __ffs(EB) - 3;        // 4-byte pieces of a mask row
  // The items' tile, chunk and buffers advance by counting, not dividing.
  long long next_lt = 0;                       // the next item to issue
  int next_ch = 0, next_st = 0, next_tb = 0;   // its chunk, stage, tile buf
  auto issue = [&]() {
    const long long e0 = (blockIdx.x + next_lt * gridDim.x) * EB;
    const int live = static_cast<int>(min(static_cast<long long>(EB), E - e0));
    const int xj0 = next_ch * C, cc = min(C, S - xj0);
    float* stage = stages + next_st * stage_f;
    for (int p = tid; p < (S * C) << row_shift; p += blockDim.x) {
      const int row = p >> row_shift;          // xi * C + cl
      const int piece = (p & ((1 << row_shift) - 1)) * vec;
      const int xi = row >> c_shift, cl = row & (C - 1);
      if (cl < cc && piece < live)
        cp_async(stage + row * ROW + piece,
                 logpsi_t + static_cast<long long>(xi * S + xj0 + cl) * E
                     + e0 + piece, vec);
    }
    if (next_ch == 0) {
      const int b = next_tb * S * EB;
      for (int p = tid; p < S << row_shift; p += blockDim.x) {
        const int x = p >> row_shift;
        const int piece = (p & ((1 << row_shift) - 1)) * vec;
        if (piece < live) {
          cp_async(pres + b + x * EB + piece, pre_t + x * E + e0 + piece, vec);
          cp_async(lms + b + x * EB + piece, logm_t + x * E + e0 + piece,
                   vec);
        }
      }
      if (vec == 4)
        for (int p = tid; p < S << mrow_shift; p += blockDim.x) {
          const int x = p >> mrow_shift;
          const int piece = (p & ((1 << mrow_shift) - 1)) * 4;
          if (piece < live)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(static_cast<uint32_t>(
                                __cvta_generic_to_shared(
                                    msks + b + x * EB + piece))),
                            "l"(dmask_t + x * E + e0 + piece)
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    next_st ^= 1;
    if (++next_ch == nch) {
      next_ch = 0;
      ++next_lt;
      next_tb ^= 1;
    }
  };

  if (n_items > 0) issue();
  long long lt = 0;                            // this item's tile, chunk,
  int ch = 0, cur_st = 0, cur_tb = 0;          // stage and tile buffer
  for (long long it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {                    // the next item, other stage
      issue();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const long long e0 = (blockIdx.x + lt * gridDim.x) * EB;
    const int live = static_cast<int>(min(static_cast<long long>(EB), E - e0));
    const int b = cur_tb * S * EB;
    const int8_t* msk = msks + b;
    if (vec == 1 && ch == 0)                    // mask rows not 4-aligned
      for (int p = tid; p < S * EB; p += blockDim.x)
        if (p % EB < live) msks[b + p] = __ldg(dmask_t + (p / EB) * E + e0
                                               + p % EB);
    __syncthreads();

    // Candidate xj = ch*C + c of edge el: the max over source states, then
    // the shifted exp-sum, in order over xi.
    const int xj = ch * C + c;
    for (int el = el0; el < EB; el += le) {
    if (el < live && xj < S) {
      const float* col = stages + cur_st * stage_f + c * ROW + el;
      const float* pre_s = pres + b + el;
      const int stride = C * ROW;
      float m = -__int_as_float(0x7f800000);    // -inf
      float s = 0.0f;
      if (NREG > 0) {
        float x[NREG > 0 ? NREG : 1];
#pragma unroll
        for (int i = 0; i < NREG; ++i)
          if (i < S) {
            x[i] = col[i * stride] + pre_s[i * EB];
            m = fmaxf(m, x[i]);
          }
        m = fmaxf(m, kNegInf);
#pragma unroll
        for (int i = 0; i < NREG; ++i)
          if (i < S) s += expf(x[i] - m);
      } else {
#pragma unroll 4
        for (int i = 0; i < S; ++i)
          m = fmaxf(m, col[i * stride] + pre_s[i * EB]);
        m = fmaxf(m, kNegInf);
#pragma unroll 4
        for (int i = 0; i < S; ++i)
          s += expf(col[i * stride] + pre_s[i * EB] - m);
      }
      const float cv = m + logf(fmaxf(s, kTiny));
      cand_s[xj * CROW + el] = msk[xj * EB + el] != 0 ? cv : kNegInf;
    }
    }
    if (ch == nch - 1) {
      // The tile's epilogue. The C lanes of edge el (one warp segment) take
      // the states xj = c, c + C, ... and meet in xor-shuffle trees of width
      // C for the maxima (exact in any order); lane 0 sums the normalizer
      // over xj in order, as the walk does, so the messages are bitwise the
      // walk's.
      __syncthreads();
      const float* lm_s = lms + b;
      for (int el = el0; el < EB; el += le) {   // same count in every lane
      const bool act = el < live;
      float zm = kNegInf;
      for (int j = c; j < S; j += C) zm = fmaxf(zm, cand_s[j * CROW + el]);
      for (int o = C >> 1; o > 0; o >>= 1)
        zm = fmaxf(zm, __shfl_xor_sync(0xffffffffu, zm, o, C));
      // The normalizer's terms in parallel, then their sum in order over
      // xj by lane 0 (a masked state's term is +0.0, which leaves the sum
      // unchanged, as skipping it does).
      for (int j = c; j < S; j += C)
        term_s[j * CROW + el] =
            msk[j * EB + el] ? expf(cand_s[j * CROW + el] - zm) : 0.0f;
      __syncwarp();
      float zs = 0.0f;
      if (c == 0) {
#pragma unroll 8
        for (int j = 0; j < S; ++j) zs += term_s[j * CROW + el];
      }
      zs = __shfl_sync(0xffffffffu, zs, 0, C);
      const float z = zm + logf(fmaxf(zs, kTiny));
      float r = 0.0f;
      for (int j = c; j < S; j += C) {
        const bool valid = msk[j * EB + el] != 0;
        const float v = valid ? cand_s[j * CROW + el] - z : kNegInf;
        cand_s[j * CROW + el] = v;             // the message, in place
        if (valid) r = fmaxf(r, fabsf(v - lm_s[j * EB + el]));
      }
      for (int o = C >> 1; o > 0; o >>= 1)
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o, C));
      if (c == 0 && act) resid[e0 + el] = r;
      }
      __syncthreads();
      // out_t rows, consecutive edges on consecutive threads (coalesced).
      const int eb_shift = __ffs(EB) - 1;
      for (int p = tid; p < S * EB; p += blockDim.x) {
        const int j = p >> eb_shift, q = p & (EB - 1);
        if (q < live) out_t[j * E + e0 + q] = cand_s[j * CROW + q];
      }
    }
    __syncthreads();                            // stage, buffers reusable
    cur_st ^= 1;
    if (++ch == nch) {
      ch = 0;
      ++lt;
      cur_tb ^= 1;
    }
  }
}

constexpr int kRegStates = 16;   // S up to this keeps columns in registers

// The plan's shape, as message_update.plan_t makes it.
bool staged_plan_ok(int s, int c, int eb, int vec, int threads, int smem,
                    int grid, long long n_edges) {
  return s >= 1 && s <= kStagedMaxStates && c >= 1 && c <= s &&
         (c & (c - 1)) == 0 && eb >= 8 && (eb & (eb - 1)) == 0 &&
         threads % c == 0 && eb % (threads / c) == 0 && threads >= 32 &&
         threads <= kStagedThreads && (vec == 1 || vec == 4) &&
         (vec == 1 || n_edges % 4 == 0) && grid >= 1 &&
         smem >= staged_smem_bytes(s, c, eb) && smem <= 232448;
}

template <int NREG>
int staged_occupancy(int threads, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(edge_t_staged_kernel<NREG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, edge_t_staged_kernel<NREG>, threads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int NREG>
cudaError_t launch_staged(int grid, int threads, int smem, cudaStream_t st,
                          const float* logpsi_t, const float* pre_t,
                          const float* logm_t, const int8_t* dmask_t,
                          float* out_t, float* resid, long long n, int s,
                          int c, int eb, int vec) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_t_staged_kernel<NREG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  edge_t_staged_kernel<NREG><<<grid, threads, smem, st>>>(
      logpsi_t, pre_t, logm_t, dmask_t, out_t, resid, n, s, c, eb, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident blocks per SM of the staged kernel for this block size and
// shared memory (the plan's grid is this times the SM count); -1 when the
// query fails.
int fused_update_t_occupancy(int n_states, int threads, int smem) {
  return n_states <= kRegStates ? staged_occupancy<kRegStates>(threads, smem)
                                : staged_occupancy<0>(threads, smem);
}


// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// n_edges == 0 launches nothing. variant (0 = "walk", 1 = "staged"),
// xj_chunk, tile_edges, vec, threads, smem and grid are the launch plan of
// message_update.plan_t; a plan that does not fit is refused with
// cudaErrorInvalidValue.
int fused_update_t_launch(const float* logpsi_t, const float* pre_t,
                          const float* logm_t, const int8_t* dmask_t,
                          float* out_t, float* resid, long long n_edges,
                          int n_states, int variant, int xj_chunk,
                          int tile_edges, int vec, int threads, int smem,
                          int grid, void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaSuccess);
  if (n_states < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant != (n_states <= kStagedMaxStates ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_edges + kThreads - 1) / kThreads);
    edge_t_kernel<<<blocks, kThreads, 0, st>>>(
        logpsi_t, pre_t, logm_t, dmask_t, out_t, resid, n_edges, n_states);
    return static_cast<int>(cudaGetLastError());
  }
  if (!staged_plan_ok(n_states, xj_chunk, tile_edges, vec, threads, smem,
                      grid, n_edges))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = n_states <= kRegStates ? launch_staged<kRegStates>
                                    : launch_staged<0>;
  return static_cast<int>(go(grid, threads, smem, st, logpsi_t, pre_t, logm_t,
                             dmask_t, out_t, resid, n_edges, n_states,
                             xj_chunk, tile_edges, vec));
}

}  // extern "C"
