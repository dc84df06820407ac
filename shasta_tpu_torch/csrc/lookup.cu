// sorted_lookup: left binary search of query keys in an ascending key table.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/window_conv.py
// `_lookup_kernel` (launched by `_lookup_call`, wrapped by `windowed_lookup`
// and `windowed_lookup_triple`), which walks per-tap cursors through
// VMEM-resident widened key windows, hops when a tile's span outgrows its
// window, carries positions in f32 and flags an XLA fallback on overflow.
// On Hopper the whole key table (at most 480k x 4 bytes for a key table,
// 3.84M x 4 bytes for the down1 compaction count table) is read from L2:
// exact for every input, positions exact in int32, no windows or flags.
//
// For each probe q:
//   pos = lower_bound(keys, q); out = (keys[pos] == q && q != SENTINEL)
//                                     ? (perm ? perm[pos] : pos) : V
// which is `_xla_lookup` (window_conv.py:382-390): the first occurrence of a
// duplicate key wins. Triple mode probes c-1, c, c+1 for each centre c (a
// SENTINEL centre misses on all three; a probe outside int32 or equal to
// SENTINEL misses) and writes them in (g, dx) raster order. Identity mode
// (perm null) returns the table position itself.
//
// Bound on the H100: bytes (the queries read, the results written, the
// table read once). What held the first version (one thread per query, a
// full binary search each, three in triple mode) back was latency: ~22
// dependent L2 loads per search. This design cuts the dependent loads and
// the sectors each search touches:
// - A task is 64 consecutive rows of one query column, two per lane, run by
//   one warp with the searches of sorted_search.cuh (a 32-ary warp search
//   for the task's smallest probe, 128 keys staged in shared memory from
//   there, one search per triple). The callers' rows come in key order
//   (voxels key-sorted, strided outputs ascending, identity slots
//   1..max_out), so a task's probes are close together and usually all
//   finish among the staged keys.
// - A block holds the tasks of 64*R rows and gc <= GCMAX columns, one warp
//   each (R*gc <= 8, or R = 1 at 9 columns), reads its query tile and
//   writes its result tile through shared memory, coalesced.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace {

using namespace ssearch;

constexpr int GCMAX = 9;                   // query columns per block
constexpr int MAX_WARPS = GCMAX;           // one task each
constexpr int Q_INTS = TASK_ROWS * MAX_WARPS;  // query tile: TASK_ROWS*R rows x gc
constexpr int OUT_INTS = 3 * Q_INTS;       // result tile: TASK_ROWS*R rows x gc*D

// Block: rows [r0, r0 + TASK_ROWS*R) x columns [g0, g0 + gc) of the (M, G)
// queries; warp w takes column w % GC (none when it lies past gc, in the
// last column block) of row group w / GC, lane l its rows l and 32 + l.
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
sorted_lookup_kernel(const int* __restrict__ keys, const int* __restrict__ perm,
                     const int* __restrict__ q, int* __restrict__ out, int V,
                     long long M, int G, int GC, int R) {
  __shared__ int q_s[Q_INTS];
  __shared__ int out_s[OUT_INTS];
  __shared__ int stage_s[MAX_WARPS][STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nt = blockDim.x;
  const long long r0 = (long long)blockIdx.x * TASK_ROWS * R;
  const int g0 = blockIdx.y * GC, gc = min(GC, G - g0), w = gc * D;
  const int rows = (int)min((long long)TASK_ROWS * R, M - r0);
  for (int e = threadIdx.x; e < rows * gc; e += nt) {
    const int r = e / gc;
    q_s[e] = __ldg(q + (r0 + r) * G + g0 + e - r * gc);
  }
  __syncthreads();
  const int c = warp % GC, rg = (warp / GC) * TASK_ROWS + lane;
  if (c < gc) {  // warp-uniform
    int x[PER_LANE], res[PER_LANE][D];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int r = rg + 32 * t;
      x[t] = r < rows ? q_s[r * gc + c] : INT_MAX;
    }
    lookup_warp<D>(keys, perm, V, x, stage_s[warp], lane, res);
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
#pragma unroll
      for (int d = 0; d < D; ++d) out_s[(rg + 32 * t) * w + c * D + d] = res[t][d];
    }
  }
  __syncthreads();
  if (gc == G) {  // the tile is one contiguous run of `out`
    int* o = out + r0 * G * D;
    for (int e = threadIdx.x; e < rows * w; e += nt) o[e] = out_s[e];
  } else {
    for (int e = threadIdx.x; e < rows * w; e += nt) {
      const int r = e / w;
      out[((r0 + r) * G + g0) * D + e - r * w] = out_s[e];
    }
  }
}

}  // namespace

// keys (V,) ascending int32; perm (V,) int32 or null (identity mode);
// q (M, G) int32; out (M, G) or (M, 3G) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int sorted_lookup_launch(const int* keys, const int* perm,
                                    const int* q, int* out, int V, long long M,
                                    int G, int triple, void* stream) {
  if (V < 1 || M < 0 || G < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int GC = G < GCMAX ? G : GCMAX, R = GC < 8 ? 8 / GC : 1, rows = TASK_ROWS * R;
  const dim3 grid((unsigned)((M + rows - 1) / rows), (unsigned)((G + GC - 1) / GC));
  const dim3 block(32 * R * GC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (triple) sorted_lookup_kernel<3><<<grid, block, 0, s>>>(keys, perm, q, out, V, M, G, GC, R);
  else sorted_lookup_kernel<1><<<grid, block, 0, s>>>(keys, perm, q, out, V, M, G, GC, R);
  return (int)cudaGetLastError();
}
