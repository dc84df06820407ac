// greedy_rows: the scan tracker's greedy assignment, every lane in one launch.
//
// Replaces no Pallas kernel: it replaces the JAX package's `lax.scan` over
// rows (`greedy_assign_jax`, shasta_tpu/tracker/greedy.py), which the port
// first wrote as a host loop of a min, a compare and a scatter per row (~900
// launches a frame at the streams' 180 rows, each carrying almost no work).
//
// The result is the loop's (`greedy_assign_plain`, tracker/greedy.py), bit
// for bit: rows in order, row i takes the lowest column among the columns of
// least value that no earlier row of its lane took, provided that value is
// < THRESH (1e16 in f32); the column is then closed to the rows after it. A
// row with no free column below THRESH, or with a NaN anywhere (the loop's
// min is then NaN), gets -1 and closes nothing. -0 and +0 are one value.
// Exact wherever no entry lies below THRESH - INVALID (~-9.9e17), where the
// loop's +INVALID would leave a taken column below THRESH; the tracker's
// distances are >= 0.
//
// Bound on the H100: the chain of rows, not bytes. Row i needs the columns
// rows 0..i-1 took, so the rows run one after another; the bytes (dist read
// once, 4.5 MB at 7 lanes of 180 x 900) take ~1.4 us at 3.35 TB/s.
//
// Design. One block a lane, so lanes run side by side on their own SMs.
// Phase 1, parallel over rows: each warp takes rows and compacts each row's
// entries below THRESH into a candidate list in scratch (worst case M a row),
// each candidate one 64-bit key: the value's bits mapped to an unsigned
// order, then the column, so the smallest key is the row's (least value,
// lowest column). The tracker's gates, class match and used mask leave most
// entries at BIG, so lists are short; nothing depends on how short. Phase 2,
// one warp, sequential over rows, with no block-wide barrier inside the loop:
// the taken columns are a bitmap of M bits in shared memory; for row i each
// lane reads a candidate (the first 32 loaded AHEAD rows early, since they
// do not depend on the bitmap), drops it if its column is taken, and two
// warp reductions (`redux.sync`: the value's order, then the column among
// the lanes holding that value) give the match. Lane 0 sets the column's bit
// and writes the row's result; a __syncwarp orders the bit before the next
// row's reads. A row with an empty list costs its prefetched reads alone.
// Phase 1 stays on the lane's own block: spreading it over more blocks
// would take a second launch or a grid-wide handoff to save a few
// microseconds of a step the host's dispatch bounds. On an H100 80GB HBM3
// the launch takes 0.065 ms at 180 x 900, at 1 lane and at 7.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int BLOCK = 1024;
constexpr int WARPS = BLOCK / 32;
constexpr int UNROLL = 8;  // 32-column chunks a warp loads before it compacts them
constexpr int AHEAD = 4;   // rows phase 2 loads ahead of the one it decides
constexpr unsigned FULL = 0xffffffffu;
constexpr float THRESH = 1e16f;
constexpr u64 NONE = ~0ull;  // no candidate: above every key (no key's order is ~0u)
constexpr int MAX_M = 1 << 20;  // 128 KB of taken bits in shared memory
constexpr int DEFAULT_SMEM = 48 * 1024;

// The float's bits as an unsigned that orders as the floats do, for every
// non-NaN value; -0 maps to +0's order, since the loop's min ties them.
__device__ __forceinline__ unsigned order_of(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool is_taken(const unsigned* taken, unsigned col) {
  return (taken[col >> 5] >> (col & 31)) & 1u;
}

__global__ void __launch_bounds__(BLOCK)
greedy_kernel(const float* __restrict__ dist, int N, int M, u64* cand, int* count,
              long long* __restrict__ match) {
  extern __shared__ unsigned taken[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t lane_rows = (size_t)blockIdx.x * N;
  const size_t lane_cells = lane_rows * M;
  for (int w = threadIdx.x; w < (M + 31) / 32; w += BLOCK) taken[w] = 0u;

  // phase 1: each row's entries below THRESH, compacted in column order
  for (int i = warp; i < N; i += WARPS) {
    const float* row = dist + lane_cells + (size_t)i * M;
    u64* out = cand + lane_cells + (size_t)i * M;
    int n = 0;
    bool nan = false;
    for (int c0 = 0; c0 < M; c0 += 32 * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; u++) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < M ? row[c] : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; u++) {
        const bool keep = v[u] < THRESH;
        nan |= isnan(v[u]);
        const unsigned votes = __ballot_sync(FULL, keep);
        if (keep)
          out[n + __popc(votes & below)] =
              ((u64)order_of(v[u]) << 32) | (unsigned)(c0 + 32 * u + lane);
        n += __popc(votes);
      }
    }
    nan = __any_sync(FULL, nan);
    if (lane == 0) count[lane_rows + i] = nan ? -1 : n;
  }
  __syncthreads();
  if (warp != 0) return;

  // phase 2: the rows in order, one warp
  const u64* cb = cand + lane_cells;
  const int* cn = count + lane_rows;
  long long* mb = match + lane_rows;
  int c_ahead[AHEAD];
  u64 k_ahead[AHEAD];
  // a row's count and its first 32 slots, read together: slots past the
  // count are scratch never written, read only to start the load early
  auto load = [&](int i, int& c, u64& k) {
    c = cn[i];
    k = lane < M ? cb[(size_t)i * M + lane] : NONE;
  };
#pragma unroll
  for (int a = 0; a < AHEAD; a++)
    if (a < N) load(a, c_ahead[a], k_ahead[a]);
  for (int i0 = 0; i0 < N; i0 += AHEAD) {
#pragma unroll
    for (int a = 0; a < AHEAD; a++) {
      const int i = i0 + a;
      if (i >= N) break;
      const int c = c_ahead[a];
      const u64 k = k_ahead[a];
      if (i + AHEAD < N) load(i + AHEAD, c_ahead[a], k_ahead[a]);
      u64 best = NONE;
      if (lane < c && !is_taken(taken, (unsigned)k)) best = k;
      for (int s = 32 + lane; s < c; s += 32) {  // a row of more than 32 candidates
        const u64 kk = cb[(size_t)i * M + s];
        if (kk < best && !is_taken(taken, (unsigned)kk)) best = kk;
      }
      const unsigned hi = __reduce_min_sync(FULL, (unsigned)(best >> 32));
      const unsigned col = __reduce_min_sync(FULL, (unsigned)(best >> 32) == hi ? (unsigned)best
                                                                               : FULL);
      if (lane == 0) {
        if (hi != FULL) taken[col >> 5] |= 1u << (col & 31);
        mb[i] = hi != FULL ? (long long)col : -1ll;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// dist (B, N, M) f32, contiguous, on the device; cand (B, N, M) and count
// (B, N) scratch (u64, int32); match (B, N) int64 out. 1 <= M <= 2^20,
// B, N >= 1. Enqueues one launch on `stream`; returns the CUDA error of the
// launch, 0 if none.
extern "C" int greedy_rows_launch(const float* dist, int B, int N, int M, void* cand,
                                  int* count, long long* match, void* stream) {
  if (B < 1 || N < 1 || M < 1 || M > MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((M + 31) / 32) * sizeof(unsigned);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_kernel<<<B, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      dist, N, M, static_cast<u64*>(cand), count, match);
  return (int)cudaGetLastError();
}
