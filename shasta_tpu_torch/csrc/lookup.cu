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
// - A task is 64 consecutive rows of one query column, two per lane. The
//   callers' rows come in key order (voxels key-sorted, strided outputs
//   ascending, identity slots 1..max_out), so a task's probes are close
//   together. The warp reduces their min and max and finds the min's lower
//   bound lo with a 32-ary search: each lane loads one of 32 split points,
//   a ballot picks the part; 3-4 dependent loads for V up to 4M, shifts and
//   adds only.
// - The warp copies the STAGE keys from lo into shared memory (one
//   coalesced load). When the max probe's lower bound lies among them, each
//   lane finishes its searches there. Otherwise (shuffled queries, a frame
//   boundary) the warp searches the max's lower bound hi too and each lane
//   searches the global table between lo and hi. The result does not depend
//   on the query order; only the speed does.
// - Triple mode searches once per centre, for c-1; c and c+1 then advance
//   from there, usually by one or two compares in the same sector. Only
//   where a run of equal keys starts there (duplicates, or a frame's filler
//   run, ~V/lanes long, right after its last cell) does a gallop run.
// - A block holds the tasks of 64*R rows and gc <= GCMAX columns, one warp
//   each (R*gc <= 8, or R = 1 at 9 columns), reads its query tile and
//   writes its result tile through shared memory, coalesced.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PER_LANE = 2;                // a task's rows per lane
constexpr int TASK_ROWS = 32 * PER_LANE;
constexpr int GCMAX = 9;                   // query columns per block
constexpr int MAX_WARPS = GCMAX;           // one task each
constexpr int Q_INTS = TASK_ROWS * MAX_WARPS;  // query tile: TASK_ROWS*R rows x gc
constexpr int OUT_INTS = 3 * Q_INTS;       // result tile: TASK_ROWS*R rows x gc*D
constexpr int STAGE = 128;                 // keys a task stages
constexpr unsigned FULL = 0xffffffffu;

// First i in [s, e) with a[i] >= key, else e.
__device__ __forceinline__ int lower_bound(const int* a, int s, int e, int key) {
  while (s < e) {
    const int mid = s + ((e - s) >> 1);
    if (a[mid] < key) s = mid + 1;
    else e = mid;
  }
  return s;
}

// lower_bound(key), given a[i] < key for every i < p and lower_bound(key)
// <= e: one or two compares, or a gallop over a run of equal keys.
__device__ __forceinline__ int advance(const int* a, int p, int e, int key) {
  if (p >= e || a[p] >= key) return p;
  if (++p >= e || a[p] >= key) return p;
  int step = 1;  // a[p] < key
  while (step < e - p && a[p + step] < key) {
    p += step;
    step <<= 1;
  }
  return lower_bound(a, p + 1, step < e - p ? p + step : e, key);
}

// One step of a 32-ary search for the lower bound lb in [s, e], e - s > 32:
// lane i holds p_i = min(s + (i+1)*step, e) - 1 with step = ceil((e-s)/32),
// and `less` is the ballot of keys[p_i] < key (a prefix of the lanes, the
// keys ascend). lb > p_{c-1} and lb <= p_c leave a range of < step keys.
__device__ __forceinline__ int split(int s, int e, int i) {
  const unsigned n = (unsigned)(e - s), step = (n + 31) >> 5;
  return s + (int)min((unsigned)(i + 1) * step, n) - 1;
}

__device__ __forceinline__ void narrow(int& s, int& e, unsigned less) {
  const int c = __popc(less), s0 = s;
  if (c > 0) s = split(s0, e, c - 1) + 1;
  if (c < 32) e = split(s0, e, c);
}

// lower_bound over keys[0, V) of the warp-uniform key, by the whole warp.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int V, int key,
                                                int lane) {
  int s = 0, e = V;
  while (e - s > 32) {  // warp-uniform, as s and e
    const int v = __ldg(keys + split(s, e, lane));
    narrow(s, e, __ballot_sync(FULL, v < key));
  }
  const bool less = s + lane < e && __ldg(keys + s + lane) < key;
  return s + __popc(__ballot_sync(FULL, less));
}

// The D results of each lane's PER_LANE queries x[t] (D = 3: the centre of
// a triple), the whole warp together; `stage` is the warp's STAGE ints of
// shared memory.
template <int D>
__device__ __forceinline__ void lookup_warp(const int* __restrict__ keys,
                                            const int* __restrict__ perm, int V,
                                            const int (&x)[PER_LANE], int* stage, int lane,
                                            int (&res)[PER_LANE][D]) {
  int mn = INT_MAX, mx = INT_MIN;  // the smallest and the largest live probe
  bool any = false;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
#pragma unroll
    for (int d = 0; d < D; ++d) res[t][d] = V;
    if (x[t] == INT_MAX) continue;
    any = true;
    int k_lo = x[t], k_hi = x[t];
    if constexpr (D == 3) {
      if (x[t] != INT_MIN) k_lo = x[t] - 1;
      if (x[t] < INT_MAX - 1) k_hi = x[t] + 1;
    }
    mn = min(mn, k_lo);
    mx = max(mx, k_hi);
  }
  if (!__any_sync(FULL, any)) return;
  mn = __reduce_min_sync(FULL, mn);
  mx = __reduce_max_sync(FULL, mx);
  const int lo = warp_lower_bound(keys, V, mn, lane), n = min(STAGE, V - lo);
#pragma unroll
  for (int j = 0; j < STAGE / 32; ++j) {
    if (32 * j + lane < n) stage[32 * j + lane] = __ldg(keys + lo + 32 * j + lane);
  }
  __syncwarp();
  // the searches run on a[s, e] of `a` (every probe's lower bound lies
  // there), global position = off + local one; positions below `avail` are
  // readable
  const int* a = stage;
  int off = lo, s = 0, e = n, avail = n;
  if (lo + n < V) {
    if (stage[n - 1] >= mx) {  // warp-uniform
      e = n - 1;
    } else {
      a = keys;
      off = 0;
      s = lo;
      e = warp_lower_bound(keys, V, mx, lane);
      avail = V;
    }
  }
  auto hit = [&](int p, int key) {
    return (p < avail && a[p] == key) ? (perm ? __ldg(perm + off + p) : off + p) : V;
  };
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const int c = x[t];
    if (c == INT_MAX) continue;
    if constexpr (D == 1) {
      res[t][0] = hit(lower_bound(a, s, e, c), c);
    } else {
      int p = lower_bound(a, s, e, c != INT_MIN ? c - 1 : c);
      if (c != INT_MIN) res[t][0] = hit(p, c - 1);
      p = advance(a, p, e, c);
      res[t][1] = hit(p, c);
      if (c < INT_MAX - 1) {
        p = advance(a, p, e, c + 1);
        res[t][2] = hit(p, c + 1);
      }
    }
  }
}

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
