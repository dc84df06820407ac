// Warp-cooperative lower-bound searches in an ascending int32 key table,
// shared by sorted_lookup (lookup.cu) and keyed_conv's tile resolver
// (window_conv.cu).
//
// A task is 64 probe rows, two per lane. The warp reduces their smallest
// and largest probe, finds the smallest's lower bound lo with a 32-ary
// search (each lane loads one of 32 split points, a ballot picks the part:
// 3-4 dependent loads for V up to 4M, shifts and adds only) and copies the
// STAGE keys from lo into shared memory in one coalesced load. When the
// largest probe's lower bound lies among them, each lane finishes its
// searches there; otherwise (shuffled probes, a frame boundary) the warp
// searches the largest's lower bound hi too and each lane searches the
// global table between lo and hi. The results do not depend on the probe
// order; only the speed does. Triple mode (D = 3) searches once per centre
// c, for c-1, and advances to c and c+1, usually by one or two compares in
// the same sector; only where a run of equal keys starts there (duplicates,
// a frame's filler run) does a gallop run.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace ssearch {

constexpr int PER_LANE = 2;  // a task's rows per lane
constexpr int TASK_ROWS = 32 * PER_LANE;
constexpr int STAGE = 128;  // keys a task stages
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

// The D results of each lane's PER_LANE probes x[t] (D = 3: the centre of
// a triple), the whole warp together: perm[pos] (pos itself where perm is
// null) on a hit, V on a miss or an INT_MAX probe; `stage` is the warp's
// STAGE ints of shared memory.
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
  __syncwarp();  // the stage may be reused by the warp's next task
}

}  // namespace ssearch
