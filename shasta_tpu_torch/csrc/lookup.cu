// sorted_lookup: left binary search of query keys in an ascending key table.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/window_conv.py
// `_lookup_kernel` (launched by `_lookup_call`, wrapped by `windowed_lookup`
// and `windowed_lookup_triple`), which walks per-tap cursors through
// VMEM-resident widened key windows, hops when a tile's span outgrows its
// window, carries positions in f32 and flags an XLA fallback on overflow.
// On Hopper the whole key table (at most 480k x 4 bytes for a key table,
// 3.84M x 4 bytes for the down1 compaction count table) is read from L2,
// so each thread runs a plain left binary search over all of it: exact for
// every input, positions exact in int32, no windows, cursors or flags.
//
// One thread per (query row, query column); for each probe q:
//   pos = lower_bound(keys, q); out = (keys[pos] == q && q != SENTINEL)
//                                     ? (perm ? perm[pos] : pos) : V
// which is `_xla_lookup` (window_conv.py:382-390): the first occurrence of a
// duplicate key wins. The search never walks forward over equal keys: the
// padded rows share one filler key, so a run of equal keys can be ~V long.
// Triple mode probes c-1, c, c+1 for each centre c (a SENTINEL centre misses
// on all three; a probe outside int32 or equal to SENTINEL misses) and
// writes them in (g, dx) raster order. Identity mode (perm null) returns
// the table position itself.
//
// Bound on the H100: bytes. Per call it reads the queries (M*G*4 bytes)
// and the table (V*4, plus V*4 for perm) once and writes M*G*D*4 bytes;
// the log2(V) probes per search hit L2 (the top levels of the search tree
// are shared by every thread). About 22 dependent L2 loads per search set
// the latency; enough threads are in flight (M*G up to 4.3M) to hide it.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int find(const int* __restrict__ keys,
                                    const int* __restrict__ perm, int V,
                                    long long q) {
  if (q >= INT_MAX || q < INT_MIN) return V;  // SENTINEL or out of int32
  const int key = (int)q;
  int lo = 0, hi = V;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= V || keys[lo] != key) return V;
  return perm ? perm[lo] : lo;
}

template <bool TRIPLE>
__global__ void __launch_bounds__(THREADS)
sorted_lookup_kernel(const int* __restrict__ keys, const int* __restrict__ perm,
                     const int* __restrict__ q, int* __restrict__ out, int V,
                     long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int c = q[i];
  if (!TRIPLE) {
    out[i] = find(keys, perm, V, c);
    return;
  }
  int* o = out + 3 * i;
  if (c == INT_MAX) {
    o[0] = o[1] = o[2] = V;
    return;
  }
  o[0] = find(keys, perm, V, (long long)c - 1);
  o[1] = find(keys, perm, V, c);
  o[2] = find(keys, perm, V, (long long)c + 1);
}

}  // namespace

// keys (V,) ascending int32; perm (V,) int32 or null (identity mode);
// q (n,) int32 = the (M, G) queries flattened; out (n,) or (3n,) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int sorted_lookup_launch(const int* keys, const int* perm,
                                    const int* q, int* out, int V, long long n,
                                    int triple, void* stream) {
  if (V < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (triple) sorted_lookup_kernel<true><<<grid, THREADS, 0, s>>>(keys, perm, q, out, V, n);
  else sorted_lookup_kernel<false><<<grid, THREADS, 0, s>>>(keys, perm, q, out, V, n);
  return (int)cudaGetLastError();
}
