// keyed_conv: sparse conv whose neighbours are found by key inside the kernel.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/window_conv.py
// `_fused_conv_kernel` (launched by `_fused_conv_call`, wrapped by
// `fused_conv_apply`, index from `build_fused_index`), which matches query
// keys against a VMEM window of the key table with one-hot compares and
// needs per-tile window bases plus a coverage flag. Here the neighbour of
// (row, tap) is feats[perm[pos]], pos the left lower bound of the query in
// the full sorted key table (it sits in L2), when the key there equals the
// query: the first occurrence of a duplicate key wins and any physical row
// order is exact. No windows, no coverage flag, no fallback. A query < 0
// (-2) or SENTINEL is a miss. K may be 27 (3x3x3) or 3 (the extra conv's
// (3,1,1) kernel).
//
// Main path: the 10 convs with C_in >= 64 (res2 64->64 at M = 25k, down3
// 64->128, res3 128->128 and extra 128->128 at M = 12k). They do
// 2*hits*Cin*Co FLOPs against about M*(K*4 + Co*4) bytes of queries and
// output; with Cin*Co >= 4096 they reach the H100's bf16 ridge (~295
// FLOP/byte) only above ~7 hits per row, so on sparse frames the bytes
// bound them. The key table (V x 4 bytes) and the feature table (at most
// 25k x 64 x 2 bytes) are L2-resident.
//
// bf16 runs the tensor-core cores of gather_mma.cuh: res2, down3 and res3
// the staged core, the extra conv (104 KB of W) the warp core. f32 runs the
// CUDA-core core gather_conv.cuh, kept for parity checks. The choice is by
// dtype; either launch that fails is reported.
//
// Finding the neighbours. One full binary search per (row, tap) costs ~14
// dependent L2 loads at V = 12k, ~95 per thread of a 128 x 27 tile before
// its first product: most of a tensor-core conv's time. The TPU kernel
// resolves a whole dx triple from one key window; here, in the staged core,
// the tile resolver (KeyedFind::resolve_tile) does the same with
// sorted_search.cuh: the 27 taps of a 3x3x3 kernel come as 9 dx groups
// whose queries are c-1, c, c+1 (or SENTINEL where a tap leaves the grid),
// and the rows come in key order, so one warp task per 64 rows and group
// searches the centres once (a 32-ary warp search, 128 keys staged in
// shared memory) and advances to c-1 and c+1. A tap whose query is not
// c - 1 + d (any other query, or a live side beside a SENTINEL centre) is
// searched on its own, so the kernel is exact for any queries; only its
// speed depends on the triple structure. The warp core, and a staged K that
// is not a multiple of 3, search per query.
#include <climits>

#include "gather_conv.cuh"
#include "gather_mma.cuh"
#include "sorted_search.cuh"

namespace {

struct KeyedFind {
  const int* __restrict__ skeys;
  const int* __restrict__ perm;
  const int* __restrict__ q;
  int V, K;

  static constexpr bool kResolvesTile = true;
  static constexpr size_t kScratchBytes = gmma::WARPS * ssearch::STAGE * sizeof(int);

  // a key's input row, -1 on a miss: one full left search
  __device__ __forceinline__ int search(int key) const {
    if (key < 0 || key == INT_MAX) return -1;
    const int p = ssearch::lower_bound(skeys, 0, V, key);
    return (p < V && __ldg(skeys + p) == key) ? __ldg(perm + p) : -1;
  }

  __device__ __forceinline__ int operator()(int m, int k) const {
    return search(__ldg(q + (size_t)m * K + k));
  }

  // gather_mma.cuh's tile hook: rows[k * ROWS_LD + r] for the TM rows from
  // m0, on all gmma::THREADS threads; scratch holds one STAGE of keys per
  // warp.
  __device__ __forceinline__ void resolve_tile(int m0, int M, int* rows, int* scratch) const {
    using namespace ssearch;
    constexpr int tm = gmma::TM, ld = gmma::ROWS_LD;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // 1. the raw keys, read coalesced; a key < 0 and a row past M: SENTINEL
    for (int e = tid; e < tm * K; e += gmma::THREADS) {
      const int r = e / K, k = e - r * K;
      const int key = m0 + r < M ? __ldg(q + (size_t)m0 * K + e) : INT_MAX;
      rows[k * ld + r] = key < 0 ? INT_MAX : key;
    }
    __syncthreads();
    if (K % 3 != 0) {  // no dx groups: one search per entry, in place
      for (int e = tid; e < tm * K; e += gmma::THREADS) {
        const int r = e / K, k = e - r * K;
        rows[k * ld + r] = search(rows[k * ld + r]);
      }
      return;
    }
    // 2. one warp task per TASK_ROWS rows x dx group; each lane owns its
    // rows' three entries of the group, reads and rewrites them in place
    constexpr int halves = tm / TASK_ROWS;
    const int tasks = K / 3 * halves;
    int* const stage = scratch + warp * STAGE;
    for (int t = warp; t < tasks; t += gmma::WARPS) {  // warp-uniform
      const int g = t / halves, r0 = (t - g * halves) * TASK_ROWS + lane;
      int* const grp = rows + 3 * g * ld + r0;  // entry (d, i) at grp[d * ld + 32 * i]
      int x[PER_LANE], res[PER_LANE][3];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) x[i] = grp[ld + 32 * i];
      lookup_warp<3>(skeys, perm, V, x, stage, lane, res);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = x[i];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int key = grp[d * ld + 32 * i];
          int row;
          if (key == INT_MAX) row = -1;
          else if (c != INT_MAX && key == c - 1 + d) row = res[i][d] < V ? res[i][d] : -1;
          else row = search(key);
          grp[d * ld + 32 * i] = row;
        }
      }
    }
  }
};

template <int CO>
__global__ void __launch_bounds__(gconv::THREADS)
keyed_conv_kernel(const int* __restrict__ skeys, const int* __restrict__ perm,
                  const int* __restrict__ q, const float* __restrict__ feats,
                  const float* __restrict__ w, float* __restrict__ out, int V,
                  int M, int K, int Cin) {
  gconv::gather_gemm_tile<CO>(feats, w, out, V, M, K, Cin, KeyedFind{skeys, perm, q, V, K});
}

template <int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const int* skeys,
                  const int* perm, const int* q, const void* feats,
                  const void* w, float* out, int V, int M, int K, int Cin) {
    keyed_conv_kernel<CO><<<grid, gconv::THREADS, 0, stream>>>(
        skeys, perm, q, static_cast<const float*>(feats), static_cast<const float*>(w),
        out, V, M, K, Cin);
  }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int keyed_conv_launch(const int* skeys, const int* perm,
                                 const int* q, const void* feats,
                                 const void* w, float* out, int V, int M,
                                 int K, int Cin, int Co, int bf16,
                                 void* stream) {
  if (K < 1 || K > gconv::KMAX || Cin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return gmma::launch(KeyedFind{skeys, perm, q, V, K}, feats, w, out, V, M, K, Cin, Co, s);
  return gconv::dispatch<Launch>(Co, M, s, skeys, perm, q, feats, w, out, V, M, K, Cin);
}
