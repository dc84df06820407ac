// keyed_conv: sparse conv whose neighbours are found by key inside the kernel.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/window_conv.py
// `_fused_conv_kernel` (launched by `_fused_conv_call`, wrapped by
// `fused_conv_apply`, index from `build_fused_index`), which matches query
// keys against a VMEM window of the key table with one-hot compares and
// needs per-tile window bases plus a coverage flag. Here each (row, tap)
// runs a left binary search over the full sorted key table (it sits in
// L2) and gathers feats[perm[pos]] on a hit, so the first occurrence of a
// duplicate key wins and any physical row order is exact: no windows, no
// coverage flag, no fallback. A query < 0 (-2) or SENTINEL is a miss.
// K may be 27 (3x3x3) or 3 (the extra conv's (3,1,1) kernel).
//
// Main path: the 10 convs with C_in >= 64 (res2 64->64 at M = 25k, down3
// 64->128, res3 128->128 and extra 128->128 at M = 12k). Bound: see
// gather_conv.cuh. These convs do 2*hits*Cin*Co FLOPs against about
// M*(K*4 + Co*4) bytes of queries and output; with Cin*Co >= 4096 they
// reach the H100's bf16 ridge (~295 FLOP/byte) only above ~7 hits per
// row, so on sparse frames the bytes bound them. The key table (V x 4
// bytes) and the feature table (at most 25k x 64 x 2 bytes) are
// L2-resident.
#include <climits>

#include "gather_conv.cuh"

namespace {

struct KeyedFind {
  const int* __restrict__ skeys;
  const int* __restrict__ perm;
  const int* __restrict__ q;
  int V, K;
  __device__ __forceinline__ int operator()(int m, int k) const {
    const int key = q[(size_t)m * K + k];
    if (key < 0 || key == INT_MAX) return -1;
    int lo = 0, hi = V;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (skeys[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    return (lo < V && skeys[lo] == key) ? perm[lo] : -1;
  }
};

template <typename T, int CO>
__global__ void __launch_bounds__(gconv::THREADS)
keyed_conv_kernel(const int* __restrict__ skeys, const int* __restrict__ perm,
                  const int* __restrict__ q, const T* __restrict__ feats,
                  const T* __restrict__ w, float* __restrict__ out, int V,
                  int M, int K, int Cin) {
  gconv::gather_gemm_tile<T, CO>(feats, w, out, V, M, K, Cin,
                                 KeyedFind{skeys, perm, q, V, K});
}

template <typename T, int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const int* skeys,
                  const int* perm, const int* q, const void* feats,
                  const void* w, float* out, int V, int M, int K, int Cin) {
    keyed_conv_kernel<T, CO><<<grid, gconv::THREADS, 0, stream>>>(
        skeys, perm, q, static_cast<const T*>(feats), static_cast<const T*>(w),
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
  return gconv::dispatch<Launch>(Co, bf16, M, static_cast<cudaStream_t>(stream),
                                 skeys, perm, q, feats, w, out, V, M, K, Cin);
}
