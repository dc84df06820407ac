// rulebook_conv: sparse conv over a host-built rulebook.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/block_conv.py
// `_pos_conv_kernel` (launched by `_pos_conv_call`, wrapped by
// `pos_conv_apply`), which takes host-built 16-bit PosWords and extracts
// neighbour rows from 128-lane pair-block windows by one-hot matmuls. On
// Hopper a block gathers rows by index, so the host planner emits the
// neighbour rows themselves: an (M, K) int32 rulebook, -1 for a miss, and
// the kernel needs no windows, no window-fit check and no fallback.
//
// Main path: the 11 convs with C_in <= 32 (conv_input 5->16, res0 16->16,
// down1 16->32, res1 32->32, down2 32->64; M = 120k / 50k / 25k rows).
// Bound: see gather_conv.cuh. Per conv the kernel reads the rulebook
// (M*K*4 bytes), the gathered rows (from L2: the V x Cin table is at most
// 120k x 16 x 2 bytes) and W, and writes M*Co*4 bytes; at Cin*Co <= 2048
// these convs sit near the memory side of the H100's roofline.
#include "gather_conv.cuh"

namespace {

struct RulebookFind {
  const int* __restrict__ nbr;
  int K;
  __device__ __forceinline__ int operator()(int m, int k) const {
    return nbr[(size_t)m * K + k];
  }
};

template <typename T, int CO>
__global__ void __launch_bounds__(gconv::THREADS)
rulebook_conv_kernel(const T* __restrict__ feats, const int* __restrict__ nbr,
                     const T* __restrict__ w, float* __restrict__ out, int V,
                     int M, int K, int Cin) {
  gconv::gather_gemm_tile<T, CO>(feats, w, out, V, M, K, Cin, RulebookFind{nbr, K});
}

template <typename T, int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const void* feats,
                  const int* nbr, const void* w, float* out, int V, int M,
                  int K, int Cin) {
    rulebook_conv_kernel<T, CO><<<grid, gconv::THREADS, 0, stream>>>(
        static_cast<const T*>(feats), nbr, static_cast<const T*>(w), out, V, M,
        K, Cin);
  }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rulebook_conv_launch(const void* feats, const int* nbr,
                                    const void* w, float* out, int V, int M,
                                    int K, int Cin, int Co, int bf16,
                                    void* stream) {
  if (K < 1 || K > gconv::KMAX || Cin < 1) return (int)cudaErrorInvalidValue;
  return gconv::dispatch<Launch>(Co, bf16, M, static_cast<cudaStream_t>(stream),
                                 feats, nbr, w, out, V, M, K, Cin);
}
