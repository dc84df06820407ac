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
// down1 16->32, res1 32->32, down2 32->64; M = 120k / 50k / 25k rows at
// 0.9-4.7 hits per row). Per conv the kernel reads the rulebook (M*K*4
// bytes: 13 MB at stage 0, most of the bytes), the gathered rows (from
// L2: the V x Cin table is at most 120k x 16 x 2 bytes) and W, and writes
// M*Co*4 bytes; at Cin*Co <= 2048 the bytes bound these convs.
//
// bf16 runs the tensor-core warp core of gather_mma.cuh (all of W, 20.7 to
// 124.4 KB, once per block in shared memory; each warp reads its 16 rows'
// 16 x K rulebook entries in one coalesced load, walks their hit taps with
// A fragments loaded straight from L2 into registers). A rulebook row
// outside [0, V) is a miss, the contract of gather_conv's table, so the
// finder reads it as it is. f32 runs the CUDA-core core gather_conv.cuh,
// kept for parity checks. The choice is by dtype; either launch that fails
// is reported.
#include "gather_conv.cuh"
#include "gather_mma.cuh"

namespace {

// The rulebook as it is; the cores map a row outside [0, V) to a miss.
struct RulebookFind {
  const int* __restrict__ nbr;
  int K;
  __device__ __forceinline__ int operator()(int m, int k) const {
    return nbr[(size_t)m * K + k];
  }
};

template <int CO>
__global__ void __launch_bounds__(gconv::THREADS)
rulebook_conv_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                     const float* __restrict__ w, float* __restrict__ out, int V,
                     int M, int K, int Cin) {
  gconv::gather_gemm_tile<CO>(feats, w, out, V, M, K, Cin, RulebookFind{nbr, K});
}

template <int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const void* feats,
                  const int* nbr, const void* w, float* out, int V, int M,
                  int K, int Cin) {
    rulebook_conv_kernel<CO><<<grid, gconv::THREADS, 0, stream>>>(
        static_cast<const float*>(feats), nbr, static_cast<const float*>(w), out, V, M,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return gmma::launch(RulebookFind{nbr, K}, feats, w, out, V, M, K, Cin, Co, s);
  return gconv::dispatch<Launch>(Co, M, s, feats, nbr, w, out, V, M, K, Cin);
}
