// gather_conv: sparse conv over an explicit (M, K) gather table.
//
// Replaces the TPU kernel shasta_tpu/ops/pallas/window_conv.py
// `_conv_kernel` (launched by `_conv_call`, wrapped by
// `windowed_gather_matmul`), which slices a (W, C) window of a
// VMEM-resident feature table per tile and tap, extracts the gathered rows
// by a one-hot matmul on the MXU, and needs a per-tile window-coverage
// check with an XLA fallback (plus one kernel per lane at B > 1 so each
// lane's table fits VMEM). On Hopper a block gathers rows by index from
// L2, so the kernel reads the JAX gather table as it is: an input row in
// [0, V) is a hit, a row >= V (the JAX miss) or < 0 adds nothing. No
// windows, no coverage flag, no lane split: one launch covers all lanes of
// the global layout.
//
// Path: the scene-batched step's 21 convs (ops/sparse.py NeighborIndex,
// models/backbone.py without plans). Per conv the kernel reads the gather
// table (M*K*4 bytes), the gathered rows (the V x Cin table is at most
// 480k x 16 x 2 bytes at 4 lanes, L2-resident) and W, and writes M*Co*4
// bytes; 2*hits*Cin*Co FLOPs at 0.9-13 hits per row put every conv of the
// step on the bytes side of the H100's roofline.
//
// bf16 inputs (the serving trunk's type) run the tensor-core cores of
// gather_mma.cuh: the warp core for conv_input through down2 and the extra
// conv, the staged core for res2, down3 and res3. f32 inputs run the
// CUDA-core core gather_conv.cuh, kept for parity checks at f32. The choice
// is by dtype; either launch that fails is reported.
#include "gather_conv.cuh"
#include "gather_mma.cuh"

namespace {

// The gather table as it is; the cores map a row >= V or < 0 to a miss.
struct GatherFind {
  const int* __restrict__ gather;
  int K;
  __device__ __forceinline__ int operator()(int m, int k) const {
    return gather[(size_t)m * K + k];
  }
};

template <int CO>
__global__ void __launch_bounds__(gconv::THREADS)
gather_conv_kernel(const float* __restrict__ feats, const int* __restrict__ gather,
                   const float* __restrict__ w, float* __restrict__ out, int V,
                   int M, int K, int Cin) {
  gconv::gather_gemm_tile<CO>(feats, w, out, V, M, K, Cin, GatherFind{gather, K});
}

template <int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const void* feats,
                  const int* gather, const void* w, float* out, int V, int M,
                  int K, int Cin) {
    gather_conv_kernel<CO><<<grid, gconv::THREADS, 0, stream>>>(
        static_cast<const float*>(feats), gather, static_cast<const float*>(w), out, V,
        M, K, Cin);
  }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_conv_launch(const void* feats, const int* gather,
                                  const void* w, float* out, int V, int M,
                                  int K, int Cin, int Co, int bf16,
                                  void* stream) {
  if (K < 1 || K > gconv::KMAX || Cin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return gmma::launch(GatherFind{gather, K}, feats, w, out, V, M, K, Cin, Co, s);
  return gconv::dispatch<Launch>(Co, M, s, feats, gather, w, out, V, M, K, Cin);
}

// The bf16 core a conv of these shapes takes (gmma::Core: 0 the warp core,
// 1 the staged core); the same in every kernel library, which all launch
// through gather_mma.cuh.
extern "C" int gather_mma_core(int K, int Cin, int Co) { return gmma::core_of(K, Cin, Co); }
