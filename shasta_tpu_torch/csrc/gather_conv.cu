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
// models/backbone.py without plans). Bound: see gather_conv.cuh. Per conv
// the kernel reads the gather table (M*K*4 bytes), the gathered rows (the
// V x Cin table is at most 480k x 16 x 2 bytes at 4 lanes, L2-resident)
// and W, and writes M*Co*4 bytes; 2*hits*Cin*Co FLOPs put the C_in <= 32
// convs on the bytes side of the H100's roofline and the C_in >= 64 convs
// there too below ~7 hits per row.
#include "gather_conv.cuh"

namespace {

// The gather table as it is; the core maps a row >= V or < 0 to a miss.
struct GatherFind {
  const int* __restrict__ gather;
  int K;
  __device__ __forceinline__ int operator()(int m, int k) const {
    return gather[(size_t)m * K + k];
  }
};

template <typename T, int CO>
__global__ void __launch_bounds__(gconv::THREADS)
gather_conv_kernel(const T* __restrict__ feats, const int* __restrict__ gather,
                   const T* __restrict__ w, float* __restrict__ out, int V,
                   int M, int K, int Cin) {
  gconv::gather_gemm_tile<T, CO>(feats, w, out, V, M, K, Cin, GatherFind{gather, K});
}

template <typename T, int CO>
struct Launch {
  static void run(dim3 grid, cudaStream_t stream, const void* feats,
                  const int* gather, const void* w, float* out, int V, int M,
                  int K, int Cin) {
    gather_conv_kernel<T, CO><<<grid, gconv::THREADS, 0, stream>>>(
        static_cast<const T*>(feats), gather, static_cast<const T*>(w), out, V,
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
  return gconv::dispatch<Launch>(Co, bf16, M, static_cast<cudaStream_t>(stream),
                                 feats, gather, w, out, V, M, K, Cin);
}
