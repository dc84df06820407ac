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
// bytes; 2*hits*Cin*Co FLOPs at 0.9-13 hits per row put every bf16 conv
// of the step on the bytes side of the H100's roofline.
//
// Both dtypes run the tensor-core cores of gather_mma.cuh: bf16 (the
// serving steps' trunk) on mma.sync m16n8k16, f32 (every CLI path: serving,
// eval, training, the feature cache, BEVMap) as three TF32 passes on
// m16n8k8, f32-accurate. bf16 takes the warp core for conv_input through
// down2 and the extra conv, the staged core for res2, down3 and res3; f32
// (twice the bytes of W) the warp core through res1, the staged core from
// down2 on. f32 moves twice the feature and W bytes of bf16, and its
// products, priced at 495/3 TFLOP/s, bound it on the denser frames (a
// served frame, BEVMap's); the bytes bound bf16 everywhere. A launch that
// fails is reported.
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

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_conv_launch(const void* feats, const int* gather,
                                  const void* w, float* out, int V, int M,
                                  int K, int Cin, int Co, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GatherFind find{gather, K};
  return bf16 ? gmma::launch<gmma::bf16>(find, feats, w, out, V, M, K, Cin, Co, s)
              : gmma::launch<float>(find, feats, w, out, V, M, K, Cin, Co, s);
}

// The core a conv of these shapes and dtype takes (gmma::Core: 0 the warp
// core, 1 the staged core); the same in every kernel library, which all
// launch through gather_mma.cuh.
extern "C" int gather_mma_core(int K, int Cin, int Co, int f32) {
  return f32 ? gmma::core_of<float>(K, Cin, Co) : gmma::core_of<gmma::bf16>(K, Cin, Co);
}
