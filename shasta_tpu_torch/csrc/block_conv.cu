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
// Both dtypes run the tensor-core cores of gather_mma.cuh: bf16 (the B=1
// planned step's trunk) on mma.sync m16n8k16, the warp core for all of
// these convs (all of W, 20.7 to 124.4 KB, once per block in shared memory;
// each warp reads its 16 rows' 16 x K rulebook entries in one coalesced
// load, walks their hit taps with A fragments loaded straight from L2 into
// registers); f32 (the parity route) as three TF32 passes on m16n8k8,
// f32-accurate, the warp core through 32 -> 32 and the staged core for
// down2 (W twice the bytes). A rulebook row outside [0, V) is a miss, the
// contract of gather_conv's table, so the finder reads it as it is. A
// launch that fails is reported.
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

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rulebook_conv_launch(const void* feats, const int* nbr,
                                    const void* w, float* out, int V, int M,
                                    int K, int Cin, int Co, int bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RulebookFind find{nbr, K};
  return bf16 ? gmma::launch<gmma::bf16>(find, feats, w, out, V, M, K, Cin, Co, s)
              : gmma::launch<float>(find, feats, w, out, V, M, K, Cin, Co, s);
}
