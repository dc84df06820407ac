// Gather-GEMM core shared by the two sparse-conv kernels.
//
//   out[m, :] = sum_k feats[n(m, k), :] @ W_k      (a miss contributes 0)
//
// One block owns TM output rows. It first resolves the TM x K neighbour
// rows into shared memory (a Finder maps (m, k) to an input row or -1),
// then, for each tap that has at least one hit in the tile, stages the
// gathered rows and W_k in shared memory, KC input channels at a time, and
// accumulates the out tile in f32 registers: each thread owns RM rows x 4
// output columns. Inputs are f32 or bf16 (converted to f32 on the way into
// shared memory); accumulation is f32 on the CUDA cores.
//
// Bound on the H100: with bf16 inputs at the main-path widths the work is
// 2*hits*Cin*Co FLOPs against ~hits*Cin*2 gathered bytes; the input tables
// (V x Cin, at most 120k x 16 or 25k x 64 rows, a few MB) and the weights
// stay resident in the 50 MB L2, so the gather reads come from L2, not HBM.
// This first version is limited by its CUDA-core FMAs and shared-memory
// traffic, far from the tensor-core bound; wgmma/TMA come later.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gconv {

constexpr int TM = 64;        // output rows per block
constexpr int KC = 32;        // input channels per shared-memory chunk
constexpr int KMAX = 27;      // taps of a 3x3x3 kernel
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int CO, typename Finder>
__device__ __forceinline__ void gather_gemm_tile(const T* __restrict__ feats,
                                                 const T* __restrict__ w,
                                                 float* __restrict__ out,
                                                 int V, int M, int K, int Cin,
                                                 const Finder& find) {
  constexpr int TX = CO / 4;         // threads across the output columns
  constexpr int TY = THREADS / TX;   // threads across the rows
  constexpr int RM = TM / TY;        // rows per thread
  static_assert(CO % 4 == 0 && THREADS % TX == 0 && TM % TY == 0, "tile shape");

  __shared__ int nbr_s[KMAX * TM];   // [k][r] input row or -1
  __shared__ int any_s[KMAX];        // tap k has a hit in this tile
  __shared__ float a_s[TM][KC + 1];  // gathered rows (+1: no bank conflicts)
  __shared__ __align__(16) float w_s[KC][CO];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;

  if (tid < K) any_s[tid] = 0;
  // row-major walk: the (M, K) rulebook / queries read coalesced
  for (int e = tid; e < TM * K; e += THREADS) {
    const int r = e / K, k = e - r * K;
    const int m = m0 + r;
    int row = m < M ? find(m, k) : -1;
    if (row >= V) row = -1;          // out-of-table rows gather zeros
    nbr_s[k * TM + r] = row;
  }
  __syncthreads();
  for (int e = tid; e < TM * K; e += THREADS) {
    if (nbr_s[e] >= 0) any_s[e / TM] = 1;
  }
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  for (int k = 0; k < K; ++k) {
    if (!any_s[k]) continue;         // block-uniform
    const int* nk = nbr_s + k * TM;
    for (int c0 = 0; c0 < Cin; c0 += KC) {
      const int kc = min(KC, Cin - c0);
      for (int e = tid; e < TM * kc; e += THREADS) {
        const int r = e / kc, c = e - r * kc;
        const int row = nk[r];
        a_s[r][c] = row >= 0 ? to_f32(feats[(size_t)row * Cin + c0 + c]) : 0.f;
      }
      const T* wk = w + ((size_t)k * Cin + c0) * CO;
      for (int e = tid; e < kc * CO; e += THREADS) {
        w_s[e / CO][e % CO] = to_f32(wk[e]);
      }
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(&w_s[c][tx * 4]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = a_s[ty + i * TY][c];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m < M) {
      *reinterpret_cast<float4*>(out + (size_t)m * CO + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Host-side dispatch over the output width and the input type. `Launch`
// is a functor template instantiated as Launch<T, CO>::run(grid, stream).
template <template <typename, int> class Launch, typename... Args>
int dispatch(int Co, int bf16, int M, cudaStream_t stream, Args... args) {
  if (M <= 0) return 0;
  const dim3 grid((M + TM - 1) / TM);
#define GCONV_CASE(CO_)                                                       \
  case CO_:                                                                   \
    if (bf16) Launch<__nv_bfloat16, CO_>::run(grid, stream, args...);          \
    else Launch<float, CO_>::run(grid, stream, args...);                       \
    break;
  switch (Co) {
    GCONV_CASE(16)
    GCONV_CASE(32)
    GCONV_CASE(64)
    GCONV_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GCONV_CASE
  return (int)cudaGetLastError();
}

}  // namespace gconv
