// The f32 gather-GEMM core of the three sparse-conv kernels (their f32
// parity route; bf16 takes the tensor-core cores of gather_mma.cuh).
//
//   out[m, :] = sum_k feats[n(m, k), :] @ W_k      (a miss contributes 0)
//
// One block owns TM output rows. It first resolves the TM x K neighbour
// rows into shared memory (a Finder maps (m, k) to an input row or -1),
// then, for each tap that has at least one hit in the tile, stages the
// gathered rows and W_k in shared memory, KC input channels at a time, and
// accumulates the out tile in f32 registers on the CUDA cores: each thread
// owns RM rows x 4 output columns. It does 64*Cin*Co FMAs for every tap
// with a hit in the tile, whether each row hits or not: simple and exact
// in f32, and far from the card's bound, which is why bf16 does not run
// here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gconv {

constexpr int TM = 64;        // output rows per block
constexpr int KC = 32;        // input channels per shared-memory chunk
constexpr int KMAX = 27;      // taps of a 3x3x3 kernel
constexpr int THREADS = 256;

template <int CO, typename Finder>
__device__ __forceinline__ void gather_gemm_tile(const float* __restrict__ feats,
                                                 const float* __restrict__ w,
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
        a_s[r][c] = row >= 0 ? feats[(size_t)row * Cin + c0 + c] : 0.f;
      }
      const float* wk = w + ((size_t)k * Cin + c0) * CO;
      for (int e = tid; e < kc * CO; e += THREADS) {
        w_s[e / CO][e % CO] = wk[e];
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

// Host-side dispatch over the output width. `Launch` is a functor template
// instantiated as Launch<CO>::run(grid, stream, args...).
template <template <int> class Launch, typename... Args>
int dispatch(int Co, int M, cudaStream_t stream, Args... args) {
  if (M <= 0) return 0;
  const dim3 grid((M + TM - 1) / TM);
#define GCONV_CASE(CO_)                         \
  case CO_:                                     \
    Launch<CO_>::run(grid, stream, args...);    \
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
