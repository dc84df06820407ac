// block_extract: the block-extraction conv of the variant probe, in its five
// variants (ohonly, extract, nokeys, noselect, full).
//
// Replaces the TPU kernel tools/probe_block_conv.py `_variant_kernel`
// (launched by `_call`), which finds each row's key block by comparing it
// against a window of NBWL guard pairs, then extracts the block's features
// and byte-split keys with one-hot matmuls on the MXU. On Hopper a warp finds
// the block directly and adds the rows of the blocks that hit:
//
//   per row m and group g < G:  a = q[m, 3g+1] - 1,  r = bases[m / tile, g]
//     oh[j]  = a > sg1[r, j] && !(a > sg2[r, j])              (j < NBWL)
//     afeat  = sum_j oh[j] * f2[r*GB + j, :]                   (128 lanes)
//     akey   = int(sum_j oh[j] * k2q[r*GB + j, :])             (8H lanes)
//   and per variant (acc is the (C,) output row, summed over g):
//     ohonly    acc += sum_j oh[j]
//     extract   acc += (afeat @ w[g, 0])[:C]
//     nokeys    row_d = (q[m,3g+d] > 0) * sum_{j<2H} afeat[jC:(j+1)C]
//     noselect  row_d = afeat[:C] * eq_d[0]
//     full      row_d = sum_{j<2H} eq_d[j] * afeat[jC:(j+1)C]
//               (eq_d[j]: all 4 byte quarters of q[m,3g+d] equal akey[c*2H+j])
//     then      acc += (concat(row_0, row_1, row_2) @ w[g, 2, :3C])[:C]
// The semantics hold for any input: several ones in oh (duplicated guard
// values) add several rows, no one adds nothing; r is clamped to [0, NBr),
// as the TPU kernel's dynamic slices clamp their start.
//
// Layout: one block per tile of rows; the tile's G guard rows of sg1 and sg2
// are staged in shared memory once. One warp per row: each lane tests 32
// guard pairs per step (a ballot gives the hits in j order), holds 4 of the
// 128 feature lanes and one key lane, and lane k < C owns output column k.
// f32 throughout.
//
// Bound on the H100: operations. Per (row, group) the function needs the
// 2*NBWL compares of the block find, 2H*C + 8H adds per hit, 3 * 8H
// key-quarter compares and the selects, and 2*3C*C FLOPs of the weight
// product (extract: 2*128*C): about 2,400 operations for `full` at the s0
// shape against about 40 bytes of input per (row, group), above the H100's
// 20 f32 operations per byte of device memory. The guard rows come from
// shared memory, the feature rows and weights from L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GB = 16;   // guard rows per base step (ops/pallas/block_conv.py GB)
constexpr int F = 128;   // feature lanes of f2 and afeat
constexpr int CMAX = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Variant { OHONLY = 0, EXTRACT = 1, NOKEYS = 2, NOSELECT = 3, FULLV = 4 };

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
block_extract_kernel(const int* __restrict__ q, const int* __restrict__ bases,
                     const int* __restrict__ sg1, const int* __restrict__ sg2,
                     const float* __restrict__ k2q, const float* __restrict__ f2,
                     const float* __restrict__ w, float* __restrict__ out,
                     int tile, int G, int NBr, int NBWL, int H, int C, int Wc) {
  extern __shared__ int s_guard[];  // [G][NBWL] of sg1, then [G][NBWL] of sg2
  __shared__ float s_af[WARPS][F];
  __shared__ float s_im[WARPS][3 * CMAX];
  int* s_lo = s_guard;
  int* s_hi = s_guard + G * NBWL;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = 3 * G, H2 = 2 * H, KQ = 8 * H;
  constexpr bool KEYS = VARIANT == NOSELECT || VARIANT == FULLV;

  for (int i = threadIdx.x; i < G * NBWL; i += THREADS) {
    const int g = i / NBWL, j = i - g * NBWL;
    const int r = min(max(bases[t * G + g], 0), NBr - 1);
    s_lo[i] = sg1[(size_t)r * NBWL + j];
    s_hi[i] = sg2[(size_t)r * NBWL + j];
  }
  __syncthreads();

  for (int mi = warp; mi < tile; mi += WARPS) {
    const size_t m = (size_t)t * tile + mi;
    const int* qrow = q + m * K;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) {
      const int a = (int)((unsigned)qrow[3 * g + 1] - 1u);
      const int r = min(max(bases[t * G + g], 0), NBr - 1);
      const int* lo = s_lo + g * NBWL;
      const int* hi = s_hi + g * NBWL;
      const float* f2w = f2 + (size_t)r * GB * F;
      const float* k2w = k2q + (size_t)r * GB * KQ;
      float4 af = make_float4(0.f, 0.f, 0.f, 0.f);
      float ak = 0.f;
      int nhit = 0;
      for (int j0 = 0; j0 < NBWL; j0 += 32) {
        const int j = j0 + lane;
        const bool hit = j < NBWL && a > lo[j] && !(a > hi[j]);
        unsigned mask = __ballot_sync(FULL_MASK, hit);
        nhit += __popc(mask);
        if constexpr (VARIANT != OHONLY) {
          while (mask) {  // the hits of this step, in j order
            const int jj = j0 + __ffs(mask) - 1;
            mask &= mask - 1;
            const float4 v = reinterpret_cast<const float4*>(f2w + (size_t)jj * F)[lane];
            af.x += v.x; af.y += v.y; af.z += v.z; af.w += v.w;
            if (KEYS && lane < KQ) ak += k2w[(size_t)jj * KQ + lane];
          }
        }
      }
      if (VARIANT == OHONLY) {
        acc += (float)nhit;
        continue;
      }
      reinterpret_cast<float4*>(s_af[warp])[lane] = af;
      __syncwarp();
      if (VARIANT == EXTRACT) {
        if (lane < C) {
          const float* wg = w + ((size_t)g * 3 + 0) * F * Wc + lane;
          float s = 0.f;
          for (int i = 0; i < F; ++i) s = fmaf(s_af[warp][i], wg[(size_t)i * Wc], s);
          acc += s;
        }
        __syncwarp();
        continue;
      }
      const int akey = (int)ak;  // truncation, as the TPU kernel's astype(int32)
      for (int d = 0; d < 3; ++d) {
        const int qd = qrow[3 * g + d];
        unsigned eqm = 0;
        if (KEYS) {
          bool match = false;
          if (lane < KQ) {
            const int c = lane / H2;
            match = akey == ((qd >> (8 * c)) & 255);
          }
          const unsigned bits = __ballot_sync(FULL_MASK, match);
          eqm = (1u << H2) - 1u;
          for (int c = 0; c < 4; ++c) eqm &= bits >> (c * H2);
        }
        if (lane < C) {
          float rd = 0.f;
          if (VARIANT == NOSELECT) {
            rd = s_af[warp][lane] * (float)(eqm & 1u);
          } else {
            const bool pos = qd > 0;
            for (int j = 0; j < H2; ++j) {
              const bool sel = VARIANT == NOKEYS ? pos : ((eqm >> j) & 1u);
              rd += sel ? s_af[warp][j * C + lane] : 0.f;
            }
          }
          s_im[warp][d * C + lane] = rd;
        }
      }
      __syncwarp();
      if (lane < C) {
        const float* wg = w + ((size_t)g * 3 + 2) * F * Wc + lane;
        float s = 0.f;
        for (int i = 0; i < 3 * C; ++i) s = fmaf(s_im[warp][i], wg[(size_t)i * Wc], s);
        acc += s;
      }
      __syncwarp();
    }
    if (lane < C) out[m * C + lane] = acc;
  }
}

template <int VARIANT>
int launch(dim3 grid, size_t smem, cudaStream_t s, const int* q, const int* bases,
           const int* sg1, const int* sg2, const float* k2q, const float* f2,
           const float* w, float* out, int tile, int G, int NBr, int NBWL, int H,
           int C, int Wc) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_extract_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_extract_kernel<VARIANT><<<grid, THREADS, smem, s>>>(
      q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Mp, 3G) int32; bases (Mp/tile, G) int32; sg1, sg2 (NBr, NBWL) int32;
// k2q (NBP, 8H) f32; f2 (NBP, 128) f32, 16-byte aligned; w (G, 3, 128, Wc)
// f32; out (Mp, C) f32. NBP >= (NBr-1)*16 + NBWL, 8H <= 32, 2H*C <= 128,
// C <= 32, Wc >= C. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_extract_launch(const int* q, const int* bases, const int* sg1,
                                    const int* sg2, const float* k2q, const float* f2,
                                    const float* w, float* out, int Mp, int tile,
                                    int G, int NBr, int NBWL, int H, int C, int Wc,
                                    int variant, void* stream) {
  if (tile < 1 || Mp < 0 || Mp % tile != 0 || G < 1 || NBr < 1 || NBWL < 1 ||
      H < 1 || 8 * H > 32 || C < 1 || C > CMAX || 2 * H * C > F || Wc < C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * G * NBWL * sizeof(int);
  if (smem + sizeof(float) * WARPS * (F + 3 * CMAX) > 232448)
    return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  const dim3 grid((unsigned)(Mp / tile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case OHONLY: return launch<OHONLY>(grid, smem, s, q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
    case EXTRACT: return launch<EXTRACT>(grid, smem, s, q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
    case NOKEYS: return launch<NOKEYS>(grid, smem, s, q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
    case NOSELECT: return launch<NOSELECT>(grid, smem, s, q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
    case FULLV: return launch<FULLV>(grid, smem, s, q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr, NBWL, H, C, Wc);
    default: return (int)cudaErrorInvalidValue;
  }
}
