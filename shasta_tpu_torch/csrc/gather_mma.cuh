// Tensor-core gather-GEMM cores: both routes, bf16 and f32, of all three
// sparse-conv kernels (gather_conv, rulebook_conv, keyed_conv), f32 sums.
//
//   out[m, :] = sum_k feats[n(m, k), :] @ W_k      (a miss contributes 0)
//
// Bound on the H100: at the paths' densities (0.9 hits per row of 27 taps
// at stage 0, 1-13 deeper down) a conv does 2*hits*Cin*Co FLOPs against
// the neighbour table or queries (M*K*4 bytes), the f32 output (M*Co*4) and
// the feature table and W at their dtype's width. bf16 products run on
// mma.sync m16n8k16 (989 TFLOP/s dense): the bytes bound every bf16 conv.
// f32 products run at f32 accuracy as three TF32 passes (3xTF32) on
// mma.sync m16n8k8, 495/3 TFLOP/s, which bound the denser f32 frames: each
// operand x splits as it is loaded into fragment registers into hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and hi*hi +
// hi*lo + lo*hi is summed in f32, each pass over all of an item's
// accumulators before the next. The dropped lo*lo and the two roundings
// leave ~2^-21 of relative error a product, near what f32 FMAs' summation
// order gives. The split is made in registers, not stored as hi and lo
// planes in shared memory: planes would double the staged rows and W again,
// so that 32 -> 32 would leave the warp core and the staged core's stages
// would shrink. On the card an f32 staged tile's time follows its
// compacted rows more than its bytes (res3 against down3): the split's
// three instructions an element and the three MMAs a fragment, on the 8
// warps of the one block an SM holds, not the loads, set its pace.
//
// Finders. A Finder maps (m, k) to an input row through operator(); a row
// outside [0, V) is a miss (gather_conv's table, rulebook_conv's rulebook,
// keyed_conv's per-query search). A Finder that declares
// `static constexpr bool kResolvesTile = true` resolves a staged tile's
// whole neighbour table at once instead (keyed_conv: one staged search per
// dx triple, window_conv.cu), with the ring buffers, idle then, as its
// scratch.
//
// Two cores, chosen by `core_of` from the shapes and the dtype alone: where
// all K weight slices fit WC_W_BYTES_MAX of shared memory, the warp core
// (its note is below, with the code); else the staged core, for the wide
// convs, whose per-tap W slices must stream through shared memory. At 27
// taps bf16 takes the warp core up to 32 -> 64, f32 (twice the bytes) up to
// 32 -> 32; the extra conv's 3 taps of 128 -> 128 take it in bf16 only.
//
// The staged core, per block of TM output rows:
// - Resolve the TM x K neighbour rows into shared memory, then compact each
//   tap's hit rows in place with ballot / popc prefix sums: tap k has cnt[k]
//   hits, their input rows and their local output rows. Taps without a hit
//   are skipped.
// - Walk the hit taps in ascending order, in stages of up to RC compacted
//   rows x KC input channels (128 in bf16, 64 in f32: the same bytes). A
//   stage gathers only the hit rows, in their dtype as they are, with
//   16-byte cp.async copies (TMA has no gather mode on sm_90), and W_k's KC
//   x Co slice beside them. Two buffers: the next stage's rows and weights
//   load while this stage's products run. At Co >= 64 a stage holds all TM
//   rows, so a tap's W slice loads once per block: every block moves K x
//   Cin x Co weights from L2 (332 MB per bf16 128 -> 128 conv at 48k rows),
//   which a larger TM would cut but its f32 tile would not fit.
// - Products on the tensor cores over ceil(h/16) fragments of the h
//   compacted rows. ldmatrix feeds A from padded rows, free of bank
//   conflicts (an f32 row of 4 is a row of 8 b16 to it, which gives the
//   tf32 A fragment as it stands); bf16 B comes by ldmatrix.trans, f32 B by
//   32-bit loads from rows padded to 8 words past a multiple of 32 banks. A
//   warp's item is FR fragments x NJ 16-column groups, so that each A and B
//   fragment read from shared memory (whose bandwidth bounds the wide
//   convs' products) serves several products. Channels past Cin are zero in
//   both operands (Cin = 5 pads to 16 in bf16, 8 in f32). wgmma is not the
//   instrument here: it takes 64-row tiles, and a non-centre tap has a few
//   hits per tile at these densities, so most of its rows would be padding.
// - Each fragment's 16 x 8 results are added into an f32 TM x Co tile in
//   shared memory at their rows' places. Within a stage a compacted row
//   appears once and each column belongs to one warp, so every element has
//   one writer: no atomics, and the taps' order is fixed, so results are
//   identical from run to run. The tile goes to `out` once, coalesced.
//
// Each kernel instantiation raises its shared-memory limit once, to the
// most any shape can ask of it (the step launches ~2,100 kernels a frame
// from a host-bound loop; one card per process).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gmma {

constexpr int TM = 128;       // output rows per staged block
constexpr int NBUF = 2;       // stages in shared memory: one loading, one multiplying
constexpr int KMAX = 27;      // taps of a 3x3x3 kernel
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD_F32 = 4;    // 16 bytes past every accumulator row
constexpr int ROWS_LD = TM + 1;  // the neighbour table's row stride: no bank conflicts
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// What an operand dtype changes: the MMA's depth (and the channel padding),
// the elements of a 16-byte copy, the staged core's channels per stage and
// the row pads that keep the fragment loads free of bank conflicts.
template <typename T>
struct Op;
template <>
struct Op<bf16> {             // mma.sync m16n8k16
  static constexpr int KSTEP = 16, VEC = 8, KC = 128, W_PAD = 8, A_PAD = 8;
  static __device__ __forceinline__ bf16 zero() { return __float2bfloat16(0.f); }
};
template <>
struct Op<float> {            // 3xTF32 on mma.sync m16n8k8
  static constexpr int KSTEP = 8, VEC = 4, KC = 64, W_PAD = 8, A_PAD = 4;
  static __device__ __forceinline__ float zero() { return 0.f; }
};

// Compacted rows per stage: all of the tile at Co >= 64 (one W load per
// tap); half at the narrow widths, where the smaller stage buffers leave
// room for more blocks per SM.
__host__ __device__ constexpr int rows_per_stage(int co) { return co >= 64 ? TM : TM / 2; }

// Dynamic shared memory of a staged block, carved the same way on the host
// and the device.
template <typename T>
struct Layout {
  using E = Op<T>;
  int co, kcp, K;  // output width; channels per stage, padded to the MMA depth; taps
  __host__ __device__ constexpr Layout(int co_, int cin, int K_)
      : co(co_), kcp(((cin < E::KC ? cin : E::KC) + E::KSTEP - 1) / E::KSTEP * E::KSTEP),
        K(K_) {}
  __host__ __device__ constexpr int acc_ld() const { return co + PAD_F32; }
  __host__ __device__ constexpr int w_ld() const { return co + E::W_PAD; }
  __host__ __device__ constexpr int a_ld() const { return kcp + E::A_PAD; }
  __host__ __device__ constexpr size_t acc_bytes() const { return (size_t)TM * acc_ld() * 4; }
  __host__ __device__ constexpr size_t w_bytes() const { return (size_t)kcp * w_ld() * sizeof(T); }
  __host__ __device__ constexpr size_t a_bytes() const {
    return (size_t)rows_per_stage(co) * a_ld() * sizeof(T);
  }
  // the W and row rings, one after the other: a tile resolver's scratch
  __host__ __device__ constexpr size_t ring_bytes() const { return NBUF * (w_bytes() + a_bytes()); }
  __host__ __device__ constexpr size_t rows_bytes() const {
    return ((size_t)K * ROWS_LD * 4 + 15) / 16 * 16;
  }
  __host__ __device__ constexpr size_t loc_bytes() const { return ((size_t)K * TM + 15) / 16 * 16; }
  __host__ __device__ constexpr size_t bytes() const {
    return acc_bytes() + ring_bytes() + rows_bytes() + loc_bytes() + (2 * KMAX + 4) * 4;
  }
};

// Whether a Finder resolves whole staged tiles (see the note at the top):
//   find.resolve_tile(m0, M, rows, scratch)
// runs on all THREADS threads of the block and leaves rows[k * ROWS_LD + r],
// for r < TM, holding output row m0 + r's input row for tap k (in [0, V),
// or -1 for a miss and for m0 + r >= M); scratch is Finder::kScratchBytes
// of shared memory it may use.
template <typename F, typename = void>
struct resolves_tile : std::false_type {};
template <typename F>
struct resolves_tile<F, std::void_t<decltype(F::kResolvesTile)>>
    : std::bool_constant<F::kResolvesTile> {};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) @ b (16 x 8, column-major), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row-major) @ b (8 x 8, column-major), tf32 in, f32 accumulate
// (not volatile: the compiler may move it among independent instructions)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each a tf32 (round to nearest, ties away from zero)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split_tf32(float x) {
  Split s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s.hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s.lo) : "f"(x - __uint_as_float(s.hi)));
  return s;
}

// An f32 A fragment (4 registers of the m16n8k8 layout) split once
struct SplitA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ SplitA split_a(const float (&a)[4]) {
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split p = split_tf32(a[i]);
    s.hi[i] = p.hi;
    s.lo[i] = p.lo;
  }
  return s;
}

// One of the three passes of d += a @ b at f32 accuracy, the small products
// first: 0 lo*hi, 1 hi*lo, 2 hi*hi. Callers run each pass over all their
// accumulators before the next, so that an MMA does not wait on the one
// issued just before it (the three passes of one accumulator are a chain).
__device__ __forceinline__ void mma_pass(int pass, float (&d)[4], const SplitA& a, Split b0,
                                         Split b1) {
  if (pass == 0) mma_tf32(d, a.lo, b0.hi, b1.hi);
  else if (pass == 1) mma_tf32(d, a.hi, b0.lo, b1.lo);
  else mma_tf32(d, a.hi, b0.hi, b1.hi);
}

// One stage: hit tap taps[t], input channels [ci*KC, ..), compacted rows
// [rc*RC, ..). Stages run tap-major, then channel chunk, then row chunk, so
// W's slice changes exactly when rc wraps to 0; `run` counts those slices.
struct Stage {
  int t, ci, rc, run;
};

template <typename T, int CO, bool VEC, typename Finder>
__device__ __forceinline__ void gather_mma_tile(const T* __restrict__ feats,
                                                const T* __restrict__ w,
                                                float* __restrict__ out, int V, int M, int K,
                                                int Cin, const Finder& find) {
  static_assert(CO % 16 == 0 && CO <= 128, "output width");
  using E = Op<T>;
  constexpr int RC = rows_per_stage(CO), KC = E::KC, KS = E::KSTEP;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> L(CO, Cin, K);
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + L.acc_bytes();
  T* const wring = reinterpret_cast<T*>(p);          // NBUF W slices
  p += NBUF * L.w_bytes();
  T* const aring = reinterpret_cast<T*>(p);          // NBUF row stages
  p += NBUF * L.a_bytes();
  int* rows = reinterpret_cast<int*>(p);            // [k][ROWS_LD] input rows
  p += L.rows_bytes();
  unsigned char* loc = p;                            // [k][TM] output rows
  p += L.loc_bytes();
  int* cnt = reinterpret_cast<int*>(p);              // hits per tap
  int* taps = cnt + KMAX;                            // the hit taps, ascending
  int* ntaps = taps + KMAX;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * TM;
  const int acc_ld = L.acc_ld(), w_ld = L.w_ld(), a_ld = L.a_ld();

  // 1. resolve the tile's neighbour rows: the finder's own resolver, or one
  // find per entry (row-major walk: coalesced reads)
  if constexpr (resolves_tile<Finder>::value) {
    find.resolve_tile(m0, M, rows, reinterpret_cast<int*>(wring));
  } else {
    for (int e = tid; e < TM * K; e += THREADS) {
      const int r = e / K, k = e - r * K;
      const int m = m0 + r;
      int row = m < M ? find(m, k) : -1;
      if (row >= V || row < 0) row = -1;
      rows[k * ROWS_LD + r] = row;
    }
  }
  for (int e = tid; e < TM * acc_ld / 4; e += THREADS) {
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // 2. compact each tap's hits in place (a write never passes a read)
  for (int k = warp; k < K; k += WARPS) {
    int base = 0;
    for (int r0 = 0; r0 < TM; r0 += 32) {
      const int v = rows[k * ROWS_LD + r0 + lane];
      const unsigned hit = __ballot_sync(FULL, v >= 0);
      if (v >= 0) {
        const int at = base + __popc(hit & ((1u << lane) - 1));
        rows[k * ROWS_LD + at] = v;
        loc[k * TM + at] = (unsigned char)(r0 + lane);
      }
      base += __popc(hit);
    }
    if (lane == 0) cnt[k] = base;
  }
  __syncthreads();
  if (warp == 0) {  // the hit taps, ascending (K <= 32)
    const bool any = lane < K && cnt[lane] > 0;
    const unsigned hit = __ballot_sync(FULL, any);
    if (any) taps[__popc(hit & ((1u << lane) - 1))] = lane;
    if (lane == 0) *ntaps = __popc(hit);
  }
  __syncthreads();

  const int nt = *ntaps, nci = (Cin + KC - 1) / KC;

  // stage `s`'s compacted rows into a, and W's slice into wb (if not null)
  auto load = [&](const Stage& s, T* a, T* wb) {
    const int k = taps[s.t], h0 = s.rc * RC, h = min(RC, cnt[k] - h0);
    const int c0 = s.ci * KC, kc = min(KC, Cin - c0), kcp = (kc + KS - 1) / KS * KS;
    const int* src_rows = rows + k * ROWS_LD + h0;
    const T* wk = w + ((size_t)k * Cin + c0) * CO;
    if constexpr (VEC) {  // Cin % E::VEC == 0, both tables 16-byte aligned
      constexpr int EV = E::VEC;
      const int segs = kc / EV;
      for (int e = tid; e < h * segs; e += THREADS) {
        const int r = e / segs, g = e - r * segs;
        cp_async16(a + r * a_ld + EV * g, feats + (size_t)src_rows[r] * Cin + c0 + EV * g);
      }
      if (wb) {
        for (int e = tid; e < kc * (CO / EV); e += THREADS) {
          const int r = e / (CO / EV), g = e - r * (CO / EV);
          cp_async16(wb + r * w_ld + EV * g, wk + (size_t)r * CO + EV * g);
        }
      }
    } else {  // element by element (an f32 row of Cin = 5 is 20 bytes)
      for (int e = tid; e < h * kc; e += THREADS) {
        const int r = e / kc, c = e - r * kc;
        a[r * a_ld + c] = feats[(size_t)src_rows[r] * Cin + c0 + c];
      }
      if (wb) {
        for (int e = tid; e < kc * CO; e += THREADS) {
          const int r = e / CO, c = e - r * CO;
          wb[r * w_ld + c] = wk[e];
        }
      }
    }
    if (kcp != kc) {  // channels past Cin: zero in both operands
      for (int e = tid; e < h * (kcp - kc); e += THREADS) {
        const int r = e / (kcp - kc);
        a[r * a_ld + kc + e - r * (kcp - kc)] = E::zero();
      }
      if (wb) {
        for (int e = tid; e < (kcp - kc) * CO; e += THREADS) {
          wb[(kc + e / CO) * w_ld + e % CO] = E::zero();
        }
      }
    }
  };

  // products of stage `s` into acc: warp items of FR 16-row fragments x NJ
  // 16-column groups; each A fragment serves 2*NJ products, each B pair FR.
  // f32 at Co = 128 takes 64-column items: an A fragment, split once per
  // item, serves twice the products (a fifth off res3 on an H100, with
  // down3 a tenth slower for its fewer items: probe_f32_route's "NJ 2")
  auto compute = [&](const Stage& s, const T* a, const T* wb) {
    const int k = taps[s.t], h0 = s.rc * RC, h = min(RC, cnt[k] - h0);
    const int kc = min(KC, Cin - s.ci * KC), kcp = (kc + KS - 1) / KS * KS;
    const unsigned char* lk = loc + k * TM + h0;
    constexpr int NJ = std::is_same_v<T, float> && CO >= 128 ? 4 : CO >= 32 ? 2 : 1;
    constexpr int FR = CO >= 64 ? 2 : 1, NG = CO / (16 * NJ);
    const int nf = (h + 15) / 16, items = (nf + FR - 1) / FR * NG;
    for (int it = warp; it < items; it += WARPS) {
      const int f0 = it / NG * FR, j = it % NG, fr = min(FR, nf - f0);  // warp-uniform
      float c[FR][2 * NJ][4] = {};
      if constexpr (std::is_same_v<T, bf16>) {
        const bf16* arow = a + (16 * f0 + (lane & 15)) * a_ld + 8 * (lane >> 4);
        const bf16* brow = wb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * w_ld + 16 * NJ * j +
                           8 * (lane >> 4);
        for (int kk = 0; kk < kcp; kk += 16) {
          uint32_t af[FR][4];
#pragma unroll
          for (int i = 0; i < FR; ++i) {
            if (i < fr) ldmatrix_x4(af[i], arow + 16 * i * a_ld + kk);
          }
#pragma unroll
          for (int n = 0; n < NJ; ++n) {
            uint32_t bfr[4];
            ldmatrix_x4_trans(bfr, brow + kk * w_ld + 16 * n);
#pragma unroll
            for (int i = 0; i < FR; ++i) {
              if (i < fr) {
                mma_bf16(c[i][2 * n], af[i], bfr[0], bfr[1]);
                mma_bf16(c[i][2 * n + 1], af[i], bfr[2], bfr[3]);
              }
            }
          }
        }
      } else {
        // A by ldmatrix: lanes 0-15 address rows 0-15 at column 0, lanes
        // 16-31 at column 4; B: lane (g, q) reads rows q and q + 4, column g
        const float* arow = a + (16 * f0 + (lane & 15)) * a_ld + 4 * (lane >> 4);
        const float* bcol = wb + (lane & 3) * w_ld + 16 * NJ * j + (lane >> 2);
        for (int kk = 0; kk < kcp; kk += 8) {
          SplitA af[FR];
#pragma unroll
          for (int i = 0; i < FR; ++i) {
            if (i < fr) {
              uint32_t r[4];
              ldmatrix_x4(r, arow + 16 * i * a_ld + kk);
              const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                                  __uint_as_float(r[2]), __uint_as_float(r[3])};
              af[i] = split_a(x);
            }
          }
          Split b[2 * NJ][2];
#pragma unroll
          for (int n8 = 0; n8 < 2 * NJ; ++n8) {
            const float* bp = bcol + kk * w_ld + 8 * n8;
            b[n8][0] = split_tf32(bp[0]);
            b[n8][1] = split_tf32(bp[4 * w_ld]);
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int i = 0; i < FR; ++i) {
#pragma unroll
              for (int n8 = 0; n8 < 2 * NJ; ++n8) {
                if (i < fr) mma_pass(pass, c[i][n8], af[i], b[n8][0], b[n8][1]);
              }
            }
          }
        }
      }
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int i = 0; i < FR; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int hr = 16 * (f0 + i) + g + 8 * half;
          if (i < fr && hr < h) {
            float* dst = acc + lk[hr] * acc_ld + 16 * NJ * j + 2 * q;
#pragma unroll
            for (int n8 = 0; n8 < 2 * NJ; ++n8) {
              float2 v = *reinterpret_cast<float2*>(dst + 8 * n8);
              v.x += c[i][n8][2 * half];
              v.y += c[i][n8][2 * half + 1];
              *reinterpret_cast<float2*>(dst + 8 * n8) = v;
            }
          }
        }
      }
    }
  };

  // the stage after `s`; nt marks the end
  auto next = [&](Stage s) {
    if ((s.rc + 1) * RC < cnt[taps[s.t]]) {
      ++s.rc;
      return s;
    }
    s.rc = 0;
    ++s.run;
    if (++s.ci == nci) {
      s.ci = 0;
      ++s.t;
    }
    return s;
  };

  // 3. the stages: stage i in row buffer i % NBUF, its W slice (run j) in W
  // buffer j % NBUF. Once stage i has landed, the load of stage i + NBUF - 1
  // goes out before stage i's products, into the buffers of stage i - 1 (or
  // of a run that ended by then), which the barrier has seen every warp
  // finish.
  constexpr int P = NBUF - 1;
  const size_t a_elems = L.a_bytes() / sizeof(T), w_elems = L.w_bytes() / sizeof(T);
  auto issue = [&](Stage& s, int i) {
    if (s.t < nt) {
      load(s, aring + (i % NBUF) * a_elems, s.rc == 0 ? wring + (s.run % NBUF) * w_elems : nullptr);
      s = next(s);
    }
    cp_async_commit();
  };
  Stage ld{0, 0, 0, 0}, cur{0, 0, 0, 0};
  for (int i = 0; i < P; ++i) issue(ld, i);
  for (int i = 0; cur.t < nt; ++i) {
    cp_async_wait<P - 1>();
    __syncthreads();
    issue(ld, i + P);
    compute(cur, aring + (i % NBUF) * a_elems, wring + (cur.run % NBUF) * w_elems);
    cur = next(cur);
  }
  __syncthreads();

  // 4. the tile to `out`, once, coalesced
  for (int e = tid; e < TM * (CO / 4); e += THREADS) {
    const int r = e / (CO / 4), c4 = e - r * (CO / 4);
    if (m0 + r < M) {
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * CO + 4 * c4) =
          *reinterpret_cast<const float4*>(acc + r * acc_ld + 4 * c4);
    }
  }
}

// The warp core, for convs whose K weight slices all fit in shared memory
// (at 27 taps, bf16 up to 32 -> 64, 20.7 to 124.4 KB of W, and the extra
// conv's 3 taps of 128 -> 128, 104 KB; f32 up to 32 -> 32, 20.7 to 138.2
// KB). There a tap has a few hits per tile, and a stage of the core above
// is a handful of rows behind a barrier and a load's latency, 27 times per
// block. Here the block loads all of W once, and then each warp owns 16
// output rows and walks their hit taps alone, with no barrier:
// - the warp reads its 16 x K gather entries in one coalesced load into
//   shared memory, and their OR over the rows gives its hit taps: a tap
//   none of its rows hits costs nothing;
// - for a hit tap the 16 rows' inputs go straight from L2 into the mma A
//   fragment registers (a miss or a channel past Cin is a zero, not a
//   load; f32 splits there), B comes from shared memory (bf16 by ldmatrix,
//   f32 by 32-bit loads), and the 16 x Co sum stays in registers. At res1's
//   density (5 hits per row) a warp runs ~26 taps with ~1 useful row in 5:
//   cheap on the tensor cores, and only the hit rows' bytes move.
// Each output element has one owner lane and a fixed tap order: no
// atomics, identical results from run to run.
constexpr int WC_WARPS = 16;
constexpr int WC_THREADS = 32 * WC_WARPS;
constexpr int WC_ROWS = 16 * WC_WARPS;      // output rows per block
constexpr size_t WC_W_BYTES_MAX = 160 * 1024;

template <typename T>
__host__ __device__ inline int warp_core_kcp(int Cin) {
  return (Cin + Op<T>::KSTEP - 1) / Op<T>::KSTEP * Op<T>::KSTEP;
}

template <typename T>
__host__ __device__ inline size_t warp_core_w_bytes(int K, int Cin, int co) {
  return (size_t)K * warp_core_kcp<T>(Cin) * (co + Op<T>::W_PAD) * sizeof(T);
}

template <typename T>
__host__ __device__ inline size_t warp_core_bytes(int K, int Cin, int co) {
  return warp_core_w_bytes<T>(K, Cin, co) + (size_t)WC_ROWS * K * 4;
}

// feats[r, c], feats[r, c + 1] as one bf16 pair (the lower column in the low
// half), zero for a miss (r < 0) or a channel past Cin. VEC: Cin even,
// 4-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint32_t a_pair(const bf16* __restrict__ feats, int r, int c,
                                           int Cin) {
  if (r < 0 || c >= Cin) return 0u;
  const bf16* src = feats + (size_t)r * Cin + c;
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint32_t*>(src));
  } else {
    const uint32_t lo = __bfloat16_as_ushort(src[0]);
    const uint32_t hi = c + 1 < Cin ? __bfloat16_as_ushort(src[1]) : 0u;
    return lo | (hi << 16);
  }
}

// feats[r, c], zero for a miss (r < 0) or a channel past Cin
__device__ __forceinline__ float a_elem(const float* __restrict__ feats, int r, int c, int Cin) {
  return r < 0 || c >= Cin ? 0.f : __ldg(feats + (size_t)r * Cin + c);
}

template <typename T, int CO, bool VEC, typename Finder>
__device__ __forceinline__ void gather_mma_warp_tile(const T* __restrict__ feats,
                                                     const T* __restrict__ w,
                                                     float* __restrict__ out, int V, int M,
                                                     int K, int Cin, const Finder& find) {
  static_assert(CO % 16 == 0 && CO <= 128, "output width");
  constexpr int EV = Op<T>::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kcp = warp_core_kcp<T>(Cin), w_ld = CO + Op<T>::W_PAD;
  T* const ws = reinterpret_cast<T*>(smem);  // [K][kcp][w_ld]: every W_k
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* const rows = reinterpret_cast<int*>(smem + warp_core_w_bytes<T>(K, Cin, CO)) +
                    warp * 16 * K;                 // the warp's [16][K] input rows

  // 1. all K weight slices, channels past Cin zero
  if constexpr (VEC) {  // 16-byte rows of EV columns
    for (int e = tid; e < K * kcp * (CO / EV); e += WC_THREADS) {
      const int kc = e / (CO / EV), n = e - kc * (CO / EV), k = kc / kcp, c = kc - k * kcp;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < Cin) v = __ldg(reinterpret_cast<const uint4*>(w + ((size_t)k * Cin + c) * CO) + n);
      *reinterpret_cast<uint4*>(ws + (size_t)kc * w_ld + EV * n) = v;
    }
  } else {
    for (int e = tid; e < K * kcp * CO; e += WC_THREADS) {
      const int kc = e / CO, n = e - kc * CO, k = kc / kcp, c = kc - k * kcp;
      ws[(size_t)kc * w_ld + n] = c < Cin ? w[((size_t)k * Cin + c) * CO + n] : Op<T>::zero();
    }
  }

  // 2. the warp's 16 rows' gather entries (-1: a miss) and its hit taps
  const int m0 = blockIdx.x * WC_ROWS + 16 * warp;
  unsigned taps = 0;  // bit k: some row hits tap k (K <= 32)
  for (int e = lane; e < 16 * K; e += 32) {
    const int r = e / K, k = e - r * K, m = m0 + r;
    int row = m < M ? find(m, k) : -1;
    if (row >= V || row < 0) row = -1;
    else taps |= 1u << k;
    rows[e] = row;
  }
  taps = __reduce_or_sync(FULL, taps);
  __syncthreads();  // W is in; the warps' rows are their own from here

  // 3. lane (g, q) holds rows g and g + 8 of the A and accumulator
  // fragments: of A columns 2q, 2q + 1 (+ 8) in bf16, q (+ 4) in f32; of
  // each 8-column accumulator tile columns 2q, 2q + 1
  const int g = lane >> 2, q = lane & 3;
  float acc[CO / 8][4] = {};
  for (; taps; taps &= taps - 1) {
    const int k = __ffs(taps) - 1;
    const int rlo = rows[g * K + k], rhi = rows[(g + 8) * K + k];
    if constexpr (std::is_same_v<T, bf16>) {
      const bf16* wk = ws + ((lane & 7) + 8 * ((lane >> 3) & 1)) * w_ld + 8 * (lane >> 4) +
                       (size_t)k * kcp * w_ld;
      for (int kk = 0; kk < kcp; kk += 16) {
        const uint32_t a[4] = {a_pair<VEC>(feats, rlo, kk + 2 * q, Cin),
                               a_pair<VEC>(feats, rhi, kk + 2 * q, Cin),
                               a_pair<VEC>(feats, rlo, kk + 8 + 2 * q, Cin),
                               a_pair<VEC>(feats, rhi, kk + 8 + 2 * q, Cin)};
#pragma unroll
        for (int n = 0; n < CO / 16; ++n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wk + kk * w_ld + 16 * n);
          mma_bf16(acc[2 * n], a, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
        }
      }
    } else {  // A: rows g, g + 8 at columns q, q + 4; B: rows q, q + 4 at column g
      const float* wk = ws + q * w_ld + g + (size_t)k * kcp * w_ld;
      for (int k0 = 0; k0 < kcp; k0 += 32) {  // four k-steps' loads in flight at once
        float a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // past kcp every column is past Cin: zeros
          const int kk = k0 + 8 * s;
          a[s][0] = a_elem(feats, rlo, kk + q, Cin);
          a[s][1] = a_elem(feats, rhi, kk + q, Cin);
          a[s][2] = a_elem(feats, rlo, kk + 4 + q, Cin);
          a[s][3] = a_elem(feats, rhi, kk + 4 + q, Cin);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int kk = k0 + 8 * s;
          if (kk >= kcp) break;
          const SplitA as = split_a(a[s]);
          Split b[CO / 8][2];
#pragma unroll
          for (int n8 = 0; n8 < CO / 8; ++n8) {
            const float* bp = wk + kk * w_ld + 8 * n8;
            b[n8][0] = split_tf32(bp[0]);
            b[n8][1] = split_tf32(bp[4 * w_ld]);
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int n8 = 0; n8 < CO / 8; ++n8) mma_pass(pass, acc[n8], as, b[n8][0], b[n8][1]);
          }
        }
      }
    }
  }

  // 4. the sums to `out`: per 8-column tile, 8 rows of 32 contiguous bytes
  const int mlo = m0 + g, mhi = m0 + g + 8;
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
    if (mlo < M)
      *reinterpret_cast<float2*>(out + (size_t)mlo * CO + 8 * j + 2 * q) =
          make_float2(acc[j][0], acc[j][1]);
    if (mhi < M)
      *reinterpret_cast<float2*>(out + (size_t)mhi * CO + 8 * j + 2 * q) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <typename T, int CO, bool VEC, typename Finder>
__global__ void __launch_bounds__(WC_THREADS)
gather_mma_warp_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                       float* __restrict__ out, int V, int M, int K, int Cin, Finder find) {
  gather_mma_warp_tile<T, CO, VEC>(feats, w, out, V, M, K, Cin, find);
}

template <typename T, int CO, bool VEC, typename Finder>
__global__ void __launch_bounds__(THREADS)
gather_mma_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                  float* __restrict__ out, int V, int M, int K, int Cin, Finder find) {
  gather_mma_tile<T, CO, VEC>(feats, w, out, V, M, K, Cin, find);
}

enum Core : int { WARP = 0, STAGED = 1 };

// The core a conv of these shapes and this operand type takes: the warp
// core where all of W fits its budget, else the staged core.
template <typename T>
inline int core_of(int K, int Cin, int Co) {
  return warp_core_w_bytes<T>(K, Cin, Co) <= WC_W_BYTES_MAX ? WARP : STAGED;
}

// static: each kernel library keeps its own copy of run's function-local
// statics. With external linkage, one instantiation in two libraries of a
// process would share them (a unique symbol), and the second library's
// kernel would never get its shared-memory limit raised.
template <typename T, int CO, bool VEC, typename Finder>
static int run(const Finder& find, const void* feats, const void* w, float* out, int V, int M,
        int K, int Cin, cudaStream_t stream) {
  const T* f = static_cast<const T*>(feats);
  const T* wt = static_cast<const T*>(w);
  if (core_of<T>(K, Cin, CO) == WARP) {
    auto kernel = gather_mma_warp_kernel<T, CO, VEC, Finder>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(WC_W_BYTES_MAX + (size_t)WC_ROWS * KMAX * 4));
    if (attr != cudaSuccess) return (int)attr;
    kernel<<<(M + WC_ROWS - 1) / WC_ROWS, WC_THREADS, warp_core_bytes<T>(K, Cin, CO), stream>>>(
        f, wt, out, V, M, K, Cin, find);
    return (int)cudaGetLastError();
  }
  if constexpr (resolves_tile<Finder>::value) {  // the smallest ring holds the scratch
    static_assert(Layout<T>(16, 1, 1).ring_bytes() >= Finder::kScratchBytes, "resolver scratch");
  }
  auto kernel = gather_mma_kernel<T, CO, VEC, Finder>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<T>(CO, Op<T>::KC, KMAX).bytes());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(M + TM - 1) / TM, THREADS, Layout<T>(CO, Cin, K).bytes(), stream>>>(f, wt, out, V, M,
                                                                              K, Cin, find);
  return (int)cudaGetLastError();
}

// Host-side launch over the output width: feats (V, Cin) and weights (K,
// Cin, Co) of type T (bf16 or float), out (M, Co) f32. Returns
// cudaGetLastError() after the launch (0 = launched).
template <typename T, typename Finder>
int launch(const Finder& find, const void* feats, const void* w, float* out, int V, int M,
           int K, int Cin, int Co, cudaStream_t stream) {
  if (K < 1 || K > KMAX || Cin < 1) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const bool vec = Cin % Op<T>::VEC == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define GMMA_CASE(CO_)                                                                   \
  case CO_:                                                                              \
    return vec ? run<T, CO_, true>(find, feats, w, out, V, M, K, Cin, stream)            \
               : run<T, CO_, false>(find, feats, w, out, V, M, K, Cin, stream);
  switch (Co) {
    GMMA_CASE(16)
    GMMA_CASE(32)
    GMMA_CASE(64)
    GMMA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GMMA_CASE
}

}  // namespace gmma
