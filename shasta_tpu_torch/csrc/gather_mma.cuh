// Tensor-core gather-GEMM cores: the bf16 route of all three sparse-conv
// kernels (gather_conv, rulebook_conv, keyed_conv), f32 sums. Their f32
// route is the CUDA-core core gather_conv.cuh.
//
//   out[m, :] = sum_k feats[n(m, k), :] @ W_k      (a miss contributes 0)
//
// Bound on the H100: at the step's densities (0.9 hits per row of 27 taps
// at stage 0, 1-13 deeper down) a conv does 2*hits*Cin*Co FLOPs against
// the neighbour table or queries (M*K*4 bytes) and the f32 output
// (M*Co*4): bytes, far below the bf16 tensor-core rate. The CUDA-core core
// instead does 64*Cin*Co FMAs in f32 for every tap with any hit in a
// 64-row tile, whether each row hits or not: ~27x the useful work, plus
// bf16 widened to f32 in shared memory.
//
// Finders. A Finder maps (m, k) to an input row through operator(); a row
// outside [0, V) is a miss (gather_conv's table, rulebook_conv's rulebook,
// keyed_conv's per-query search). A Finder that declares
// `static constexpr bool kResolvesTile = true` resolves a staged tile's
// whole neighbour table at once instead (keyed_conv: one staged search per
// dx triple, window_conv.cu), with the ring buffers, idle then, as its
// scratch.
//
// Two cores, chosen by `core_of` from the shapes alone: where all K weight
// slices fit WC_W_BYTES_MAX of shared memory, the warp core (its note is
// below, with the code); else the staged core, for the wide convs (64 ->
// 64 and up at 27 taps), whose per-tap W slices must stream through shared
// memory.
//
// The staged core, per block of TM output rows:
// - Resolve the TM x K neighbour rows into shared memory, then compact each
//   tap's hit rows in place with ballot / popc prefix sums: tap k has cnt[k]
//   hits, their input rows and their local output rows. Taps without a hit
//   are skipped.
// - Walk the hit taps in ascending order, in stages of up to RC compacted
//   rows x KC input channels. A stage gathers only the hit rows, in bf16 as
//   they are, with 16-byte cp.async copies (TMA has no gather mode on
//   sm_90), and W_k's KC x Co slice beside them. Two buffers: the next
//   stage's rows and weights load while this stage's products run. At
//   Co >= 64 a stage holds all TM rows, so a tap's W slice loads once per
//   block: every block moves K x Cin x Co weights from L2 (332 MB per
//   128 -> 128 conv at 48k rows), which a larger TM would cut but its f32
//   tile would not fit.
// - Products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out)
//   over ceil(h/16) fragments of the h compacted rows; ldmatrix feeds A and
//   (transposed) B from padded rows, free of bank conflicts. A warp's item
//   is FR fragments x NJ 16-column groups, so that each A and B fragment
//   read from shared memory (whose bandwidth bounds the wide convs'
//   products) serves several products. Channels past Cin are zero in both
//   operands (Cin = 5 pads to 16). wgmma is not the
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
constexpr int KC = 128;       // input channels per stage
constexpr int KMAX = 27;      // taps of a 3x3x3 kernel
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD_BF16 = 8;   // 16 bytes past every staged bf16 row
constexpr int PAD_F32 = 4;    // 16 bytes past every accumulator row
constexpr int ROWS_LD = TM + 1;  // the neighbour table's row stride: no bank conflicts
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// Compacted rows per stage: all of the tile at Co >= 64 (one W load per
// tap); half at the narrow widths, where the smaller stage buffers leave
// room for more blocks per SM.
__host__ __device__ constexpr int rows_per_stage(int co) { return co >= 64 ? TM : TM / 2; }

// Dynamic shared memory of a staged block, carved the same way on the host
// and the device.
struct Layout {
  int co, kcp, K;  // output width; channels per stage, padded to 16; taps
  __host__ __device__ constexpr Layout(int co_, int cin, int K_)
      : co(co_), kcp(((cin < KC ? cin : KC) + 15) / 16 * 16), K(K_) {}
  __host__ __device__ constexpr int acc_ld() const { return co + PAD_F32; }
  __host__ __device__ constexpr int w_ld() const { return co + PAD_BF16; }
  __host__ __device__ constexpr int a_ld() const { return kcp + PAD_BF16; }
  __host__ __device__ constexpr size_t acc_bytes() const { return (size_t)TM * acc_ld() * 4; }
  __host__ __device__ constexpr size_t w_bytes() const { return (size_t)kcp * w_ld() * 2; }
  __host__ __device__ constexpr size_t a_bytes() const {
    return (size_t)rows_per_stage(co) * a_ld() * 2;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
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

// One stage: hit tap taps[t], input channels [ci*KC, ..), compacted rows
// [rc*RC, ..). Stages run tap-major, then channel chunk, then row chunk, so
// W's slice changes exactly when rc wraps to 0; `run` counts those slices.
struct Stage {
  int t, ci, rc, run;
};

template <int CO, bool VEC, typename Finder>
__device__ __forceinline__ void gather_mma_tile(const bf16* __restrict__ feats,
                                                const bf16* __restrict__ w,
                                                float* __restrict__ out, int V, int M, int K,
                                                int Cin, const Finder& find) {
  static_assert(CO % 16 == 0 && CO <= 128, "output width");
  constexpr int RC = rows_per_stage(CO);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(CO, Cin, K);
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + L.acc_bytes();
  bf16* const wring = reinterpret_cast<bf16*>(p);  // NBUF W slices
  p += NBUF * L.w_bytes();
  bf16* const aring = reinterpret_cast<bf16*>(p);  // NBUF row stages
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
  auto load = [&](const Stage& s, bf16* a, bf16* wb) {
    const int k = taps[s.t], h0 = s.rc * RC, h = min(RC, cnt[k] - h0);
    const int c0 = s.ci * KC, kc = min(KC, Cin - c0), kcp = (kc + 15) / 16 * 16;
    const int* src_rows = rows + k * ROWS_LD + h0;
    const bf16* wk = w + ((size_t)k * Cin + c0) * CO;
    if constexpr (VEC) {  // Cin % 8 == 0, both tables 16-byte aligned
      const int segs = kc / 8;
      for (int e = tid; e < h * segs; e += THREADS) {
        const int r = e / segs, g = e - r * segs;
        cp_async16(a + r * a_ld + 8 * g, feats + (size_t)src_rows[r] * Cin + c0 + 8 * g);
      }
      if (wb) {
        for (int e = tid; e < kc * (CO / 8); e += THREADS) {
          const int r = e / (CO / 8), g = e - r * (CO / 8);
          cp_async16(wb + r * w_ld + 8 * g, wk + (size_t)r * CO + 8 * g);
        }
      }
    } else {
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
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < h * (kcp - kc); e += THREADS) {
        const int r = e / (kcp - kc);
        a[r * a_ld + kc + e - r * (kcp - kc)] = zero;
      }
      if (wb) {
        for (int e = tid; e < (kcp - kc) * CO; e += THREADS) wb[(kc + e / CO) * w_ld + e % CO] = zero;
      }
    }
  };

  // products of stage `s` into acc: warp items of FR 16-row fragments x NJ
  // 16-column groups; each A fragment serves 2*NJ products, each B pair FR
  auto compute = [&](const Stage& s, const bf16* a, const bf16* wb) {
    const int k = taps[s.t], h0 = s.rc * RC, h = min(RC, cnt[k] - h0);
    const int kc = min(KC, Cin - s.ci * KC), kcp = (kc + 15) / 16 * 16;
    const unsigned char* lk = loc + k * TM + h0;
    constexpr int NJ = CO >= 32 ? 2 : 1, FR = CO >= 64 ? 2 : 1, NG = CO / (16 * NJ);
    const int nf = (h + 15) / 16, items = (nf + FR - 1) / FR * NG;
    for (int it = warp; it < items; it += WARPS) {
      const int f0 = it / NG * FR, j = it % NG, fr = min(FR, nf - f0);  // warp-uniform
      float c[FR][2 * NJ][4] = {};
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
  auto issue = [&](Stage& s, int i) {
    if (s.t < nt) {
      load(s, aring + (i % NBUF) * (L.a_bytes() / 2),
           s.rc == 0 ? wring + (s.run % NBUF) * (L.w_bytes() / 2) : nullptr);
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
    compute(cur, aring + (i % NBUF) * (L.a_bytes() / 2),
            wring + (cur.run % NBUF) * (L.w_bytes() / 2));
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
// (every conv up to 32 -> 64 at 27 taps, 20.7 to 124.4 KB of W, and the
// extra conv's 3 taps of 128 -> 128, 104 KB). There a tap has a few hits
// per tile, and a stage of the core above
// is a handful of rows behind a barrier and a load's latency, 27 times per
// block. Here the block loads all of W once, and then each warp owns 16
// output rows and walks their hit taps alone, with no barrier:
// - the warp reads its 16 x K gather entries in one coalesced load into
//   shared memory, and their OR over the rows gives its hit taps: a tap
//   none of its rows hits costs nothing;
// - for a hit tap the 16 rows' inputs go straight from L2 into the mma A
//   fragment registers (a miss or a channel past Cin is a zero, not a
//   load), B comes from shared memory by ldmatrix, and the 16 x Co sum
//   stays in registers. At res1's density (5 hits per row) a warp runs
//   ~26 taps with ~1 useful row in 5: cheap on the tensor cores, and only
//   the hit rows' bytes move.
// Each output element has one owner lane and a fixed tap order: no
// atomics, identical results from run to run.
constexpr int WC_WARPS = 16;
constexpr int WC_THREADS = 32 * WC_WARPS;
constexpr int WC_ROWS = 16 * WC_WARPS;      // output rows per block
constexpr size_t WC_W_BYTES_MAX = 160 * 1024;

__host__ __device__ inline size_t warp_core_w_bytes(int K, int Cin, int co) {
  return (size_t)K * ((Cin + 15) / 16 * 16) * (co + PAD_BF16) * 2;
}

__host__ __device__ inline size_t warp_core_bytes(int K, int Cin, int co) {
  return warp_core_w_bytes(K, Cin, co) + (size_t)WC_ROWS * K * 4;
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

template <int CO, bool VEC, typename Finder>
__device__ __forceinline__ void gather_mma_warp_tile(const bf16* __restrict__ feats,
                                                     const bf16* __restrict__ w,
                                                     float* __restrict__ out, int V, int M,
                                                     int K, int Cin, const Finder& find) {
  static_assert(CO % 16 == 0 && CO <= 128, "output width");
  extern __shared__ __align__(16) unsigned char smem[];
  const int kcp = (Cin + 15) / 16 * 16, w_ld = CO + PAD_BF16;
  bf16* const ws = reinterpret_cast<bf16*>(smem);  // [K][kcp][w_ld]: every W_k
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* const rows = reinterpret_cast<int*>(smem + warp_core_w_bytes(K, Cin, CO)) +
                    warp * 16 * K;                 // the warp's [16][K] input rows

  // 1. all K weight slices, channels past Cin zero
  if constexpr (VEC) {  // 16-byte rows of 8 columns
    for (int e = tid; e < K * kcp * (CO / 8); e += WC_THREADS) {
      const int kc = e / (CO / 8), n8 = e - kc * (CO / 8), k = kc / kcp, c = kc - k * kcp;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < Cin) v = __ldg(reinterpret_cast<const uint4*>(w + ((size_t)k * Cin + c) * CO) + n8);
      *reinterpret_cast<uint4*>(ws + (size_t)kc * w_ld + 8 * n8) = v;
    }
  } else {
    for (int e = tid; e < K * kcp * CO; e += WC_THREADS) {
      const int kc = e / CO, n = e - kc * CO, k = kc / kcp, c = kc - k * kcp;
      ws[(size_t)kc * w_ld + n] = c < Cin ? w[((size_t)k * Cin + c) * CO + n]
                                          : __float2bfloat16(0.f);
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
  // fragments, columns 2q, 2q + 1 (+ 8)
  const int g = lane >> 2, q = lane & 3;
  float acc[CO / 8][4] = {};
  const bf16* const wl = ws + ((lane & 7) + 8 * ((lane >> 3) & 1)) * w_ld + 8 * (lane >> 4);
  for (; taps; taps &= taps - 1) {
    const int k = __ffs(taps) - 1;
    const int rlo = rows[g * K + k], rhi = rows[(g + 8) * K + k];
    const bf16* wk = wl + (size_t)k * kcp * w_ld;
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

template <int CO, bool VEC, typename Finder>
__global__ void __launch_bounds__(WC_THREADS)
gather_mma_warp_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                       float* __restrict__ out, int V, int M, int K, int Cin, Finder find) {
  gather_mma_warp_tile<CO, VEC>(feats, w, out, V, M, K, Cin, find);
}

template <int CO, bool VEC, typename Finder>
__global__ void __launch_bounds__(THREADS)
gather_mma_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                  float* __restrict__ out, int V, int M, int K, int Cin, Finder find) {
  gather_mma_tile<CO, VEC>(feats, w, out, V, M, K, Cin, find);
}

enum Core : int { WARP = 0, STAGED = 1 };

// The core a conv of these shapes takes: the warp core where all of W fits
// its budget, else the staged core.
inline int core_of(int K, int Cin, int Co) {
  return warp_core_w_bytes(K, Cin, Co) <= WC_W_BYTES_MAX ? WARP : STAGED;
}

// static: each kernel library keeps its own copy of run's function-local
// statics. With external linkage, one instantiation in two libraries of a
// process would share them (a unique symbol), and the second library's
// kernel would never get its shared-memory limit raised.
template <int CO, bool VEC, typename Finder>
static int run(const Finder& find, const void* feats, const void* w, float* out, int V, int M,
        int K, int Cin, cudaStream_t stream) {
  const bf16* f = static_cast<const bf16*>(feats);
  const bf16* wt = static_cast<const bf16*>(w);
  if (core_of(K, Cin, CO) == WARP) {
    auto kernel = gather_mma_warp_kernel<CO, VEC, Finder>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(WC_W_BYTES_MAX + (size_t)WC_ROWS * KMAX * 4));
    if (attr != cudaSuccess) return (int)attr;
    kernel<<<(M + WC_ROWS - 1) / WC_ROWS, WC_THREADS, warp_core_bytes(K, Cin, CO), stream>>>(
        f, wt, out, V, M, K, Cin, find);
    return (int)cudaGetLastError();
  }
  if constexpr (resolves_tile<Finder>::value) {  // the smallest ring holds the scratch
    static_assert(Layout(16, 1, 1).ring_bytes() >= Finder::kScratchBytes, "resolver scratch");
  }
  auto kernel = gather_mma_kernel<CO, VEC, Finder>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Layout(CO, KC, KMAX).bytes());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(M + TM - 1) / TM, THREADS, Layout(CO, Cin, K).bytes(), stream>>>(f, wt, out, V, M,
                                                                           K, Cin, find);
  return (int)cudaGetLastError();
}

// Host-side launch over the output width: bf16 feats (V, Cin) and weights
// (K, Cin, Co), out (M, Co) f32. Returns cudaGetLastError() after the
// launch (0 = launched).
template <typename Finder>
int launch(const Finder& find, const void* feats, const void* w, float* out, int V, int M,
           int K, int Cin, int Co, cudaStream_t stream) {
  if (K < 1 || K > KMAX || Cin < 1) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const bool vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define GMMA_CASE(CO_)                                                                   \
  case CO_:                                                                              \
    return vec ? run<CO_, true>(find, feats, w, out, V, M, K, Cin, stream)               \
               : run<CO_, false>(find, feats, w, out, V, M, K, Cin, stream);
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
