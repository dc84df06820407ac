// block_extract: the block-extraction conv of the variant probe, in its five
// variants (ohonly, extract, nokeys, noselect, full).
//
// Replaces the TPU kernel tools/probe_block_conv.py `_variant_kernel`
// (launched by `_call`), which finds each row's key block by comparing it
// against a window of NBWL guard pairs, then extracts the block's features
// and byte-split keys with one-hot matmuls on the MXU. On Hopper the block
// is found directly and the rows of the blocks that hit are added:
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
// values) add several rows, no one adds nothing. An r outside [0, NBr) is
// read as the TPU kernel's dynamic slices read it in Pallas interpret mode:
// each window (the guard row r of sg1/sg2, the NBWL rows from r*GB of
// f2/k2q) takes its start from the end when it is negative, then clamps it
// so that the window fits, each on its own (r = -1 is guard row NBr - 1).
//
// Bound on the H100: operations, chiefly the weight product (2*128*C FLOPs
// per (row, group) for extract, 2*3C*C for the others), then the 2*NBWL
// guard compares on the int32 pipe. Every row of a tile reads the same guard
// window, the same f2/k2q window and the same w[g], so the design shares
// them across the tile. One block owns a chunk of ROWS rows of one tile
// (rows_of: 128 for ohonly, 64 for the variants with a product, whose
// second tile AF and two w buffers then leave room for 2-3 blocks per SM)
// and walks the G groups; per group, each step a pass of all 256 threads
// between two barriers:
//   stage   the guard window, the chunk's q columns and the C columns of the
//           w[g] slice the variant multiplies by, with cp.async into one of
//           two buffers, issued one group ahead;
//   find    a thread takes (32 guard pairs, one row) and builds the row's
//           hit word from 32 compares of pairs that every lane of the warp
//           reads alike (a broadcast); the words, hits in j order, stay in
//           shared memory;
//   gather  a thread takes (row, 16 of afeat's lanes): per hit four 16-byte
//           loads, eight threads reading one f2 row's 512 bytes, summed in
//           j order into a shared tile: A itself for extract, else AF; for
//           the key variants a thread per (row, block j) sums block j's four
//           key quarters, packs them into one word and sets bit j of eq_d
//           where it equals q[m, 3g+d] (an atomic OR in shared memory: the
//           same bits in any order);
//   select  (not extract) a thread per (row, column c) writes row_d[c] into
//           A, adding AF's blocks j of eq_d's set bits;
//   product all 256 threads compute A (ROWS x Kg) @ w slice (Kg x C) from
//           shared memory: a thread owns 16 columns of one row (in
//           registers) over a share of Kg, so each A value read feeds 16
//           FMAs, and a warp's 32 rows read the same w row, one broadcast
//           (shared memory's bandwidth, not the FMAs, bounds a product this
//           narrow when each thread's block is a few rows by a few columns).
// After the last group the k splits' sums meet in shared memory and the
// chunk's (nrows, C) output is stored once, coalesced. f32 throughout; every
// sum is in a fixed order: reruns give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GB = 16;   // guard rows per base step (ops/pallas/block_conv.py GB)
constexpr int F = 128;   // feature lanes of f2 and afeat
constexpr int CMAX = 32;
constexpr int SMEM_MAX = 232448;

enum Variant { OHONLY = 0, EXTRACT = 1, NOKEYS = 2, NOSELECT = 3, FULLV = 4 };

// rows of one block; probe_block_conv --rows-study times the other choice
// from a copy of this file with this line edited
__host__ __device__ constexpr int rows_of(int variant) { return variant == OHONLY ? 128 : 64; }

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// a row stride of at least x words, x a multiple of 4, with stride / 4 odd:
// float4 accesses to 8 neighbouring rows then cover all 32 banks once
__host__ __device__ constexpr int odd_stride(int x) { return x + ((x / 4) % 2 == 0 ? 4 : 0); }

// afeat lanes a variant reads
__host__ __device__ inline int feat_width(int variant, int H, int C) {
  return variant == EXTRACT ? F : variant == NOSELECT ? C : 2 * H * C;
}

// Shared-memory layout, in 4-byte words; every region starts on 16 bytes.
struct Layout {
  int nwp;          // hit words per row (NBWL / 32 rounded up), made odd
  int kg, kp, lda;  // product depth, rounded up to 4, and A's row stride
  int afld;         // AF's row stride
  int pairs, qs, ws, stage;  // offsets within a stage; words per stage
  int rs, hm, a, af, eq, cnt, total;  // rs: G guard rows, then G f2/k2q window starts
};

__host__ __device__ inline Layout layout(int variant, int rows, int cp, int G, int NBWL,
                                         int H, int C) {
  Layout L{};
  const int nw = (NBWL + 31) / 32;
  L.nwp = nw | 1;  // odd: the find's stores for 32 rows miss no bank twice
  L.kg = variant == EXTRACT ? F : 3 * C;
  L.kp = round4(L.kg);
  L.lda = odd_stride(L.kp);
  L.afld = odd_stride(round4(feat_width(variant, H, C)));
  const bool product = variant != OHONLY, sel = variant >= NOKEYS;
  L.pairs = 0;  // (sg1, sg2) of guard j at 2j, 2j + 1; j < 32 * nw
  L.qs = 64 * nw;
  L.ws = L.qs + 3 * rows;
  L.stage = round4(L.ws + (product ? L.kp * cp : 0));
  L.rs = 2 * L.stage;
  L.hm = L.rs + round4(2 * G);
  L.a = round4(L.hm + rows * L.nwp);
  L.af = L.a + (product ? rows * L.lda : 0);
  L.eq = L.af + (sel ? rows * L.afld : 0);
  L.cnt = L.eq + (sel ? round4(3 * rows) : 0);
  L.total = L.cnt + (product ? 0 : rows);
  // the product's splits meet in shared memory from A on
  if (product && L.total < L.a + THREADS * (cp + 1)) L.total = L.a + THREADS * (cp + 1);
  return L;
}

// The start of a `size`-row window of an n-row array, as a dynamic slice
// reads it in Pallas interpret mode: a negative start counts from the end,
// then the start is clamped so that the window fits.
__device__ __forceinline__ int window_start(long long start, int n, int size) {
  if (start < 0) start += n;
  return (int)min(max(start, 0LL), (long long)(n - size));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Calls hit(j) for each set bit j of a row's hit words, in j order.
template <typename Fn>
__device__ __forceinline__ void for_each_hit(const unsigned* words, int nw, Fn&& hit) {
  for (int wd = 0; wd < nw; ++wd)
    for (unsigned m = words[wd]; m; m &= m - 1u) hit(wd * 32 + __ffs(m) - 1);
}

// One block: rows [row0, row0 + nrows) of tile t, nrows <= rows_of(VARIANT).
// CP: C rounded up to 16 or 32 (the w slice's zero-padded columns). Blocks
// of 64 rows at C <= 16 fit 3 to an SM in shared memory; their registers
// are held to that too.
template <int VARIANT, int CP>
__global__ void __launch_bounds__(THREADS, rows_of(VARIANT) == 64 && CP == 16 ? 3 : 2)
block_extract_kernel(const int* __restrict__ q, const int* __restrict__ bases,
                     const int* __restrict__ sg1, const int* __restrict__ sg2,
                     const float* __restrict__ k2q, const float* __restrict__ f2,
                     const float* __restrict__ w, float* __restrict__ out,
                     int tile, int G, int NBr, int NBP, int NBWL, int H, int C, int Wc) {
  extern __shared__ __align__(16) int smem[];
  constexpr int ROWS = rows_of(VARIANT);
  constexpr bool PRODUCT = VARIANT != OHONLY;
  constexpr bool SELECT = VARIANT >= NOKEYS;  // reads q[m, 3g+d] for all d
  constexpr bool KEYS = VARIANT == NOSELECT || VARIANT == FULLV;
  constexpr int SC = CP / 16, SK = THREADS / ROWS / SC;  // the product's column, k splits
  const Layout L = layout(VARIANT, ROWS, CP, G, NBWL, H, C);
  const int tid = threadIdx.x;
  const int chunks = (tile + ROWS - 1) / ROWS;
  const int t = blockIdx.x / chunks;
  const int row0 = (blockIdx.x - t * chunks) * ROWS;
  const int nrows = min(ROWS, tile - row0);
  const size_t m0 = (size_t)t * tile + row0;
  const int K = 3 * G, H2 = 2 * H, KQ = 8 * H;
  const int NW = (NBWL + 31) / 32;
  const int FW = feat_width(VARIANT, H, C);
  const int* rs = smem + L.rs;  // the tile's guard row per group, then its window start
  unsigned* hm = reinterpret_cast<unsigned*>(smem + L.hm);
  float* A = reinterpret_cast<float*>(smem + L.a);
  float* AF = reinterpret_cast<float*>(smem + L.af);
  unsigned* eq = reinterpret_cast<unsigned*>(smem + L.eq);
  const int wsel = VARIANT == EXTRACT ? 0 : 2;

  auto load_stage = [&](int g) {
    int* st = smem + (g & 1) * L.stage;
    const int r = rs[g];
    for (int i = tid; i < NBWL; i += THREADS) {
      cp_async4(st + L.pairs + 2 * i, sg1 + (size_t)r * NBWL + i);
      cp_async4(st + L.pairs + 2 * i + 1, sg2 + (size_t)r * NBWL + i);
    }
    const int d0 = SELECT ? 0 : 1, nd = SELECT ? 3 : 1;
    for (int i = tid; i < nd * nrows; i += THREADS) {
      const int d = d0 + i / nrows, row = i % nrows;
      cp_async4(st + L.qs + d * ROWS + row, q + (m0 + row) * K + 3 * g + d);
    }
    if constexpr (PRODUCT) {
      const float* wg = w + (size_t)(g * 3 + wsel) * F * Wc;
      for (int i = tid; i < L.kg * C; i += THREADS) {
        const int k = i / C, n = i - k * C;
        cp_async4(st + L.ws + k * CP + n, wg + (size_t)k * Wc + n);
      }
    }
  };

  for (int i = tid; i < G; i += THREADS) {
    const int r = bases[(size_t)t * G + i];
    smem[L.rs + i] = window_start(r, NBr, 1);
    smem[L.rs + G + i] = window_start((long long)r * GB, NBP, NBWL);
  }
  // guard pairs past NBWL, never copied: (0, 0) holds no a
  for (int i = 2 * NBWL + tid; i < 64 * NW; i += THREADS) smem[i] = smem[L.stage + i] = 0;
  if constexpr (PRODUCT) {
    // zeros where the copies never write: w's padded columns and rows, A's
    // padded columns (3C <= k < kp)
    for (int i = tid; i < 2 * L.kp * CP; i += THREADS) {
      const int s = i / (L.kp * CP), e = i - s * L.kp * CP, k = e / CP, n = e - k * CP;
      if (k >= L.kg || n >= C) reinterpret_cast<float*>(smem + s * L.stage + L.ws)[e] = 0.f;
    }
    for (int i = tid; i < ROWS * (L.kp - L.kg); i += THREADS) {
      const int row = i / (L.kp - L.kg);
      A[row * L.lda + L.kg + i % (L.kp - L.kg)] = 0.f;
    }
  }
  __syncthreads();
  load_stage(0);
  cp_async_commit();

  // product: thread (row pr, column split ch, k split ks) owns 16 columns of
  // its row over k4 in [k4a, k4b); a warp holds 32 rows of one split, so its
  // reads of the w slice are one address (a broadcast)
  const int pr = tid % ROWS, ch = tid / ROWS % SC, ks = tid / ROWS / SC;
  const int nk4 = L.kp / 4, k4a = ks * nk4 / SK, k4b = (ks + 1) * nk4 / SK;
  float acc[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n] = 0.f;
  int cnt = 0;  // ohonly: hits of row tid

  for (int g = 0; g < G; ++g) {
    __syncthreads();  // the previous group is done with every buffer and the other stage
    if (g + 1 < G) load_stage(g + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int* st = smem + (g & 1) * L.stage;
    const int* qs = st + L.qs;

    // find: (word w, row) -> hm[row][w], bit b for guard pair 32w + b; a
    // warp's lanes take neighbouring rows, so each pair read is a broadcast
    const int2* pairs = reinterpret_cast<const int2*>(st + L.pairs);
    for (int it = tid; it < NW * nrows; it += THREADS) {
      const int wd = it / nrows, row = it - wd * nrows;
      const int a = (int)((unsigned)qs[ROWS + row] - 1u);
      const int2* pw = pairs + wd * 32;
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int2 pb = pw[b];
        word |= a > pb.x && !(a > pb.y) ? 1u << b : 0u;
      }
      hm[row * L.nwp + wd] = word;
    }
    if constexpr (KEYS)
      for (int i = tid; i < 3 * nrows; i += THREADS) eq[i] = 0u;
    __syncthreads();

    if constexpr (VARIANT == OHONLY) {
      if (tid < nrows)
        for (int wd = 0; wd < NW; ++wd) cnt += __popc(hm[tid * L.nwp + wd]);
      continue;
    } else {
      const float* f2w = f2 + (size_t)rs[G + g] * F;
      // gather: (row, p) sums afeat lanes 4p + 32s (s < 4) of the row's hits
      float* dst = VARIANT == EXTRACT ? A : AF;
      const int ld = VARIANT == EXTRACT ? L.lda : L.afld;
      for (int it = tid; it < nrows * 8; it += THREADS) {
        const int row = it >> 3, p = it & 7;
        float4 s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        for_each_hit(hm + row * L.nwp, NW, [&](int j) {
          const float4* src = reinterpret_cast<const float4*>(f2w + (size_t)j * F) + p;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * p + 32 * k < FW) add4(s[k], __ldg(src + 8 * k));
        });
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * p + 32 * k < FW)
            *reinterpret_cast<float4*>(dst + row * ld + 4 * p + 32 * k) = s[k];
      }
      if constexpr (KEYS) {
        // (row, block j) packs akey[c*2H + j] (c < 4); a quarter outside
        // [0, 255] equals no byte of q. noselect reads block 0 alone.
        const float* k2w = k2q + (size_t)rs[G + g] * KQ;
        const int nj = VARIANT == NOSELECT ? 1 : H2;
        for (int it = tid; it < nrows * nj; it += THREADS) {
          const int row = it / nj, jb = it - row * nj;
          float k4[4] = {0.f, 0.f, 0.f, 0.f};
          for_each_hit(hm + row * L.nwp, NW, [&](int j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) k4[c] += __ldg(k2w + (size_t)j * KQ + c * H2 + jb);
          });
          unsigned packed = 0;
          bool ok = true;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = (int)k4[c];  // truncation, as the TPU kernel's astype(int32)
            ok = ok && (unsigned)key < 256u;
            packed |= (unsigned)key << (8 * c);
          }
#pragma unroll
          for (int d = 0; d < 3; ++d)
            if (ok && packed == (unsigned)qs[d * ROWS + row]) atomicOr(eq + row * 3 + d, 1u << jb);
        }
      }
      __syncthreads();

      if constexpr (SELECT) {
        for (int it = tid; it < nrows * C; it += THREADS) {
          const int row = it / C, c = it - row * C;
          const float* af = AF + row * L.afld + c;
          float* arow = A + row * L.lda + c;
          if constexpr (VARIANT == NOKEYS) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)  // 2H <= 8
              if (j < H2) s += af[j * C];
#pragma unroll
            for (int d = 0; d < 3; ++d) arow[d * C] = qs[d * ROWS + row] > 0 ? s : 0.f;
          } else if constexpr (VARIANT == NOSELECT) {
#pragma unroll
            for (int d = 0; d < 3; ++d) arow[d * C] = af[0] * (float)(eq[row * 3 + d] & 1u);
          } else {
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              float s = 0.f;
              for (unsigned m = eq[row * 3 + d]; m; m &= m - 1u) s += af[(__ffs(m) - 1) * C];
              arow[d * C] = s;
            }
          }
        }
        __syncthreads();
      }

      // product: this group's part of the row's sums, then into acc (the
      // plain version's order: per group, then across groups)
      const float* ws = reinterpret_cast<const float*>(st + L.ws) + 16 * ch;
      const float* arow = A + pr * L.lda;
      float part[16];
#pragma unroll
      for (int n = 0; n < 16; ++n) part[n] = 0.f;
#pragma unroll 2
      for (int k4 = k4a; k4 < k4b; ++k4) {
        const float4 a = *reinterpret_cast<const float4*>(arow + 4 * k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float x = lane_of(a, kk);
          const float4* wr = reinterpret_cast<const float4*>(ws + (4 * k4 + kk) * CP);
#pragma unroll
          for (int n4 = 0; n4 < 4; ++n4) {
            const float4 v = wr[n4];
            part[4 * n4] = fmaf(x, v.x, part[4 * n4]);
            part[4 * n4 + 1] = fmaf(x, v.y, part[4 * n4 + 1]);
            part[4 * n4 + 2] = fmaf(x, v.z, part[4 * n4 + 2]);
            part[4 * n4 + 3] = fmaf(x, v.w, part[4 * n4 + 3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[n] += part[n];
    }
  }

  // the chunk's (nrows, C) output, staged in shared memory, stored coalesced
  __syncthreads();
  float* o = out + m0 * C;
  if constexpr (VARIANT == OHONLY) {
    int* cs = smem + L.cnt;
    if (tid < nrows) cs[tid] = cnt;
    __syncthreads();
    for (int i = tid; i < nrows * C; i += THREADS) o[i] = (float)cs[i / C];
  } else {
    float* P = A;  // the k splits' sums, [ks][pr][CP + 1]
#pragma unroll
    for (int n = 0; n < 16; ++n) P[(ks * ROWS + pr) * (CP + 1) + 16 * ch + n] = acc[n];
    __syncthreads();
    for (int i = tid; i < nrows * C; i += THREADS) {
      const int row = i / C, n = i - row * C;
      float sum = 0.f;
      for (int k = 0; k < SK; ++k) sum += P[(k * ROWS + row) * (CP + 1) + n];
      o[i] = sum;
    }
  }
}

template <int VARIANT, int CP>
int launch(cudaStream_t s, const int* q, const int* bases, const int* sg1, const int* sg2,
           const float* k2q, const float* f2, const float* w, float* out, int Mp, int tile,
           int G, int NBr, int NBP, int NBWL, int H, int C, int Wc) {
  constexpr int ROWS = rows_of(VARIANT);
  const long long blocks = (long long)(Mp / tile) * ((tile + ROWS - 1) / ROWS);
  const size_t smem = sizeof(int) * (size_t)layout(VARIANT, ROWS, CP, G, NBWL, H, C).total;
  if (blocks > 0x7fffffff || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto* kernel = block_extract_kernel<VARIANT, CP>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(int)blocks, THREADS, smem, s>>>(q, bases, sg1, sg2, k2q, f2, w, out, tile, G, NBr,
                                            NBP, NBWL, H, C, Wc);
  return (int)cudaGetLastError();
}

template <int CP>
int dispatch(int variant, cudaStream_t s, const int* q, const int* bases, const int* sg1,
             const int* sg2, const float* k2q, const float* f2, const float* w, float* out,
             int Mp, int tile, int G, int NBr, int NBP, int NBWL, int H, int C, int Wc) {
#define BE_ARGS s, q, bases, sg1, sg2, k2q, f2, w, out, Mp, tile, G, NBr, NBP, NBWL, H, C, Wc
  switch (variant) {
    case OHONLY: return launch<OHONLY, 32>(BE_ARGS);
    case EXTRACT: return launch<EXTRACT, CP>(BE_ARGS);
    case NOKEYS: return launch<NOKEYS, CP>(BE_ARGS);
    case NOSELECT: return launch<NOSELECT, CP>(BE_ARGS);
    case FULLV: return launch<FULLV, CP>(BE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BE_ARGS
}

}  // namespace

// q (Mp, 3G) int32; bases (Mp/tile, G) int32; sg1, sg2 (NBr, NBWL) int32;
// k2q (NBP, 8H) f32; f2 (NBP, 128) f32, 16-byte aligned; w (G, 3, 128, Wc)
// f32; out (Mp, C) f32. NBP >= (NBr-1)*16 + NBWL, 8H <= 32, 2H*C <= 128,
// C <= 32, Wc >= C. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_extract_launch(const int* q, const int* bases, const int* sg1,
                                    const int* sg2, const float* k2q, const float* f2,
                                    const float* w, float* out, int Mp, int tile,
                                    int G, int NBr, int NBP, int NBWL, int H, int C, int Wc,
                                    int variant, void* stream) {
  if (tile < 1 || Mp < 0 || Mp % tile != 0 || G < 1 || NBr < 1 || NBWL < 1 || H < 1 ||
      NBP < (NBr - 1) * GB + NBWL ||
      8 * H > 32 || C < 1 || C > CMAX || 2 * H * C > F || Wc < C)
    return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BE_ARGS variant, s, q, bases, sg1, sg2, k2q, f2, w, out, Mp, tile, G, NBr, NBP, NBWL, H, C, Wc
  return C > 16 ? dispatch<32>(BE_ARGS) : dispatch<16>(BE_ARGS);
#undef BE_ARGS
}
