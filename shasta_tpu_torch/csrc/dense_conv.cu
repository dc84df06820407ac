// dense_conv: the f32 neck's convolutions (models/rpn.py RPN, ResNeck and
// SharedConv) as one implicit-GEMM launch each, eval-mode BN, an optional
// residual input and an optional ReLU in the epilogue.
//
// Replaces no TPU kernel: the JAX package leaves the neck's dense convs to
// XLA. It replaces cuDNN here, which with TF32 off runs the f32 neck at B=1
// by FFT tiling: ~33,000 cuBLAS gemv launches a frame, each a few
// microseconds of device and ~10 of host. Here the neck is 15 launches:
// the 12 convs of its two blocks, its two deblocks and the shared conv.
//
//   out[m, n] = relu(scale[n] * sum_k A[m, k] W[n, k] + shift[n] + res[m, n])
//
// The ReLU and the residual are template flags of the kernel: the RPN's
// launches take the ReLU without a residual (the variant every conv had
// before ResNeck); a residual block's second conv adds its identity before
// the ReLU; its 1x1 downsample branch and a plain conv (TransFusion-L's
// shared conv) keep neither. The two new variants are built for 128-column
// tiles only (every ResNeck width is a multiple of 128), so the build grows
// by two kernels a tile height. `res` has the output's layout and is read
// at each output's own place.
//
// M is the B*Ho*Wo output pixels, N the output channels, K the taps x Cin.
// A is never formed: a block's loads address the NHWC input at each pixel's
// tap (stride and zero padding by addressing, a pixel outside the input
// loads zeros), so no padded copy is made. W is packed once per module as
// (N, taps, Cin), K-major, which is the column-major B operand of the MMA.
// The 2x2 stride-2 transposed conv is the same GEMM over its input pixels
// with one tap and N = 4 * Cout, columns (dy, dx, co); its epilogue stores
// each pixel's 2x2 outputs (`up` = 2). A store writes into a channel range
// [co_off, co_off + N / up^2) of a buffer `ldo` channels wide, so the two
// deblocks fill their halves of one NHWC map and no concatenation follows.
//
// Bound on the H100: 145 GFLOP a frame at 180 x 180 (B=1) against ~70 MB
// of activations and 12 MB of weights: products, priced as f32-accurate
// products at 495/3 TFLOP/s (0.88 ms a frame), not bytes (~0.03 ms).
// Products run as three TF32 passes on mma.sync m16n8k8 (hi*lo, lo*hi,
// hi*hi, f32 sums), each operand split into TF32 hi and lo parts in
// registers as its fragment is read from shared memory, as the trunk's
// f32 route does (gather_mma.cuh): ~2^-21 relative error a product. Each
// 8-deep k-step's three passes sum from zero and are added into the
// accumulators in f32 (round to nearest): chained over all of K, the
// tensor cores' truncated sums drifted by 1.5e-5 of |out|. Tiles
// of BM x BN outputs, 8 warps of (BM / warp rows) x 32, over a 3-stage
// cp.async ring of BK = 32 deep slices of A and W (a slice lies in one tap,
// since Cin % 32 == 0), rows padded to 36 words so that the fragment reads
// are free of bank conflicts. BN is 128, or 64 where N is (the shared
// conv). BM follows M: 128 rows where that gives a full wave of blocks on
// the card, else 64 (a 90 x 90 conv at B=1). Not wgmma: its 64-row
// asynchronous tiles and TMA descriptors would take the products nearer
// the tensor cores' rate, but the neck's cost on the card was its launch
// count, not the last factor of device time; that is later work.
#include "gather_mma.cuh"

namespace {

constexpr int BK = 32;         // K per stage: 32 channels of one tap
constexpr int LDS = BK + 4;    // a staged row's stride in words: conflict-free fragments
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 8 warps

struct Conv {
  const float* x;      // (B, H, W, Cin)
  const float* w;      // (N, ks * ks * Cin)
  const float* scale;  // (N,)
  const float* shift;  // (N,)
  float* out;          // (B, Ho * up, Wo * up, ldo)
  const float* res;    // null, or as out: added before the ReLU
  int H, W, Cin, Ho, Wo, M, ks, stride, pad, N, up, ldo, co_off;
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(gmma::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + BN) * LDS * sizeof(float);
}

template <int BM, int BN, bool RELU, bool RES>
__global__ void __launch_bounds__(THREADS, 1) dense_conv_kernel(const Conv p) {
  constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M, MI = WM / 16, NI = 4;  // a warp's tile: WM x 32
  constexpr int A_COPIES = BM / 32, B_COPIES = BN / 32;   // 16-byte copies a thread a stage
  static_assert(MI >= 1 && WM % 16 == 0, "tile");
  extern __shared__ __align__(16) unsigned char dc_smem[];
  float* const As = reinterpret_cast<float*>(dc_smem);  // [STAGES][BM][LDS]
  float* const Bs = As + STAGES * BM * LDS;              // [STAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntn = p.N / BN;  // column tiles vary fastest: neighbouring blocks share A
  const int mt = blockIdx.x / ntn, nt = blockIdx.x - mt * ntn;
  const int m0 = mt * BM, n0 = nt * BN;
  const int K = p.ks * p.ks * p.Cin, KT = K / BK, HWo = p.Ho * p.Wo;

  // this thread copies 16 bytes (column 4 * cc) of rows r0 + 32 i of each slice
  const int cc = tid & 7, r0 = tid >> 3;
  int a_iy[A_COPIES], a_ix[A_COPIES];
  const float* a_img[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int m = m0 + r0 + 32 * i;
    a_iy[i] = -(1 << 28);  // a row past M: every tap misses
    a_ix[i] = 0;
    a_img[i] = p.x;
    if (m < p.M) {
      const int b = m / HWo, rem = m - b * HWo, oy = rem / p.Wo, ox = rem - oy * p.Wo;
      a_iy[i] = oy * p.stride - p.pad;
      a_ix[i] = ox * p.stride - p.pad;
      a_img[i] = p.x + (size_t)b * p.H * p.W * p.Cin;
    }
  }

  auto load = [&](int kt, int slot) {
    const int k0 = kt * BK, tap = k0 / p.Cin, c0 = k0 - tap * p.Cin;
    const int ky = tap / p.ks, kx = tap - ky * p.ks;
    float* as = As + slot * BM * LDS + r0 * LDS + 4 * cc;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int iy = a_iy[i] + ky, ix = a_ix[i] + kx;
      const bool valid = (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
      const float* src =
          valid ? a_img[i] + ((size_t)iy * p.W + ix) * p.Cin + c0 + 4 * cc : p.x;
      cp_async16_zfill(as + 32 * i * LDS, src, valid);
    }
    float* bs = Bs + slot * BN * LDS + r0 * LDS + 4 * cc;
    const float* wsrc = p.w + (size_t)(n0 + r0) * K + k0 + 4 * cc;
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) gmma::cp_async16(bs + 32 * i * LDS, wsrc + (size_t)32 * i * K);
  };

  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;
  const int g = lane >> 2, q = lane & 3;
  float acc[MI][NI][4] = {};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    gmma::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    gmma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed; every warp is done with slice kt - 1
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    gmma::cp_async_commit();
    // A: rows g, g + 8 at columns q, q + 4; B (W's rows are its columns): column g at rows q, q + 4
    const float* as = As + (kt % STAGES) * BM * LDS + (wm * WM + g) * LDS + q;
    const float* bs = Bs + (kt % STAGES) * BN * LDS + (wn * 32 + g) * LDS + q;
#pragma unroll
    for (int k = 0; k < BK; k += 8) {
      gmma::SplitA a[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* ap = as + mi * 16 * LDS + k;
        const float v[4] = {ap[0], ap[8 * LDS], ap[4], ap[8 * LDS + 4]};
        a[mi] = gmma::split_a(v);
      }
      gmma::Split b[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* bp = bs + ni * 8 * LDS + k;
        b[ni][0] = gmma::split_tf32(bp[0]);
        b[ni][1] = gmma::split_tf32(bp[4]);
      }
      // this k-step's sums, from zero, join acc by f32 adds (the note at the top)
      float t[MI][NI][4] = {};
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) gmma::mma_pass(pass, t[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += t[mi][ni][e];
        }
      }
    }
  }
  gmma::cp_async_wait<0>();

  // epilogue: BN's scale and shift, the residual, ReLU, and the store at
  // each pixel's place (up x up outputs a pixel for the transposed conv)
  const int co_n = p.N / (p.up * p.up), Hu = p.Ho * p.up, Wu = p.Wo * p.up;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WM + mi * 16 + g + 8 * half;
      if (m >= p.M) continue;
      const int b = m / HWo, rem = m - b * HWo, oy = rem / p.Wo, ox = rem - oy * p.Wo;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * q;
        const int sub = n / co_n, co = n - sub * co_n, dy = sub / p.up, dx = sub - dy * p.up;
        float* dst = p.out +
                     (((size_t)b * Hu + oy * p.up + dy) * Wu + ox * p.up + dx) * p.ldo +
                     p.co_off + co;
        float v0 = fmaf(acc[mi][ni][2 * half], __ldg(p.scale + n), __ldg(p.shift + n));
        float v1 =
            fmaf(acc[mi][ni][2 * half + 1], __ldg(p.scale + n + 1), __ldg(p.shift + n + 1));
        if constexpr (RES) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(p.res + (dst - p.out)));
          v0 += r.x;
          v1 += r.y;
        }
        if constexpr (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

// Rows a tile: 128 where that makes a full wave of blocks, else 64.
int tile_rows(int M, int N) {
  const int bn = N % 128 == 0 ? 128 : 64;
  return (long long)((M + 127) / 128) * (N / bn) >= sm_count() ? 128 : 64;
}

// static: each library keeps its own shared-memory attribute (gather_mma.cuh's `run`)
template <int BM, int BN, bool RELU = true, bool RES = false>
static int run(const Conv& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_conv_kernel<BM, BN, RELU, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<BM, BN>());
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((p.M + BM - 1) / BM) * (p.N / BN);
  dense_conv_kernel<BM, BN, RELU, RES>
      <<<(unsigned)blocks, THREADS, smem_bytes<BM, BN>(), stream>>>(p);
  return (int)cudaGetLastError();
}

// The two epilogues ResNeck adds, on 128-column tiles: no ReLU and no
// residual (a downsample branch, a plain conv), or the residual then ReLU.
template <int BM>
static int run_res(const Conv& p, bool relu, cudaStream_t stream) {
  if (relu && p.res) return run<BM, 128, true, true>(p, stream);
  if (!relu && !p.res) return run<BM, 128, false, false>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tile rows (BM) a conv of M output pixels and N columns takes.
extern "C" int dense_conv_tile_rows(int M, int N) { return tile_rows(M, N); }

// x (B, H, W, Cin) f32, w (N, ks * ks * Cin), scale and shift (N,); out
// (B, Ho * up, Wo * up, ldo), written at channels [co_off, co_off + N /
// up^2); res null or shaped as out. ks x ks taps at `stride` with `pad`
// zeros, or (up > 1) ks 1 and N = up^2 Cout columns ordered (dy, dx, co).
// relu 1 with no res is the RPN's epilogue; relu 0 without res and relu 1
// with res take N % 128 == 0. The wrapper checks the shapes; this refuses
// Cin % 32 != 0, N % 64 != 0, odd channel counts and the other epilogues.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dense_conv_launch(const float* x, const float* w, const float* scale,
                                 const float* shift, float* out, const float* res, int relu,
                                 int B, int H, int W, int Cin, int Ho, int Wo, int ks,
                                 int stride, int pad, int N, int up, int ldo, int co_off,
                                 void* stream) {
  if (Cin % BK != 0 || N % 64 != 0 || up < 1 || N % (up * up) != 0 || (N / (up * up)) % 2 ||
      ldo % 2 || co_off % 2 || ks < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const Conv p{x, w, scale, shift, out, res, H, W, Cin, Ho, Wo, B * Ho * Wo, ks, stride, pad,
               N, up, ldo, co_off};
  if (p.M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N % 128 == 0, tall = tile_rows(p.M, N) == 128;
  if (!relu || res) {
    if (!wide) return (int)cudaErrorInvalidValue;
    return tall ? run_res<128>(p, relu, s) : run_res<64>(p, relu, s);
  }
  if (tall) return wide ? run<128, 128>(p, s) : run<128, 64>(p, s);
  return wide ? run<64, 128>(p, s) : run<64, 64>(p, s);
}
