// voxelize_lanes: many point clouds into fixed-shape voxel grids, in one
// enqueue on the card.
//
// Replaces no TPU kernel: the JAX package voxelizes on the host, through the
// same C++ as the port's runtime (`points_to_voxel` in host_ops.cpp). It was
// added for the scene-batched eval, whose host spent two thirds of a frame
// voxelizing into 24 MB grids that were then copied to the card; the card
// now takes the raw points of every lane of a step and builds the grids
// itself.
//
// The result is byte for byte the host's (points_to_voxel, then
// voxelize_frame's optional key sort and zero padding to max_voxels):
// - per axis floor((double)(p - range_min) / (double)voxel_size), the
//   subtraction in f32 and the division in f64, a point kept only when all
//   three lie in the grid;
// - a voxel keeps its first max_points points in arrival order;
// - the voxel cap keeps the max_voxels voxels whose first point arrived
//   earliest; rows come in that arrival order, or in ascending zyx key
//   where sort_by_key is set.
//
// Design. Every point gets a 64-bit key cloud * G + zyx key (G the grid's
// cells; out-of-grid points C * G, past every valid key), and a stable LSD
// radix sort of (key, point index) over the bits the keys use groups each
// voxel's points in arrival order, clouds in order. The keys' kernel
// also counts every pass's digits; a pass is then one kernel, whose tiles
// rank their 4096 keys with cub's BlockRadixSort (stable) and find the
// earlier tiles' counts of each digit by a decoupled look-back (tiles taken
// in the order blocks start, each publishing its counts, then its prefix).
// The heads of the sorted runs are flagged back in point order; a scan of
// those flags over each cloud's tiles (a look-back again) gives each voxel
// its arrival rank, which is the cap and, without the key sort, the row;
// with it a scan of the kept heads in sorted order gives the row. One last
// pass writes every output byte in order: the points, the zero tail,
// coords, counts and valid. No device-level library sort is called, and
// nothing counts through global atomics but the digit totals.
//
// Bound on the H100: bytes. At 8 lanes of the eval (220k points a cloud)
// the points read (~35 MB) and the grids written (~208 MB) take ~0.07 ms at
// 3.35 TB/s; each sort pass moves ~42 MB over 1.8M keys. Launches: one
// memset and 1 + passes + 3 kernels (arrival order) or + 4 (key order); 8
// or 9 at 8 lanes of the car config (keys under 2^30: 4 passes), from one call.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int BLOCK = 256;
constexpr int ITEMS = 16;
constexpr int TILE = BLOCK * ITEMS;  // keys a sort tile ranks
constexpr int RADIX = 8;
constexpr int BINS = 1 << RADIX;  // == BLOCK: one bin per thread
constexpr int MAX_PASSES = 8;
constexpr int FILL_ROWS = 32;  // output rows a warp stages at a time: one a lane
constexpr int MAX_ROW_FLOATS = 8 * 32;  // P * nc: at most 8 floats a lane a row

static_assert(BINS == BLOCK, "one digit bin per thread");

// Look-back status words: 2 flag bits over a 30-bit count.
constexpr unsigned AGGREGATE = 1u << 30, PREFIX = 2u << 30, COUNT = AGGREGATE - 1;

struct Grid {
  float rmin[3];
  double vs[3];
  int g[3];  // x, y, z cells
  u64 G;     // g[0] * g[1] * g[2]
};

// Largest c in [0, n) with starts[c] <= i: the segment holding i where
// starts is nondecreasing and starts[0] <= i (empty segments skipped).
__device__ __forceinline__ int segment_of(const int* __restrict__ starts, int n, long long i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// A block's tile in the order blocks start (so a tile only ever waits on
// tiles of blocks already running).
__device__ __forceinline__ int next_tile(unsigned* counter) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return tile;
}

// Decoupled look-back: tile `tile` of a chain starting at tile `first`
// publishes its count v, adds up the counts of the tiles before it back to
// the nearest published prefix, and publishes its inclusive prefix. Returns
// the exclusive prefix. status: one zeroed word a tile, `stride` apart.
__device__ unsigned look_back(unsigned* status, int stride, int tile, int first, unsigned v) {
  volatile unsigned* st = status;
  if (tile == first) {
    st[(size_t)tile * stride] = PREFIX | v;
    return 0;
  }
  st[(size_t)tile * stride] = AGGREGATE | v;
  unsigned excl = 0;
  for (int j = tile - 1;;) {
    const unsigned w = st[(size_t)j * stride];
    if (!(w & (AGGREGATE | PREFIX))) continue;  // not published yet
    excl += w & COUNT;
    if (w & PREFIX) break;
    j--;
  }
  st[(size_t)tile * stride] = PREFIX | (excl + v);
  return excl;
}

// Keys and point indices, each pass's digit totals (added into the zeroed
// totals) and, in block 0, the per-cloud point-order tiles (ctile).
__global__ void __launch_bounds__(BLOCK)
keys_kernel(const float* __restrict__ pts, int nc, int N, const int* __restrict__ off, int C,
            Grid gr, int passes, u64* __restrict__ keys, int* __restrict__ vals,
            unsigned* __restrict__ totals, int* __restrict__ ctile) {
  __shared__ unsigned cnt[MAX_PASSES][BINS];
  const int t = threadIdx.x, b = blockIdx.x;
  for (int p = 0; p < passes; p++) cnt[p][t] = 0;
  if (b == 0 && t == 0) {
    int acc = 0;
    for (int c = 0; c < C; c++) {
      ctile[c] = acc;
      acc += (off[c + 1] - off[c] + TILE - 1) / TILE;
    }
    ctile[C] = acc;
  }
  __syncthreads();
  const u64 invalid = (u64)C * gr.G;
  for (int j = 0; j < ITEMS; j++) {
    const long long i = (long long)b * TILE + j * BLOCK + t;
    if (i >= N) break;
    const float* p = pts + i * nc;
    bool in = true;
    int ijk[3];
    for (int a = 0; a < 3; a++) {
      const double d = (double)__fsub_rn(p[a], gr.rmin[a]) / gr.vs[a];
      in = in && d >= 0.0 && d < (double)gr.g[a];
      ijk[a] = in ? (int)floor(d) : 0;
    }
    const u64 key = in ? (u64)segment_of(off, C, i) * gr.G +
                             ((u64)ijk[2] * gr.g[1] + ijk[1]) * gr.g[0] + ijk[0]
                       : invalid;
    keys[i] = key;
    vals[i] = (int)i;
    for (int p = 0; p < passes; p++) atomicAdd(&cnt[p][(key >> (p * RADIX)) & (BINS - 1)], 1u);
  }
  __syncthreads();
  for (int p = 0; p < passes; p++)
    if (cnt[p][t]) atomicAdd(&totals[p * BINS + t], cnt[p][t]);
}

// One radix pass over the digit at `shift`: rank each key of the tile
// among the tile's keys of its digit (a stable block sort) and place it
// after every key of a smaller digit (totals) and the earlier tiles' keys
// of its digit (a look-back per digit).
__global__ void __launch_bounds__(BLOCK)
scatter_kernel(const u64* __restrict__ kin, const int* __restrict__ vin, u64* __restrict__ kout,
               int* __restrict__ vout, int N, int shift, const unsigned* __restrict__ totals,
               unsigned* __restrict__ status, unsigned* __restrict__ counter) {
  typedef cub::BlockRadixSort<u64, BLOCK, ITEMS, int> Sort;
  typedef cub::BlockScan<unsigned, BLOCK> Scan;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ unsigned cnt[BINS], start[BINS], base[BINS];
  const int t = threadIdx.x;
  cnt[t] = 0;
  const int b = next_tile(counter);
  u64 k[ITEMS];
  int v[ITEMS];
  for (int j = 0; j < ITEMS; j++) {
    const long long i = (long long)b * TILE + t * ITEMS + j;
    if (i < N) {
      k[j] = kin[i];
      v[j] = vin[i];
      atomicAdd(&cnt[(k[j] >> shift) & (BINS - 1)], 1u);
    } else {  // padding: the largest digit, after the tile's own keys (stable)
      k[j] = ~0ull;
      v[j] = -1;
    }
  }
  __syncthreads();
  unsigned digit0;
  Scan(tmp.scan).ExclusiveSum(totals[t], digit0);
  __syncthreads();
  unsigned s;
  Scan(tmp.scan).ExclusiveSum(cnt[t], s);
  start[t] = s;
  base[t] = digit0 + look_back(status + t, BINS, b, 0, cnt[t]);
  __syncthreads();
  Sort(tmp.sort).SortBlockedToStriped(k, v, shift, shift + RADIX);
  for (int j = 0; j < ITEMS; j++) {
    if (v[j] < 0) continue;
    const int d = (int)((k[j] >> shift) & (BINS - 1));
    const unsigned o = base[d] + (unsigned)(j * BLOCK + t) - start[d];
    kout[o] = k[j];
    vout[o] = v[j];
  }
}

// Sorted order: the first key of each run of a valid key is its voxel's
// head, at the voxel's earliest point. Flags it in point order (first,
// headPos) and keeps its run's length up to P (run).
__global__ void heads_kernel(const u64* __restrict__ K, const int* __restrict__ Vs, int N,
                             u64 invalid, int P, unsigned char* __restrict__ first,
                             int* __restrict__ headPos, int* __restrict__ run) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const u64 k = K[i];
  if (k >= invalid || (i > 0 && K[i - 1] == k)) return;
  int n = 1;
  while (n < P && i + n < N && K[i + n] == k) n++;
  run[i] = n;
  const int p = Vs[i];
  first[p] = 1;
  headPos[p] = (int)i;
}

// Point order, a cloud's tile a block: each head's arrival rank in its
// cloud (a scan of the tile's head flags and a look-back over the cloud's
// earlier tiles); a head ranked below maxV is kept. Without the key sort
// its rank is its row; with it, the head is flagged (kept) for rows_kernel.
// The cloud's last tile writes its kept count.
__global__ void __launch_bounds__(BLOCK)
rank_kernel(const unsigned char* __restrict__ first, const int* __restrict__ headPos,
            const int* __restrict__ off, const int* __restrict__ ctile, int C, int maxV,
            int sort_by_key, int* __restrict__ rowHead, unsigned char* __restrict__ kept,
            int* __restrict__ nkept, unsigned* __restrict__ status, unsigned* __restrict__ counter) {
  typedef cub::BlockScan<unsigned, BLOCK> Scan;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ unsigned excl;
  const int b = next_tile(counter);
  if (b >= ctile[C]) return;  // the grid is an upper bound of the tiles
  const int c = segment_of(ctile, C, b);
  const long long lo = off[c] + (long long)(b - ctile[c]) * TILE;
  const long long hi = min(lo + TILE, (long long)off[c + 1]);
  unsigned f[ITEMS], e[ITEMS], agg;
  for (int j = 0; j < ITEMS; j++) {
    const long long i = lo + threadIdx.x * ITEMS + j;
    f[j] = i < hi ? first[i] : 0u;
  }
  Scan(tmp).ExclusiveSum(f, e, agg);
  if (threadIdx.x == 0) {
    excl = look_back(status, 1, b, ctile[c], agg);
    if (b == ctile[c + 1] - 1) nkept[c] = (int)min(excl + agg, (unsigned)maxV);
  }
  __syncthreads();
  for (int j = 0; j < ITEMS; j++) {
    if (!f[j]) continue;
    const unsigned r = excl + e[j];
    if (r >= (unsigned)maxV) continue;
    const int h = headPos[lo + threadIdx.x * ITEMS + j];
    if (sort_by_key) kept[h] = 1;
    else rowHead[(size_t)c * maxV + r] = h;
  }
}

// Sorted order (key sort only): each kept head's place among the kept heads
// of its cloud, in key order, is its row.
__global__ void __launch_bounds__(BLOCK)
rows_kernel(const unsigned char* __restrict__ kept, const u64* __restrict__ K, int N, u64 G,
            const int* __restrict__ nkept, int maxV, int* __restrict__ rowHead,
            unsigned* __restrict__ status, unsigned* __restrict__ counter) {
  typedef cub::BlockScan<unsigned, BLOCK> Scan;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ unsigned excl;
  const int b = next_tile(counter);
  const long long lo = (long long)b * TILE;
  unsigned f[ITEMS], e[ITEMS], agg;
  for (int j = 0; j < ITEMS; j++) {
    const long long i = lo + threadIdx.x * ITEMS + j;
    f[j] = i < N ? kept[i] : 0u;
  }
  Scan(tmp).ExclusiveSum(f, e, agg);
  if (threadIdx.x == 0) excl = look_back(status, 1, b, 0, agg);
  __syncthreads();
  for (int j = 0; j < ITEMS; j++) {
    if (!f[j]) continue;
    const long long i = lo + threadIdx.x * ITEMS + j;
    const int c = (int)(K[i] / G);
    unsigned before = 0;  // kept voxels of the clouds before c
    for (int q = 0; q < c; q++) before += nkept[q];
    rowHead[(size_t)c * maxV + (excl + e[j] - before)] = (int)i;
  }
}

// Every output byte. A warp takes FILL_ROWS consecutive rows of the (L *
// maxV) output rows at a time: lane l writes row l's coords, count and
// valid flag and holds its head and count; then the warp writes the rows'
// P * nc floats in order, lane l the floats l, l + 32, ... of each row:
// the points of the voxel's run, zeros past them. Output lane o takes
// cloud lanes[o]'s rows.
__global__ void __launch_bounds__(BLOCK)
fill_kernel(const float* __restrict__ pts, int nc, const u64* __restrict__ K,
            const int* __restrict__ Vs, const int* __restrict__ run,
            const int* __restrict__ rowHead, const int* __restrict__ nkept,
            const int* __restrict__ lanes, int L, int maxV, int P, Grid gr,
            float* __restrict__ vox, int* __restrict__ coords, int* __restrict__ num,
            unsigned char* __restrict__ valid) {
  constexpr int J = MAX_ROW_FLOATS / 32;
  const int lane = threadIdx.x & 31, row_floats = P * nc;
  int slot[J], chan[J];  // each of this lane's floats of a row: its point slot and channel
  for (int j = 0; j < J; j++) {
    const int f = lane + 32 * j;
    slot[j] = f < row_floats ? f / nc : P;
    chan[j] = f < row_floats ? f - (f / nc) * nc : 0;
  }
  const long long rows = (long long)L * maxV;
  const long long warps = (long long)gridDim.x * (BLOCK / 32);
  for (long long r0 = ((long long)blockIdx.x * (BLOCK / 32) + threadIdx.x / 32) * FILL_ROWS;
       r0 < rows; r0 += warps * FILL_ROWS) {
    const long long row = r0 + lane;
    int h = 0, n = 0;
    if (row < rows) {
      const int o = (int)(row / maxV), r = (int)(row - (long long)o * maxV), c = lanes[o];
      int z = 0, y = 0, x = 0;
      if (r < nkept[c]) {
        h = rowHead[(size_t)c * maxV + r];
        n = run[h];
        const u64 key = K[h] - (u64)c * gr.G, gx = gr.g[0], gy = gr.g[1];
        x = (int)(key % gx);
        y = (int)((key / gx) % gy);
        z = (int)(key / (gx * gy));
      }
      coords[3 * row] = z;
      coords[3 * row + 1] = y;
      coords[3 * row + 2] = x;
      num[row] = n;
      valid[row] = n > 0;
    }
    const int nr = (int)min((long long)FILL_ROWS, rows - r0);
    for (int q = 0; q < nr; q++) {
      const int hq = __shfl_sync(0xffffffffu, h, q), nq = __shfl_sync(0xffffffffu, n, q);
      float* out = vox + (r0 + q) * row_floats;
      for (int j = 0; j < J; j++) {
        if (slot[j] >= P) break;
        out[lane + 32 * j] = slot[j] < nq ? pts[(long long)Vs[hq + slot[j]] * nc + chan[j]] : 0.0f;
      }
    }
  }
}

int passes_of(u64 invalid) {
  int bits = 0;
  while (bits < 64 && (invalid >> bits)) bits++;
  const int p = (bits + RADIX - 1) / RADIX;
  return p < 1 ? 1 : p;
}

size_t align(size_t x) { return (x + 255) & ~(size_t)255; }

// The scratch's parts, 256-byte aligned; those from `zero` on are zeroed by
// one memset at the start of a call.
struct Layout {
  size_t keysA, keysB, valsA, valsB, headPos, run, rowHead, ctile, zero, totals, counters,
      sort_status, rank_status, rows_status, first, kept, nkept, bytes;
  Layout(long long N, int C, int maxV, int passes) {
    const long long nb = (N + TILE - 1) / TILE;
    size_t at = 0;
    auto take = [&](size_t n) { size_t here = at; at += align(n); return here; };
    keysA = take(N * sizeof(u64));
    keysB = take(N * sizeof(u64));
    valsA = take(N * sizeof(int));
    valsB = take(N * sizeof(int));
    headPos = take(N * sizeof(int));
    run = take(N * sizeof(int));
    rowHead = take((size_t)C * maxV * sizeof(int));
    ctile = take((C + 1) * sizeof(int));
    zero = at;
    totals = take((size_t)passes * BINS * sizeof(unsigned));
    counters = take((passes + 2) * sizeof(unsigned));
    sort_status = take((size_t)passes * nb * BINS * sizeof(unsigned));
    rank_status = take((nb + C) * sizeof(unsigned));
    rows_status = take(nb * sizeof(unsigned));
    first = take(N);
    kept = take(N);
    nkept = take(C * sizeof(int));
    bytes = at;
  }
};

struct Args {
  const float* pts;
  int N, nc;
  const int* off;
  int C;
  const int* lanes;
  int L, P, maxV, sort_by_key;
  Grid gr;
  float* vox;
  int* coords;
  int* num;
  unsigned char* valid;
};

#define VOX_CHECK()                           \
  do {                                        \
    const cudaError_t e = cudaGetLastError(); \
    if (e != cudaSuccess) return (int)e;      \
  } while (0)

// Every launch of one call.
int enqueue(const Args& a, char* base, cudaStream_t s) {
  const u64 invalid = (u64)a.C * a.gr.G;
  const int passes = passes_of(invalid), N = a.N, C = a.C, maxV = a.maxV;
  const Layout lay(N, C, maxV, passes);
  u64* keys[2] = {reinterpret_cast<u64*>(base + lay.keysA),
                   reinterpret_cast<u64*>(base + lay.keysB)};
  int* vals[2] = {reinterpret_cast<int*>(base + lay.valsA),
                  reinterpret_cast<int*>(base + lay.valsB)};
  int* headPos = reinterpret_cast<int*>(base + lay.headPos);
  int* run = reinterpret_cast<int*>(base + lay.run);
  int* rowHead = reinterpret_cast<int*>(base + lay.rowHead);
  int* ctile = reinterpret_cast<int*>(base + lay.ctile);
  unsigned* totals = reinterpret_cast<unsigned*>(base + lay.totals);
  unsigned* counters = reinterpret_cast<unsigned*>(base + lay.counters);
  unsigned* sort_status = reinterpret_cast<unsigned*>(base + lay.sort_status);
  unsigned* rank_status = reinterpret_cast<unsigned*>(base + lay.rank_status);
  unsigned* rows_status = reinterpret_cast<unsigned*>(base + lay.rows_status);
  unsigned char* first = reinterpret_cast<unsigned char*>(base + lay.first);
  unsigned char* kept = reinterpret_cast<unsigned char*>(base + lay.kept);
  int* nkept = reinterpret_cast<int*>(base + lay.nkept);
  const cudaError_t e = cudaMemsetAsync(base + lay.zero, 0, lay.bytes - lay.zero, s);
  if (e != cudaSuccess) return (int)e;
  const int nb = (N + TILE - 1) / TILE;
  if (N > 0) {
    keys_kernel<<<nb, BLOCK, 0, s>>>(a.pts, a.nc, N, a.off, C, a.gr, passes, keys[0],
                                           vals[0], totals, ctile);
    VOX_CHECK();
    for (int p = 0; p < passes; p++) {
      scatter_kernel<<<nb, BLOCK, 0, s>>>(
          keys[p & 1], vals[p & 1], keys[(p + 1) & 1], vals[(p + 1) & 1], N, p * RADIX,
          totals + p * BINS, sort_status + (size_t)p * nb * BINS, counters + p);
      VOX_CHECK();
    }
    const u64* K = keys[passes & 1];
    const int* Vs = vals[passes & 1];
    heads_kernel<<<nb * (TILE / BLOCK), BLOCK, 0, s>>>(K, Vs, N, invalid, a.P, first,
                                                             headPos, run);
    VOX_CHECK();
    rank_kernel<<<nb + C, BLOCK, 0, s>>>(first, headPos, a.off, ctile, C, maxV, a.sort_by_key,
                                         rowHead, kept, nkept, rank_status, counters + passes);
    VOX_CHECK();
    if (a.sort_by_key) {
      rows_kernel<<<nb, BLOCK, 0, s>>>(kept, K, N, a.gr.G, nkept, maxV, rowHead,
                                             rows_status, counters + passes + 1);
      VOX_CHECK();
    }
  }
  const long long rows = (long long)a.L * maxV;
  if (rows > 0) {
    const long long blocks = (rows + FILL_ROWS * (BLOCK / 32) - 1) / (FILL_ROWS * (BLOCK / 32));
    fill_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), BLOCK, 0, s>>>(
        a.pts, a.nc, keys[passes & 1], vals[passes & 1], run, rowHead, nkept, a.lanes, a.L, maxV,
        a.P, a.gr, a.vox, a.coords, a.num, a.valid);
    VOX_CHECK();
  }
  return 0;
}

#undef VOX_CHECK

}  // namespace

// Scratch bytes voxelize_lanes_launch needs for N points in C clouds of a
// grid of G cells (-1 where a key does not fit 64 bits).
extern "C" long long voxelize_lanes_scratch(long long N, int C, int maxV, long long G) {
  if (N < 0 || C < 1 || maxV < 1 || G < 1 || (u64)C > ~0ull / (u64)G) return -1;
  return (long long)Layout(N, C, maxV, passes_of((u64)C * (u64)G)).bytes;
}

// points (N, nc) f32, N < 2^30; off (C + 1) int32 cloud starts (0 .. N,
// nondecreasing); lanes (L) int32 cloud of each output lane; rmin, vs (3)
// f32 and g (3) int32 on the host: the range's minimum, the voxel size and
// the grid's cells, x y z; P * nc at most 256. Outputs: vox (L, maxV, P,
// nc) f32, coords (L, maxV, 3) int32 zyx, num (L, maxV) int32, valid (L,
// maxV) bool. Enqueues on `stream`; returns the first CUDA error.
extern "C" int voxelize_lanes_launch(const float* pts, int N, int nc, const int* off, int C,
                                     const int* lanes, int L, const float* rmin, const float* vs,
                                     const int* g, int P, int maxV, int sort_by_key,
                                     void* scratch, float* vox, int* coords, int* num,
                                     unsigned char* valid, void* stream) {
  if (N < 0 || N > (int)COUNT || nc < 3 || C < 1 || L < 0 || P < 1 || maxV < 1 ||
      P * nc > MAX_ROW_FLOATS)
    return (int)cudaErrorInvalidValue;
  Args a{pts, N, nc, off, C, lanes, L, P, maxV, sort_by_key, {}, vox, coords, num, valid};
  for (int i = 0; i < 3; i++) {
    if (g[i] < 1) return (int)cudaErrorInvalidValue;
    a.gr.rmin[i] = rmin[i];
    a.gr.vs[i] = (double)vs[i];
    a.gr.g[i] = g[i];
  }
  a.gr.G = (u64)g[0] * (u64)g[1] * (u64)g[2];
  if ((u64)C > ~0ull / a.gr.G || passes_of((u64)C * a.gr.G) > MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  return enqueue(a, static_cast<char*>(scratch), static_cast<cudaStream_t>(stream));
}
