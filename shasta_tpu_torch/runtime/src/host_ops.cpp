// Native host ops for shasta_tpu: rotated-box geometry, NMS, voxelizer.
//
// Role mirror of the reference's native components (det3d/ops/iou3d_nms
// CPU/CUDA extension and the numba voxelizer/pc_in_box kernels), written
// fresh as a plain C ABI shared library consumed via ctypes — no pybind11.
//
// Box convention matches shasta_tpu.core.geometry: rows [x,y,z,w,l,h,yaw]
// with w along the box-local x axis and clockwise-positive yaw
// (world = [[c, s], [-s, c]] @ local).
//
// Build: g++ -O3 -march=native -shared -fPIC host_ops.cpp -o libshasta_host.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <climits>
#include <thread>
#include <vector>
#include <unordered_map>

namespace {

struct Pt {
  double x, y;
};

// BEV corners, clockwise (template (-.5,-.5),(-.5,.5),(.5,.5),(.5,-.5)
// scaled by (w, l), rotated clockwise by yaw).
inline void box_corners(const float* b, Pt* c) {
  const double w = b[3], l = b[4], yaw = b[6];
  const double cs = std::cos(yaw), sn = std::sin(yaw);
  const double tx[4] = {-0.5 * w, -0.5 * w, 0.5 * w, 0.5 * w};
  const double ty[4] = {-0.5 * l, 0.5 * l, 0.5 * l, -0.5 * l};
  for (int i = 0; i < 4; i++) {
    c[i].x = tx[i] * cs + ty[i] * sn + b[0];
    c[i].y = -tx[i] * sn + ty[i] * cs + b[1];
  }
}

inline double polygon_area(const Pt* v, int n) {
  double a = 0;
  for (int i = 0; i < n; i++) {
    const Pt& p = v[i];
    const Pt& q = v[(i + 1) % n];
    a += p.x * q.y - q.x * p.y;
  }
  return std::fabs(a) * 0.5;
}

// Sutherland-Hodgman: clip clockwise polygon by the half-plane right of
// edge a->b (interior of a clockwise polygon).
inline int clip_edge(const Pt* in, int n, Pt a, Pt b, Pt* out) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  int m = 0;
  for (int i = 0; i < n; i++) {
    const Pt& s = in[i];
    const Pt& e = in[(i + 1) % n];
    const double cs = ex * (s.y - a.y) - ey * (s.x - a.x);
    const double ce = ex * (e.y - a.y) - ey * (e.x - a.x);
    const bool s_in = cs <= 1e-8, e_in = ce <= 1e-8;
    if (s_in != e_in) {
      const double t = cs / (cs - ce);
      out[m].x = s.x + t * (e.x - s.x);
      out[m].y = s.y + t * (e.y - s.y);
      m++;
    }
    if (e_in) out[m++] = e;
  }
  return m;
}

inline double rect_overlap(const float* b1, const float* b2) {
  Pt c1[4], c2[4];
  box_corners(b1, c1);
  box_corners(b2, c2);
  Pt buf1[16], buf2[16];
  std::memcpy(buf1, c1, sizeof(c1));
  int n = 4;
  Pt* cur = buf1;
  Pt* nxt = buf2;
  for (int k = 0; k < 4 && n > 0; k++) {
    n = clip_edge(cur, n, c2[k], c2[(k + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  return n >= 3 ? polygon_area(cur, n) : 0.0;
}

inline double z_overlap(const float* b1, const float* b2) {
  const double lo = std::max(b1[2] - b1[5] * 0.5, b2[2] - b2[5] * 0.5);
  const double hi = std::min(b1[2] + b1[5] * 0.5, b2[2] + b2[5] * 0.5);
  return std::max(0.0, hi - lo);
}

}  // namespace

extern "C" {

// Pairwise rotated BEV overlap areas: boxes (N,7)/(M,7) -> out (N*M).
void boxes_overlap_bev(const float* boxes1, int n, const float* boxes2, int m,
                       float* out) {
  for (int i = 0; i < n; i++)
    for (int j = 0; j < m; j++)
      out[i * m + j] = (float)rect_overlap(boxes1 + 7 * i, boxes2 + 7 * j);
}

// Pairwise BEV IoU.
void boxes_iou_bev(const float* boxes1, int n, const float* boxes2, int m,
                   float* out) {
  for (int i = 0; i < n; i++) {
    const float a1 = boxes1[7 * i + 3] * boxes1[7 * i + 4];
    for (int j = 0; j < m; j++) {
      const float a2 = boxes2[7 * j + 3] * boxes2[7 * j + 4];
      const double inter = rect_overlap(boxes1 + 7 * i, boxes2 + 7 * j);
      out[i * m + j] = (float)(inter / std::max(1e-8, (double)a1 + a2 - inter));
    }
  }
}

// Pairwise 3D IoU (BEV overlap x z overlap).
void boxes_iou_3d(const float* boxes1, int n, const float* boxes2, int m,
                  float* out) {
  for (int i = 0; i < n; i++) {
    const float* b1 = boxes1 + 7 * i;
    const double v1 = (double)b1[3] * b1[4] * b1[5];
    for (int j = 0; j < m; j++) {
      const float* b2 = boxes2 + 7 * j;
      const double v2 = (double)b2[3] * b2[4] * b2[5];
      const double inter = rect_overlap(b1, b2) * z_overlap(b1, b2);
      out[i * m + j] = (float)(inter / std::max(1e-8, v1 + v2 - inter));
    }
  }
}

// Rotated NMS: boxes (N,7) with scores (N); returns number of kept indices
// written to keep (caller-allocated N int64).
int rotate_nms(const float* boxes, const float* scores, int n,
               float iou_threshold, int64_t* keep) {
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<char> suppressed(n, 0);
  int k = 0;
  for (int oi = 0; oi < n; oi++) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[k++] = i;
    const float a1 = boxes[7 * i + 3] * boxes[7 * i + 4];
    for (int oj = oi + 1; oj < n; oj++) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float a2 = boxes[7 * j + 3] * boxes[7 * j + 4];
      const double inter = rect_overlap(boxes + 7 * i, boxes + 7 * j);
      const double iou = inter / std::max(1e-8, (double)a1 + a2 - inter);
      if (iou > iou_threshold) suppressed[j] = 1;
    }
  }
  return k;
}

// Points in rotated 3D boxes (mot_3d pc_in_box semantics: l along local x,
// CCW yaw). box rows [x,y,z,o,l,w,h]; mask out (P) uint8.
void pc_in_box(const float* box, const float* pc, int p, float scale,
               uint8_t* mask) {
  const double cx = box[0], cy = box[1], cz = box[2];
  const double yaw = box[3];
  const double hl = box[4] * scale * 0.5, hw = box[5] * scale * 0.5,
               hh = box[6] * scale * 0.5;
  const double cs = std::cos(yaw), sn = std::sin(yaw);
  for (int i = 0; i < p; i++) {
    const double dx = pc[3 * i] - cx, dy = pc[3 * i + 1] - cy;
    const double rx = dx * cs + dy * sn;
    const double ry = -dx * sn + dy * cs;
    const double rz = pc[3 * i + 2] - cz;
    mask[i] = (std::fabs(rx) < hl) && (std::fabs(ry) < hw) && (std::fabs(rz) < hh);
  }
}

// Voxelizer with the reference kernel's exact semantics
// (point_cloud_ops.py:7-55): arrival-ordered voxels, zyx coords, capped
// points per voxel. points (N, C); outputs caller-allocated:
// voxels (max_voxels, max_points, C), coors (max_voxels, 3) int32,
// num_points (max_voxels) int32. Returns the voxel count.
int points_to_voxel(const float* points, int n, int c, const float* voxel_size,
                    const float* coors_range, int max_points, int max_voxels,
                    float* voxels, int32_t* coors, int32_t* num_points) {
  const double vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
  const int gx = (int)std::round((coors_range[3] - coors_range[0]) / vx);
  const int gy = (int)std::round((coors_range[4] - coors_range[1]) / vy);
  const int gz = (int)std::round((coors_range[5] - coors_range[2]) / vz);
  std::unordered_map<int64_t, int> voxel_of;
  voxel_of.reserve(max_voxels * 2);
  int voxel_num = 0;
  for (int i = 0; i < n; i++) {
    const float* p = points + (int64_t)i * c;
    const int ix = (int)std::floor((p[0] - coors_range[0]) / vx);
    if (ix < 0 || ix >= gx) continue;
    const int iy = (int)std::floor((p[1] - coors_range[1]) / vy);
    if (iy < 0 || iy >= gy) continue;
    const int iz = (int)std::floor((p[2] - coors_range[2]) / vz);
    if (iz < 0 || iz >= gz) continue;
    const int64_t key = ((int64_t)iz * gy + iy) * gx + ix;
    auto it = voxel_of.find(key);
    int vi;
    if (it == voxel_of.end()) {
      if (voxel_num >= max_voxels) continue;
      vi = voxel_num++;
      voxel_of.emplace(key, vi);
      coors[3 * vi] = iz;
      coors[3 * vi + 1] = iy;
      coors[3 * vi + 2] = ix;
    } else {
      vi = it->second;
    }
    const int np = num_points[vi];
    if (np < max_points) {
      std::memcpy(voxels + ((int64_t)vi * max_points + np) * c, p,
                  sizeof(float) * c);
      num_points[vi] = np + 1;
    }
  }
  return voxel_num;
}

// crc32c (Castagnoli, table-driven, slice-by-1) for TFRecord framing
// verification (data/tfrecord.py) — the pure-python byte loop is ~1000x
// slower on multi-MB lidar records.
uint32_t crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      table[i] = c;
    }
    init = true;
  }
  crc ^= 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++) crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Sparse-conv plan builder (the spconv "rulebook" phase, host-native).
//
// C++ port of shasta_tpu/plans.py's two hot functions — semantics must
// stay bit-identical to the numpy reference (which remains the fallback
// and the test oracle):
//   plan_group        PosWord packing + window bases for one conv
//                     geometry (threaded over tile ranges)
//   strided_out_keys  exact spconv output set: per-tap candidate streams
//                     are monotone in voxel raster order (o_axis =
//                     floor((coord+pad)/stride) - i), so a k-way merge
//                     dedups without any sort.
// The numpy planner measures ~480 ms/frame at car scale — far over the
// ~19 ms/frame device budget; this port + loader-thread prefetch brings
// plan building fully under the compute shadow.

static const long long PLAN_MASK = 1LL << 62;  // host "no query" marker

int plan_group(const long long* keys, int V, const long long* qc,
               const unsigned char* rm, const unsigned char* rp, int M,
               int G, int H, int NBWL, int GBu, int tile, int nwin, int NBr,
               unsigned short* pos_out, int* bases_out) {
  const int T = (M + tile - 1) / tile;
  const int Mp = T * tile;
  std::memset(pos_out, 0, sizeof(unsigned short) * (size_t)Mp * G);
  std::atomic<int> ok{1};

  auto lower = [&](long long x, int from) {
    // first index >= x, galloping from a hint: per-group queries ascend
    // in row order, so successive searches start near the previous hit
    int lo = from, step = 1;
    while (lo < V && keys[lo] < x) { lo += step; step <<= 1; }
    int hi = lo < V ? lo : V;
    lo = std::max(from, hi - (step >> 1));
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (keys[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
  };

  auto run_tiles = [&](int t0, int t1) {
    std::vector<int> j0s((size_t)tile * G);
    std::vector<unsigned short> bits((size_t)tile * G);
    for (int t = t0; t < t1; t++) {
      const int r0 = t * tile;
      const int rows = std::min(tile, M - r0) > 0 ? std::min(tile, M - r0) : 0;
      for (int g = 0; g < G; g++) {
        // pass 1: positions + presence/validity bits, window-1 min block
        long long bmin1 = LLONG_MAX;
        int hint = 0;
        for (int r = 0; r < rows; r++) {
          const long long q = qc[(size_t)(r0 + r) * G + g];
          const bool real = q < PLAN_MASK;
          int j0 = V;
          if (real) {
            j0 = lower(q - 1, hint);
            hint = j0;
          }
          const bool pm1 = j0 < V && keys[j0] == q - 1;
          const int jq = j0 + (pm1 ? 1 : 0);
          const bool p0 = jq < V && keys[jq] == q;
          const int jp = jq + (p0 ? 1 : 0);
          const bool pp1 = jp < V && keys[jp] == q + 1;
          const bool vm1 = pm1 && rm[r0 + r] && real;
          const bool v0 = p0 && real;
          const bool vp1 = pp1 && rp[r0 + r] && real;
          j0s[(size_t)r * G + g] = j0;
          unsigned short b = (pm1 ? 1u << 9 : 0) | (p0 ? 1u << 10 : 0) |
                             (vm1 ? 1u << 11 : 0) | (v0 ? 1u << 12 : 0) |
                             (vp1 ? 1u << 13 : 0);
          bits[(size_t)r * G + g] = b;
          if ((b >> 11) & 7) {  // any valid tap -> active row
            const long long blk = j0 / H;
            if (blk < bmin1) bmin1 = blk;
          }
        }
        int r1 = NBr - 1;  // empty group: numpy clips INF//GB to NBr-1
        if (bmin1 != LLONG_MAX) {
          r1 = (int)(bmin1 / GBu);
          if (r1 > NBr - 1) r1 = NBr - 1;
          if (r1 < 0) r1 = 0;
        }
        // window-2 min over leftovers
        long long bmin2 = LLONG_MAX;
        if (nwin == 2) {
          for (int r = 0; r < rows; r++) {
            if (!((bits[(size_t)r * G + g] >> 11) & 7)) continue;
            const long long blk = j0s[(size_t)r * G + g] / H;
            const bool in1 = blk >= (long long)r1 * GBu &&
                             blk < (long long)r1 * GBu + NBWL;
            if (!in1 && blk < bmin2) bmin2 = blk;
          }
        }
        int r2 = NBr - 1;  // no leftovers: numpy clips INF//GB to NBr-1
        if (bmin2 != LLONG_MAX) {
          r2 = (int)(bmin2 / GBu);
          if (r2 > NBr - 1) r2 = NBr - 1;
          if (r2 < 0) r2 = 0;
        }
        if (nwin == 2) {
          bases_out[(size_t)t * 2 * G + 2 * g] = r1;
          bases_out[(size_t)t * 2 * G + 2 * g + 1] = r2;
        } else {
          bases_out[(size_t)t * G + g] = r1;
        }
        // pass 2: window assignment + rel packing
        for (int r = 0; r < rows; r++) {
          unsigned short b = bits[(size_t)r * G + g];
          if (!((b >> 11) & 7)) continue;  // inactive: word stays 0
          const int j0 = j0s[(size_t)r * G + g];
          const long long blk = j0 / H;
          const bool in1 = blk >= (long long)r1 * GBu &&
                           blk < (long long)r1 * GBu + NBWL;
          int rsel = r1;
          if (!in1) {
            const bool in2 = nwin == 2 && blk >= (long long)r2 * GBu &&
                             blk < (long long)r2 * GBu + NBWL;
            if (!in2) { ok.store(0); continue; }
            rsel = r2;
            b |= 1u << 14;
          }
          long long rel = (long long)j0 - (long long)rsel * GBu * H;
          if (rel < 0) rel = 0;
          if (rel > 511) rel = 511;
          pos_out[(size_t)(r0 + r) * G + g] =
              (unsigned short)(b | (unsigned short)rel);
        }
      }
    }
  };

  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;
  if (T < 2 * nthreads) {
    run_tiles(0, T);
  } else {
    std::vector<std::thread> ths;
    const int per = (T + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; i++) {
      const int a = i * per, b = std::min(T, (i + 1) * per);
      if (a < b) ths.emplace_back(run_tiles, a, b);
    }
    for (auto& th : ths) th.join();
  }
  return ok.load();
}

int strided_out_keys(const int* coords, const unsigned char* valid, int V,
                     const int* kernel3, const int* stride3, const int* pad3,
                     const int* shape3, int max_out, long long* out_keys,
                     long long sentinel) {
  const int kz = kernel3[0], ky = kernel3[1], kx = kernel3[2];
  const int sz = stride3[0], sy = stride3[1], sx = stride3[2];
  const int pz = pad3[0], py = pad3[1], px = pad3[2];
  const int Z = shape3[0], Y = shape3[1], X = shape3[2];
  const int OZ = (Z + 2 * pz - kz) / sz + 1;
  const int OY = (Y + 2 * py - ky) / sy + 1;
  const int OX = (X + 2 * px - kx) / sx + 1;
  const long long s_out = (long long)OZ * OY * OX + 1;
  const int cz = (kz + sz - 1) / sz, cy = (ky + sy - 1) / sy,
            cx = (kx + sx - 1) / sx;
  const int C = cz * cy * cx;
  // one candidate stream per (iz, iy, ix) multiple: for a voxel at
  // (z, y, x), candidate o_axis = floor((coord + pad)/stride) - i and
  // the tap used is (coord+pad)%stride + i*stride, valid iff < kernel.
  // Streams are NEARLY sorted in voxel raster order but floor-ties let
  // the minor axes wrap backwards, so each stream is sorted (in
  // parallel) before the dedup k-way merge — still far cheaper than one
  // big sort of the concatenated candidates.
  std::vector<std::vector<long long>> streams(C);
  for (auto& s : streams) s.reserve(V);
  for (int v = 0; v < V; v++) {
    if (!valid[v]) continue;
    const long long b = coords[4 * v];
    const int z = coords[4 * v + 1], y = coords[4 * v + 2],
              x = coords[4 * v + 3];
    const int rz = ((z + pz) % sz + sz) % sz, ry = ((y + py) % sy + sy) % sy,
              rx = ((x + px) % sx + sx) % sx;
    const int qz = (z + pz) / sz, qy = (y + py) / sy, qx = (x + px) / sx;
    int c = 0;
    for (int iz = 0; iz < cz; iz++)
      for (int iy = 0; iy < cy; iy++)
        for (int ix = 0; ix < cx; ix++, c++) {
          if (rz + iz * sz >= kz || ry + iy * sy >= ky || rx + ix * sx >= kx)
            continue;
          const int oz = qz - iz, oy = qy - iy, ox = qx - ix;
          if (oz < 0 || oz >= OZ || oy < 0 || oy >= OY || ox < 0 || ox >= OX)
            continue;
          streams[c].push_back(b * s_out + ((long long)oz * OY + oy) * OX + ox);
        }
  }
  {
    std::vector<std::thread> ths;
    for (int c = 0; c < C; c++)
      ths.emplace_back([&streams, c] {
        std::sort(streams[c].begin(), streams[c].end());
      });
    for (auto& th : ths) th.join();
  }
  std::vector<size_t> cur(C, 0);
  int n = 0;
  long long last = LLONG_MIN;
  while (n < max_out) {
    long long best = LLONG_MAX;
    int bc = -1;
    for (int c = 0; c < C; c++) {
      if (cur[c] < streams[c].size() && streams[c][cur[c]] < best) {
        best = streams[c][cur[c]];
        bc = c;
      }
    }
    if (bc < 0) break;
    cur[bc]++;
    if (best != last) {
      out_keys[n++] = best;
      last = best;
    }
  }
  for (int i = n; i < max_out; i++) out_keys[i] = sentinel;
  return n;
}

}  // extern "C"
