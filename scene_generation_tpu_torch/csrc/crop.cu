// Differentiable ROI crop, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels scene_generation_tpu/ops/pallas/crop.py::
// _crop_fwd_kernel and _crop_bwd_kernel, the custom VJP of crop_pallas:
//
//   crop[n,o,p,q,c] = sum_{y,x} ry[n,o,p,y] * img[n,y,x,c] * rx[n,o,q,x]
//
// with img (N, H, W, C) NHWC, ry (N, O, HH, H), rx (N, O, WW, W) and crop
// (N, O, HH, WW, C), all contiguous, float32 or bfloat16 of one dtype.
// Given u = dL/dcrop (the shape of crop):
//
//   d_img[n,y,x,c] = sum_o (ry_o^T (u_oc rx_o))[y,x]
//   d_ry[n,o,p,y]  = sum_c (u_oc (img_c rx_o^T)^T)[p,y]
//   d_rx[n,o,q,x]  = sum_c (u_oc^T (ry_o img_c))[q,x]
//
// What bounds it on this card. The op is defined on dense matrices, but
// the path feeds it bilinear hats (ops/sampling.py::crop_matrices): each
// row of ry and rx holds at most two nonzeros, and since the samples are
// monotone in p (q), each column's nonzeros are one contiguous run. On the
// nonzeros alone the work is a few MFLOP, so the bound is bytes (H100 SXM,
// 3.35 TB/s): at the train shapes (N=12, 128x128x3 images, O=9, f32) the
// forward reads the images (2.36 MB) and the dense hats (1.77 MB each at
// 32 px, 3.54 MB at 64 px) and writes the crops (1.33 / 5.31 MB): 2.2 us at
// 32 px, 4.4 us at 64 px. The d_img backward reads ry, rx and u and writes
// d_img, no image: 2.2 us at 32 px. d_ry and d_rx are dense outputs
// (non-zero wherever the image is, whatever the hats): with them the
// backward at 32 px needs 0.24 GFLOP, 3.5 us at the f32 rate, against
// 3.9 us of bytes.
//
// So a kernel reads every hat value once, finds the spans (the first and
// last nonzero of a row or a column) and multiplies only inside them; a
// dense ry/rx is still right (every span is then the whole row: slow, but
// the same sums). At these sizes every input sits in L2: what a kernel
// waits on is its chain of dependent round trips, the instructions it
// issues per output, and its waves, not bytes (bf16 takes the f32 time).
//
// The design (times: chip_smoke.py --only crop, H100 80GB HBM3 at 700 W):
//   forward:  one launch, no scratch. A block owns one (n, o) and a band
//             of crop rows p, the bands sized for one wave of at most
//             FWD_BLOCKS blocks. Its warps scan all of rx_o and the band's
//             rows of ry_o at once (a warp a row, eight rows a warp, every
//             load in flight before any is tested), reduce each row's span
//             and keep its first two taps in shared memory: one round trip.
//             Then each thread takes QPT (1, or 2 for crops wider than
//             NARROW) crop columns q of a row with all their channels:
//             out[p][q][c] = sum_{x in span(q)} t(x) rx[q][x],
//             t(x) = sum_{y in span(p)} ry[p][y] img[y][x][c],
//             its image taps at one address plus constant offsets, all
//             loaded before any product (the second round trip), and its
//             outputs stored in the widest stores their address allows.
//             The earlier pair of launches (a span pass, then a thread an
//             output) took 7.0 us at 32 px and 12 images; this takes 5.3,
//             and 54 us against 91 at 224 px.
//   d_img:    two launches. crop_col_spans_kernel writes, for each column
//             of ry_o and rx_o, its span over the crop's rows and its first
//             two taps (a 16-byte entry; scratch N*O*(H+W) entries); then
//             crop_bwd_img_kernel gives a thread a pixel with all its
//             channels, stages its block's entries in shared memory, skips
//             an object whose rows miss the warp's row (or whose columns
//             miss the pixel), loads the up to 2 x 2 cells of u a covered
//             pixel needs at once, and sums
//             d_img[y][x][c] = sum_o sum_{p in colspan(ry_o, y)} ry[o][p][y]
//                              * sum_{q in colspan(rx_o, x)} u[o][p][q][c]
//                                * rx[o][q][x];
//             a span longer than two (dense hats, upsampling boxes, the
//             degenerate box whose columns span every q) goes out of line,
//             two rows p and LB columns q of loads at once. The sums leave
//             through shared memory in 16-byte stores. 15.3 us at 32 px and
//             12 images, against 17.7 for the earlier gather (a thread a
//             pixel, its taps and u fetched an object at a time).
//   d_ry, d_rx (launched only when asked): one launch of two kinds of
//             block, a block per (n, o) and 32 x 64 tile of d_ry (rows p,
//             columns y) or of d_rx (rows q, columns x), 4 x 4 outputs a
//             thread, each a product of two k-major tiles in shared memory
//             with k = (s, c) in order, on the CUDA cores (f32 FMAs):
//             d_rx[q][x] = sum_{p in pr, c} u[p][q][c] t1[p][x][c],
//               t1[p][x][c] = sum_{y in rowspan(ry, p)} ry[p][y] img[y][x][c]
//             d_ry[p][y] = sum_{q in qr, c} u[p][q][c] t2[y][q][c],
//               t2[y][q][c] = sum_{x in rowspan(rx, q)} rx[q][x] img[y][x][c]
//             (the plain version's association), pr and qr the ranges of
//             rows of ry_o and rx_o that hold a nonzero. A block stages u,
//             scans ry_o (rx_o) into shared memory for its spans, forms t1
//             (t2) from two taps a value, then multiplies. Every staging
//             loop issues its loads into registers before it stores any:
//             stores to shared memory between the loads kept them one
//             round trip each. No float scratch leaves the block.
// Why the forward fuses and d_img does not. A forward band needs all of
// rx_o and its own rows of ry_o, so a block finds every span it uses in
// one scan. A tile of d_img needs the whole columns of every ry_o and rx_o
// that cross it, and the tiles of a row band share them: one launch that
// found them in-block re-read the hats about four times over and staged
// them a block at a time in shared memory (one block an SM), and lost to
// the two launches at every shape tried. The span pass reads each hat once.
//
// Summation order. Every product is a float32 FMA and every sum runs in
// float32 in a fixed ascending order (y, then x; q, then p, then o), the
// association of the dense products (for d_ry the plain version's, u
// against t2: forming u rx first, as an earlier kernel did, takes up to
// four times the products), so two runs give bitwise-equal results and
// dropping the zero terms leaves every finite result equal to the dense sum
// up to the sign of a zero. bf16 outputs are rounded once, on store.
//
// Non-finite inputs. The dense products (the TPU kernel's, and the plain
// versions') turn one NaN or Inf anywhere in an image into NaN in every
// crop of that image, since 0 * NaN = NaN. The banded forward and d_img
// kernels, like grid_sample, propagate only what they sample. A NaN in ry
// or rx counts as a nonzero and is kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The forward and d_img.
constexpr int THREADS = 256;       // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int ROW_SCAN = 8;        // rows a warp loads at once
constexpr int ROW_LOADS = 4;       // forward: loads a lane issues a row at once
constexpr int NARROW = 64;         // forward: crops at most this wide take a
                                   // column a thread, wider ones two
constexpr int FWD_BLOCKS = 264;    // forward: blocks at most (two an SM)
constexpr int SPAN_THREADS = 128;  // d_img span pass: threads a block
constexpr int COL_LOADS = 16;      // d_img span pass: loads a thread at once
constexpr int GX = 32;             // d_img: image columns a block
constexpr int GY = 8;              // d_img: image rows a block
constexpr int LB = 2;              // d_img: columns q a long span loads at once
constexpr int EG = 16;             // d_img: objects whose entries a block stages
static_assert(GX * GY == THREADS, "a d_img thread a pixel");
// The box gradients.
constexpr int BT = 128;         // threads a box-gradient block
constexpr int TI = 32;          // its output rows: p of d_ry, q of d_rx
constexpr int TJ = 64;          // its output columns: y of d_ry, x of d_rx
constexpr int AS = TI + 4;      // row stride (floats) of the k-major A tiles
constexpr int BATCH = 4;        // t1 sums a thread forms at once
constexpr int SCAN_ROWS = 4;    // rows a warp scans at once

// Through the read-only (non-coherent) cache.
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Values of one 16-byte store.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a at the lower
  return *reinterpret_cast<const unsigned*>(&h);         // address
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// The N values of v at p in the widest stores the address allows: 16
// bytes, 8 bytes, bf16 pairs, or a value at a time.
template <typename T, int N>
__device__ __forceinline__ void store_contig(T* p, const float (&v)[N]) {
  constexpr int V = Vec<T>::N;
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (N % V == 0 && at % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += V) store16(p + i, v + i);
  } else if (N % (V / 2) == 0 && at % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += V / 2) store8(p + i, v + i);
  } else if (N % (V / 4) == 0 && V == 8 && at % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<unsigned*>(p + i) = pack_bf16(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) store_from_f32(p + i, v[i]);
  }
}

// Row spans and taps of two stacked matrices, a warp a row: rows r < ra
// are A's (length la), the next rb are B's (length lb). span_a[r] and
// span_b[r] are the first and last column holding a nonzero (NaN counts),
// an empty range for a row of zeros; tap_a[r] and tap_b[r] the values at
// the first column and the next (0 where absent). A warp scans ROW_SCAN
// rows at once, every load issued before any is tested; lane r then
// reads row r's two taps (from L1: the warp has just loaded them).
template <typename T>
__device__ __forceinline__ void row_spans(const T* __restrict__ A, int la,
                                          int ra, const T* __restrict__ B,
                                          int lb, int rb, int2* span_a,
                                          float2* tap_a, int2* span_b,
                                          float2* tap_b) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows = ra + rb, L = max(la, lb);
  for (int r0 = warp * ROW_SCAN; r0 < rows; r0 += WARPS * ROW_SCAN) {
    int lo[ROW_SCAN], hi[ROW_SCAN];
#pragma unroll
    for (int r = 0; r < ROW_SCAN; ++r) {
      lo[r] = L;
      hi[r] = -1;
    }
    for (int t0 = 0; t0 < L; t0 += 32 * ROW_LOADS) {
      float v[ROW_SCAN][ROW_LOADS];
#pragma unroll
      for (int r = 0; r < ROW_SCAN; ++r) {
        const int row = r0 + r;
        const bool of_a = row < ra;
        const T* m = of_a ? A + (size_t)row * la : B + (size_t)(row - ra) * lb;
        const int len = row < rows ? (of_a ? la : lb) : 0;
#pragma unroll
        for (int j = 0; j < ROW_LOADS; ++j) {
          const int t = t0 + j * 32 + lane;
          v[r][j] = t < len ? load_ro(m + t) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROW_SCAN; ++r)
#pragma unroll
        for (int j = 0; j < ROW_LOADS; ++j)
          if (v[r][j] != 0.f) {
            const int t = t0 + j * 32 + lane;
            lo[r] = min(lo[r], t);
            hi[r] = max(hi[r], t);
          }
    }
    int my_lo = 0, my_hi = -1;
#pragma unroll
    for (int r = 0; r < ROW_SCAN; ++r) {
      const int l = __reduce_min_sync(0xffffffffu, lo[r]);
      const int h = __reduce_max_sync(0xffffffffu, hi[r]);
      if (lane == r) {
        my_lo = l;
        my_hi = h;
      }
    }
    const int row = r0 + lane;
    if (lane < ROW_SCAN && row < rows) {
      const bool of_a = row < ra;
      const T* m = of_a ? A + (size_t)row * la : B + (size_t)(row - ra) * lb;
      const float t0 = my_lo <= my_hi ? load_ro(m + my_lo) : 0.f;
      const float t1 = my_lo < my_hi ? load_ro(m + my_lo + 1) : 0.f;
      if (of_a) {
        span_a[row] = make_int2(my_lo, my_hi);
        tap_a[row] = make_float2(t0, t1);
      } else {
        span_b[row - ra] = make_int2(my_lo, my_hi);
        tap_b[row - ra] = make_float2(t0, t1);
      }
    }
  }
}

// grid (bands, N * O, channel groups). Block (b, no, g) writes crop rows
// p0 = b * band .. of crop no, channels c0 = g * CC ..; a thread a run of
// QPT (1 or 2) crop columns q of one row with its CC channels:
//   out[p][q][c] = sum_{x in span(q)} t(x) rx[q][x],
//   t(x) = sum_{y in span(p)} ry[p][y] img[y][x][c],
// y and x in order (the plain version's association), every image load of
// the run issued before any product. Shared memory: the spans and first
// two taps of rx_o's rows (WW) and of the band's rows of ry_o (band).
template <typename T, int CC, int QPT>
__global__ void __launch_bounds__(THREADS)
crop_fwd_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                const T* __restrict__ rx, T* __restrict__ out, int H, int W,
                int C, int O, int HH, int WW, int band) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  int2* sq = reinterpret_cast<int2*>(smem_bytes);
  int2* sp = sq + WW;
  float2* tq = reinterpret_cast<float2*>(sp + band);
  float2* tp = tq + WW;
  const int no = blockIdx.y, c0 = blockIdx.z * CC;
  const int p0 = blockIdx.x * band, np = min(band, HH - p0);
  const T* rx_o = rx + (size_t)no * WW * W;
  const T* ry_b = ry + ((size_t)no * HH + p0) * H;
  const T* img_n = img + (size_t)(no / O) * H * W * C + c0;
  row_spans(rx_o, W, WW, ry_b, H, np, sq, tq, sp, tp);
  __syncthreads();
  const int WC = W * C, runs = (WW + QPT - 1) / QPT;
  const bool whole = C == CC;      // a run's outputs are contiguous
  for (int it = threadIdx.x; it < np * runs; it += THREADS) {
    const int r = it / runs, q0 = (it - r * runs) * QPT;
    const int2 sy = sp[r];
    const float2 a = tp[r];
    const bool y1 = sy.x <= sy.y, y2 = sy.x < sy.y;
    const T* img_y = img_n + (size_t)(y1 ? sy.x : 0) * WC;
    int2 sx[QPT];
    float2 b[QPT];
    float i00[QPT][CC], i01[QPT][CC], i10[QPT][CC], i11[QPT][CC];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const bool live = q0 + j < WW;
      sx[j] = live ? sq[q0 + j] : make_int2(1, 0);
      b[j] = live ? tq[q0 + j] : make_float2(0.f, 0.f);
      const bool x1 = y1 && sx[j].x <= sx[j].y, x2 = sx[j].x < sx[j].y;
      const T* px = img_y + (x1 ? sx[j].x : 0) * C;
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        const bool ch = c0 + k < C;
        i00[j][k] = x1 && ch ? load_ro(px + k) : 0.f;
        i01[j][k] = x1 && x2 && ch ? load_ro(px + C + k) : 0.f;
        i10[j][k] = x1 && y2 && ch ? load_ro(px + WC + k) : 0.f;
        i11[j][k] = x1 && x2 && y2 && ch ? load_ro(px + WC + C + k) : 0.f;
      }
    }
    float v[QPT * CC];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int2 x = sx[j];
      if (sy.y <= sy.x + 1 && x.y <= x.x + 1) {
        // At most two taps each way (the hats): t(x0), then t(x0 + 1).
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          float s = 0.f;
          if (x.x <= x.y) {
            float t = 0.f;
            if (y1) t = fmaf(a.x, i00[j][k], t);
            if (y2) t = fmaf(a.y, i10[j][k], t);
            s = fmaf(t, b[j].x, s);
            if (x.x < x.y) {
              t = 0.f;
              if (y1) t = fmaf(a.x, i01[j][k], t);
              if (y2) t = fmaf(a.y, i11[j][k], t);
              s = fmaf(t, b[j].y, s);
            }
          }
          v[j * CC + k] = s;
        }
      } else {
        // Longer spans (dense matrices): taps past the second from L1/L2.
        const T* ry_row = ry_b + (size_t)r * H;
        const T* rx_row = rx_o + (size_t)(q0 + j) * W;
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          float s = 0.f;
          for (int xx = x.x; xx <= x.y && c0 + k < C; ++xx) {
            float t = 0.f;
            for (int yy = sy.x; yy <= sy.y; ++yy) {
              const float w = yy == sy.x       ? a.x
                              : yy == sy.x + 1 ? a.y
                                               : load_ro(ry_row + yy);
              t = fmaf(w, load_ro(img_n + ((size_t)yy * W + xx) * C + k), t);
            }
            const float w = xx == x.x       ? b[j].x
                            : xx == x.x + 1 ? b[j].y
                                            : load_ro(rx_row + xx);
            s = fmaf(t, w, s);
          }
          v[j * CC + k] = s;
        }
      }
    }
    T* dst = out + (((size_t)no * HH + p0 + r) * WW + q0) * C + c0;
    if (whole && q0 + QPT <= WW) {
      store_contig(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int k = 0; k < CC; ++k)
          if (q0 + j < WW && c0 + k < C)
            store_from_f32(dst + j * C + k, v[j * CC + k]);
    }
  }
}

// A column's span over the rows of a hat and its first two taps: the
// values at rows lo and lo + 1 (0 past the last row).
struct __align__(16) Col {
  int lo, hi;
  float t0, t1;
};
static_assert(sizeof(Col) == 16, "the wrapper's scratch holds 16 bytes an entry");

// grid (N * O, 2). Block (no, 0) takes the H columns of ry_o (over its HH
// rows), block (no, 1) the W columns of rx_o (over WW): a thread a
// column, its rows in order, COL_LOADS loads issued at once:
// cols[no * (H + W) + j], j < H for ry_o's, then H + x for rx_o's.
template <typename T>
__global__ void __launch_bounds__(SPAN_THREADS)
crop_col_spans_kernel(const T* __restrict__ ry, const T* __restrict__ rx,
                      Col* __restrict__ cols, int H, int W, int HH, int WW) {
  const size_t no = blockIdx.x;
  const bool of_rx = blockIdx.y == 1;
  const int L = of_rx ? W : H, S = of_rx ? WW : HH;
  const T* m = of_rx ? rx + no * WW * W : ry + no * HH * H;
  Col* out = cols + no * (H + W) + (of_rx ? H : 0);
  for (int j = threadIdx.x; j < L; j += SPAN_THREADS) {
    Col c = {S, -1, 0.f, 0.f};
    for (int r0 = 0; r0 < S; r0 += COL_LOADS) {
      float v[COL_LOADS];
#pragma unroll
      for (int b = 0; b < COL_LOADS; ++b)
        v[b] = r0 + b < S ? load_ro(m + (size_t)(r0 + b) * L + j) : 0.f;
#pragma unroll
      for (int b = 0; b < COL_LOADS; ++b) {
        const int r = r0 + b;
        if (r < S && v[b] != 0.f) {
          if (c.hi < 0) {
            c.lo = r;
            c.t0 = v[b];
          }
          c.hi = r;
        }
        if (c.hi >= 0 && r == c.lo + 1) c.t1 = v[b];
      }
    }
    out[j] = c;
  }
}

// The sums a value CC channels wide, passed and returned in registers.
template <int CC>
struct Sums {
  float v[CC];
  __device__ __forceinline__ static Sums of(const float (&a)[CC]) {
    Sums s;
#pragma unroll
    for (int k = 0; k < CC; ++k) s.v[k] = a[k];
    return s;
  }
};

// One object's terms of one pixel (x, y) when a span is longer than two
// (dense hats, upsampling or degenerate boxes), added to acc in order:
// taps past the entry's two and u from memory, rows p two at a time, LB
// columns q at once. Out of line: rare, and its loads in flight would take
// registers from the common path.
template <typename T, int CC>
__device__ __noinline__ Sums<CC> long_spans(
    const Col yc, const Col xc, const T* __restrict__ ry,
    const T* __restrict__ rx, const T* __restrict__ u, size_t no, int x,
    int y, int H, int W, int C, int HH, int WW, int c0, Sums<CC> acc) {
  const size_t QC = (size_t)WW * C;
  const T* ry_col = ry + no * HH * H + y;
  const T* rx_col = rx + no * WW * W + x;
  const T* ug = u + no * HH * QC + c0;
  for (int p = yc.lo; p <= yc.hi; p += 2) {
    // Rows p and p + 1 (when in the span) in one pass over q.
    const bool two = p < yc.hi;
    const float a0 = p == yc.lo ? yc.t0 : load_ro(ry_col + (size_t)p * H);
    const float a1 = !two             ? 0.f
                     : p == yc.lo     ? yc.t1
                                      : load_ro(ry_col + (size_t)(p + 1) * H);
    float ub0[CC], ub1[CC];
#pragma unroll
    for (int k = 0; k < CC; ++k) ub0[k] = ub1[k] = 0.f;
    for (int q0 = xc.lo; q0 <= xc.hi; q0 += LB) {
      float t[LB], v0[LB][CC], v1[LB][CC];
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int q = q0 + i;
        t[i] = q > xc.hi        ? 0.f
               : q == xc.lo     ? xc.t0
               : q == xc.lo + 1 ? xc.t1
                                : load_ro(rx_col + (size_t)q * W);
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          const bool ok = q <= xc.hi && c0 + k < C;
          v0[i][k] = ok ? load_ro(ug + p * QC + q * C + k) : 0.f;
          v1[i][k] = ok && two ? load_ro(ug + (p + 1) * QC + q * C + k) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < LB; ++i)
#pragma unroll
        for (int k = 0; k < CC; ++k)
          if (q0 + i <= xc.hi) {
            ub0[k] = fmaf(v0[i][k], t[i], ub0[k]);
            ub1[k] = fmaf(v1[i][k], t[i], ub1[k]);
          }
    }
#pragma unroll
    for (int k = 0; k < CC; ++k) {
      acc.v[k] = fmaf(a0, ub0[k], acc.v[k]);
      if (two) acc.v[k] = fmaf(a1, ub1[k], acc.v[k]);
    }
  }
  return acc;
}

// grid (pixel blocks, N, channel groups). Block b takes the GY image rows
// from y0 = b / xblocks * GY and the GX columns from x0 = b % xblocks * GX
// of image n, a thread a pixel with its CC channels c0 = g * CC ..:
//   d_img[y][x][c] = sum_o sum_{p in colspan(ry_o, y)} ry[o][p][y]
//                    * (sum_{q in colspan(rx_o, x)} u[o][p][q][c] rx[o][q][x]),
// o, p and q in order. The block stages the entries of its rows and
// columns, EG objects at a time (one load each); a warp, whose 32 pixels
// share a row, skips an object whose rows miss it, and a pixel one whose
// columns miss it, so only the objects that cover a pixel cost it loads:
// up to 2 x 2 cells of u of CC channels, issued together, or, for a longer
// span, LB columns q at once. The sums leave through shared memory, a
// block row at a time in 16-byte stores.
template <typename T, int CC>
__global__ void __launch_bounds__(THREADS)
crop_bwd_img_kernel(const T* __restrict__ ry, const T* __restrict__ rx,
                    const T* __restrict__ u, const Col* __restrict__ cols,
                    T* __restrict__ d_img, int H, int W, int C, int O,
                    int HH, int WW, int xblocks) {
  __shared__ __align__(16) float tile[GY * GX * CC];
  __shared__ Col ent[EG * (GY + GX)];
  const int lx = threadIdx.x % GX, ly = threadIdx.x / GX;
  const int x0 = blockIdx.x % xblocks * GX, y0 = blockIdx.x / xblocks * GY;
  const int x = x0 + lx, y = y0 + ly, n = blockIdx.y, c0 = blockIdx.z * CC;
  const bool active = x < W && y < H;
  const Col* ce = cols + (size_t)n * O * (H + W);
  const size_t QC = (size_t)WW * C;
  float acc[CC];
#pragma unroll
  for (int k = 0; k < CC; ++k) acc[k] = 0.f;
  for (int g0 = 0; g0 < O; g0 += EG) {
    // The block's entries of EG objects: GY rows, then GX columns each.
    const int ng = min(EG, O - g0);
    __syncthreads();
    for (int i = threadIdx.x; i < ng * (GY + GX); i += THREADS) {
      const int o = i / (GY + GX), k = i - o * (GY + GX);
      const int at = k < GY ? min(y0 + k, H - 1) : H + min(x0 + k - GY, W - 1);
      ent[i] = ce[(size_t)(g0 + o) * (H + W) + at];
    }
    __syncthreads();
    for (int o = 0; o < ng && active; ++o) {
      const Col yc = ent[o * (GY + GX) + ly];
      if (yc.lo > yc.hi) continue;                 // the same for the warp
      const Col xc = ent[o * (GY + GX) + GY + lx];
      if (xc.lo > xc.hi) continue;
      const size_t no = (size_t)n * O + g0 + o;
      if (yc.hi <= yc.lo + 1 && xc.hi <= xc.lo + 1) {
        // At most two rows p and two columns q (the hats' common case):
        // every load first.
        const bool p2 = yc.lo < yc.hi, q2 = xc.lo < xc.hi;
        const T* s = u + (no * HH + yc.lo) * QC + xc.lo * C + c0;
        float g[4][CC];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const bool ok = (m < 2 || p2) && ((m & 1) == 0 || q2);
#pragma unroll
          for (int k = 0; k < CC; ++k)
            g[m][k] = ok && c0 + k < C
                          ? load_ro(s + (m >> 1) * QC + (m & 1) * C + k)
                          : 0.f;
        }
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          float ub = fmaf(g[0][k], xc.t0, 0.f);
          if (q2) ub = fmaf(g[1][k], xc.t1, ub);
          float r = fmaf(yc.t0, ub, acc[k]);
          if (p2) {
            ub = fmaf(g[2][k], xc.t0, 0.f);
            if (q2) ub = fmaf(g[3][k], xc.t1, ub);
            r = fmaf(yc.t1, ub, r);
          }
          acc[k] = r;
        }
      } else {
        const Sums<CC> r = long_spans<T, CC>(yc, xc, ry, rx, u, no, x, y, H,
                                             W, C, HH, WW, c0,
                                             Sums<CC>::of(acc));
#pragma unroll
        for (int k = 0; k < CC; ++k) acc[k] = r.v[k];
      }
    }
  }
  // The sums through shared memory, then out a block row at a time in
  // 16-byte stores where aligned.
#pragma unroll
  for (int k = 0; k < CC; ++k) tile[(ly * GX + lx) * CC + k] = acc[k];
  __syncthreads();
  const int nx = min(GX, W - x0), ny = min(GY, H - y0), XC = nx * CC;
  const size_t WC = (size_t)W * C;
  T* dst = d_img + (((size_t)n * H + y0) * W + x0) * C + c0;
  constexpr int V = Vec<T>::N;
  if (C == CC && XC % V == 0 && WC % V == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    for (int i = threadIdx.x; i < ny * XC / V; i += THREADS) {
      const int r = i / (XC / V), k = (i - r * (XC / V)) * V;
      store16(dst + r * WC + k, tile + r * GX * CC + k);
    }
  } else {
    for (int i = threadIdx.x; i < ny * XC; i += THREADS) {
      const int r = i / XC, k = i - r * XC, xx = k / CC, c = k - xx * CC;
      if (c0 + c < C)
        store_from_f32(dst + r * WC + xx * C + c, tile[r * GX * CC + k]);
    }
  }
}

__device__ __forceinline__ void lds(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// A block's output tile: TI rows by TJc columns, an RI x RJ piece a thread.
// A warp takes 4 groups of rows by 8 of columns, so a k step reads RI * 16
// bytes of A and RJ * 32 of B, one wavefront each, without conflicts.
template <int TJc, int RI, int RJ>
struct Tile {
  static constexpr int ROWS = RI, COLS = RJ;
  static constexpr int BS = TJc + 4;      // row stride of B (floats)
  static constexpr int GI = TI / RI;      // groups of rows
  static_assert(GI * (TJc / RJ) == BT, "one piece a thread");
  static_assert(GI % 4 == 0, "4 groups of rows a warp");
  int i0, j0;

  __device__ __forceinline__ Tile() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    i0 = (warp % (GI / 4) * 4 + lane / 8) * RI;
    j0 = (warp / (GI / 4) * 8 + lane % 8) * RJ;
  }

  __device__ __forceinline__ void step(const float* A, const float* B, int k,
                                       float (&acc)[RI][RJ]) const {
    float a[RI], b[RJ];
    lds(A + k * AS + i0, a);
    lds(B + k * BS + j0, b);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }

  // acc[r][c] = fmaf(A[k][i0 + r], B[k][j0 + c], acc[r][c]) for k = 0..kn-1
  // in order; A and B are k-major, row strides AS and BS.
  __device__ __forceinline__ void fma(const float* A, const float* B, int kn,
                                      float (&acc)[RI][RJ]) const {
    int k = 0;
    for (; k + 8 <= kn; k += 8) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) step(A, B, k + kk, acc);
    }
    for (; k < kn; ++k) step(A, B, k, acc);
  }

  // out[r0 + i][c0 + j] (a rows x cols matrix) from the thread's piece.
  template <typename T>
  __device__ __forceinline__ void store(T* out, int rows, int cols, int r0,
                                        int c0,
                                        const float (&acc)[RI][RJ]) const {
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        const int i = r0 + i0 + r, j = c0 + j0 + c;
        if (i < rows && j < cols)
          store_from_f32(out + (size_t)i * cols + j, acc[r][c]);
      }
  }
};

using BoxTile = Tile<TJ, 4, 4>;

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Shared memory (floats) of a box-gradient block: the scanned matrix (S
// rows of L) and its row spans, then A and B, k-major, S*C rows each.
__host__ __device__ inline size_t box_smem(int S, int L, int C) {
  return round4(2 * S) + round4(S * L) +
         (size_t)S * C * (AS + BoxTile::BS);
}

// What a kind of block reads and writes. d_ry: s = q (the scanned matrix
// is rx_o, its taps t are image columns x), output rows p, columns y. d_rx:
// s = p (ry_o, taps y), output rows q, columns x.
struct BoxPlan {
  int S, L;           // the scanned matrix: rows (s), row length (t)
  int rows, cols;     // the output matrix
  int u_s, u_i;       // offsets in u_o of s and of an output row
  int im_t, im_j;     // offsets in the image of a tap and of an output column
};

// R (S rows of L) into R_s, and each row's span over t: a warp per row,
// SCAN_ROWS rows a warp at once, every load issued before any store;
// range: the first and last row with one. NaN counts as a nonzero.
template <typename T>
__device__ __forceinline__ void scan_rows(const T* __restrict__ R, int S,
                                          int L, float* R_s, int2* spans,
                                          int* range) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int lo_s = S, hi_s = -1;
  for (int sb = warp * SCAN_ROWS; sb < S; sb += BT / 32 * SCAN_ROWS) {
    int lo[SCAN_ROWS], hi[SCAN_ROWS];
#pragma unroll
    for (int r = 0; r < SCAN_ROWS; ++r) {
      lo[r] = L;
      hi[r] = -1;
    }
    for (int tb = 0; tb < L; tb += 128) {
      float v[SCAN_ROWS][4];
#pragma unroll
      for (int r = 0; r < SCAN_ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = tb + q * 32 + lane;
          v[r][q] = sb + r < S && t < L
                        ? load_ro(R + (size_t)(sb + r) * L + t)
                        : 0.f;
        }
#pragma unroll
      for (int r = 0; r < SCAN_ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = tb + q * 32 + lane;
          if (sb + r < S && t < L) {
            R_s[(sb + r) * L + t] = v[r][q];
            if (v[r][q] != 0.f) {
              lo[r] = min(lo[r], t);
              hi[r] = max(hi[r], t);
            }
          }
        }
    }
#pragma unroll
    for (int r = 0; r < SCAN_ROWS; ++r) {
      const int l = __reduce_min_sync(0xffffffffu, lo[r]);
      const int h = __reduce_max_sync(0xffffffffu, hi[r]);
      if (lane == 0 && sb + r < S) {
        spans[sb + r] = make_int2(l, h);
        if (l <= h) {
          lo_s = min(lo_s, sb + r);
          hi_s = sb + r;
        }
      }
    }
  }
  if (hi_s >= 0) {
    atomicMin(&range[0], lo_s);
    atomicMax(&range[1], hi_s);
  }
}

// One tile (rows r0.., columns c0..) of d_ry (RX false) or d_rx (RX true)
// of one crop:
//   out[i][j] = sum_{k = (s, c), s in sr} A[k][i] B[k][j], k in order,
//   A[s*C + c][i] = u (s, r0 + i, c),
//   B[s*C + c][j] = sum_{t in span(R, s)} R[s][t] img(t, c0 + j, c), t in
//   order,
// sr the range of rows of R that hold a nonzero. Every staging loop issues
// its loads into registers before it stores any, and steps its indices
// instead of dividing.
template <bool RX, typename T>
__device__ __forceinline__ void box_tile(const T* __restrict__ img_n,
                                         const T* __restrict__ R,
                                         const T* __restrict__ u_o,
                                         T* __restrict__ out, const BoxPlan P,
                                         int C, int r0, int c0, float* smem,
                                         int* range) {
  int2* spans = reinterpret_cast<int2*>(smem);        // [S]
  float* R_s = smem + round4(2 * P.S);                // [S][L]
  float* A = R_s + round4(P.S * P.L);                 // [S*C][AS]
  float* B = A + (size_t)P.S * C * AS;                // [S*C][BS]
  const int tid = threadIdx.x, SC = P.S * C;

  // A: a thread keeps k % 8 and takes rows i, i + BT / 8, ... of every
  // eighth k (a warp: 8 consecutive k of 4 rows, conflict-free stores), 4 k
  // at once.
  {
    constexpr int IH = TI * 8 / BT;
    const int rows = min(TI, P.rows - r0);
    const int kl = tid % 8, il = tid / 8;
    for (int kb = kl; kb < SC; kb += 8 * 4) {
      float v[4][IH];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int k = kb + 8 * g, s = k / C;
        const T* src = u_o + s * P.u_s + k - s * C;
#pragma unroll
        for (int h = 0; h < IH; ++h) {
          const int i = il + BT / 8 * h;
          v[g][h] = k < SC && i < rows ? load_ro(src + (r0 + i) * P.u_i)
                                       : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int h = 0; h < IH; ++h)
          if (kb + 8 * g < SC)
            A[(kb + 8 * g) * AS + il + BT / 8 * h] = v[g][h];
    }
  }
  scan_rows(R, P.S, P.L, R_s, spans, range);
  __syncthreads();
  const int sa = range[0];
  const int ka = sa * C, K = range[1] >= sa ? (range[1] - sa + 1) * C : 0;
  const int cols = min(TJ, P.cols - c0);

  if (RX) {
    // B of d_rx: a thread keeps its column j (the lanes of a warp on
    // consecutive image pixels) and steps k by BT / TJ, BATCH at once.
    constexpr int KS = BT / TJ;
    const int j = tid % TJ;
    const int im_j = (c0 + min(j, cols - 1)) * P.im_j;
    int s = sa + tid / TJ / C, c = tid / TJ % C;
    for (int kr0 = tid / TJ; kr0 < K; kr0 += KS * BATCH) {
      int2 sp[BATCH];
      int ro[BATCH], io[BATCH];
      float w0[BATCH], w1[BATCH], v0[BATCH], v1[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const bool live = kr0 + KS * b < K;
        sp[b] = live && j < cols ? spans[s] : make_int2(1, 0);
        ro[b] = min(s, P.S - 1) * P.L;
        io[b] = im_j + c;
        c += KS;
        while (c >= C) {
          c -= C;
          ++s;
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int t = sp[b].x;
        const bool one = t <= sp[b].y, two = t + 1 <= sp[b].y;
        w0[b] = one ? R_s[ro[b] + t] : 0.f;
        w1[b] = two ? R_s[ro[b] + t + 1] : 0.f;
        v0[b] = one ? load_ro(img_n + io[b] + t * P.im_t) : 0.f;
        v1[b] = two ? load_ro(img_n + io[b] + (t + 1) * P.im_t) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        float acc = 0.f;
        if (sp[b].x <= sp[b].y) acc = fmaf(w0[b], v0[b], acc);
        if (sp[b].x + 1 <= sp[b].y) acc = fmaf(w1[b], v1[b], acc);
        for (int t = sp[b].x + 2; t <= sp[b].y; ++t)
          acc = fmaf(R_s[ro[b] + t], load_ro(img_n + io[b] + t * P.im_t),
                     acc);
        if (kr0 + KS * b < K) B[(ka + kr0 + KS * b) * BoxTile::BS + j] = acc;
      }
    }
  } else {
    // B of d_ry: a thread keeps k % 8 and takes rows j, j + BT / 8, ... of
    // every eighth k (a warp: 8 consecutive k of 4 rows, conflict-free
    // stores), whose span and tap weights serve them all; KG k at once.
    constexpr int KG = 2, JS = BT / 8, JR = TJ / JS;
    const int kl = tid % 8, jl = tid / 8;
    for (int kr0 = kl; kr0 < K; kr0 += 8 * KG) {
      int2 sp[KG];
      int io[KG];
      float w0[KG], w1[KG], v0[KG][JR], v1[KG][JR];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const int k = ka + kr0 + 8 * g, s = k / C;
        sp[g] = kr0 + 8 * g < K ? spans[s] : make_int2(1, 0);
        const float* rr = R_s + min(s, P.S - 1) * P.L;
        w0[g] = sp[g].x <= sp[g].y ? rr[sp[g].x] : 0.f;
        w1[g] = sp[g].x + 1 <= sp[g].y ? rr[sp[g].x + 1] : 0.f;
        io[g] = k - s * C;
#pragma unroll
        for (int r = 0; r < JR; ++r) {
          const int j = jl + JS * r, t = sp[g].x;
          const T* px = img_n + (c0 + min(j, cols - 1)) * P.im_j + io[g];
          v0[g][r] = t <= sp[g].y && j < cols ? load_ro(px + t * P.im_t)
                                              : 0.f;
          v1[g][r] = t + 1 <= sp[g].y && j < cols
                         ? load_ro(px + (t + 1) * P.im_t)
                         : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const int kr = kr0 + 8 * g;
        if (kr >= K) continue;
        const float* rr = R_s + (ka + kr) / C * P.L;
#pragma unroll
        for (int r = 0; r < JR; ++r) {
          const int j = jl + JS * r;
          float acc = 0.f;
          if (sp[g].x <= sp[g].y) acc = fmaf(w0[g], v0[g][r], acc);
          if (sp[g].x + 1 <= sp[g].y) acc = fmaf(w1[g], v1[g][r], acc);
          if (sp[g].y >= sp[g].x + 2 && j < cols) {
            const T* px = img_n + (c0 + j) * P.im_j + io[g];
            for (int t = sp[g].x + 2; t <= sp[g].y; ++t)
              acc = fmaf(rr[t], load_ro(px + t * P.im_t), acc);
          }
          B[(ka + kr) * BoxTile::BS + j] = acc;
        }
      }
    }
  }
  __syncthreads();

  const BoxTile tile;
  float acc[BoxTile::ROWS][BoxTile::COLS] = {};
  if (K > 0)
    tile.fma(A + (size_t)ka * AS, B + (size_t)ka * BoxTile::BS, K, acc);
  tile.store(out, P.rows, P.cols, r0, c0, acc);
}

// grid (d_ry tiles + d_rx tiles, N * O). Blocks below the d_ry count take a
// tile of d_ry, the others one of d_rx.
template <typename T>
__global__ void __launch_bounds__(BT)
crop_bwd_boxes_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                      const T* __restrict__ rx, const T* __restrict__ u,
                      T* __restrict__ d_ry, T* __restrict__ d_rx, int H,
                      int W, int C, int O, int HH, int WW) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    range[0] = 1 << 30;
    range[1] = -1;
  }
  __syncthreads();
  const size_t no = blockIdx.y;
  const T* img_n = img + (size_t)(blockIdx.y / O) * H * W * C;
  const T* u_o = u + no * HH * WW * C;
  const int ry_cols = (H + TJ - 1) / TJ;
  const int ry_tiles = (HH + TI - 1) / TI * ry_cols;
  const int t = blockIdx.x;
  if (t < ry_tiles) {
    // d_ry[p][y] = sum_{q, c} u[p][q][c] t2[y][q][c], t2[y][q][c] =
    // sum_{x in span(rx, q)} rx[q][x] img[y][x][c].
    const BoxPlan P{WW, W, HH, H, C, WW * C, C, W * C};
    box_tile<false>(img_n, rx + no * WW * W, u_o, d_ry + no * HH * H, P, C,
             t / ry_cols * TI, t % ry_cols * TJ, smem, range);
  } else {
    // d_rx[q][x] = sum_{p, c} u[p][q][c] t1[p][x][c], t1[p][x][c] =
    // sum_{y in span(ry, p)} ry[p][y] img[y][x][c].
    const int rx_cols = (W + TJ - 1) / TJ, r = t - ry_tiles;
    const BoxPlan P{HH, H, WW, W, WW * C, C, W * C, C};
    box_tile<true>(img_n, ry + no * HH * H, u_o, d_rx + no * WW * W, P, C,
             r / rx_cols * TI, r % rx_cols * TJ, smem, range);
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory; a request beyond
// the block's limit comes back as an error and is cleared, so no later
// launch check reports it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

constexpr size_t STATIC_SMEM = 48 * 1024;  // dynamic shared memory without
                                           // the attribute

// Channels a block computes: all three of an RGB image, else groups of four
// (grid z).
inline int channel_group(int C) { return C == 3 ? 3 : 4; }

// One forward launch: crop_fwd_kernel<T, CC, QPT>.
template <typename T, int CC, int QPT>
cudaError_t launch_fwd(dim3 grid, size_t smem, cudaStream_t stream,
                       const T* img, const T* ry, const T* rx, T* out, int H,
                       int W, int C, int O, int HH, int WW, int band) {
  if (smem > STATIC_SMEM) {
    const cudaError_t err = allow_smem(crop_fwd_kernel<T, CC, QPT>, smem);
    if (err != cudaSuccess) return err;
  }
  crop_fwd_kernel<T, CC, QPT><<<grid, THREADS, smem, stream>>>(
      img, ry, rx, out, H, W, C, O, HH, WW, band);
  return cudaGetLastError();
}

template <typename T>
cudaError_t crop_fwd(const void* img, const void* ry, const void* rx,
                     void* out, int N, int H, int W, int C, int O, int HH,
                     int WW, cudaStream_t stream) {
  if ((size_t)N * O * HH * WW * C == 0) return cudaSuccess;
  const int cc = channel_group(C), groups = (C + cc - 1) / cc;
  const int crops = N * O * groups, qpt = WW <= NARROW ? 1 : 2;
  // Bands of crop rows: a run of qpt columns a thread, in one wave of at
  // most FWD_BLOCKS blocks.
  const int runs = (WW + qpt - 1) / qpt;
  int bands = (HH * runs + THREADS - 1) / THREADS;
  bands = max(1, min(min(bands, FWD_BLOCKS / crops), HH));
  const int band = (HH + bands - 1) / bands;
  bands = (HH + band - 1) / band;
  const size_t smem = (sizeof(int2) + sizeof(float2)) * (WW + band);
  const dim3 grid(bands, N * O, groups);
  const T* im = static_cast<const T*>(img);
  const T* y = static_cast<const T*>(ry);
  const T* x = static_cast<const T*>(rx);
  T* o = static_cast<T*>(out);
  if (cc == 3)
    return qpt == 1 ? launch_fwd<T, 3, 1>(grid, smem, stream, im, y, x, o, H,
                                         W, C, O, HH, WW, band)
                    : launch_fwd<T, 3, 2>(grid, smem, stream, im, y, x, o, H,
                                         W, C, O, HH, WW, band);
  return qpt == 1 ? launch_fwd<T, 4, 1>(grid, smem, stream, im, y, x, o, H, W,
                                       C, O, HH, WW, band)
                  : launch_fwd<T, 4, 2>(grid, smem, stream, im, y, x, o, H, W,
                                       C, O, HH, WW, band);
}

template <typename T>
cudaError_t crop_bwd_img(const void* ry, const void* rx, const void* u,
                         void* d_img, void* spans, int N, int H, int W, int C,
                         int O, int HH, int WW, cudaStream_t stream) {
  if ((size_t)N * H * W * C == 0) return cudaSuccess;
  const T* y = static_cast<const T*>(ry);
  const T* x = static_cast<const T*>(rx);
  Col* cols = static_cast<Col*>(spans);
  if (N * O > 0) {
    crop_col_spans_kernel<T><<<dim3(N * O, 2), SPAN_THREADS, 0, stream>>>(
        y, x, cols, H, W, HH, WW);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int cc = channel_group(C), groups = (C + cc - 1) / cc;
  const int xblocks = (W + GX - 1) / GX, yblocks = (H + GY - 1) / GY;
  const dim3 grid(xblocks * yblocks, N, groups);
  const T* g = static_cast<const T*>(u);
  T* d = static_cast<T*>(d_img);
  if (cc == 3)
    crop_bwd_img_kernel<T, 3><<<grid, THREADS, 0, stream>>>(
        y, x, g, cols, d, H, W, C, O, HH, WW, xblocks);
  else
    crop_bwd_img_kernel<T, 4><<<grid, THREADS, 0, stream>>>(
        y, x, g, cols, d, H, W, C, O, HH, WW, xblocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t crop_bwd_boxes(const void* img, const void* ry, const void* rx,
                           const void* u, void* d_ry, void* d_rx, int N,
                           int H, int W, int C, int O, int HH, int WW,
                           cudaStream_t stream) {
  const size_t ry_floats = box_smem(WW, W, C);
  const size_t rx_floats = box_smem(HH, H, C);
  const size_t smem =
      sizeof(float) * (ry_floats > rx_floats ? ry_floats : rx_floats);
  cudaError_t err = allow_smem(crop_bwd_boxes_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (HH + TI - 1) / TI * ((H + TJ - 1) / TJ) +
                    (WW + TI - 1) / TI * ((W + TJ - 1) / TJ);
  crop_bwd_boxes_kernel<T><<<dim3(tiles, N * O), BT, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<const T*>(u),
      static_cast<T*>(d_ry), static_cast<T*>(d_rx), H, W, C, O, HH, WW);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() of its
// launch, or cudaErrorInvalidValue for what it does not take.
int sg_crop_fwd(const void* img, const void* ry, const void* rx, void* out,
                int N, int H, int W, int C, int O, int HH, int WW, int dtype,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return crop_fwd<float>(img, ry, rx, out, N, H, W, C, O, HH, WW, s);
  if (dtype == 1)
    return crop_fwd<__nv_bfloat16>(img, ry, rx, out, N, H, W, C, O, HH, WW,
                                   s);
  return cudaErrorInvalidValue;
}

// d_img alone. spans: scratch of N*O*(H+W) column entries of 16 bytes.
int sg_crop_bwd_img(const void* ry, const void* rx, const void* u,
                    void* d_img, void* spans, int N, int H, int W, int C,
                    int O, int HH, int WW, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return crop_bwd_img<float>(ry, rx, u, d_img, spans, N, H, W, C, O, HH,
                               WW, s);
  if (dtype == 1)
    return crop_bwd_img<__nv_bfloat16>(ry, rx, u, d_img, spans, N, H, W, C,
                                       O, HH, WW, s);
  return cudaErrorInvalidValue;
}

int sg_crop_bwd_boxes(const void* img, const void* ry, const void* rx,
                      const void* u, void* d_ry, void* d_rx, int N, int H,
                      int W, int C, int O, int HH, int WW, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return crop_bwd_boxes<float>(img, ry, rx, u, d_ry, d_rx, N, H, W, C, O,
                                 HH, WW, s);
  if (dtype == 1)
    return crop_bwd_boxes<__nv_bfloat16>(img, ry, rx, u, d_ry, d_rx, N, H, W,
                                         C, O, HH, WW, s);
  return cudaErrorInvalidValue;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
