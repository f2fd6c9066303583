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
// The banded design. A span is the first and last nonzero of a row or a
// column of a hat; the kernels multiply only inside spans, so a dense ry/rx
// is still right (every span is then the whole row: slow, but the same
// sums). Each output is owned by one thread, whose chain of dependent loads
// is what the kernels wait on: the spans, then the taps, loaded together.
//   forward:  a row-span pass (a warp per row of ry and rx) writes the
//             (N, O, HH + WW) row spans to int32 scratch; then a thread per
//             crop pixel (n, o, p, q) and group of CG channels computes
//             out[p][q][c] = sum_{x in span(q)} rx[q][x] *
//                            (sum_{y in span(p)} ry[p][y] img[y][x][c]),
//             the image through the read-only path (a box's rows are a small
//             part of an image, and all 12 images fit in L2), neighbouring
//             threads on neighbouring q, so loads and the NHWC store stay
//             close.
//   d_img:    a column-span pass (a block per (n, o)) writes the (N, O,
//             H + W) column spans; then a thread per image pixel (n, y, x)
//             and group of CG channels computes
//             d_img[y][x][c] = sum_o sum_{p in colspan(ry_o, y)} ry[o][p][y]
//                              * sum_{q in colspan(rx_o, x)} u[o][p][q][c]
//                                * rx[o][q][x],
//             loading the spans of SPAN_BATCH objects at once: no float
//             scratch, no atomics. A degenerate box (x1 == x0) gives image
//             columns whose span is every q: right, not fast.
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
// Why two launches, not one: on the H100, a forward block that staged its
// ry rows and all of rx_o in shared memory made each thread's staging loop
// a chain of round trips, and a fused forward that found its rows' spans
// in-block (every load issued at once) needed more registers and re-read
// all of rx_o from L2 in every block; both were slower than this design.
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

namespace {

constexpr int THREADS = 256;
constexpr int SPAN_ROWS = 8;    // rows (one a warp) per row-span block
constexpr int SPAN_THREADS = 128;
constexpr int SPAN_BATCH = 8;   // objects whose spans d_img loads at once
constexpr int CG = 4;           // channels per thread: forward and d_img
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

// grid (ceil(N * O * (HH + WW) / SPAN_ROWS)), one warp per row. Row spans:
// spans[no * (HH + WW) + r] = the first and last column of row r holding a
// nonzero (len and -1 for a row of zeros); r < HH: rows of ry_o (over H),
// then r - HH < WW: rows of rx_o (over W). NaN counts as a nonzero.
template <typename T>
__global__ void __launch_bounds__(32 * SPAN_ROWS)
crop_row_spans_kernel(const T* __restrict__ ry, const T* __restrict__ rx,
                      int2* __restrict__ spans, int H, int W, int HH, int WW,
                      int rows) {
  const int row = blockIdx.x * SPAN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int no = row / (HH + WW), r = row - no * (HH + WW);
  const bool of_ry = r < HH;
  const int len = of_ry ? H : W;
  const T* m = of_ry ? ry + ((size_t)no * HH + r) * H
                     : rx + ((size_t)no * WW + r - HH) * W;
  int lo = len, hi = -1;
#pragma unroll 4
  for (int j = lane; j < len; j += 32) {
    if (load_ro(m + j) != 0.f) {
      lo = min(lo, j);
      hi = j;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) spans[row] = make_int2(lo, hi);
}

// grid (ceil(HH * WW * groups / THREADS), N * O). One thread per crop pixel
// (p, q) and group of CG channels, neighbouring threads on neighbouring q:
// out[n,o,p,q,c] = sum_{x in span(q)} (sum_{y in span(p)} ry[p][y]
// img[y][x][c]) rx[q][x], y and x in order. Unrolled by two, the hats'
// width, so a thread's loads issue together once its spans are known.
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_fwd_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                const T* __restrict__ rx, const int2* __restrict__ spans,
                T* __restrict__ out, int H, int W, int C, int O, int HH,
                int WW, int plane) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= plane) return;
  const int groups = (C + CG - 1) / CG;
  const int pq = idx / groups;
  const int c0 = (idx - pq * groups) * CG, nc = min(CG, C - c0);
  const int p = pq / WW, q = pq - p * WW;
  const int no = blockIdx.y, n = no / O;
  const int2 sp = spans[(size_t)no * (HH + WW) + p];
  const int2 sq = spans[(size_t)no * (HH + WW) + HH + q];
  const T* ry_row = ry + ((size_t)no * HH + p) * H;
  const T* rx_row = rx + ((size_t)no * WW + q) * W;
  const T* img_n = img + (size_t)n * H * W * C + c0;
  float s[CG] = {};
#pragma unroll 2
  for (int x = sq.x; x <= sq.y; ++x) {
    float t[CG] = {};
#pragma unroll 2
    for (int y = sp.x; y <= sp.y; ++y) {
      const float a = load_ro(ry_row + y);
      const T* px = img_n + ((size_t)y * W + x) * C;
#pragma unroll
      for (int k = 0; k < CG; ++k)
        if (k < nc) t[k] = fmaf(a, load_ro(px + k), t[k]);
    }
    const float b = load_ro(rx_row + x);
#pragma unroll
    for (int k = 0; k < CG; ++k) s[k] = fmaf(t[k], b, s[k]);
  }
  T* o = out + (((size_t)no * HH + p) * WW + q) * C + c0;
#pragma unroll
  for (int k = 0; k < CG; ++k)
    if (k < nc) store_from_f32(o + k, s[k]);
}

// grid (N * O, 2). Column spans: spans[no * (H + W) + j] = the first and
// last row of column j holding a nonzero (rows and -1 for a column of
// zeros); j < H: columns of ry_o (rows p), then j - H < W: columns of rx_o
// (rows q).
template <typename T>
__global__ void __launch_bounds__(SPAN_THREADS)
crop_col_spans_kernel(const T* __restrict__ ry, const T* __restrict__ rx,
                      int2* __restrict__ spans, int H, int W, int HH,
                      int WW) {
  const size_t no = blockIdx.x;
  const bool of_rx = blockIdx.y == 1;
  const int cols = of_rx ? W : H, rows = of_rx ? WW : HH;
  const T* m = of_rx ? rx + no * WW * W : ry + no * HH * H;
  int2* out = spans + no * (H + W) + (of_rx ? H : 0);
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    int lo = rows, hi = -1;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      if (load_ro(m + (size_t)r * cols + j) != 0.f) {
        lo = min(lo, r);
        hi = r;
      }
    }
    out[j] = make_int2(lo, hi);
  }
}

// grid (ceil(H * W * groups / THREADS), N). One thread per image pixel
// (y, x) and group of CG channels, neighbouring threads on neighbouring x:
// d_img[n,y,x,c] = sum_o sum_{p in colspan(ry_o, y)} ry[o][p][y]
//                  * (sum_{q in colspan(rx_o, x)} u[o][p][q][c] rx[o][q][x]),
// o, p and q in order. The spans of SPAN_BATCH objects are loaded at once;
// the span loops are unrolled by two, the hats' width.
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_bwd_img_kernel(const T* __restrict__ ry, const T* __restrict__ rx,
                    const T* __restrict__ u, const int2* __restrict__ spans,
                    T* __restrict__ d_img, int H, int W, int C, int O,
                    int HH, int WW, int plane) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= plane) return;
  const int groups = (C + CG - 1) / CG;
  const int yx = idx / groups;
  const int c0 = (idx - yx * groups) * CG, nc = min(CG, C - c0);
  const int y = yx / W, x = yx - y * W;
  const int n = blockIdx.y;
  const int QC = WW * C;
  float acc[CG] = {};
  for (int o0 = 0; o0 < O; o0 += SPAN_BATCH) {
    int2 sy[SPAN_BATCH], sx[SPAN_BATCH];
#pragma unroll
    for (int k = 0; k < SPAN_BATCH; ++k) {
      if (o0 + k < O) {
        const int2* so = spans + ((size_t)n * O + o0 + k) * (H + W);
        sy[k] = so[y];
        sx[k] = so[H + x];
      }
    }
#pragma unroll
    for (int k = 0; k < SPAN_BATCH; ++k) {
      if (o0 + k >= O) break;
      if (sy[k].x > sy[k].y || sx[k].x > sx[k].y) continue;
      const size_t no = (size_t)n * O + o0 + k;
      const T* ry_col = ry + no * HH * H + y;
      const T* rx_col = rx + no * WW * W + x;
      const T* u_no = u + no * HH * QC + c0;
#pragma unroll 2
      for (int p = sy[k].x; p <= sy[k].y; ++p) {
        float ub[CG] = {};
#pragma unroll 2
        for (int q = sx[k].x; q <= sx[k].y; ++q) {
          const float b = load_ro(rx_col + (size_t)q * W);
          const T* uq = u_no + (size_t)p * QC + q * C;
#pragma unroll
          for (int j = 0; j < CG; ++j)
            if (j < nc) ub[j] = fmaf(load_ro(uq + j), b, ub[j]);
        }
        const float a = load_ro(ry_col + (size_t)p * H);
#pragma unroll
        for (int j = 0; j < CG; ++j) acc[j] = fmaf(a, ub[j], acc[j]);
      }
    }
  }
  T* out = d_img + (((size_t)n * H + y) * W + x) * C + c0;
#pragma unroll
  for (int j = 0; j < CG; ++j)
    if (j < nc) store_from_f32(out + j, acc[j]);
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

template <typename T>
cudaError_t crop_fwd(const void* img, const void* ry, const void* rx,
                     void* out, int2* spans, int N, int H, int W, int C,
                     int O, int HH, int WW, cudaStream_t stream) {
  const T* ry_t = static_cast<const T*>(ry);
  const T* rx_t = static_cast<const T*>(rx);
  const int rows = N * O * (HH + WW);
  crop_row_spans_kernel<T><<<(rows + SPAN_ROWS - 1) / SPAN_ROWS,
                             32 * SPAN_ROWS, 0, stream>>>(
      ry_t, rx_t, spans, H, W, HH, WW, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int plane = HH * WW * ((C + CG - 1) / CG);
  crop_fwd_kernel<T><<<dim3((plane + THREADS - 1) / THREADS, N * O), THREADS,
                       0, stream>>>(static_cast<const T*>(img), ry_t, rx_t,
                                    spans, static_cast<T*>(out), H, W, C, O,
                                    HH, WW, plane);
  return cudaGetLastError();
}

template <typename T>
cudaError_t crop_bwd_img(const void* ry, const void* rx, const void* u,
                         void* d_img, int2* spans, int N, int H, int W, int C,
                         int O, int HH, int WW, cudaStream_t stream) {
  const T* ry_t = static_cast<const T*>(ry);
  const T* rx_t = static_cast<const T*>(rx);
  crop_col_spans_kernel<T><<<dim3(N * O, 2), SPAN_THREADS, 0, stream>>>(
      ry_t, rx_t, spans, H, W, HH, WW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int plane = H * W * ((C + CG - 1) / CG);
  crop_bwd_img_kernel<T><<<dim3((plane + THREADS - 1) / THREADS, N), THREADS,
                           0, stream>>>(ry_t, rx_t, static_cast<const T*>(u),
                                        spans, static_cast<T*>(d_img), H, W,
                                        C, O, HH, WW, plane);
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
// launches (the first that failed).
// spans: int32 scratch of N*O*(HH+WW)*2 values (the row spans).
int sg_crop_fwd(const void* img, const void* ry, const void* rx, void* out,
                void* spans, int N, int H, int W, int C, int O, int HH,
                int WW, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* sp = static_cast<int2*>(spans);
  if (dtype == 0)
    return crop_fwd<float>(img, ry, rx, out, sp, N, H, W, C, O, HH, WW, s);
  if (dtype == 1)
    return crop_fwd<__nv_bfloat16>(img, ry, rx, out, sp, N, H, W, C, O, HH,
                                   WW, s);
  return cudaErrorInvalidValue;
}

// spans: int32 scratch of N*O*(H+W)*2 values (the column spans).
int sg_crop_bwd_img(const void* ry, const void* rx, const void* u,
                    void* d_img, void* spans, int N, int H, int W, int C,
                    int O, int HH, int WW, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* sp = static_cast<int2*>(spans);
  if (dtype == 0)
    return crop_bwd_img<float>(ry, rx, u, d_img, sp, N, H, W, C, O, HH, WW,
                               s);
  if (dtype == 1)
    return crop_bwd_img<__nv_bfloat16>(ry, rx, u, d_img, sp, N, H, W, C, O,
                                       HH, WW, s);
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
