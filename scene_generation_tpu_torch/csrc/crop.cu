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
//   d_ry, d_rx (launched only when asked): per (n, o, TP rows of p) the
//             rows kernel forms t1 = ry img (kept in f32 scratch) and
//             ub = u rx (in shared memory) and writes its rows of d_ry; per
//             (n, o, TQ columns of q) the rx kernel sums u t1 into d_rx.
//             Dense, on the CUDA cores.
// Why two launches, not one: on the H100, a forward block that staged its
// ry rows and all of rx_o in shared memory made each thread's staging loop
// a chain of round trips, and a fused forward that found its rows' spans
// in-block (every load issued at once) needed more registers and re-read
// all of rx_o from L2 in every block; both were slower than this design.
//
// Summation order. Every product is a float32 FMA and every sum runs in
// float32 in a fixed ascending order (y, then x; q, then p, then o), the
// association of the dense kernels, so two runs give bitwise-equal results
// and dropping the zero terms leaves every finite result equal to the dense
// sum up to the sign of a zero. bf16 outputs are rounded once, on store.
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
constexpr int TP = 16;          // crop rows (p) per block: backward d_ry rows
constexpr int TQ = 16;          // crop columns (q) per block: backward d_rx
constexpr int SPAN_ROWS = 8;    // rows (one a warp) per row-span block
constexpr int SPAN_THREADS = 128;
constexpr int SPAN_BATCH = 8;   // objects whose spans d_img loads at once
constexpr int CG = 4;           // channels per thread: forward and d_img

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// Through the read-only (non-coherent) cache.
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// dst[r * cols + j] = src[r * cols + j] for r < avail, zero for avail <= r <
// rows.
template <typename T>
__device__ void stage_rows(float* dst, const T* src, int avail, int rows,
                           int cols) {
  const int total = rows * cols, have = avail * cols;
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    dst[i] = i < have ? load_f32(src + i) : 0.f;
}

// rx_o (WW, W) into shared memory with row stride W + 1.
template <typename T>
__device__ void stage_rx(float* rx_s, const T* rx, int WW, int W) {
  for (int i = threadIdx.x; i < WW * W; i += blockDim.x) {
    const int q = i / W, x = i - q * W;
    rx_s[q * (W + 1) + x] = load_f32(rx + i);
  }
}

// t[i][k] = sum_y ry_s[i][y] * img[y][k] for i < TP and k < K, y in order.
template <typename T>
__device__ void rows_times_image(const float* ry_s, const T* img, float* t_s,
                                 int H, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[TP];
#pragma unroll
    for (int i = 0; i < TP; ++i) acc[i] = 0.f;
    for (int y = 0; y < H; ++y) {
      const float v = load_f32(img + (size_t)y * K + k);
#pragma unroll
      for (int i = 0; i < TP; ++i) acc[i] = fmaf(ry_s[i * H + y], v, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < TP; ++i) t_s[i * K + k] = acc[i];
  }
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

// grid (ceil(HH / TP), O, N). Writes t1 (f32 scratch, (N,O,HH,K)) and the
// d_ry rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_bwd_rows_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                     const T* __restrict__ rx, const T* __restrict__ u,
                     T* __restrict__ d_ry, float* __restrict__ t1g, int H,
                     int W, int C, int O, int HH, int WW) {
  extern __shared__ __align__(16) float smem[];
  const int K = W * C, QC = WW * C;
  float* ry_s = smem;                     // [TP][H]
  float* t_s = ry_s + TP * H;             // [TP][K]
  float* ub_s = t_s + TP * K;             // [TP][K]
  float* u_s = ub_s + TP * K;             // [TP][QC]
  float* rx_s = u_s + TP * QC;            // [WW][W + 1]
  const int n = blockIdx.z, o = blockIdx.y, p0 = blockIdx.x * TP;
  const size_t no = (size_t)n * O + o;
  const int rows = min(TP, HH - p0);
  const T* img_n = img + (size_t)n * H * K;

  stage_rows(ry_s, ry + (no * HH + p0) * H, rows, TP, H);
  stage_rows(u_s, u + (no * HH + p0) * QC, rows, TP, QC);
  stage_rx(rx_s, rx + no * WW * W, WW, W);
  __syncthreads();
  rows_times_image(ry_s, img_n, t_s, H, K);

  // ub[i][x*C + c] = sum_q u[i][q*C + c] * rx[q][x]
  for (int idx = threadIdx.x; idx < TP * K; idx += blockDim.x) {
    const int i = idx / K, k = idx - i * K, x = k / C, c = k - x * C;
    const float* ur = u_s + i * QC + c;
    float s = 0.f;
    for (int q = 0; q < WW; ++q) s = fmaf(ur[q * C], rx_s[q * (W + 1) + x], s);
    ub_s[idx] = s;
  }
  __syncthreads();

  float* t1_rows = t1g + (no * HH + p0) * K;
  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x)
    t1_rows[idx] = t_s[idx];

  // d_ry[i][y] = sum_k ub[i][k] * img[y][k]
  T* d_ry_rows = d_ry + (no * HH + p0) * H;
  for (int y = threadIdx.x; y < H; y += blockDim.x) {
    float acc[TP];
#pragma unroll
    for (int i = 0; i < TP; ++i) acc[i] = 0.f;
    const T* img_row = img_n + (size_t)y * K;
    for (int k = 0; k < K; ++k) {
      const float v = load_f32(img_row + k);
#pragma unroll
      for (int i = 0; i < TP; ++i) acc[i] = fmaf(ub_s[i * K + k], v, acc[i]);
    }
    for (int i = 0; i < rows; ++i) store_from_f32(d_ry_rows + i * H + y, acc[i]);
  }
}

// grid (ceil(WW / TQ), O, N). d_rx[q][x] = sum_p sum_c u[p][q][c] t1[p][x][c]
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_bwd_rx_kernel(const T* __restrict__ u, const float* __restrict__ t1g,
                   T* __restrict__ d_rx, int W, int C, int O, int HH, int WW) {
  const int K = W * C, QC = WW * C;
  const int n = blockIdx.z, o = blockIdx.y, q0 = blockIdx.x * TQ;
  const size_t no = (size_t)n * O + o;
  const int cols = min(TQ, WW - q0);
  const T* u_no = u + no * HH * QC;
  const float* t1_no = t1g + no * HH * K;
  for (int idx = threadIdx.x; idx < cols * W; idx += blockDim.x) {
    const int j = idx / W, x = idx - j * W, q = q0 + j;
    float s = 0.f;
    for (int p = 0; p < HH; ++p) {
      const T* ur = u_no + (size_t)p * QC + q * C;
      const float* tr = t1_no + (size_t)p * K + x * C;
      for (int c = 0; c < C; ++c) s = fmaf(load_f32(ur + c), tr[c], s);
    }
    store_from_f32(d_rx + (no * WW + q) * W + x, s);
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
                           const void* u, void* d_ry, void* d_rx, float* t1,
                           int N, int H, int W, int C, int O, int HH, int WW,
                           cudaStream_t stream) {
  const int K = W * C, QC = WW * C;
  const size_t smem_rows =
      sizeof(float) * ((size_t)TP * H + 2 * (size_t)TP * K +
                       (size_t)TP * QC + (size_t)WW * (W + 1));
  cudaError_t err = allow_smem(crop_bwd_rows_kernel<T>, smem_rows);
  if (err != cudaSuccess) return err;
  crop_bwd_rows_kernel<T><<<dim3((HH + TP - 1) / TP, O, N), THREADS,
                            smem_rows, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<const T*>(u),
      static_cast<T*>(d_ry), t1, H, W, C, O, HH, WW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  crop_bwd_rx_kernel<T><<<dim3((WW + TQ - 1) / TQ, O, N), THREADS, 0,
                          stream>>>(static_cast<const T*>(u), t1,
                                    static_cast<T*>(d_rx), W, C, O, HH, WW);
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

// t1: float32 scratch of N*O*HH*W*C values.
int sg_crop_bwd_boxes(const void* img, const void* ry, const void* rx,
                      const void* u, void* d_ry, void* d_rx, void* t1, int N,
                      int H, int W, int C, int O, int HH, int WW, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t1f = static_cast<float*>(t1);
  if (dtype == 0)
    return crop_bwd_boxes<float>(img, ry, rx, u, d_ry, d_rx, t1f, N, H, W, C,
                                 O, HH, WW, s);
  if (dtype == 1)
    return crop_bwd_boxes<__nv_bfloat16>(img, ry, rx, u, d_ry, d_rx, t1f, N,
                                         H, W, C, O, HH, WW, s);
  return cudaErrorInvalidValue;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
