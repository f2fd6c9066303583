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
// Every product is a float32 FMA and every sum is taken in float32 in a
// fixed order (no atomics), so two runs give bitwise-equal results; bf16
// outputs are rounded once, on store.
//
// What bounds it on this card: at the train shapes (N=12, 128x128x3 images,
// O=9 crops of 64x64 or 32x32) the dense products are 0.4 to 1.3 GFLOP
// against 2 to 15 MB of traffic, so the floor is the float32 FMA rate
// outside the tensor cores (tens of microseconds at most). ry and rx hold at
// most two nonzeros a row (bilinear hats), but the op is defined on dense
// matrices, as the TPU kernel computes it.
//
// What this design does about it. An NHWC image row is K = W*C contiguous
// values, so "ry @ img_c" for every channel at once is one (rows x H) by
// (H x K) product whose columns are coalesced in device memory. A forward
// block owns one (n, o) and TP rows of the crop: it stages those TP rows of
// ry, all of rx_o (row stride W+1, so a warp's reads of different rows hit
// different banks) and the (TP x K) product t = ry_rows @ img in shared
// memory, then writes the (TP, WW, C) tile once, coalesced, in the output's
// layout. The image is read from L2 (12 images of 196 KB fit in its 50 MB),
// once per block. The NHWC <-> channel-major transposes the TPU version does
// outside its kernel are this kernel's own indexing.
//
// The backward runs three kernels on the stream, each owning its outputs:
//   rows:  per (n, o, TP rows of p): t1 = ry_rows @ img and ub = u_rows . rx
//          (both (TP x K), kept in f32 scratch for the next two), then the
//          d_ry rows = ub @ img^T;
//   rx:    per (n, o, TQ rows of q): d_rx = sum_{p,c} u[p,q,c] t1[p,x,c];
//   image: per (n, TY rows of y): d_img = sum_{o,p} ry[o,p,y] ub[o,p,:],
//          looping over o and p in order: the sum over objects that the TPU
//          kernel carries across its sequential grid, without atomics.
// The sums run on the CUDA cores; a version on the tensor cores (wgmma, or
// the hats' two-nonzero structure) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 16;   // crop rows (p) per block: forward and backward rows
constexpr int TQ = 16;   // crop columns (q) per block: backward d_rx
constexpr int TY = 16;   // image rows (y) per block: backward d_img

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// grid (ceil(HH / TP), O, N).
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_fwd_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                const T* __restrict__ rx, T* __restrict__ out, int H, int W,
                int C, int O, int HH, int WW) {
  extern __shared__ __align__(16) float smem[];
  const int K = W * C, QC = WW * C;
  float* ry_s = smem;                     // [TP][H]
  float* t_s = ry_s + TP * H;             // [TP][K]
  float* rx_s = t_s + TP * K;             // [WW][W + 1]
  const int n = blockIdx.z, o = blockIdx.y, p0 = blockIdx.x * TP;
  const size_t no = (size_t)n * O + o;
  const int rows = min(TP, HH - p0);

  stage_rows(ry_s, ry + (no * HH + p0) * H, rows, TP, H);
  stage_rx(rx_s, rx + no * WW * W, WW, W);
  __syncthreads();
  rows_times_image(ry_s, img + (size_t)n * H * K, t_s, H, K);
  __syncthreads();

  T* out_rows = out + (no * HH + p0) * QC;
  for (int idx = threadIdx.x; idx < rows * QC; idx += blockDim.x) {
    const int i = idx / QC, r = idx - i * QC, q = r / C, c = r - q * C;
    const float* trow = t_s + i * K + c;
    const float* rxr = rx_s + q * (W + 1);
    float s = 0.f;
    for (int x = 0; x < W; ++x) s = fmaf(trow[x * C], rxr[x], s);
    store_from_f32(out_rows + idx, s);
  }
}

// grid (ceil(HH / TP), O, N). Writes t1 and ub (f32 scratch, (N,O,HH,K))
// and the d_ry rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_bwd_rows_kernel(const T* __restrict__ img, const T* __restrict__ ry,
                     const T* __restrict__ rx, const T* __restrict__ u,
                     T* __restrict__ d_ry, float* __restrict__ t1g,
                     float* __restrict__ ubg, int H, int W, int C, int O,
                     int HH, int WW) {
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
  float* ub_rows = ubg + (no * HH + p0) * K;
  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
    t1_rows[idx] = t_s[idx];
    ub_rows[idx] = ub_s[idx];
  }

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

// grid (ceil(H / TY), N). d_img[y][k] = sum_o sum_p ry[o][p][y] * ub[o][p][k]
template <typename T>
__global__ void __launch_bounds__(THREADS)
crop_bwd_img_kernel(const T* __restrict__ ry, const float* __restrict__ ubg,
                    T* __restrict__ d_img, int H, int W, int C, int O,
                    int HH) {
  extern __shared__ __align__(16) float smem[];
  float* ry_s = smem;                     // [O * HH][TY]
  const int K = W * C, OP = O * HH;
  const int n = blockIdx.y, y0 = blockIdx.x * TY;
  const int rows = min(TY, H - y0);
  const T* ry_n = ry + (size_t)n * OP * H;
  for (int i = threadIdx.x; i < OP * TY; i += blockDim.x) {
    const int op = i / TY, j = i - op * TY;
    ry_s[i] = j < rows ? load_f32(ry_n + (size_t)op * H + y0 + j) : 0.f;
  }
  __syncthreads();
  const float* ub_n = ubg + (size_t)n * OP * K;
  T* out = d_img + ((size_t)n * H + y0) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[TY];
#pragma unroll
    for (int j = 0; j < TY; ++j) acc[j] = 0.f;
    for (int op = 0; op < OP; ++op) {
      const float v = ub_n[(size_t)op * K + k];
#pragma unroll
      for (int j = 0; j < TY; ++j) acc[j] = fmaf(ry_s[op * TY + j], v, acc[j]);
    }
    for (int j = 0; j < rows; ++j) store_from_f32(out + (size_t)j * K + k, acc[j]);
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
                     void* out, int N, int H, int W, int C, int O, int HH,
                     int WW, cudaStream_t stream) {
  const int K = W * C;
  const size_t smem =
      sizeof(float) * ((size_t)TP * H + (size_t)TP * K + (size_t)WW * (W + 1));
  cudaError_t err = allow_smem(crop_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((HH + TP - 1) / TP, O, N);
  crop_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<T*>(out), H, W, C, O, HH, WW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t crop_bwd(const void* img, const void* ry, const void* rx,
                     const void* u, void* d_img, void* d_ry, void* d_rx,
                     float* t1, float* ub, int N, int H, int W, int C, int O,
                     int HH, int WW, cudaStream_t stream) {
  const int K = W * C, QC = WW * C;
  const T* img_t = static_cast<const T*>(img);
  const T* ry_t = static_cast<const T*>(ry);
  const T* rx_t = static_cast<const T*>(rx);
  const T* u_t = static_cast<const T*>(u);

  const size_t smem_rows =
      sizeof(float) * ((size_t)TP * H + 2 * (size_t)TP * K +
                       (size_t)TP * QC + (size_t)WW * (W + 1));
  cudaError_t err = allow_smem(crop_bwd_rows_kernel<T>, smem_rows);
  if (err != cudaSuccess) return err;
  crop_bwd_rows_kernel<T><<<dim3((HH + TP - 1) / TP, O, N), THREADS,
                            smem_rows, stream>>>(
      img_t, ry_t, rx_t, u_t, static_cast<T*>(d_ry), t1, ub, H, W, C, O, HH,
      WW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  crop_bwd_rx_kernel<T><<<dim3((WW + TQ - 1) / TQ, O, N), THREADS, 0,
                          stream>>>(u_t, t1, static_cast<T*>(d_rx), W, C, O,
                                    HH, WW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_img = sizeof(float) * (size_t)O * HH * TY;
  err = allow_smem(crop_bwd_img_kernel<T>, smem_img);
  if (err != cudaSuccess) return err;
  crop_bwd_img_kernel<T><<<dim3((H + TY - 1) / TY, N), THREADS, smem_img,
                           stream>>>(ry_t, ub, static_cast<T*>(d_img), H, W,
                                     C, O, HH);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() of its
// launches (the first that failed).
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

// t1 and ub: float32 scratch of N*O*HH*W*C values each.
int sg_crop_bwd(const void* img, const void* ry, const void* rx,
                const void* u, void* d_img, void* d_ry, void* d_rx, void* t1,
                void* ub, int N, int H, int W, int C, int O, int HH, int WW,
                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t1f = static_cast<float*>(t1);
  float* ubf = static_cast<float*>(ub);
  if (dtype == 0)
    return crop_bwd<float>(img, ry, rx, u, d_img, d_ry, d_rx, t1f, ubf, N, H,
                           W, C, O, HH, WW, s);
  if (dtype == 1)
    return crop_bwd<__nv_bfloat16>(img, ry, rx, u, d_img, d_ry, d_rx, t1f,
                                   ubf, N, H, W, C, O, HH, WW, s);
  return cudaErrorInvalidValue;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
