// Test-mode occlusion compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel
// scene_generation_tpu/ops/pallas/compositor.py::masks_to_layout_pallas.
// Objects arrive in ascending-mass order with invalid slots zeroed (the prep
// is ops/layout.py::compositor_inputs). For each image and each object k in
// that order:
//
//   s      = ry_k (H x M) @ mask_k (M x M) @ rx_k^T (M x W)
//   claim  = (s > 0.5) * (1 - taken)
//   taken  = min(taken + claim, 1)
//   out   += (s * claim) (x) vecs_k            -> out (N, H, W, D)
//
// Inputs are float32 or bfloat16; every product and sum is float32, in a
// fixed order, so a float32 mask of 0.5 + 2^-12 stays above 0.5 and claims.
//
// What bounds it on this card: the output. At the serving shape (b16,
// 128x128, O=9, M=32, D=204) the kernel writes 107 MB of bf16 layout
// (about 32 us at 3.35 TB/s) while it does about 1.2 GFLOP, which does not
// bind.
//
// What this design does about it: the (N, O, H, W) sampled-mask field and
// the claims never reach device memory. A block owns one image and TH rows.
// Per object it forms tmp = ry_k[rows] @ mask_k (TH x M) and the transposed
// rx_k in shared memory, then every thread takes pixels, sums
// tmp[r] . rx_k[x] over M, updates taken/claim and keeps the claimed weight
// in shared memory. A last pass writes the (TH, W, D) output tile once,
// contiguous and coalesced, as sum_k weight_k * vecs_k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compositor_kernel(const T* __restrict__ vecs, const T* __restrict__ ry,
                  const T* __restrict__ rx, const T* __restrict__ masks,
                  T* __restrict__ out, int O, int D, int H, int W, int M) {
  extern __shared__ float smem[];
  const int P = TH * W;
  float* wts = smem;               // [O][TH*W] claimed weights
  float* taken = wts + O * P;      // [TH*W]
  float* tmp = taken + P;          // [TH][M]
  float* rxt = tmp + TH * M;       // [M][W]
  float* vs = rxt + M * W;         // [O][D]

  const int n = blockIdx.y;
  const int y0 = blockIdx.x * TH;
  const int th = min(TH, H - y0);
  const int pix = th * W;

  for (int i = threadIdx.x; i < O * D; i += THREADS)
    vs[i] = load_f32(vecs + (size_t)n * O * D + i);
  for (int p = threadIdx.x; p < pix; p += THREADS) taken[p] = 0.f;

  for (int k = 0; k < O; ++k) {
    const size_t nk = (size_t)n * O + k;
    const T* rxk = rx + nk * W * M;
    for (int i = threadIdx.x; i < W * M; i += THREADS)
      rxt[(i % M) * W + i / M] = load_f32(rxk + i);
    const T* ryk = ry + (nk * H + y0) * M;
    const T* mk = masks + nk * M * M;
    for (int i = threadIdx.x; i < th * M; i += THREADS) {
      const int r = i / M, j = i % M;
      float s = 0.f;
      for (int q = 0; q < M; ++q)
        s = fmaf(load_f32(ryk + r * M + q), load_f32(mk + q * M + j), s);
      tmp[i] = s;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pix; p += THREADS) {
      const int r = p / W, x = p % W;
      float s = 0.f;
      for (int j = 0; j < M; ++j) s = fmaf(tmp[r * M + j], rxt[j * W + x], s);
      const float claim = (s > 0.5f ? 1.f : 0.f) * (1.f - taken[p]);
      taken[p] = fminf(taken[p] + claim, 1.f);
      wts[k * P + p] = s * claim;
    }
    __syncthreads();
  }

  T* on = out + ((size_t)n * H + y0) * W * D;
  const int count = pix * D;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int p = e / D, d = e - p * D;
    float acc = 0.f;
    for (int k = 0; k < O; ++k) acc = fmaf(wts[k * P + p], vs[k * D + d], acc);
    store_from_f32(on + e, acc);
  }
}

template <typename T>
cudaError_t launch(const void* vecs, const void* ry, const void* rx,
                   const void* masks, void* out, int N, int O, int D, int H,
                   int W, int M, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)O * TH * W + TH * W + TH * M +
                                       (size_t)M * W + (size_t)O * D);
  cudaError_t err = cudaFuncSetAttribute(
      compositor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  dim3 grid((H + TH - 1) / TH, N);
  compositor_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(vecs), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<const T*>(masks),
      static_cast<T*>(out), O, D, H, W, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int sg_compositor(const void* vecs, const void* ry, const void* rx,
                  const void* masks, void* out, int N, int O, int D, int H,
                  int W, int M, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vecs, ry, rx, masks, out, N, O, D, H, W, M, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vecs, ry, rx, masks, out, N, O, D, H, W, M,
                                 s);
  return cudaErrorInvalidValue;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
