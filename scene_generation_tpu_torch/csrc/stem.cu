// Fused factored generator stem for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_generation_tpu/ops/pallas/stem.py::stem_pallas:
//
//   out[n,y,x,c] = sum_{dy,dx<7, o<O} w_pad[n, y+dy, x+dx, o] * g[n, dy, dx, o, c]
//
// with w_pad (N, H+6, W+6, O), g (N, 7, 7, O, C) and out (N, H, W, C), all
// contiguous, float32 or bfloat16, summed in float32.
//
// What bounds it on this card: per image it is an implicit GEMM with
// M = H*W pixels, N = C channels and K = 49*O taps whose B operand (g[n])
// differs per image. At the serving shape (b16, 128x128, O=9, C=64) that is
// 14.8 GFLOP against about 40 MB of traffic, so the card's floor is set by
// arithmetic (about 15 us at the bf16 tensor-core rate, 12 us for the bytes).
//
// What this design does about it: the im2col matrix never exists. A block
// owns one image and TH output rows. It stages the (TH+6) x (W+6) x O halo
// of w_pad (stored o-major, so a warp reads consecutive x) and the whole of
// g[n] (49*O*C values, 113 KB in f32) in dynamic shared memory as float32,
// so each input byte comes from device memory about once per block and
// every multiply reads shared memory only. Each warp owns one output row;
// lane l owns the pixels x = l, l+32, l+64, l+96 and a chunk of CC channels,
// keeps the PX*CC sums in registers, and adds the 49*O taps in a fixed
// order. The FMAs run on the CUDA cores in f32: this first version does not
// use the tensor cores (wgmma), so it sits far above the arithmetic floor;
// a later version that feeds wgmma from the same staged tiles is the way
// down to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 7;                 // stem kernel size
constexpr int TH = 8;                // output rows per block, one warp each
constexpr int PX = 4;                // pixels per lane: x = lane + 32 * i
constexpr int THREADS = TH * 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Floats of the staged halo, rounded up so that g's tile starts 16-byte
// aligned and can be read as float4.
__host__ __device__ inline int halo_floats(int W, int O) {
  return (O * (TH + K - 1) * (W + K - 1) + 3) / 4 * 4;
}

template <typename T, int CC>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const T* __restrict__ w, const T* __restrict__ g,
            T* __restrict__ out, int H, int W, int O, int C) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int rows = TH + K - 1;
  float* ws = smem;                       // [O][rows][Wp]
  float* gs = smem + halo_floats(W, O);   // [7][7][O][C]
  const int n = blockIdx.y;
  const int y0 = blockIdx.x * TH;

  const int g_count = K * K * O * C;
  const T* gn = g + (size_t)n * g_count;
  for (int i = threadIdx.x; i < g_count; i += THREADS) gs[i] = load_f32(gn + i);

  // Rows y0 .. y0+rows-1 of w_pad[n]; a partial last tile reads only the
  // rows that exist (the rows of its missing outputs are never used).
  const int avail = min(rows, Hp - y0);
  const int w_count = avail * Wp * O;
  const T* wn = w + ((size_t)n * Hp + y0) * Wp * O;
  for (int i = threadIdx.x; i < w_count; i += THREADS) {
    const int o = i % O;
    const int rx = i / O;
    ws[(o * rows + rx / Wp) * Wp + rx % Wp] = load_f32(wn + i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = y0 + warp;
  if (y >= H) return;

  for (int xb = 0; xb < W; xb += 32 * PX) {
    for (int c0 = 0; c0 < C; c0 += CC) {
      float acc[PX][CC];
#pragma unroll
      for (int i = 0; i < PX; ++i)
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[i][j] = 0.f;

      for (int dy = 0; dy < K; ++dy) {
        for (int o = 0; o < O; ++o) {
          const float* wrow = ws + (o * rows + warp + dy) * Wp + xb + lane;
          const float* grow = gs + (dy * K * O + o) * C + c0;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            float wv[PX];
#pragma unroll
            for (int i = 0; i < PX; ++i)
              wv[i] = (xb + lane + 32 * i < W) ? wrow[32 * i + dx] : 0.f;
            const float* gp = grow + dx * O * C;
            float gv[CC];
            if constexpr (CC % 4 == 0) {
#pragma unroll
              for (int j = 0; j < CC; j += 4) {
                const float4 q = *reinterpret_cast<const float4*>(gp + j);
                gv[j] = q.x; gv[j + 1] = q.y; gv[j + 2] = q.z; gv[j + 3] = q.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < CC; ++j) gv[j] = gp[j];
            }
#pragma unroll
            for (int j = 0; j < CC; ++j)
#pragma unroll
              for (int i = 0; i < PX; ++i)
                acc[i][j] = fmaf(wv[i], gv[j], acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int x = xb + lane + 32 * i;
        if (x >= W) continue;
        T* op = out + (((size_t)n * H + y) * W + x) * C + c0;
#pragma unroll
        for (int j = 0; j < CC; ++j) store_from_f32(op + j, acc[i][j]);
      }
    }
  }
}

template <typename T, int CC>
cudaError_t launch(const void* w, const void* g, void* out, int N, int H,
                   int W, int O, int C, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)halo_floats(W, O) + (size_t)K * K * O * C);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<T, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  dim3 grid((H + TH - 1) / TH, N);
  stem_kernel<T, CC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(out),
      H, W, O, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* w, const void* g, void* out, int N, int H,
                     int W, int O, int C, cudaStream_t stream) {
  if (C % 16 == 0) return launch<T, 16>(w, g, out, N, H, W, O, C, stream);
  if (C % 4 == 0) return launch<T, 4>(w, g, out, N, H, W, O, C, stream);
  return launch<T, 1>(w, g, out, N, H, W, O, C, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int sg_stem(const void* w, const void* g, void* out, int N, int H, int W,
            int O, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(w, g, out, N, H, W, O, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(w, g, out, N, H, W, O, C, s);
  return cudaErrorInvalidValue;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
