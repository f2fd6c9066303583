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
// Claims are exclusive: taken starts at 0 and each claim is 0 or 1, so a
// pixel is claimed by at most one object, the first in order whose s is
// above 0.5, and out[p, :] = s_kp * vecs[kp, :] (zero where none claims).
//
// What bounds it on this card: the output. At the serving shape (b16,
// 128x128, O=9, M=32, D=204, bf16) the kernel writes 107 MB of layout,
// 32 us at 3.35 TB/s; it reads about 1 MB, and the claims on the hats'
// nonzeros are a few MFLOP.
//
// The design. A block owns one image and TH rows, in four steps:
//   spans:  for every object, the first and last nonzero of its TH rows of
//           ry_k and of all W rows of rx_k, and the values at the first two
//           (a thread per row, 16 bytes a load). ry and rx are bilinear
//           hats (ops/sampling.py::box_sample_matrices): at most two
//           nonzeros a row, and the rows outside the box are zero;
//   tmp:    tmp_k[r][j] = sum_{q in span(ry_k, r)} ry_k[r][q] mask_k[q][j]
//           for every object and row of the tile at once;
//   claims: a thread per pixel walks the objects in order, computes
//           s = sum_{j in span(rx_k, x)} tmp_k[r][j] rx_k[x][j] where both
//           spans hold a nonzero, and keeps the first s above 0.5: one
//           object index and one f32 weight a pixel, in shared memory;
//   write:  the (TH, W, D) tile, contiguous in the output, as 16-byte
//           stores. A thread takes 16 bytes of channels, steps to their
//           pixel without a division, and multiplies that pixel's weight by
//           its object's vector, read from shared memory as two 8-byte
//           halves (unclaimed pixels read a row of zeros). That needs D a
//           multiple of 8 bytes of channels and a 16-byte-aligned tile
//           (W * D * sizeof(T) % 16 == 0, as at the serving shape); other
//           shapes write one element a thread.
// No float scratch leaves the block; the output is written once. A dense ry
// or rx is still right: its spans are whole rows (slow, but the same sums).
//
// Summation order: every product is a float32 FMA and each sum runs in
// ascending q, then j, as the dense products over every q and j do, so
// dropping the zero terms leaves every finite s equal to the dense sum up
// to the sign of a zero, and the claims do not move. The
// output is s * vecs rounded once (bf16: once more, on store), which is what
// the dense sum of O products gives when all but one of them are 0.
//
// Non-finite inputs: a NaN or Inf in a mask or a vector reaches only the
// pixels that sample or claim it, and a claimed w * Inf is Inf (the dense sum
// added 0 * Inf = NaN to every pixel of the image); a NaN s claims nothing.
// A NaN in ry or rx counts as a nonzero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int THREADS = 256;
constexpr int PIX = 4;         // pixels a thread claims at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// w * v[0..8 bytes), as the 8 bytes to store: 2 floats or 4 bf16 values.
__device__ __forceinline__ uint2 scale_half(float w, const float* v) {
  const float2 h = *reinterpret_cast<const float2*>(v);
  return make_uint2(__float_as_uint(w * h.x), __float_as_uint(w * h.y));
}
__device__ __forceinline__ uint2 scale_half(float w, const __nv_bfloat16* v) {
  const uint2 h = *reinterpret_cast<const uint2*>(v);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&h.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&h.y));
  __nv_bfloat162 ra = __floats2bfloat162_rn(w * a.x, w * a.y);
  __nv_bfloat162 rb = __floats2bfloat162_rn(w * b.x, w * b.y);
  return make_uint2(*reinterpret_cast<uint32_t*>(&ra),
                    *reinterpret_cast<uint32_t*>(&rb));
}

// A row's span (the first and last nonzero; lo > hi: none) and its values
// at lo and lo + 1. NaN counts as a nonzero.
struct RowScan {
  int lo = 1 << 30, hi = -1;
  float t0 = 0.f, t1 = 0.f;
  __device__ __forceinline__ void take(int j, float v) {
    if (j == lo + 1) t1 = v;
    if (v != 0.f) {
      if (hi < 0) {
        lo = j;
        t0 = v;
      }
      hi = j;
    }
  }
};

template <typename T>
__device__ __forceinline__ void scan_row(const T* row, int M, RowScan& sc) {
#pragma unroll 8
  for (int j = 0; j < M; ++j) sc.take(j, load_ro(row + j));
}

// The same, 16 bytes a load (a 16-byte-aligned row of whole 16-byte
// pieces), every load of the row issued before the first is used.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void scan_row_vec(const T* row, int M,
                                             RowScan& sc) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
  for (int cb = 0; cb < M / VEC; ++cb) {
    float v[VEC];
    unpack(__ldg(p + cb), v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sc.take(cb * VEC + e, v[e]);
  }
}

// Byte offsets of a block's shared memory: the vectors (O + 1 rows of D, in
// the inputs' dtype; the last row zero), then per scanned row (O*TH rows of
// ry, then O*W rows of rx) its span and first two values, the tmp rows, and
// each pixel's claim.
struct Smem {
  size_t spans, taps, tmp, kp, wp, total;
};

__host__ __device__ inline Smem smem_layout(int O, int D, int W, int M,
                                            int tsize) {
  Smem s;
  size_t off = ((size_t)(O + 1) * D * tsize + 15) / 16 * 16;
  const size_t rows = (size_t)O * (TH + W);
  s.spans = off;
  off += rows * sizeof(int2);
  s.taps = off;
  off += rows * sizeof(float2);
  s.tmp = off;
  off += (size_t)O * TH * M * sizeof(float);
  s.kp = off;
  off += (size_t)TH * W * sizeof(int);
  s.wp = off;
  off += (size_t)TH * W * sizeof(float);
  s.total = off;
  return s;
}

// grid (ceil(H / TH), N). vec_path: D * sizeof(T) % 8 == 0, W * D *
// sizeof(T) % 16 == 0 and out 16-byte aligned; vec_rows: M * sizeof(T) %
// 16 == 0 and ry, rx 16-byte aligned (the host checks).
template <typename T>
__global__ void __launch_bounds__(THREADS)
compositor_kernel(const T* __restrict__ vecs, const T* __restrict__ ry,
                  const T* __restrict__ rx, const T* __restrict__ masks,
                  T* __restrict__ out, int O, int D, int H, int W, int M,
                  int vec_path, int vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(O, D, W, M, sizeof(T));
  T* vs = reinterpret_cast<T*>(smem);
  int2* spans = reinterpret_cast<int2*>(smem + L.spans);
  float2* taps = reinterpret_cast<float2*>(smem + L.taps);
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);
  int* kp = reinterpret_cast<int*>(smem + L.kp);
  float* wp = reinterpret_cast<float*>(smem + L.wp);

  const int n = blockIdx.y;
  const int y0 = blockIdx.x * TH;
  const int th = min(TH, H - y0);
  const int pix = th * W;
  const int tid = threadIdx.x;
  const size_t nO = (size_t)n * O;

  // Every staging loop issues its loads into registers before it stores
  // any: stores to shared memory between the loads keep them one round
  // trip each.
  const T* vn = vecs + nO * D;
  for (int i0 = tid; i0 < (O + 1) * D; i0 += 8 * THREADS) {
    T v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = i0 + b * THREADS;
      v[b] = i < O * D ? vn[i] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (i0 + b * THREADS < (O + 1) * D) vs[i0 + b * THREADS] = v[b];
  }

  // Spans: a thread per row. Row r < O*TH is row r % TH of ry_k (k = r /
  // TH), empty past the tile's last row; the others are row x of rx_k.
  const int rows = O * (TH + W);
  for (int r = tid; r < rows; r += THREADS) {
    const T* row = nullptr;
    if (r < O * TH) {
      const int k = r / TH, i = r - k * TH;
      if (i < th) row = ry + ((nO + k) * H + y0 + i) * M;
    } else {
      row = rx + (nO * W + r - O * TH) * M;       // the rows of rx_n in order
    }
    RowScan sc;
    if (row != nullptr) {
      if (vec_rows)
        scan_row_vec(row, M, sc);
      else
        scan_row(row, M, sc);
    }
    spans[r] = make_int2(sc.lo, sc.hi);
    taps[r] = make_float2(sc.t0, sc.lo + 1 <= sc.hi ? sc.t1 : 0.f);
  }
  __syncthreads();

  // tmp[(k*TH + i)*M + j] = sum_{q in span} ry_k[i][q] mask_k[q][j], q in
  // order; the first two taps from the spans' values, the mask values of
  // four sums loaded first.
  const int tmp_n = O * TH * M;
  for (int e0 = tid; e0 < tmp_n; e0 += 4 * THREADS) {
    int2 sp[4];
    size_t mo[4];
    float m0[4], m1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS, ki = e / M, j = e - ki * M;
      sp[u] = e < tmp_n ? spans[ki] : make_int2(1, 0);
      mo[u] = (nO + ki / TH) * M * M + j;           // mask_k[0][j]
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = sp[u].x;
      m0[u] = q <= sp[u].y ? load_ro(masks + mo[u] + (size_t)q * M) : 0.f;
      m1[u] = q + 1 <= sp[u].y ? load_ro(masks + mo[u] + (size_t)(q + 1) * M)
                               : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      if (e >= tmp_n) break;
      const int ki = e / M;
      float acc = 0.f;
      if (sp[u].x <= sp[u].y) {
        const float2 tp = taps[ki];
        acc = fmaf(tp.x, m0[u], acc);
        if (sp[u].x + 1 <= sp[u].y) acc = fmaf(tp.y, m1[u], acc);
        const int k = ki / TH;
        const T* ry_row = ry + ((nO + k) * H + y0 + ki - k * TH) * M;
        for (int q = sp[u].x + 2; q <= sp[u].y; ++q)
          acc = fmaf(load_ro(ry_row + q),
                     load_ro(masks + mo[u] + (size_t)q * M), acc);
      }
      tmp[e] = acc;
    }
  }
  __syncthreads();

  // Claims: PIX pixels a thread at once, the objects in order; the first s
  // above 0.5 claims (kp = O, wp = 0: unclaimed).
  for (int p0 = tid; p0 < pix; p0 += PIX * THREADS) {
    int kq[PIX], rq[PIX], xq[PIX];
    float wq[PIX];
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      const int p = p0 + u * THREADS;
      rq[u] = p / W;
      xq[u] = p - rq[u] * W;
      kq[u] = p < pix ? O : -1;           // -1: no pixel
      wq[u] = 0.f;
    }
    for (int k = 0; k < O; ++k) {
#pragma unroll
      for (int u = 0; u < PIX; ++u) {
        if (kq[u] != O) continue;         // claimed already, or no pixel
        const int2 sy = spans[k * TH + rq[u]];
        const int2 sx = spans[O * TH + k * W + xq[u]];
        if (sy.x > sy.y || sx.x > sx.y) continue;
        const float* t = tmp + (k * TH + rq[u]) * M;
        const float2 tx = taps[O * TH + k * W + xq[u]];
        float s = fmaf(t[sx.x], tx.x, 0.f);
        if (sx.x + 1 <= sx.y) s = fmaf(t[sx.x + 1], tx.y, s);
        const T* rx_row = rx + ((nO + k) * W + xq[u]) * M;
        for (int j = sx.x + 2; j <= sx.y; ++j)
          s = fmaf(t[j], load_ro(rx_row + j), s);
        if (s > 0.5f) {
          kq[u] = k;
          wq[u] = s;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      const int p = p0 + u * THREADS;
      if (p < pix) {
        kp[p] = kq[u];
        wp[p] = wq[u];
      }
    }
  }
  __syncthreads();

  // Write the tile: out[p][d] = wp[p] * vs[kp[p]][d].
  T* on = out + ((size_t)n * H + y0) * W * D;
  const int count = pix * D;
  if (vec_path) {
    constexpr int VEC = 16 / sizeof(T), HALF = VEC / 2;
    const int step = THREADS * VEC;
    const int dp = step / D, dd = step - dp * D;
    int p = tid * VEC / D, d = tid * VEC - p * D;
    for (int e = tid * VEC; e < count; e += step) {
      int p1 = p, d1 = d + HALF;
      if (d1 >= D) {
        d1 -= D;
        ++p1;
      }
      const uint2 a = scale_half(wp[p], vs + kp[p] * D + d);
      const uint2 b = scale_half(wp[p1], vs + kp[p1] * D + d1);
      *reinterpret_cast<uint4*>(on + e) = make_uint4(a.x, a.y, b.x, b.y);
      p += dp;
      d += dd;
      if (d >= D) {
        d -= D;
        ++p;
      }
    }
  } else {
    for (int e = tid; e < count; e += THREADS) {
      const int p = e / D, d = e - p * D;
      on[e] = from_f32<T>(wp[p] * to_f32(vs[kp[p] * D + d]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* vecs, const void* ry, const void* rx,
                   const void* masks, void* out, int N, int O, int D, int H,
                   int W, int M, cudaStream_t stream) {
  const size_t smem = smem_layout(O, D, W, M, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      compositor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  const int vec_path = (D * sizeof(T)) % 8 == 0 &&
                       ((size_t)W * D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec_rows = (M * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(ry) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(rx) % 16 == 0;
  dim3 grid((H + TH - 1) / TH, N);
  compositor_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(vecs), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<const T*>(masks),
      static_cast<T*>(out), O, D, H, W, M, vec_path, vec_rows);
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
