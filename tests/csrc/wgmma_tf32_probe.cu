// A test instrument, not a kernel of the port: one warpgroup product
//
//   d[m][n] = sum_{k<8} a[m][k] * b[n][k]     (m < 64, n < 64)
//
// by wgmma.mma_async m64n64k8 .tf32, A from registers and B from shared
// memory in the non-swizzled K-major layout the f32 stem kernel reads
// (csrc/stem.cu): each 16-byte chunk (4 k) of one row of B is a row of a
// core matrix, the 64 rows of one chunk lie 16 bytes apart, and the two
// chunks of the k8 step lie 1024 bytes apart. tests/test_torch_kernels_cuda.py
// builds it with nvcc and asks of it what the stem kernel relies on: which
// descriptor field gives the stride along k, and that a tf32 operand's low
// 13 bits are not read (so an f32 value in shared memory serves as its own
// truncated high part).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void probe_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ d, int k_stride_in_lbo) {
  __shared__ __align__(128) float bs[2 * 64 * 4];   // [chunk][row][4 k]
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 8; i += 128) {
    const int n = i / 8, k = i % 8;
    bs[(k / 4) * 256 + n * 4 + k % 4] = b[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int w = t / 32, l = t % 32;
  const int m = 16 * w + l / 4, k = l % 4;
  uint32_t f[4];
  f[0] = __float_as_uint(a[m * 8 + k]);
  f[1] = __float_as_uint(a[(m + 8) * 8 + k]);
  f[2] = __float_as_uint(a[m * 8 + k + 4]);
  f[3] = __float_as_uint(a[(m + 8) * 8 + k + 4]);
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  const uint64_t k_stride = 1024 >> 4, row_stride = 128 >> 4;
  const uint64_t desc =
      (uint64_t)((addr & 0x3FFFF) >> 4) |
      ((k_stride_in_lbo ? k_stride : row_stride) << 16) |
      ((k_stride_in_lbo ? row_stride : k_stride) << 32);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31])
      : "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3]), "l"(desc));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // Lane l of warp w: rows 16w + l/4 (+8), columns 8j + 2(l%4) (+1).
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(m + 8 * h) * 64 + 8 * j + 2 * k + e] = acc[4 * j + 2 * h + e];
}

}  // namespace

extern "C" int wgmma_tf32_probe(const void* a, const void* b, void* d,
                                int k_stride_in_lbo) {
  probe_kernel<<<1, 128>>>(static_cast<const float*>(a),
                           static_cast<const float*>(b),
                           static_cast<float*>(d), k_stride_in_lbo);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}
