// Fused factored generator stem for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_generation_tpu/ops/pallas/stem.py::stem_pallas:
//
//   out[n,y,x,c] = sum_{dy,dx<7, o<O} w_pad[n, y+dy, x+dx, o] * g[n, dy, dx, o, c]
//
// with w_pad (N, H+6, W+6, O), g (N, 7, 7, O, C) and out (N, H, W, C), all
// contiguous, float32 or bfloat16, summed in float32. The dtype picks one of
// two hand-written kernels; neither stands in for the other.
//
// What bounds it on this card: per image it is an implicit GEMM with
// M = H*W pixels, N = C channels and K = 49*O taps whose B operand (g[n])
// differs per image. At the serving shape (b16, 128x128, O=9, C=64) that is
// 14.8 GFLOP against about 40 MB of traffic, so the card's floor is set by
// arithmetic: about 15 us at the bf16 tensor-core rate (12 us for the bytes).
//
// bfloat16 (serving): stem_tc_kernel, warpgroup products (wgmma.mma_async,
// bf16 in, f32 sums) fed by bulk copies (cp.async.bulk) on mbarriers.
//   * The sum is re-associated: k = dx*O + o inside one product, dy outside
//     it, out[y] = sum_{dy<7} A[y+dy] * B[dy] with B[dy][k][c] =
//     g[n, dy, dx, o, c] (g[n, dy] as it lies: a 7*O x C matrix) and the
//     packed input row A[r][x][k] = w_pad[n, r, x+dx, o] = raw[x*O + k],
//     raw being row r of w_pad[n] as it lies. A packed row is a window of
//     its raw row slid O elements a pixel; it is built once and serves the 7
//     output rows r-6..r, and the shift lies along dy, a whole packed row,
//     never inside an operand. (Packing dy into k, as the TPU kernel does,
//     shifts an operand by dx pixel rows, which a wgmma descriptor cannot
//     express inside a swizzled tile.) k is 7*O rounded up to 16: 63 of 64
//     at O=9, so KO/16 = 4 k16 steps a dy, 28 products a pass.
//   * The product is taken transposed, out^T (64 channels x pixels) =
//     B[dy]^T (A operand) * A[y+dy]^T (B operand), as m64n128k16: with the
//     pixels as N, a product is twice as wide as m64n64 with the channels
//     as N, and the narrow one ran well below the tensor rate. Both
//     operands are read by descriptor in the 128-byte swizzle (chunk ^ row &
//     7 within 1024-byte atoms): the taps MN-major (rows of k, 64 channels =
//     128 bytes: g[n, dy]'s own layout, staged by a 16-byte copy, no
//     transpose; imm-trans-a), the packed rows K-major (a pixel's 64 k =
//     128 bytes; k past 64, at O=10, in a second block). A pass covers 128
//     pixels, the last one 64 (m64n64k16) when no more are left.
//   * A block is three warpgroups. Warpgroup 2 produces: every output row
//     of the unit in turn, gathered from its 7 input rows' band spans
//     through L1 (where the 7 output rows that use an input row find it;
//     a table of each chunk's 4 element offsets, built once, saves the
//     index arithmetic), split and stored 16 bytes a chunk into the ring
//     of 3 (mbarriers full and empty a slot), with 40 registers a thread
//     (setmaxnreg). Warpgroups 0 and 1 consume, even and odd output rows,
//     with 232: they stage the unit's taps, then take each row's 56 steps
//     (k8, then dx) of 3 products, 21 products a group behind one fence,
//     the next step's fragments loaded and split while a group runs; then
//     free the slot and store. Two consumers keep the tensor cores fed
//     (one alone runs its products well below the rate two reach) while
//     the producer packs ahead. Packing in the consumers, the two fell
//     into step and the tensor cores idled while both packed; taking
//     turns left each alone on them.
//   * Stores go straight from the fragments: f32 sums at channels 16w +
//     l/4 and pixels 8j + 2(l%4) make a warp's store four whole 32-byte
//     sectors (8 channels of 4 pixels).
//   * The grid is persistent and balanced like the bf16 one: an image's
//     bands cut into SMs / (N * CT * bands of pixels) bands of rows, one
//     block an SM (shared memory allows one), so that both the serving
//     shape (16 images: 128 units of 32 rows) and a val sweep's (12: 120
//     of 26) take one wave.
// bfloat16 wider than a ring of 7 full-width packed rows allows (W above
// 152 at O = 9 and C = 64, or O from 10 at W = 128): stem_tc_banded_kernel.
//   * It runs the body of stem_tc_kernel (one device function, whose
//     whole rows are one band of W pixels), on bands of
//     PX output pixels: 128 where the tiles fit, else 64, else 32 (a
//     pixel's k and g[n] fill the block: O up to 16 at C = 64). A unit is
//     one band of RB rows of one image and channel tile; its input rows
//     are staged PX + 6 pixels wide (the halo of the 7 taps) and packed
//     into rows of PX pixels, so the ring no longer grows with W. At the
//     256 px serving shape (b16, O = 9, C = 64) that is bands of 128
//     pixels and 64 rows, 128 units in one wave, the 128 px launch's ring.
//   * A pass over a band's last, narrower pixels takes m64n64 where at
//     most 64 are left; one of a 32-pixel band reads 32 pixels past it
//     (the plan keeps them inside the allocation), whose columns are
//     not stored.
//   * Each output element is summed in the same order as in
//     stem_tc_kernel, so the two agree bit for bit where both run.
// No atomics and a fixed order of the three products, of k and of dx: a
// call is bitwise repeatable. Ragged edges: pixels past W+6 and k past 7*O
// are zero in E, channels past C are zero in T and not stored, nor pixels
// past W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int K = 7;                 // stem kernel size

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1, set on the
// host): index arithmetic in the staging loops without integer division.
struct FastDiv {
  uint32_t m;
  int s;
};

inline FastDiv fast_div(int d) {
  FastDiv f;
  f.s = 0;
  while ((1ll << f.s) < d) ++f.s;
  f.m = (uint32_t)(((uint64_t)1 << 32) * ((1ull << f.s) - d) / d + 1);
  return f;
}

__device__ __forceinline__ int operator/(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

// The position of 16-byte chunk j of tile row r: chunks are swizzled within
// each group of 8 (128 bytes) by the row's low 3 bits.
__device__ __forceinline__ int swizzle(int j, int r) {
  return (j & ~7) | ((j ^ r) & 7);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst = *src (4 bytes) by cp.async, or 0 (no read) when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(shared_address(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// --- host: the card, read once a process -----------------------------------

// The SM count and the shared memory a block may opt into, of one device.
struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;
};

constexpr int MAX_DEVICES = 64;
enum KernelIndex {
  KERNEL_TC, KERNEL_TC_BANDED, KERNEL_F32_64, KERNEL_F32_32, KERNELS
};

// What sg_stem reports it launched (ops/stem.py reads the same numbers).
enum KernelLaunched { STEM_F32 = 0, STEM_TC = 1, STEM_TC_BANDED = 2 };

std::mutex host_mutex;                  // ctypes calls come without the GIL
DeviceInfo devices[MAX_DEVICES];
uint32_t smem_allowed[MAX_DEVICES][KERNELS];

// The current device and its info, queried at its first launch only.
cudaError_t device_info(int& device, DeviceInfo& info) {
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(host_mutex);
  DeviceInfo& d = devices[device];
  if (d.sms == 0) {
    DeviceInfo q;
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &q.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    d = q;
  }
  info = d;
  return cudaSuccess;
}

// Lets kernel use bytes of dynamic shared memory on device: one
// cudaFuncSetAttribute a kernel, device and larger size, none after.
cudaError_t allow_smem(const void* kernel, int which, int device,
                       uint32_t bytes) {
  std::lock_guard<std::mutex> lock(host_mutex);
  if (smem_allowed[device][which] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  smem_allowed[device][which] = bytes;
  return cudaSuccess;
}

// --- bfloat16: warpgroup products -------------------------------------------

constexpr int TC_WG = 128;             // threads of a warpgroup
constexpr int TC_THREADS = 3 * TC_WG;  // consumers 0 and 1, producer 2
constexpr int TC_NC = 64;              // channels of a product (wgmma's N)
constexpr int TC_PACKERS = 4;          // producer warps: a row each at a time,
                                       // its raw row staged in a slot of its own
constexpr int TC_OUT_PX = 64;          // pixels of a consumer's output tile
constexpr int TC_RING_MAX = 9;         // packed rows resident, at most

// The launch's plan: its bands (of rows, and of PX pixels in the banded
// kernel) and where its tiles lie in dynamic shared memory (byte offsets
// from its first 1024-byte boundary): the taps
// [dy][KO k-rows][64 channels] (MN-major) at 0, the ring of packed rows
// [ring][k-blocks][WP pixels][64 k] (K-major) at ring_at, g[n] staged at a
// band's start at g_at (the end of the ring's space), the raw rows'
// staging slots at stage_at, the consumers' output tiles [2][64 pixels][64
// channels] at out_at, the mbarriers at bars_at (full[ring], empty[ring],
// landed[TC_PACKERS], g_landed, taps_done). Rows are 128 bytes, swizzled.
struct TcPlan {
  int KO;           // k of a product: 7*O rounded up to 16
  int CT;           // channel tiles of 64
  int PX;           // output pixels of a band: W for whole rows
  int XT;           // pixel bands of a row: 1 for whole rows
  bool banded;      // bands of pixels: stem_tc_banded_kernel
  int RB;           // output rows of a band
  int bands;        // bands of rows of an image's column
  int units;        // bands of the launch: N * CT * XT * bands
  int ring;         // packed rows resident: 7 to 9
  uint32_t block;   // bytes of a k-block of a packed row: its pixels * 128
  uint32_t slot;    // bytes of a packed row: its k-blocks
  uint32_t stage;   // bytes of a staging slot
  uint32_t ring_at, g_at, stage_at, out_at, bars_at, total;
  int g_slot;       // the first ring slot that overlaps the staged g[n]
};

inline size_t round_up_size(size_t v, size_t m) { return (v + m - 1) / m * m; }

// Places the ring (9 packed rows, down to 7) and the tiles after it in
// max_smem bytes, with P's rows and staging slots set; false if even 7 do
// not fit. overrun: bytes a pass may read past the last slot.
inline bool tc_fit(int O, int C, size_t overrun, int max_smem, TcPlan& P) {
  const size_t taps = (size_t)K * P.KO * 128;
  const size_t g_bytes = (size_t)K * K * O * C * 2 + 64;
  for (int ring = TC_RING_MAX; ring >= K; --ring) {
    const size_t ring_bytes =
        round_up_size(std::max((size_t)ring * P.slot, g_bytes), 1024);
    const size_t stage_at = taps + ring_bytes + overrun;
    const size_t out_at = stage_at + (size_t)TC_PACKERS * P.stage;
    const size_t bars_at = out_at + 2 * TC_OUT_PX * 128;
    // 1024 spare: the dynamic shared memory is aligned to 1024 in-kernel.
    const size_t total = bars_at + 8 * (2 * ring + TC_PACKERS + 2) + 1024;
    if (total <= (size_t)max_smem) {
      P.ring = ring;
      P.ring_at = (uint32_t)taps;
      P.g_at = (uint32_t)(taps + ring_bytes - round_up_size(g_bytes, 16));
      P.g_slot = (int)((P.g_at - taps) / P.slot);
      P.stage_at = (uint32_t)stage_at;
      P.out_at = (uint32_t)out_at;
      P.bars_at = (uint32_t)bars_at;
      P.total = (uint32_t)total;
      return true;
    }
  }
  return false;
}

// Fills P for the shape on a card of sms SMs and max_smem bytes of shared
// memory a block, rows whole (stem_tc_kernel); false if even a ring of 7
// packed rows does not fit.
inline bool tc_plan(int N, int H, int W, int O, int C, int sms, int max_smem,
                    TcPlan& P) {
  P.KO = round_up(K * O, 16);
  P.CT = (C + TC_NC - 1) / TC_NC;
  P.PX = W;
  P.XT = 1;
  P.banded = false;
  const int per_image = std::min(H, std::max(1, sms / (N * P.CT)));
  P.RB = (H + per_image - 1) / per_image;
  P.bands = (H + P.RB - 1) / P.RB;
  P.units = N * P.CT * P.bands;
  P.block = (uint32_t)round_up(W, 8) * 128;
  P.slot = (P.KO + 63) / 64 * P.block;   // k-blocks of 64 k
  // A span starts up to 14 bytes before its row; the packing reads up to
  // 33 bytes past a row's last byte (masked).
  P.stage = (uint32_t)round_up_size((size_t)(W + K - 1) * O * 2 + 48, 16);
  // The last pass of a row reads up to round_up(W, 64) pixels: past the
  // last slot, that many more bytes must lie inside the allocation.
  return tc_fit(O, C, (size_t)(round_up(W, 64) - round_up(W, 8)) * 128,
                max_smem, P);
}

// The same in bands of PX pixels (stem_tc_banded_kernel): rows of PX + 6
// input pixels staged, PX packed; balanced over the SMs as the f32 plan is.
inline bool tc_banded_plan_at(int N, int H, int W, int O, int C, int sms,
                              int max_smem, int PX, TcPlan& P) {
  P.KO = round_up(K * O, 16);
  P.CT = (C + TC_NC - 1) / TC_NC;
  P.PX = PX;
  P.XT = (W + PX - 1) / PX;
  P.banded = true;
  const int columns = N * P.CT * P.XT;
  const int per_column = std::min(H, std::max(1, sms / columns));
  P.RB = (H + per_column - 1) / per_column;
  P.bands = (H + P.RB - 1) / P.RB;
  P.units = columns * P.bands;
  P.block = (uint32_t)PX * 128;
  P.slot = (P.KO + 63) / 64 * P.block;
  P.stage = (uint32_t)round_up_size((size_t)(PX + K - 1) * O * 2 + 48, 16);
  return tc_fit(O, C, (size_t)(round_up(PX, 64) - PX) * 128, max_smem, P);
}

// Bands of 128 pixels where their tiles fit (the passes stay m64n128),
// else of 64, else of 32; false if none fits.
inline bool tc_banded_plan(int N, int H, int W, int O, int C, int sms,
                           int max_smem, TcPlan& P) {
  for (int PX = 128; PX >= 32; PX /= 2)
    if (tc_banded_plan_at(N, H, W, O, C, sms, max_smem, PX, P)) return true;
  return false;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Orders this thread's generic writes to shared memory before the async
// proxy's reads (wgmma) and writes (bulk copies) that follow a barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Starts a bulk copy of count bf16 elements at src into dst: the
// 16-byte-aligned span that holds them (bulk copies take 16-byte-aligned
// addresses and sizes), src's first element span_lead(src) elements into
// dst. It completes on bar, which expects its bytes.
__device__ __forceinline__ void load_span(uint32_t dst, const uint16_t* src,
                                          int count, uint32_t bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + 2 * (uintptr_t)count + 15) & ~(uintptr_t)15;
  const uint32_t bytes = (uint32_t)(hi - lo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(lo), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ int span_lead(const uint16_t* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 1);
}

// A wgmma matrix descriptor of an operand in the 128-byte swizzle: rows of
// 128 bytes whose 16-byte chunks lie at chunk ^ (row & 7), in atoms of 8
// rows (1024 bytes apart: SBO) from a 1024-byte boundary. K-major (the
// packed rows: a row a pixel, 64 k), a k16 step lies 32 bytes into the
// rows; MN-major (the taps: a row a k, 64 channels), 16 rows on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Where 16-byte chunk j (k = 8j..8j+7) of row r of a swizzled K-major tile
// lies, from the tile's start (k-blocks of 64 k, block bytes apart).
__device__ __forceinline__ uint32_t sw_chunk(int r, int j, uint32_t block) {
  return (j >> 3) * block + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// d += A * B: m64nNk16 (NR = N/2 sums a thread), bf16 in shared memory, A
// MN-major (imm-trans-a), B K-major, f32 sums. Lane l of warp w of the
// warpgroup holds rows 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8
// (d[4j+2], d[4j+3]) at columns 8j + 2(l%4) + {0, 1}.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int NR>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[NR], uint64_t a,
                                             uint64_t b) {
  if constexpr (NR == 64) wgmma_m64n128k16(d, a, b);
  else wgmma_m64n64k16(d, a, b);
}

// Keeps the compiler from moving an accumulator across the asynchronous
// products' fence and wait.
template <int NR>
__device__ __forceinline__ void pin(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The taps B[dy] for the band's channels c0..c0+63 from g[n] staged at
// gs + lead: g[n, dy] is already [k][c] (k = dx*O + o), so the MN-major
// tile is its rows as they are, 16-byte chunks put at chunk ^ (k & 7),
// zero for k >= 7*O or c >= C. A 16-byte copy a chunk when the rows are
// 16-byte aligned, else element by element. The consumers' threads.
__device__ __forceinline__ void tc_stage_taps(uint8_t* smem,
                                              const uint16_t* gs, int lead,
                                              int KO, int KR, int C, int c0) {
  const int chunks = K * KO * 8;
  const bool fast = (C & 7) == 0 && (lead & 7) == 0;
  for (int i = threadIdx.x; i < chunks; i += 2 * TC_WG) {   // consumers
    const int j = i & 7, row = i >> 3;          // row = dy*KO + k
    const int dy = row / KO, k = row - dy * KO, c = c0 + 8 * j;
    uint4 v = make_uint4(0, 0, 0, 0);
    const uint16_t* src = gs + lead + (dy * KR + k) * C + c;
    if (k < KR && c < C) {
      if (fast) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = c + e < C ? src[e] : 0u;
        v = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                       h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(smem + row * 128 + ((j ^ (k & 7)) << 4)) = v;
  }
}

// Chunks j0..j0+NCH-1 of pixel x: the words of raw from p, shifted by
// one element when odd, zero from element valid0 on; stored in the
// swizzled packed row at dst. All loads come before the stores.
template <int NCH>
__device__ __forceinline__ void tc_pack_chunks(uint8_t* dst, uint32_t block,
                                               int x, int j0,
                                               const uint32_t* p, bool odd,
                                               int valid0) {
  uint32_t a[4 * NCH + 1];
#pragma unroll
  for (int m = 0; m < 4 * NCH + 1; ++m) a[m] = p[m];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int valid = valid0 - 8 * c;           // real k of the chunk
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t x =
          odd ? __funnelshift_r(a[4 * c + m], a[4 * c + m + 1], 16)
              : a[4 * c + m];
      v[m] = 2 * m + 1 < valid ? x : 2 * m < valid ? (x & 0xffffu) : 0u;
    }
    *reinterpret_cast<uint4*>(dst + sw_chunk(x, j0 + c, block)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Packs the landed raw row (O elements a pixel, at element lead of raw)
// into dst: dst[j][x] = the 16-byte chunk raw[x*O + 8j .. +8), zero from k
// = 7*O on. A thread a pixel; its chunks are one run of raw's words (read
// up to 33 bytes past the row's last byte: the staging slot's spare).
__device__ __forceinline__ void tc_pack_row(uint8_t* dst,
                                            const uint32_t* raw, int lead,
                                            int W, int O, int KC, int KR,
                                            uint32_t block, int lane) {
  for (int x = lane; x < W; x += 32) {
    const int e = lead + x * O;
    const uint32_t* p = raw + (e >> 1);
    const bool odd = e & 1;
    int j = 0;
    for (; j + 8 <= KC; j += 8)
      tc_pack_chunks<8>(dst, block, x, j, p + 4 * j, odd, KR - 8 * j);
    for (; j + 4 <= KC; j += 4)
      tc_pack_chunks<4>(dst, block, x, j, p + 4 * j, odd, KR - 8 * j);
    for (; j < KC; j += 2)
      tc_pack_chunks<2>(dst, block, x, j, p + 4 * j, odd, KR - 8 * j);
  }
}

// The 16-byte chunk of pixel x (of a 64-pixel tile) holding channels
// 8*chunk..: swizzled by the pixel's low 3 bits, so that 8 consecutive
// pixels (one 8x8 block of stmatrix) and the 8 chunks of one pixel (the
// read-out) each fall in 8 different banks.
__device__ __forceinline__ uint32_t out_chunk(int x, int chunk) {
  return x * 128 + ((chunk ^ (x & 7)) << 4);
}

// Stores four 8x8 bf16 blocks, each held as mma fragments (lane l: row l/4,
// columns 2(l%4), 2(l%4)+1), transposed: row i of block q goes to the
// address lane 8q + i gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&v)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

// Rounds a pass's sums (D = out^T: rows 64 channels, columns NR/2 pixels
// from x0) to bf16 and stores them in row orow of out, 64 pixels at a
// time through the warpgroup's tile: stmatrix writes each 8x8 block (8
// channels x 8 pixels) transposed, a pixel's 8 channels a 16-byte row of
// the tile; then the warpgroup writes the tile's pixels out whole, 16
// bytes a lane and consecutive lanes on consecutive bytes. bar is the
// warpgroup's barrier.
template <int NR>
__device__ __forceinline__ void tc_store(const float (&acc)[NR], uint8_t* tile,
                                         __nv_bfloat16* orow, int x0, int W,
                                         int C, int c0, int wq, int lane,
                                         int wt, int bar) {
  const uint32_t tile_at = shared_address(tile);
  const int q = lane / 8, i = lane % 8;    // this lane's block and row
#pragma unroll
  for (int half = 0; half < NR / 32; ++half) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        const int j = 8 * half + j0;
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = pack_bf16x2(acc[4 * (j + u) + 2 * h],
                             acc[4 * (j + u) + 2 * h + 1]);
        stmatrix_x4_trans(tile_at + out_chunk(8 * (j0 + q) + i, 2 * wq + h),
                          v);
      }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(bar) : "memory");
    const int xh = x0 + TC_OUT_PX * half;
#pragma unroll
    for (int m = 0; m < TC_OUT_PX * 8 / TC_WG; ++m) {
      const int e = wt + TC_WG * m, x = e / 8, chunk = e % 8;
      const int c = c0 + 8 * chunk;
      const uint4 v =
          *reinterpret_cast<const uint4*>(tile + out_chunk(x, chunk));
      if (xh + x >= W || c >= C) continue;
      __nv_bfloat16* op = orow + (size_t)(xh + x) * C + c;
      if ((C & 7) == 0) {
        *reinterpret_cast<uint4*>(op) = v;
      } else {
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c + k < C)
            op[k] = __ushort_as_bfloat16(
                (unsigned short)(w4[k / 2] >> (16 * (k % 2))));
      }
    }
    // The tile is read out before the next half overwrites it.
    asm volatile("bar.sync %0, 128;\n" :: "r"(bar) : "memory");
  }
}

// One pass of a consumer warpgroup over an output row: acc = out^T for
// the row's 64 channels of the band's tile x NR/2 pixels from x0, summed
// over dy < 7 and the k16 steps: A = B[dy] (the taps, 64 channels), B =
// the packed row y+dy at pixel x0. All the products are issued back to
// back, then waited for; a pass has no branch between its fence and its
// wait, so ptxas keeps the products in flight together.
template <int NR>
__device__ __forceinline__ void tc_pass(float (&acc)[NR],
                                        const uint32_t (&rows)[K], int x0,
                                        uint32_t taps, int KO,
                                        uint32_t block) {
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = 0.f;
  pin(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const uint32_t a0 = taps + dy * KO * 128;
    const uint32_t b0 = rows[dy] + x0 * 128;
    for (int ks = 0; ks < KO / 16; ++ks) {
      const uint32_t k_at = (ks & 3) * 32;     // k16 step within its block
      wgmma_m64k16(acc, smem_desc(a0 + ks * 2048),
                   smem_desc(b0 + (ks >> 2) * block + k_at));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(acc);
}

// The bf16 kernels' body: bands of P.PX pixels, each unit's rows as wide
// as its band; whole rows (stem_tc_kernel) are one band of W pixels.
__device__ __forceinline__ void tc_body(const uint16_t* __restrict__ w,
                                        const uint16_t* __restrict__ g,
                                        __nv_bfloat16* __restrict__ out,
                                        int H, int W, int O, int C,
                                        const TcPlan& P) {
  extern __shared__ __align__(1024) uint8_t tc_smem_raw[];
  // The swizzled tiles start at 1024-byte boundaries of the shared window.
  uint8_t* tc_smem =
      tc_smem_raw + (1024 - shared_address(tc_smem_raw) % 1024) % 1024;
  const uint32_t base = shared_address(tc_smem);
  const uint32_t ring = base + P.ring_at, stage = base + P.stage_at;
  const uint32_t full = base + P.bars_at;          // [ring]: a row is packed
  const uint32_t empty = full + 8 * P.ring;        // [ring]: consumers done
  const uint32_t landed = empty + 8 * P.ring;      // [TC_PACKERS]: a raw row
  const uint32_t g_landed = landed + 8 * TC_PACKERS;
  const uint32_t taps_done = g_landed + 8;
  const int tid = threadIdx.x;
  // The warpgroup, read through a shuffle so that ptxas sees it uniform
  // across the warp (the products' issue may not sit on a divergent path).
  const int wg = __shfl_sync(0xffffffffu, tid / TC_WG, 0);
  if (tid == 0) {
    for (int r = 0; r < P.ring; ++r) {
      mbar_init(full + 8 * r, 1);
      mbar_init(empty + 8 * r, 2);
    }
    for (int s = 0; s < TC_PACKERS; ++s) mbar_init(landed + 8 * s, 1);
    mbar_init(g_landed, 1);
    mbar_init(taps_done, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int Hp = H + K - 1, Wp = W + K - 1, KR = K * O, KC = P.KO / 8;
  const int row_len = Wp * O;                      // elements of a raw row
  uint32_t q = 0;       // input rows of the block's earlier bands
  int it = 0;           // the block's earlier bands
  for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++it) {
    const int per_image = P.CT * P.XT * P.bands;
    const int n = u / per_image;
    int r = u - n * per_image;
    const int ct = r / (P.XT * P.bands);
    r -= ct * P.XT * P.bands;
    const int xt = r / P.bands;
    const int ya = (r - xt * P.bands) * P.RB;
    // The unit's output pixels x0..x0+px-1, and the span of an input row
    // they read: px + 6 pixels from x0 (the whole row: x0 = 0, px = W).
    const int x0 = xt * P.PX;
    const int px = min(P.PX, W - x0);
    const int span = (px + K - 1) * O;
    const int rows = min(P.RB, H - ya), rows_in = rows + K - 1;
    const uint16_t* gn = g + (size_t)n * K * KR * C;
    const uint16_t* wn = w + ((size_t)n * Hp + ya) * row_len + (size_t)x0 * O;

    // The band's g[n] and each producer warp's first raw row in flight.
    // Producer warp pw packs the rows s = q+i with s % TC_PACKERS == pw,
    // each staged in its slot pw.
    const int pw = tid / 32 - 2 * TC_WG / 32, lane = tid % 32;
    const int first = (pw - (int)(q % TC_PACKERS) + TC_PACKERS) % TC_PACKERS;
    if (tid == 2 * TC_WG)
      load_span(base + P.g_at, gn, K * KR * C, g_landed);
    if (wg == 2 && lane == 0 && first < rows_in)
      load_span(stage + pw * P.stage, wn + (size_t)first * row_len, span,
                landed + 8 * pw);
    if (wg == 2) {
      // Producer warp pw: its rows i into ring slot (q+i) % ring once both
      // consumers are done with the slot's previous row. The four warps
      // pack four rows at once, each a chain of shared-memory round trips.
      for (int i = first; i < rows_in; i += TC_PACKERS) {
        const uint32_t s = q + i, ss = pw, rs = s % P.ring;
        mbar_wait(landed + 8 * ss, (s / TC_PACKERS) & 1);
        mbar_wait(empty + 8 * rs, ((s / P.ring) & 1) ^ 1);
        // Slots from g_slot on hold the staged g[n] until B is built.
        if ((int)rs >= P.g_slot) mbar_wait(taps_done, it & 1);
        tc_pack_row(tc_smem + P.ring_at + rs * P.slot,
                    reinterpret_cast<const uint32_t*>(tc_smem + P.stage_at +
                                                      ss * P.stage),
                    span_lead(wn + (size_t)i * row_len), px, O, KC, KR,
                    P.block, lane);
        fence_async_shared();
        // Every lane has written its chunks and is done reading the
        // staging slot: one signals the row and refills the slot.
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(full + 8 * rs);
          if (i + TC_PACKERS < rows_in)
            load_span(stage + ss * P.stage,
                      wn + (size_t)(i + TC_PACKERS) * row_len, span,
                      landed + 8 * ss);
        }
      }
    } else {
      // The consumers build B from the staged g[n] while the producer
      // packs the band's first rows into the slots below it.
      mbar_wait(g_landed, it & 1);
      tc_stage_taps(tc_smem,
                    reinterpret_cast<const uint16_t*>(tc_smem + P.g_at),
                    span_lead(gn), P.KO, KR, C, ct * TC_NC);
      fence_async_shared();
      asm volatile("bar.sync 4, 256;\n" ::: "memory");
      if (tid == 0) mbar_arrive(taps_done);
      // Consumer warpgroup wg: output rows ya+wg, ya+wg+2, ... A row
      // needs packed rows i..i+6; after it the warpgroup releases the rows
      // below its next output row (a slot is refilled once both have).
      // Rows are released only after they were waited for, so an arrival
      // always counts toward the slot's current use.
      const int wt = tid % TC_WG;
      const int wq = wt / 32;
      const uint32_t taps = base;
      uint32_t waited = q, released = q;
      // Releases the rows below `upto`: once all four warps are past their
      // products' wait, one thread arrives for the warpgroup.
      auto release = [&](uint32_t upto) {
        if (wg == 0) asm volatile("bar.sync 2, 128;\n" ::: "memory");
        else asm volatile("bar.sync 3, 128;\n" ::: "memory");
        for (; released < upto; ++released)
          if (wt == 0) mbar_arrive(empty + 8 * (released % P.ring));
      };
      for (int i = wg; i < rows; i += 2) {
        for (; waited < q + i + K; ++waited)
          mbar_wait(full + 8 * (waited % P.ring), (waited / P.ring) & 1);
        uint32_t in_rows[K];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
          in_rows[dy] = ring + ((q + i + dy) % P.ring) * P.slot;
        __nv_bfloat16* orow =
            out + (((size_t)n * H + ya + i) * W + x0) * C;
        const int c0 = ct * TC_NC;
        uint8_t* tile = tc_smem + P.out_at + wg * TC_OUT_PX * 128;
        // Passes of 128 pixels (n128), the last one of 64 (n64) when no
        // more are left.
        for (int xp = 0; xp < px; xp += 128) {
          if (px - xp > 64) {
            float acc[64];
            tc_pass(acc, in_rows, xp, taps, P.KO, P.block);
            tc_store(acc, tile, orow, xp, px, C, c0, wq, lane, wt, 2 + wg);
          } else {
            float acc[32];
            tc_pass(acc, in_rows, xp, taps, P.KO, P.block);
            tc_store(acc, tile, orow, xp, px, C, c0, wq, lane, wt, 2 + wg);
          }
        }
        release(q + i + 2);
      }
      for (; waited < q + rows_in; ++waited)
        mbar_wait(full + 8 * (waited % P.ring), (waited / P.ring) & 1);
      release(q + rows_in);
    }
    q += rows_in;
    // The band is done: its ring and staging slots are free for the next.
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
stem_tc_kernel(const uint16_t* __restrict__ w, const uint16_t* __restrict__ g,
               __nv_bfloat16* __restrict__ out, int H, int W, int O, int C,
               TcPlan P) {
  tc_body(w, g, out, H, W, O, C, P);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
stem_tc_banded_kernel(const uint16_t* __restrict__ w,
                      const uint16_t* __restrict__ g,
                      __nv_bfloat16* __restrict__ out, int H, int W, int O,
                      int C, TcPlan P) {
  tc_body(w, g, out, H, W, O, C, P);
}

struct TcLaunch {
  TcPlan plan;
  int grid;
};

// The plan and grid of a launch at this shape on the current card: whole
// rows where a ring of them fits, else bands (L.plan.banded);
// cudaErrorInvalidValue if neither fits a block's shared memory.
cudaError_t tc_launch_plan(int N, int H, int W, int O, int C, TcLaunch& L) {
  int device = 0;
  DeviceInfo info;
  cudaError_t err = device_info(device, info);
  if (err != cudaSuccess) return err;
  if (tc_plan(N, H, W, O, C, info.sms, info.max_smem, L.plan)) {
    L.grid = std::min(L.plan.units, info.sms);
    return allow_smem((const void*)stem_tc_kernel, KERNEL_TC, device,
                      L.plan.total);
  }
  if (!tc_banded_plan(N, H, W, O, C, info.sms, info.max_smem, L.plan))
    return cudaErrorInvalidValue;
  L.grid = std::min(L.plan.units, info.sms);
  return allow_smem((const void*)stem_tc_banded_kernel, KERNEL_TC_BANDED,
                    device, L.plan.total);
}

// The kernel of a plan: stem_tc_kernel, or stem_tc_banded_kernel.
inline const void* tc_kernel(const TcPlan& P) {
  return P.banded ? (const void*)stem_tc_banded_kernel
              : (const void*)stem_tc_kernel;
}

cudaError_t launch_tc(const void* w, const void* g, void* out, int N, int H,
                      int W, int O, int C, cudaStream_t stream,
                      int* launched) {
  TcLaunch L;
  const cudaError_t err = tc_launch_plan(N, H, W, O, C, L);
  if (err != cudaSuccess) return err;
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  const uint16_t* gb = static_cast<const uint16_t*>(g);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (L.plan.banded) {
    stem_tc_banded_kernel<<<L.grid, TC_THREADS, L.plan.total, stream>>>(
        wb, gb, ob, H, W, O, C, L.plan);
    *launched = STEM_TC_BANDED;
  } else {
    stem_tc_kernel<<<L.grid, TC_THREADS, L.plan.total, stream>>>(
        wb, gb, ob, H, W, O, C, L.plan);
    *launched = STEM_TC;
  }
  return cudaGetLastError();
}

// --- float32: warpgroup products in 3xTF32 -------------------------------

constexpr int F32_WG = 128;              // threads of a warpgroup
constexpr int F32_THREADS = 3 * F32_WG;  // consumers 0 and 1, producer 2
constexpr int F32_CONSUMERS = 2 * F32_WG;
constexpr int F32_NC = 64;               // channels of a product (wgmma's M)
constexpr int F32_RING_MAX = 3;          // packed rows resident, at most

// The launch's plan: a band of PX pixels (64, or 32 where 64 does not
// fit) of RB output rows of one image and channel tile is a unit, and
// where its tiles lie in dynamic shared memory (byte offsets): the taps
// [7 dx][CS channels][RS chunks] at 0 (a chunk is 4 k; k = dy*O + o), then
// a ring of packed rows at taps, each [KC chunks][XP pixels] of the high
// parts, then the same of the low parts; then the mbarriers (full[ring],
// empty[ring]); then each chunk's 4 element offsets in an input pixel.
struct F32Plan {
  int PX;           // pixels of a band and of a product (wgmma's N)
  int XP;           // pixels of a packed row: PX + 6
  int KC;           // chunks of a tap row and of a packed pixel: 7*O / 4, up
  int RS;           // chunks a tap row takes: KC if swizzled, else KC | 1
  int CS;           // tap rows staged: C rounded up to 16, at most 64
  int CT, XT;       // channel tiles of 64, pixel bands of PX
  int RB, bands;    // output rows of a band, bands of an image's column
  int units;        // N * CT * XT * bands
  int ring;         // packed rows resident: 3, or 2 where 3 do not fit
  FastDiv by_O;
  uint32_t taps;    // bytes of the taps
  uint32_t slot;    // bytes of a packed row: high, then low parts
  uint32_t bars_at, koff_at, total;
};

inline bool f32_plan_at(int N, int H, int W, int O, int C, int sms,
                        int max_smem, int PX, F32Plan& P) {
  P.PX = PX;
  P.XP = PX + K - 1;
  P.KC = round_up(K * O, 8) / 4;
  P.RS = P.KC % 8 == 0 ? P.KC : (P.KC | 1);
  P.CS = std::min(F32_NC, round_up(C, 16));
  P.CT = (C + F32_NC - 1) / F32_NC;
  P.XT = (W + PX - 1) / PX;
  const int columns = N * P.CT * P.XT;
  const int per_column = std::min(H, std::max(1, sms / columns));
  P.RB = (H + per_column - 1) / per_column;
  P.bands = (H + P.RB - 1) / P.RB;
  P.units = columns * P.bands;
  P.by_O = fast_div(O);
  const size_t taps = (size_t)K * P.CS * P.RS * 16;
  const size_t slot = (size_t)2 * P.KC * P.XP * 16;
  for (int ring = F32_RING_MAX; ring >= 2; --ring) {
    const size_t bars_at = taps + ring * slot;
    const size_t koff_at = bars_at + 2 * 8 * ring;
    const size_t total = koff_at + (size_t)P.KC * 16;
    if (total <= (size_t)max_smem) {
      P.ring = ring;
      P.taps = (uint32_t)taps;
      P.slot = (uint32_t)slot;
      P.bars_at = (uint32_t)bars_at;
      P.koff_at = (uint32_t)koff_at;
      P.total = (uint32_t)total;
      return true;
    }
  }
  return false;
}

// Bands of 64 pixels where their tiles fit a block's shared memory, else of
// 32; false if neither fits.
inline bool f32_plan(int N, int H, int W, int O, int C, int sms,
                     int max_smem, F32Plan& P) {
  return f32_plan_at(N, H, W, O, C, sms, max_smem, 64, P) ||
         f32_plan_at(N, H, W, O, C, sms, max_smem, 32, P);
}

// A wgmma matrix descriptor of a K-major operand without swizzle: core
// matrices of 8 rows of 16 bytes (a row: one pixel's 4 k), the rows of one
// core matrix contiguous, k_stride bytes from one 4-k chunk to the next
// (the leading dimension) and 128 from one 8 rows to the next (the
// stride dimension). A start 16*dx bytes on is the same operand dx pixels
// on: the dx shift of the stem's sum.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr,
                                               uint32_t k_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(k_stride >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// d += A * B: m64nNk8 in tf32, A (4 registers a thread: rows 16w + l/4
// (+8), k l%4 (+4)) from registers, B by descriptor, f32 sums. A tf32
// operand's low 13 bits are not read.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// x rounded to tf32 (to nearest, ties away: its 13 low mantissa bits
// rounded off), in integer arithmetic (cvt.rna.tf32 issues at a fraction
// of the rate).
__device__ __forceinline__ uint32_t tf32_round(uint32_t raw) {
  return (raw + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of an f32 word: hi = x rounded to tf32 and lo = x - hi
// (exact in f32) rounded to tf32 too, so that the tensor cores, which read
// a tf32 operand truncated (its 13 low bits ignored), read both exactly:
// hi + lo is x to within 2^-22 of it, and the dropped lo*lo term is as
// small. Rounding, not truncating, keeps the errors unbiased: truncated
// parts err the same way in every product, so that a sum of many positive
// products drifts by their count times the error of one.
__device__ __forceinline__ void tf32_split(uint32_t raw, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(raw);
  lo = tf32_round(__float_as_uint(__uint_as_float(raw) -
                                  __uint_as_float(hi)));
}

// The taps of channels c0.. for one image: T[dx][c][chunk j] = g[n, dy, dx,
// o, c0 + c] for k = 4j + q = dy*O + o, zero for k >= 7*O or c0 + c >= C.
// A thread a chunk, lanes over channels (coalesced reads), every element a
// 4-byte cp.async (zero-filled where there is no source). The chunks of a
// row are swizzled (chunk ^ c & 7 within groups of 8) or the row takes an
// odd number of chunks, so that ldmatrix's 8 rows fall in 8 bank groups.
// The consumers' threads.
__device__ __forceinline__ void f32_stage_taps(uint8_t* smem,
                                               const float* gn, int O, int C,
                                               int c0, const F32Plan& P) {
  const int KR = K * O, chunks = K * P.KC * P.CS;
  for (int i = threadIdx.x; i < chunks; i += F32_CONSUMERS) {
    const int c = i % P.CS, r = i / P.CS;       // r = dx * KC + j
    const int dx = r / P.KC, j = r - dx * P.KC;
    const int at = P.RS == P.KC ? swizzle(j, c) : j;
    float* d = reinterpret_cast<float*>(
        smem + ((dx * P.CS + c) * P.RS + at) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * j + q, dy = k / P.by_O, o = k - dy * O;
      const bool real = k < KR && c0 + c < C;
      cp_async4(d + q, real ? gn + ((dy * K + dx) * O + o) * C + c0 + c : gn,
                real);
    }
  }
}

// Packs the operand of one output row y: slot[j][x] = the chunk of
// w_pad[n, y+dy, x0+x, o] for k = 4j..4j+3 (k = dy*O + o; zero for k >=
// 7*O or x0+x >= W+6) split into high parts, and at lo_at their low
// parts, XP pixels. src is w_pad[n, y, x0]; its 7 rows (2.5 KB each at the
// serving shape) are read through L1, where the 7 output rows that use
// each of them find it; koff[j] holds chunk j's 4 element offsets from a
// pixel's first element of row y (dy*row_len + o, or -1 past 7*O). The
// producer's threads, lanes over pixels, each thread's loads issued
// before its stores.
template <int XP>
__device__ __forceinline__ void f32_pack_row(uint8_t* slot, uint32_t lo_at,
                                             const float* src, int valid_px,
                                             const int4* koff, int O,
                                             const F32Plan& P, int wt) {
  constexpr int U = 3;                     // chunks a thread takes at once
  const int chunks = P.KC * XP;
  for (int i0 = wt; i0 < chunks; i0 += U * F32_WG) {
    float v[U][4];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int i = i0 + m * F32_WG;
      const int j = i / XP, x = i - j * XP;
      const int4 off = koff[min(j, P.KC - 1)];
      const int offs[4] = {off.x, off.y, off.z, off.w};
      const bool on = i < chunks && x < valid_px;
      const float* px = src + x * O;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[m][q] = on && offs[q] >= 0 ? __ldg(px + offs[q]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int i = i0 + m * F32_WG;
      if (i >= chunks) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tf32_split(__float_as_uint(v[m][q]), hi[q], lo[q]);
      *reinterpret_cast<uint4*>(slot + i * 16) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(slot + lo_at + i * 16) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// Step s's A fragments of every dx (ldmatrix of the taps' row at at, dx
// dx_bytes on), split in registers.
__device__ __forceinline__ void f32_frags(uint32_t (&hi)[K][4],
                                          uint32_t (&lo)[K][4], uint32_t at,
                                          uint32_t dx_bytes, bool a_on) {
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    uint32_t raw[4];
    ldmatrix_x4(raw, at + dx * dx_bytes);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32_split(a_on ? raw[i] : 0u, hi[dx][i], lo[dx][i]);
  }
}

// Step s's products, one group: for each dx, a_lo*b_hi, a_hi*b_lo and
// a_hi*b_hi (the small terms first), b the packed row read dx pixels on
// (b_hi, b_lo: its chunks 2s, 2s+1).
template <int NR>
__device__ __forceinline__ void f32_step(float (&acc)[NR],
                                         const uint32_t (&hi)[K][4],
                                         const uint32_t (&lo)[K][4],
                                         uint64_t b_hi, uint64_t b_lo) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    wgmma_tf32(acc, lo[dx], b_hi + dx);
    wgmma_tf32(acc, hi[dx], b_lo + dx);
    wgmma_tf32(acc, hi[dx], b_hi + dx);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// One output row of a warpgroup: acc = out^T (64 channels x PX pixels)
// over the k8 steps s and, inside each, dx: a fixed order. A step's A
// fragments (the taps of channels 16w.. at k 8s..8s+7 of each dx) are
// loaded and split into one of two register sets while the step before
// runs, after the step that last used the set is done; its 21 products
// are issued behind one fence and waited for as one group.
template <int PX>
__device__ __forceinline__ void f32_row(float (&acc)[PX / 2], uint32_t a_at,
                                        int a_row, int a_kc, bool a_on,
                                        uint32_t hi_at, uint32_t lo_at,
                                        const F32Plan& P) {
#pragma unroll
  for (int e = 0; e < PX / 2; ++e) acc[e] = 0.f;
  pin(acc);
  const uint32_t k_stride = (uint32_t)(PX + K - 1) * 16;
  // In 16-byte units a step is two chunks of the packed row further on.
  const uint64_t step = 2 * (k_stride >> 4);
  const uint64_t b_hi = plain_desc(hi_at, k_stride);
  const uint64_t b_lo = plain_desc(hi_at + lo_at, k_stride);
  const uint32_t dx_bytes = (uint32_t)P.CS * P.RS * 16;
  const bool swizzled = P.RS == P.KC;
  auto tap_at = [&](int s) {
    const int j = 2 * s + a_kc;
    return a_at + (uint32_t)(swizzled ? swizzle(j, a_row) : j) * 16;
  };
  const int steps = P.KC / 2;
  uint32_t hi0[K][4], lo0[K][4], hi1[K][4], lo1[K][4];
  f32_frags(hi0, lo0, tap_at(0), dx_bytes, a_on);
  for (int s = 0; s < steps; s += 2) {
    f32_step(acc, hi0, lo0, b_hi + s * step, b_lo + s * step);
    if (s + 1 < steps) {
      wgmma_wait<1>();                 // step s-1, the last to read set 1
      f32_frags(hi1, lo1, tap_at(s + 1), dx_bytes, a_on);
      f32_step(acc, hi1, lo1, b_hi + (s + 1) * step, b_lo + (s + 1) * step);
    }
    if (s + 2 < steps) {
      wgmma_wait<1>();                 // step s, the last to read set 0
      f32_frags(hi0, lo0, tap_at(s + 2), dx_bytes, a_on);
    }
  }
  wgmma_wait<0>();
  pin(acc);
}

// Stores a row's sums (lane l of warp w: channels 16w + l/4 (+8), pixels
// 8j + 2(l%4) (+1)): a warp's store covers 8 channels of 4 pixels, four
// whole 32-byte sectors. orow is out[n, y, x0, c0]; px pixels and cc
// channels of the tile are real.
template <int PX>
__device__ __forceinline__ void f32_store(const float (&acc)[PX / 2],
                                          float* orow, int px, int cc, int C,
                                          int warp, int lane) {
#pragma unroll
  for (int j = 0; j < PX / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * warp + lane / 4 + 8 * h;
        const int x = 8 * j + 2 * (lane % 4) + e;
        if (c < cc && x < px) orow[(size_t)x * C + c] = acc[4 * j + 2 * h + e];
      }
}

template <int PX>
__global__ void __launch_bounds__(F32_THREADS, 1)
stem_f32_kernel(const float* __restrict__ w, const float* __restrict__ g,
                float* __restrict__ out, int H, int W, int O, int C,
                F32Plan P) {
  constexpr int XP = PX + K - 1;
  extern __shared__ __align__(128) uint8_t f32_smem[];
  const uint32_t base = shared_address(f32_smem);
  const int tid = threadIdx.x;
  // The warpgroup, read through a shuffle so that ptxas sees it uniform
  // across the warp (the products' issue may not sit on a divergent path).
  const int wg = __shfl_sync(0xffffffffu, tid / F32_WG, 0);
  const int wt = tid % F32_WG, warp = wt / 32, lane = tid % 32;
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int row_len = Wp * O;
  const uint32_t lo_at = P.slot / 2;
  const uint32_t full = base + P.bars_at;          // [ring]: a row is packed
  const uint32_t empty = full + 8 * P.ring;        // [ring]: its products done
  if (tid == 0) {
    for (int r = 0; r < P.ring; ++r) {
      mbar_init(full + 8 * r, 1);
      mbar_init(empty + 8 * r, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_image = P.CT * P.XT * P.bands;
  auto unit = [&](int u, int& n, int& ct, int& xt, int& ya) {
    n = u / per_image;
    int r = u - n * per_image;
    ct = r / (P.XT * P.bands);
    r -= ct * P.XT * P.bands;
    xt = r / P.bands;
    ya = (r - xt * P.bands) * P.RB;
  };

  uint32_t q = 0;       // output rows of the block's earlier units
  if (wg == 2) {
    // The producer: every output row of the block's units, in order, into
    // ring slot (q+i) % ring once the consumer of its previous row is done
    // with it. Few registers: the consumers get the rest.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int* koff = reinterpret_cast<int*>(f32_smem + P.koff_at);
    for (int k = wt; k < 4 * P.KC; k += F32_WG) {
      const int dy = k / P.by_O;
      koff[k] = k < K * O ? dy * row_len + k - dy * O : -1;
    }
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
    for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
      int n, ct, xt, ya;
      unit(u, n, ct, xt, ya);
      const int rows = min(P.RB, H - ya), x0 = xt * PX;
      const float* wn = w + ((size_t)n * Hp * Wp + x0) * O;
      for (int i = 0; i < rows; ++i) {
        const uint32_t s = q + i, rs = s % P.ring;
        mbar_wait(empty + 8 * rs, ((s / P.ring) & 1) ^ 1);
        f32_pack_row<XP>(f32_smem + P.taps + rs * P.slot, lo_at,
                         wn + (size_t)(ya + i) * row_len, Wp - x0,
                         reinterpret_cast<const int4*>(koff), O, P, wt);
        fence_async_shared();
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
        if (wt == 0) mbar_arrive(full + 8 * rs);
      }
      q += rows;
    }
    return;
  }

  // The consumers: warpgroup wg takes rows ya+wg, ya+wg+2, ... of each
  // unit, after the two have staged the unit's taps.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // This lane's ldmatrix row of the taps: lanes 0-15 give channels 16w +
  // 0..15 at k 0-3 of a step, lanes 16-31 the same at k 4-7 (matrices a0,
  // a1, a2, a3 of the fragment); rows past CS read row CS-1 and are zeroed.
  const int a_row = 16 * warp + (lane & 15), a_kc = lane >> 4;
  const bool a_on = a_row < P.CS;
  const uint32_t a_at = base + (uint32_t)(min(a_row, P.CS - 1) * P.RS) * 16;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
    int n, ct, xt, ya;
    unit(u, n, ct, xt, ya);
    const int rows = min(P.RB, H - ya);
    const int c0 = ct * F32_NC, x0 = xt * PX;
    const int px = min(PX, W - x0), cc = min(F32_NC, C - c0);
    // Both are done with the previous unit's taps; then the unit's.
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
    f32_stage_taps(f32_smem, g + (size_t)n * K * K * O * C, O, C, c0, P);
    cp_async_wait_all();
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
    for (int i = wg; i < rows; i += 2) {
      const uint32_t s = q + i, rs = s % P.ring;
      mbar_wait(full + 8 * rs, (s / P.ring) & 1);
      float acc[PX / 2];
      f32_row<PX>(acc, a_at, a_row, a_kc, a_on,
                  base + P.taps + rs * P.slot, lo_at, P);
      // Every warp's products are done with the slot: one thread frees it.
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (wt == 0) mbar_arrive(empty + 8 * rs);
      f32_store<PX>(acc, out + (((size_t)n * H + ya + i) * W + x0) * C + c0,
                    px, cc, C, warp, lane);
    }
    q += rows;
  }
}

struct F32Launch {
  F32Plan plan;
  int grid;
};

cudaError_t f32_launch_plan(int N, int H, int W, int O, int C,
                            F32Launch& L) {
  int device = 0;
  DeviceInfo info;
  cudaError_t err = device_info(device, info);
  if (err != cudaSuccess) return err;
  if (!f32_plan(N, H, W, O, C, info.sms, info.max_smem, L.plan))
    return cudaErrorInvalidValue;
  L.grid = std::min(L.plan.units, info.sms);
  return L.plan.PX == 64
             ? allow_smem((const void*)stem_f32_kernel<64>, KERNEL_F32_64,
                          device, L.plan.total)
             : allow_smem((const void*)stem_f32_kernel<32>, KERNEL_F32_32,
                          device, L.plan.total);
}

cudaError_t launch_f32(const void* w, const void* g, void* out, int N, int H,
                       int W, int O, int C, cudaStream_t stream,
                       int* launched) {
  F32Launch L;
  const cudaError_t err = f32_launch_plan(N, H, W, O, C, L);
  if (err != cudaSuccess) return err;
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(g);
  float* of = static_cast<float*>(out);
  if (L.plan.PX == 64)
    stem_f32_kernel<64><<<L.grid, F32_THREADS, L.plan.total, stream>>>(
        wf, gf, of, H, W, O, C, L.plan);
  else
    stem_f32_kernel<32><<<L.grid, F32_THREADS, L.plan.total, stream>>>(
        wf, gf, of, H, W, O, C, L.plan);
  *launched = STEM_F32;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (stem_f32_kernel), 1 = bfloat16 (stem_tc_kernel, or
// stem_tc_banded_kernel where whole rows do not fit). Sets *launched to
// the kernel that ran (KernelLaunched) and returns cudaGetLastError() of
// the launch.
int sg_stem(const void* w, const void* g, void* out, int N, int H, int W,
            int O, int C, int dtype, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(w, g, out, N, H, W, O, C, s, launched);
  if (dtype == 1) return launch_tc(w, g, out, N, H, W, O, C, s, launched);
  return cudaErrorInvalidValue;
}

// The bf16 launch at this shape on the current card, launching nothing:
// info[0..8] = registers a thread, dynamic shared memory (bytes), blocks
// an SM, grid, packed rows resident, output rows a band, local memory a
// thread (bytes), threads a block, pixels a band (0: whole rows,
// stem_tc_kernel). Returns a CUDA error code.
int sg_stem_tc_config(int N, int H, int W, int O, int C, int* info) {
  TcLaunch L;
  cudaError_t err = tc_launch_plan(N, H, W, O, C, L);
  cudaFuncAttributes a;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, tc_kernel(L.plan));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tc_kernel(L.plan), TC_THREADS, L.plan.total);
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = (int)L.plan.total;
  info[2] = blocks;
  info[3] = L.grid;
  info[4] = L.plan.ring;
  info[5] = L.plan.RB;
  info[6] = (int)a.localSizeBytes;
  info[7] = TC_THREADS;
  info[8] = L.plan.banded ? L.plan.PX : 0;
  return 0;
}

// The f32 kernel's launch at this shape on the current card, launching
// nothing: info[0..7] = registers a thread, dynamic shared memory (bytes),
// blocks an SM, grid, pixels a band, output rows a band, local memory a
// thread (bytes), threads a block. Returns a CUDA error code.
int sg_stem_f32_config(int N, int H, int W, int O, int C, int* info) {
  F32Launch L;
  cudaError_t err = f32_launch_plan(N, H, W, O, C, L);
  if (err != cudaSuccess) return err;
  const void* kernel = L.plan.PX == 64 ? (const void*)stem_f32_kernel<64>
                                       : (const void*)stem_f32_kernel<32>;
  cudaFuncAttributes a;
  int blocks = 0;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, F32_THREADS, L.plan.total);
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = (int)L.plan.total;
  info[2] = blocks;
  info[3] = L.grid;
  info[4] = L.plan.PX;
  info[5] = L.plan.RB;
  info[6] = (int)a.localSizeBytes;
  info[7] = F32_THREADS;
  return 0;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
