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
//   * A block is three warpgroups. Warpgroup 2 produces: each of its warps
//     packs every 4th input row, its raw row brought by one bulk copy of the
//     16-byte-aligned span that holds it (a row of w_pad is (W+6)*O*2 bytes,
//     2412 at the serving shape, so rows and bases are not 16-byte aligned;
//     the span starts and ends inside the 16-byte granules of the row's first
//     and last bytes, which lie in the row's own allocation, so nothing past
//     it is read), completing on an mbarrier, into a ring of 7-9 packed rows
//     (an mbarrier pair a slot: full, empty). Four warps keep four rows in
//     flight: packing is a chain of shared-memory round trips that the
//     products' operand reads slow down. Warpgroups 0 and 1 consume, even
//     and odd output rows: wait for the rows they need, issue the pass's
//     products back to back, wait, release the rows they are done with, and
//     store while the producer packs ahead and the other consumer's products
//     run. The store rounds to bf16 once; stmatrix.trans writes each 8x8
//     block (8 channels x 8 pixels) transposed into the warpgroup's 64-pixel
//     tile, a pixel's channels 16-byte rows (swizzled by pixel & 7), and the
//     warpgroup then writes whole pixels out, consecutive lanes on
//     consecutive bytes: stored straight from the fragments, a warp's 32
//     16-byte pieces would lie 128 bytes apart.
//   * The grid is persistent and balanced: the images' output rows are cut
//     into bands, SMs/(N*CT) of them an image (CT = channel tiles of 64), so
//     that the bands fill at most one block an SM (shared memory allows one):
//     at the serving shape 8 bands of 16 rows an image, 128 blocks, one
//     wave. With more images than SMs a block walks several bands. At a
//     band's start g[n] arrives by one bulk copy at the end of the ring's
//     space; the consumers stage B from it while the producer packs the
//     band's first rows into the slots below it (it waits for B only before
//     a slot that overlaps g), so g[n] is read once a band, not a row.
// Every output is summed by one warpgroup in a fixed order, with no atomics:
// a call is bitwise repeatable. Ragged edges: a packed row holds W pixels
// (rounded up to 8) and the last pass's pixels past W read what follows it
// (finite or not, it reaches only its own columns of the product, which are
// not stored); k past 7*O is zero in both operands; channels past C are
// zero in B and not stored.
//
// float32: stem_f32_kernel, on the tensor cores in 3xTF32. Plain TF32
// (10 mantissa bits) would spend the f32 card-vs-CPU margins, so every
// operand is split after its fragment is loaded, hi = x rounded to tf32
// and lo = x - hi, and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (the small terms first) by mma.sync m16n8k8 tf32 with f32 sums: about 21
// bits of each product, f32 sums. So the bound is three TF32 products a
// multiply-add: 3 x 14.8 GFLOP at the dense TF32 rate, about 0.09 ms at
// the serving shape. It packs as the TPU kernel does (dy in k), in f32 tiles:
//   * wE[ty][x][k] (k = dy*O + o, KS = 7*O rounded up to 32 floats a
//     pixel), gathered straight from w_pad[n] (no o-major copy: in f32 a
//     pixel's 9 channels are 36 contiguous bytes of one row);
//   * gB[dx][c][k], c-major: ldmatrix moves 16-bit elements and .trans
//     would tear the f32 words, so B is stored with k contiguous and read
//     untransposed, an 8x8 b16 matrix being 8 rows of 4 f32 words, one a
//     lane, which is the tf32 fragment (k = lane % 4, c = lane / 4);
//   * the dx shift: A_dx is wE read dx pixel rows further on, which
//     ldmatrix takes at any 16-byte-aligned row, and a 16-byte-chunk swizzle
//     (chunk ^ row & 7) of every 128 bytes against bank conflicts.
// f32 doubles every tile, and all of g[n] (7 x 64 x 64 floats, 112 KB at
// the serving shape) stays resident, so a block owns TH_F32 = 2 output
// rows at a time (183 KB of shared memory at the serving shape, one block
// an SM). Blocks are persistent over the row pairs of one image: g[n] is
// staged once a block, and only wE for each pair. Its 8 warps each own one
// row of the pair, one half of the pixels in passes of 64 and one half of
// every 64 channels (MT x NT = 4 x 4 fragments, 64 f32 sums a lane), with
// each step's fragments loaded during the step before and the three
// products issued as three rounds over the 16 tiles. The split is integer
// and f32 arithmetic (cvt.rna.tf32 issues at a fraction of the rate and
// held the first version to the old kernel's time). No atomics and a fixed
// order of the three products and of k: a call is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

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

// --- bfloat16: warpgroup products -------------------------------------------

constexpr int TC_WG = 128;             // threads of a warpgroup
constexpr int TC_THREADS = 3 * TC_WG;  // consumers 0 and 1, producer 2
constexpr int TC_NC = 64;              // channels of a product (wgmma's N)
constexpr int TC_PACKERS = 4;          // producer warps: a row each at a time,
                                       // its raw row staged in a slot of its own
constexpr int TC_OUT_PX = 64;          // pixels of a consumer's output tile
constexpr int TC_RING_MAX = 9;         // packed rows resident, at most

// The launch's plan: its bands and where its tiles lie in dynamic shared
// memory (byte offsets from its first 1024-byte boundary): the taps
// [dy][KO k-rows][64 channels] (MN-major) at 0, the ring of packed rows
// [ring][k-blocks][WP pixels][64 k] (K-major) at ring_at, g[n] staged at a
// band's start at g_at (the end of the ring's space), the raw rows'
// staging slots at stage_at, the consumers' output tiles [2][64 pixels][64
// channels] at out_at, the mbarriers at bars_at (full[ring], empty[ring],
// landed[TC_PACKERS], g_landed, taps_done). Rows are 128 bytes, swizzled.
struct TcPlan {
  int KO;           // k of a product: 7*O rounded up to 16
  int CT;           // channel tiles of 64
  int RB;           // output rows of a band
  int bands;        // bands of an image
  int units;        // bands of the launch: N * CT * bands
  int ring;         // packed rows resident: 7 to 9
  uint32_t block;   // bytes of a k-block of a packed row: WP * 128
  uint32_t slot;    // bytes of a packed row: its k-blocks
  uint32_t stage;   // bytes of a staging slot
  uint32_t ring_at, g_at, stage_at, out_at, bars_at, total;
  int g_slot;       // the first ring slot that overlaps the staged g[n]
};

inline size_t round_up_size(size_t v, size_t m) { return (v + m - 1) / m * m; }

// Fills P for the shape on a card of sms SMs and max_smem bytes of shared
// memory a block; false if even a ring of 7 packed rows does not fit.
inline bool tc_plan(int N, int H, int W, int O, int C, int sms, int max_smem,
                    TcPlan& P) {
  P.KO = round_up(K * O, 16);
  P.CT = (C + TC_NC - 1) / TC_NC;
  const int per_image = std::min(H, std::max(1, sms / (N * P.CT)));
  P.RB = (H + per_image - 1) / per_image;
  P.bands = (H + P.RB - 1) / P.RB;
  P.units = N * P.CT * P.bands;
  P.block = (uint32_t)round_up(W, 8) * 128;
  P.slot = (P.KO + 63) / 64 * P.block;   // k-blocks of 64 k
  // A span starts up to 14 bytes before its row; the packing reads up to
  // 33 bytes past a row's last byte (masked).
  P.stage = (uint32_t)round_up_size((size_t)(W + K - 1) * O * 2 + 48, 16);
  const size_t taps = (size_t)K * P.KO * 128;
  const size_t g_bytes = (size_t)K * K * O * C * 2 + 64;
  // The last pass of a row reads up to round_up(W, 64) pixels: past the
  // last slot, that many more bytes must lie inside the allocation.
  const size_t overrun = (size_t)(round_up(W, 64) - round_up(W, 8)) * 128;
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

__global__ void __launch_bounds__(TC_THREADS, 1)
stem_tc_kernel(const uint16_t* __restrict__ w, const uint16_t* __restrict__ g,
               __nv_bfloat16* __restrict__ out, int H, int W, int O, int C,
               TcPlan P) {
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
    const int per_image = P.CT * P.bands;
    const int n = u / per_image, r = u - n * per_image;
    const int ct = r / P.bands, ya = (r - ct * P.bands) * P.RB;
    const int rows = min(P.RB, H - ya), rows_in = rows + K - 1;
    const uint16_t* gn = g + (size_t)n * K * KR * C;
    const uint16_t* wn = w + ((size_t)n * Hp + ya) * row_len;

    // The band's g[n] and each producer warp's first raw row in flight.
    // Producer warp pw packs the rows s = q+i with s % TC_PACKERS == pw,
    // each staged in its slot pw.
    const int pw = tid / 32 - 2 * TC_WG / 32, lane = tid % 32;
    const int first = (pw - (int)(q % TC_PACKERS) + TC_PACKERS) % TC_PACKERS;
    if (tid == 2 * TC_WG)
      load_span(base + P.g_at, gn, K * KR * C, g_landed);
    if (wg == 2 && lane == 0 && first < rows_in)
      load_span(stage + pw * P.stage, wn + (size_t)first * row_len, row_len,
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
                    span_lead(wn + (size_t)i * row_len), W, O, KC, KR,
                    P.block, lane);
        fence_async_shared();
        // Every lane has written its chunks and is done reading the
        // staging slot: one signals the row and refills the slot.
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(full + 8 * rs);
          if (i + TC_PACKERS < rows_in)
            load_span(stage + ss * P.stage,
                      wn + (size_t)(i + TC_PACKERS) * row_len, row_len,
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
        __nv_bfloat16* orow = out + ((size_t)n * H + ya + i) * W * C;
        const int c0 = ct * TC_NC;
        uint8_t* tile = tc_smem + P.out_at + wg * TC_OUT_PX * 128;
        // Passes of 128 pixels (n128), the last one of 64 (n64) when no
        // more are left.
        for (int x0 = 0; x0 < W; x0 += 128) {
          if (W - x0 > 64) {
            float acc[64];
            tc_pass(acc, in_rows, x0, taps, P.KO, P.block);
            tc_store(acc, tile, orow, x0, W, C, c0, wq, lane, wt, 2 + wg);
          } else {
            float acc[32];
            tc_pass(acc, in_rows, x0, taps, P.KO, P.block);
            tc_store(acc, tile, orow, x0, W, C, c0, wq, lane, wt, 2 + wg);
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

struct TcLaunch {
  TcPlan plan;
  int grid;
};

// The plan and grid of a launch at this shape on the current card;
// cudaErrorInvalidValue if its tiles do not fit a block's shared memory.
cudaError_t tc_launch_plan(int N, int H, int W, int O, int C, TcLaunch& L) {
  int device = 0, sms = 1, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (!tc_plan(N, H, W, O, C, sms, max_smem, L.plan))
    return cudaErrorInvalidValue;
  L.grid = std::min(L.plan.units, sms);
  err = cudaFuncSetAttribute(stem_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.plan.total);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for later checks
  return err;
}

cudaError_t launch_tc(const void* w, const void* g, void* out, int N, int H,
                      int W, int O, int C, cudaStream_t stream) {
  TcLaunch L;
  const cudaError_t err = tc_launch_plan(N, H, W, O, C, L);
  if (err != cudaSuccess) return err;
  stem_tc_kernel<<<L.grid, TC_THREADS, L.plan.total, stream>>>(
      static_cast<const uint16_t*>(w), static_cast<const uint16_t*>(g),
      static_cast<__nv_bfloat16*>(out), H, W, O, C, L.plan);
  return cudaGetLastError();
}

// --- float32: tensor cores, 3xTF32 -----------------------------------------

constexpr int TH_F32 = 2;            // output rows per block
constexpr int MT = 4;                // m16 tiles of a warp's pass: 64 pixels
constexpr int NT = 4;                // n8 tiles of a warp's pass: 32 channels
constexpr int F32_WARPS = 8;         // (row, pixel half, channel half)
constexpr int F32_THREADS = 32 * F32_WARPS;

// Where the f32 kernel's tiles lie in dynamic shared memory, in floats:
// wE [TH_F32][WX][KS] at 0, gB [7][CS][KS] at gB.
struct F32Layout {
  int KO;      // k of the product: 7*O rounded up to 8
  int KS;      // floats per row of wE and gB: 7*O rounded up to 32
  int WX;      // pixels of wE: W rounded up to 16, plus 6
  int CS;      // channel rows of gB: C rounded up to 16
  FastDiv by_O;
  size_t gB, total;
};

inline F32Layout f32_layout(int W, int O, int C) {
  F32Layout t;
  t.KO = round_up(K * O, 8);
  t.KS = round_up(K * O, 32);
  t.WX = round_up(W, 16) + K - 1;
  t.CS = round_up(C, 16);
  t.by_O = fast_div(O);
  t.gB = (size_t)TH_F32 * t.WX * t.KS;
  t.total = t.gB + (size_t)K * t.CS * t.KS;
  return t;
}

// The 3xTF32 split of a fragment register, in full-rate integer and f32
// ops (cvt.rna.tf32.f32 issues at a fraction of their rate): hi = x
// rounded to tf32 (to nearest, ties away: the 13 low mantissa bits
// rounded off), lo = x - hi, exact in f32 and passed as it is: a tf32
// operand's low 13 bits are not read, so lo is truncated to tf32, an
// error of at most 2^-21 of x.
__device__ __forceinline__ void split_tf32(uint32_t raw, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (raw + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(raw) - __uint_as_float(hi));
}

// d += a * b: m16n8k8, A row-major tf32, B column-major tf32, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One step's raw fragments (f32 bits): A of MT m-tiles, B of NT n-tiles.
struct F32Frags {
  uint32_t a[MT][4];
  uint32_t b[NT][2];
};

// Loads step s (dx = s / KQ, k = 8 * (s % KQ)) of a warp's pass at pixels
// x0 and channels c0 by ldmatrix.x4 from the swizzled tiles; GUARD skips
// the tiles beyond W or C (a pass without such tiles runs no test).
template <bool GUARD>
__device__ __forceinline__ void f32_load(
    F32Frags& f, int s, int KQ, int x0, int c0, uint32_t a_base,
    uint32_t b_base, int a_row, int a_kc, int b_row, int b_kc, int KS, int CS,
    const bool (&m_on)[MT], const bool (&n_on)[NT]) {
  const int dx = s / KQ, ks = s - dx * KQ;
  const int xa = x0 + a_row + dx;
  const uint32_t a_addr = a_base + 4u * (uint32_t)(
      xa * KS + 4 * swizzle(2 * ks + a_kc, xa));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (!GUARD || m_on[mt]) ldmatrix_x4(f.a[mt], a_addr + 64u * mt * KS);
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    if (GUARD && !n_on[2 * p]) continue;
    const int c = c0 + 16 * p + b_row;
    uint32_t q[4];
    ldmatrix_x4(q, b_base + 4u * (uint32_t)(
        (dx * CS + c) * KS + 4 * swizzle(2 * ks + b_kc, c)));
    f.b[2 * p][0] = q[0];
    f.b[2 * p][1] = q[1];
    f.b[2 * p + 1][0] = q[2];
    f.b[2 * p + 1][1] = q[3];
  }
}

// acc += A * B of one step in 3xTF32: every fragment split, then the
// three products as three rounds over the tiles (a_lo*b_hi, a_hi*b_lo,
// a_hi*b_hi), so that no product waits on the one before it.
template <bool GUARD>
__device__ __forceinline__ void f32_products(float (&acc)[MT][NT][4],
                                             const F32Frags& f,
                                             const bool (&m_on)[MT],
                                             const bool (&n_on)[NT]) {
  uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(f.a[mt][i], a_hi[mt][i], a_lo[mt][i]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      split_tf32(f.b[nt][i], b_hi[nt][i], b_lo[nt][i]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (!GUARD || (m_on[mt] && n_on[nt]))
        mma_tf32(acc[mt][nt], a_lo[mt], b_hi[nt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (!GUARD || (m_on[mt] && n_on[nt]))
        mma_tf32(acc[mt][nt], a_hi[mt], b_lo[nt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (!GUARD || (m_on[mt] && n_on[nt]))
        mma_tf32(acc[mt][nt], a_hi[mt], b_hi[nt]);
}

// One pass of a warp: acc = the 64 pixels at x0 times the 32 channels at
// c0 of the block's output row, over every step (dx, 8 k). Each step's
// fragments are loaded during the step before (two register sets, so the
// loop runs two steps a turn).
template <bool GUARD>
__device__ __forceinline__ void f32_pass(
    float (&acc)[MT][NT][4], int KQ, int x0, int c0, uint32_t a_base,
    uint32_t b_base, int a_row, int a_kc, int b_row, int b_kc, int KS,
    int CS, const bool (&m_on)[MT], const bool (&n_on)[NT]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int steps = K * KQ;
  F32Frags f0, f1;
  f32_load<GUARD>(f0, 0, KQ, x0, c0, a_base, b_base, a_row, a_kc, b_row,
                  b_kc, KS, CS, m_on, n_on);
  for (int s = 0; s < steps; s += 2) {
    if (s + 1 < steps)
      f32_load<GUARD>(f1, s + 1, KQ, x0, c0, a_base, b_base, a_row, a_kc,
                      b_row, b_kc, KS, CS, m_on, n_on);
    f32_products<GUARD>(acc, f0, m_on, n_on);
    if (s + 1 >= steps) break;
    if (s + 2 < steps)
      f32_load<GUARD>(f0, s + 2, KQ, x0, c0, a_base, b_base, a_row, a_kc,
                      b_row, b_kc, KS, CS, m_on, n_on);
    f32_products<GUARD>(acc, f1, m_on, n_on);
  }
}

__global__ void __launch_bounds__(F32_THREADS, 1)
stem_f32_kernel(const float* __restrict__ w, const float* __restrict__ g,
                float* __restrict__ out, int H, int W, int O, int C,
                F32Layout L) {
  extern __shared__ __align__(128) float f32_smem[];
  float* wE = f32_smem;
  float* gB = f32_smem + L.gB;
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int n = blockIdx.y;
  const int KS = L.KS, WX = L.WX, CS = L.CS, KR = K * O;
  const int KC = KS / 4;                  // 16-byte chunks of a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. Once a block: gB[dx][c][k] = g[n, dy, dx, o, c] (k = dy*O + o), zero
  // for k >= 7*O or c >= C; a thread a 16-byte chunk (4 k), lanes over
  // consecutive c: coalesced loads, and the swizzle keeps the stores
  // conflict-free. Every element is a 4-byte cp.async (zero-filled where
  // there is no source), so all of a thread's loads are in flight at once.
  const float* gn = g + (size_t)n * K * K * O * C;
  const int g_chunks = K * KC * CS;
  for (int i = threadIdx.x; i < g_chunks; i += F32_THREADS) {
    const int c = i % CS, r = i / CS;     // r = dx*KC + j
    const int dx = r / KC, j = r - dx * KC;
    float* d = gB + (dx * CS + c) * KS + 4 * swizzle(j, c);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * j + q;
      const int dy = k / L.by_O, o = k - dy * O;
      const bool real = k < KR && c < C;
      cp_async4(d + q, real ? gn + ((dy * K + dx) * O + o) * C + c : gn,
                real);
    }
  }

  // Warp (ty, xq, cq) owns output row y0+ty of each pair, the passes of 64
  // pixels at 64*xq + 128*i and, of each 64 channels, the 32 at 32*cq.
  const int ty = warp >> 2, xq = (warp >> 1) & 1, cq = warp & 1;
  const uint32_t a_base = shared_address(wE + ty * WX * KS);
  const uint32_t b_base = shared_address(gB);
  // ldmatrix.x4 rows. A: lanes 0-15 give pixels 0-15 at k 0-3, lanes 16-31
  // the same pixels at k 4-7 (matrices: a0, a1, a2, a3 of the tf32
  // fragment). B: lanes 0-7 give channels 0-7 at k 0-3, 8-15 the same at
  // k 4-7, 16-31 channels 8-15 likewise (b0, b1 of two n-tiles).
  const int a_row = lane & 15, a_kc = lane >> 4;
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_kc = (lane >> 3) & 1;
  const int quad = lane >> 2, t = lane & 3;
  const int KQ = L.KO / 8;                // steps of 8 k
  const int pairs = (H + TH_F32 - 1) / TH_F32;

  // The block's pairs of output rows of image n: blockIdx.x, then every
  // gridDim.x-th, so that g[n] is staged once for all of them.
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int y0 = pair * TH_F32;
    const int rows = min(TH_F32, H - y0);

    // 2. wE[ty][x][k] = w_pad[n, y0+ty+dy, x, o] for k < 7*O and x < W+6,
    // zero elsewhere; lanes over consecutive pixels, 4-byte cp.asyncs as
    // above. The previous pair's products are done with wE (the barrier at
    // the loop's end); the first pair's wait also lands gB.
    const float* wn = w + ((size_t)n * Hp + y0) * Wp * O;
    const int w_chunks = rows * KC * WX;
    for (int i = threadIdx.x; i < w_chunks; i += F32_THREADS) {
      const int x = i % WX, r = i / WX;   // r = ty*KC + j
      const int sty = r / KC, j = r - sty * KC;
      float* d = wE + (sty * WX + x) * KS + 4 * swizzle(j, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * j + q;
        const int dy = k / L.by_O, o = k - dy * O;
        const bool real = k < KR && x < Wp;
        cp_async4(d + q, real ? wn + ((sty + dy) * Wp + x) * O + o : wn,
                  real);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if (ty < rows) {
      float* orow = out + ((size_t)n * H + y0 + ty) * W * C;
      for (int x0 = 64 * xq; x0 < W; x0 += 128) {
        for (int c0 = 32 * cq; c0 < C; c0 += 64) {
          bool m_on[MT], n_on[NT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) m_on[mt] = x0 + 16 * mt < W;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) n_on[nt] = c0 + 8 * nt < C;

          float acc[MT][NT][4];
          bool full = true;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) full = full && m_on[mt];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) full = full && n_on[nt];
          if (full)
            f32_pass<false>(acc, KQ, x0, c0, a_base, b_base, a_row, a_kc,
                            b_row, b_kc, KS, CS, m_on, n_on);
          else
            f32_pass<true>(acc, KQ, x0, c0, a_base, b_base, a_row, a_kc,
                           b_row, b_kc, KS, CS, m_on, n_on);

          // Lane (quad, t) holds pixels quad and quad+8 of each m-tile at
          // channels 2t, 2t+1 of each n-tile: 8-byte stores when C is even.
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int x = x0 + 16 * mt + quad + 8 * h;
              if (x >= W) continue;
              float* op = orow + (size_t)x * C;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const int c = c0 + 8 * nt + 2 * t;
                const float v0 = acc[mt][nt][2 * h];
                const float v1 = acc[mt][nt][2 * h + 1];
                if ((C & 1) == 0) {
                  if (c < C) *reinterpret_cast<float2*>(op + c) =
                      make_float2(v0, v1);
                } else {
                  if (c < C) op[c] = v0;
                  if (c + 1 < C) op[c + 1] = v1;
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

cudaError_t launch_f32(const void* w, const void* g, void* out, int N, int H,
                       int W, int O, int C, cudaStream_t stream) {
  const F32Layout L = f32_layout(W, O, C);
  const size_t smem = sizeof(float) * L.total;
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  // One block an SM (its shared memory), all blocks in one wave where the
  // images allow: an image's row pairs shared among sms / N blocks.
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int pairs = (H + TH_F32 - 1) / TH_F32;
  dim3 grid(std::max(1, std::min(pairs, sms / N)), N);
  stem_f32_kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<float*>(out), H, W, O, C, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (stem_f32_kernel), 1 = bfloat16 (stem_tc_kernel).
// Returns cudaGetLastError() of the launch.
int sg_stem(const void* w, const void* g, void* out, int N, int H, int W,
            int O, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(w, g, out, N, H, W, O, C, s);
  if (dtype == 1) return launch_tc(w, g, out, N, H, W, O, C, s);
  return cudaErrorInvalidValue;
}

// The bf16 kernel's launch at this shape on the current card, launching
// nothing: info[0..7] = registers a thread, dynamic shared memory (bytes),
// blocks an SM, grid, packed rows resident, output rows a band, local
// memory a thread (bytes), threads a block. Returns a CUDA error code.
int sg_stem_tc_config(int N, int H, int W, int O, int C, int* info) {
  TcLaunch L;
  cudaError_t err = tc_launch_plan(N, H, W, O, C, L);
  cudaFuncAttributes a;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, stem_tc_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, stem_tc_kernel, TC_THREADS, L.plan.total);
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = (int)L.plan.total;
  info[2] = blocks;
  info[3] = L.grid;
  info[4] = L.plan.ring;
  info[5] = L.plan.RB;
  info[6] = (int)a.localSizeBytes;
  info[7] = TC_THREADS;
  return 0;
}

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
