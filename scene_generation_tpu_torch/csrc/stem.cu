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
// bfloat16 (serving): stem_tc_kernel, on the tensor cores. It follows the
// TPU kernel's packing. A block owns one image and TH output rows and
// builds, as bf16 in dynamic shared memory,
//   * the dy-packed field wE[ty][x][k] = w_pad[n, y0+ty+dy, x, o] with
//     k = dy*O + o, zero for k in [7*O, KO) (KO = 7*O rounded up to 16),
//     and zero for x beyond the field up to the last pixel tile plus 6;
//   * gB[dx][k][c] = g[n, dy, dx, o, c], zero for k >= 7*O or c >= C:
//     runs of g[n] as they are, so cp.async lays them down directly.
// Staging is latency-bound if each thread loads what it stores, so g[n]
// and the block's TH+6 input rows arrive by cp.async in one round trip;
// the rows are then made o-major (P), so that wE is built from
// consecutive pixels, two a 32-bit word, without bank conflicts.
// Then out_tile = sum_{dx<7} A_dx * gB[dx] with A_dx[(ty, x), k] =
// wE[ty][x+dx][k]: the dx-shifted operand is the same tile read dx pixel
// rows further on, so no patch matrix is ever built. The 16-byte chunks of
// every row of wE (pixel x) and gB (tap k) are swizzled, chunk' = chunk ^
// (row & 7), so the 8 row addresses of one ldmatrix 8x8 (8 consecutive x,
// or 8 consecutive k) fall in different banks for every dx shift. Two
// warps own one output row, each half of every 64 channels, in passes of
// 64 pixels x 32 channels (64 f32 sums a thread, so 16 warps fit a block
// and hide each other's latency; one warp a row with 128 sums reads the A
// fragments once, but was the slower of the two on the H100): fragments
// come by ldmatrix.x4 (B transposed on the load) straight from the
// swizzled tiles at pixel offset x+dx, the products are mma.sync m16n8k16
// bf16 with f32 sums, rounded to bf16 once. A transpose within each quad
// of lanes turns the fragments into 16-byte stores. No atomics: every
// output is summed by one warp in a fixed order, so a call is bitwise
// repeatable.
//
// Why not wgmma yet: wgmma reads A from shared memory only through a
// descriptor of a canonical swizzled layout, and a start address shifted by
// dx pixel rows (dx*KS*2 bytes) breaks that layout; it would need A in
// registers or the patch matrix rebuilt per dx. mma.sync fed by ldmatrix
// takes any 16-byte aligned rows, so the shift costs nothing here.
//
// float32: stem_f32_kernel, on the tensor cores in 3xTF32. Plain TF32
// (10 mantissa bits) would spend the f32 card-vs-CPU margins, so every
// operand is split after its fragment is loaded, hi = x rounded to tf32
// and lo = x - hi, and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (the small terms first) by mma.sync m16n8k8 tf32 with f32 sums: about 21
// bits of each product, f32 sums. So the bound is three TF32 products a
// multiply-add: 3 x 14.8 GFLOP at the dense TF32 rate, about 0.09 ms at
// the serving shape. It reuses the bf16 kernel's structure with f32 tiles:
//   * wE[ty][x][k] (k = dy*O + o, KS = 7*O rounded up to 32 floats a
//     pixel), gathered straight from w_pad[n] (no o-major copy: in f32 a
//     pixel's 9 channels are 36 contiguous bytes of one row);
//   * gB[dx][c][k], c-major: ldmatrix moves 16-bit elements and .trans
//     would tear the f32 words, so B is stored with k contiguous and read
//     untransposed, an 8x8 b16 matrix being 8 rows of 4 f32 words, one a
//     lane, which is the tf32 fragment (k = lane % 4, c = lane / 4);
//   * the same dx shift (A_dx is wE read dx pixel rows further on) and the
//     same 16-byte-chunk swizzle (chunk ^ row & 7) of every 128 bytes.
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
constexpr int TH = 8;                // bf16: output rows per block

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// --- bfloat16: tensor cores -------------------------------------------------

constexpr int WPR = 2;               // warps per output row
constexpr int MT = 4;                // m16 tiles of a warp's pass: 64 pixels
constexpr int NT = 8 / WPR;          // n8 tiles of a warp's pass
constexpr int RI = TH + K - 1;       // input rows of a block
constexpr int TC_WARPS = WPR * TH;
constexpr int TC_THREADS = 32 * TC_WARPS;

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

// Where the block's tiles lie in dynamic shared memory, in bf16 elements:
// wE [TH][WX][KS] at 0, gB [7][KO][CS] at gB, P [RI][O][WX] at P. Before
// wE is built, its space holds the block's RI input rows of w_pad[n] as
// they are.
struct TcLayout {
  int KO;      // k of the product: 7*O rounded up to 16
  int KS;      // elements per row of wE: 7*O rounded up to 64
  int WX;      // pixels of wE and P: W rounded up to 16, plus 6
  int CS;      // elements per row of gB: C rounded up to 64
  FastDiv by_O, by_C8;
  size_t gB, P, total;
};

inline TcLayout tc_layout(int W, int O, int C) {
  TcLayout t;
  t.KO = round_up(K * O, 16);
  t.KS = round_up(K * O, 64);
  t.WX = round_up(W, 16) + K - 1;
  t.CS = round_up(C, 64);
  t.by_O = fast_div(O);
  t.by_C8 = fast_div(C / 8 > 0 ? C / 8 : 1);
  const size_t wE = (size_t)TH * t.WX * t.KS;
  // The raw rows start at their source's offset within 16 bytes: 8 spare.
  const size_t raw_w = ((size_t)RI * (W + K - 1) * O + 15) / 8 * 8;
  t.gB = wE > raw_w ? wE : raw_w;
  t.P = t.gB + (size_t)K * t.KO * t.CS;
  t.total = t.P + (size_t)RI * O * t.WX;
  return t;
}

// The position of 16-byte chunk j of tile row r: chunks are swizzled within
// each group of 8 (128 bytes) by the row's low 3 bits.
__device__ __forceinline__ int swizzle(int j, int r) {
  return (j & ~7) | ((j ^ r) & 7);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_address(dst)), "l"(src));
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

// Copies count elements from src to dst + lead, lead = src's offset within
// 16 bytes (in elements), so that both sides' 16-byte chunks align: the
// chunks by cp.async (waited for by cp_async_wait_all), the ragged ends
// element by element. Returns lead. Every thread of the block calls it.
__device__ __forceinline__ int copy_async(uint16_t* dst, const uint16_t* src,
                                          int count) {
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 1);
  uint16_t* d = dst + lead;
  const int head = min(count, (8 - lead) & 7);
  const int chunks = (count - head) / 8;
  const int tail = head + 8 * chunks;
  for (int i = threadIdx.x; i < chunks; i += TC_THREADS)
    cp_async16(d + head + 8 * i, src + head + 8 * i);
  for (int i = threadIdx.x; i < head + count - tail; i += TC_THREADS) {
    const int e = i < head ? i : tail + i - head;
    d[e] = src[e];
  }
  return lead;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b: m16n8k16, A row-major bf16, B column-major bf16, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Transposes v (4 x 4 words: lane t of a quad holds row t) within each quad
// of the warp, so that lane t then holds column t.
__device__ __forceinline__ void quad_transpose(uint32_t& v0, uint32_t& v1,
                                               uint32_t& v2, uint32_t& v3,
                                               int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 1);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, odd ? v2 : v3, 1);
  if (odd) { v0 = s0; v2 = s1; } else { v1 = s0; v3 = s1; }
  s0 = __shfl_xor_sync(0xffffffffu, high ? v0 : v2, 2);
  s1 = __shfl_xor_sync(0xffffffffu, high ? v1 : v3, 2);
  if (high) { v0 = s0; v1 = s1; } else { v2 = s0; v3 = s1; }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
stem_tc_kernel(const uint16_t* __restrict__ w, const uint16_t* __restrict__ g,
               __nv_bfloat16* __restrict__ out, int H, int W, int O, int C,
               TcLayout L) {
  extern __shared__ __align__(128) uint16_t tc_smem[];
  uint16_t* wE = tc_smem;
  uint16_t* gB = tc_smem + L.gB;
  uint16_t* P = tc_smem + L.P;
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int n = blockIdx.y;
  const int y0 = blockIdx.x * TH;
  const int rows = min(TH, H - y0);
  const int KO = L.KO, KS = L.KS, WX = L.WX, CS = L.CS;
  const int KC = KO / 8;                  // 16-byte chunks of k read
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. In one round trip: the block's input rows of w_pad[n], as they are,
  // into the space of wE; and gB[dx][k][c] = g[n, dy, dx, o, c] (k = dy*O
  // + o, zero for k >= 7*O or c >= C), each run of 8 channels a 16-byte
  // copy when C is a multiple of 8 and g 16-byte aligned.
  const int w_len = (rows + K - 1) * Wp * O;
  const uint16_t* rw =
      tc_smem + copy_async(tc_smem, w + ((size_t)n * Hp + y0) * Wp * O, w_len);
  const uint16_t* gn = g + (size_t)n * K * K * O * C;
  const int KR = K * O;                   // real k
  if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int C8 = C / 8;
    for (int i = threadIdx.x; i < K * KR * C8; i += TC_THREADS) {
      const int row = i / L.by_C8, j = i - row * C8;  // (dy*7 + dx)*O + o
      const int t = row / L.by_O, o = row - t * O;
      const int dy = t / K, dx = t - dy * K, k = dy * O + o;
      cp_async16(gB + (dx * KO + k) * CS + 8 * swizzle(j, k), gn + 8 * i);
    }
    // Zero chunks: channels beyond C for k < 7*O; every channel beyond.
    const int CS8 = CS / 8, pad8 = CS8 - C8;
    for (int i = threadIdx.x; i < K * KR * pad8; i += TC_THREADS) {
      const int r = i / pad8, j = C8 + i - r * pad8;
      const int dx = r / KR, k = r - dx * KR;
      *reinterpret_cast<uint4*>(gB + ((size_t)dx * KO + k) * CS +
                                8 * swizzle(j, k)) = make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < K * (KO - KR) * CS8; i += TC_THREADS) {
      const int r = i / CS8, j = i - r * CS8;
      const int dx = r / (KO - KR), k = KR + r - dx * (KO - KR);
      *reinterpret_cast<uint4*>(gB + ((size_t)dx * KO + k) * CS +
                                8 * swizzle(j, k)) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < K * KO * CS; i += TC_THREADS) {
      const int r = i / CS, c = i - r * CS;
      const int dx = r / KO, k = r - dx * KO;
      const int dy = k / O, o = k - dy * O;
      gB[((size_t)dx * KO + k) * CS + 8 * swizzle(c / 8, k) + c % 8] =
          (k < KR && c < C) ? gn[((dy * K + dx) * O + o) * C + c] : 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. P[r][o][x] = w_pad[n, y0+r, x, o], zero for x from W+6 to WX: the
  // rows made o-major, so that building wE reads consecutive pixels, two a
  // word, without bank conflicts. Threads walk the raw rows in order.
  {
    int e = threadIdx.x;
    int o = e % O, x = e / O % Wp, r = e / (O * Wp);
    const int so = TC_THREADS % O, sx = TC_THREADS / O % Wp;
    const int sr = TC_THREADS / (O * Wp);
    for (; e < w_len; e += TC_THREADS) {
      P[(r * O + o) * WX + x] = rw[e];
      o += so; x += sx; r += sr;
      if (o >= O) { o -= O; ++x; }
      if (x >= Wp) { x -= Wp; ++r; }
    }
    const int pad = WX - Wp;
    for (int i = threadIdx.x; i < (rows + K - 1) * O * pad; i += TC_THREADS)
      P[i / pad * WX + Wp + i % pad] = 0;
  }
  __syncthreads();

  // 3. wE[ty][x][k] = w_pad[n, y0+ty+dy, x, o] = P[ty*O + k][x] for k < 7*O,
  // zero for larger k: a warp per (ty, chunk of 8 k), lanes over pairs of
  // pixels (one 32-bit word of each of 8 P rows, split into two chunks).
  for (int r = warp; r < rows * KC; r += TC_WARPS) {
    const int ty = r / KC, j = r - ty * KC;
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(P + (ty * O + 8 * j) * WX);
    const int k_left = KR - 8 * j, half = WX / 2;
    // Lanes 4-7 of every 8 store their odd pixel first: the 8 stores of a
    // quarter warp then fall on 8 different chunk positions.
    const bool odd_first = (lane >> 2) & 1;
    for (int xp = lane; xp < half; xp += 32) {
      uint32_t q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = i < k_left ? p[i * half + xp] : 0u;
      const uint4 even = make_uint4(
          __byte_perm(q[0], q[1], 0x5410), __byte_perm(q[2], q[3], 0x5410),
          __byte_perm(q[4], q[5], 0x5410), __byte_perm(q[6], q[7], 0x5410));
      const uint4 odd = make_uint4(
          __byte_perm(q[0], q[1], 0x7632), __byte_perm(q[2], q[3], 0x7632),
          __byte_perm(q[4], q[5], 0x7632), __byte_perm(q[6], q[7], 0x7632));
      const int x = 2 * xp;
      uint4* d0 = reinterpret_cast<uint4*>(
          wE + (ty * WX + x) * KS + 8 * swizzle(j, x));
      uint4* d1 = reinterpret_cast<uint4*>(
          wE + (ty * WX + x + 1) * KS + 8 * swizzle(j, x + 1));
      if (odd_first) { *d1 = odd; *d0 = even; } else { *d0 = even; *d1 = odd; }
    }
  }
  __syncthreads();

  // Warp (ty, cq) owns output row y0+ty and, of each 64 channels, the
  // 8*NT at 8*NT*cq.
  const int ty = warp / WPR, cq = warp % WPR;
  if (ty >= rows) return;
  const int y = y0 + ty;
  const uint32_t a_base = shared_address(wE + ty * WX * KS);
  const uint32_t b_base = shared_address(gB);
  // ldmatrix.x4 rows: lanes 0-15 give A's pixels 0-15 at k 0-7, lanes 16-31
  // the same pixels at k 8-15; for B (.trans, rows of k) lanes 0-15 give
  // k 0-15 at channels 0-7, lanes 16-31 the same k at channels 8-15.
  const int a_row = lane & 15, a_kc = lane >> 4;
  const int quad = lane >> 2, t = lane & 3;
  const int KQ = KO / 16;                       // steps of 16 k
  __nv_bfloat16* orow = out + ((size_t)n * H + y) * W * C;

  for (int x0 = 0; x0 < W; x0 += 16 * MT) {
    for (int c0 = 8 * NT * cq; c0 < CS; c0 += 64) {
      bool m_on[MT], n_on[NT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) m_on[mt] = x0 + 16 * mt < W;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) n_on[nt] = c0 + 8 * nt < C;

      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      for (int dx = 0; dx < K; ++dx) {
        // This lane's pixel row of A_dx (m-tile 0; m-tile mt is 16*mt
        // rows on, at the same swizzle) and tap row of gB[dx].
        const int xa = x0 + a_row + dx;
        for (int ks = 0; ks < KQ; ++ks) {
          const int k = 16 * ks + a_row;
          const uint32_t a_addr = a_base + 2u * (uint32_t)(
              xa * KS + 8 * swizzle(2 * ks + a_kc, xa));
          const uint32_t b_addr = b_base + 2u * (uint32_t)((dx * KO + k) * CS);
          uint32_t a[MT][4], b[NT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (m_on[mt]) ldmatrix_x4(a[mt], a_addr + 32u * mt * KS);
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            if (!n_on[2 * p]) continue;
            uint32_t q[4];
            ldmatrix_x4_trans(q, b_addr + 16u * swizzle(c0 / 8 + 2 * p + a_kc,
                                                       k));
            b[2 * p][0] = q[0];
            b[2 * p][1] = q[1];
            b[2 * p + 1][0] = q[2];
            b[2 * p + 1][1] = q[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              if (m_on[mt] && n_on[nt]) mma_bf16(acc[mt][nt], a[mt], b[nt]);
        }
      }

      // Lane (quad, t) holds pixels quad and quad+8 of each m-tile at
      // channels 2t, 2t+1 of each n-tile. For C a multiple of 8, a transpose
      // of each 4 n-tiles within the quad gives lane t n-tile t of them
      // whole: 16-byte stores, 64 contiguous bytes of a pixel per quad.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + 16 * mt + quad + 8 * h;
          __nv_bfloat16* op = orow + (size_t)x * C;
          if ((C & 7) == 0) {
#pragma unroll
            for (int q4 = 0; q4 < NT / 4; ++q4) {
              uint32_t v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = pack_bf16x2(acc[mt][4 * q4 + i][2 * h],
                                   acc[mt][4 * q4 + i][2 * h + 1]);
              quad_transpose(v[0], v[1], v[2], v[3], t);
              const int c = c0 + 32 * q4 + 8 * t;
              if (x < W && c < C)
                *reinterpret_cast<uint4*>(op + c) =
                    make_uint4(v[0], v[1], v[2], v[3]);
            }
          } else if (x < W) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = c0 + 8 * nt + 2 * t;
              const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
              if (c < C) op[c] = __float2bfloat16(v0);
              if (c + 1 < C) op[c + 1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }
}

cudaError_t launch_tc(const void* w, const void* g, void* out, int N, int H,
                      int W, int O, int C, cudaStream_t stream) {
  const TcLayout L = tc_layout(W, O, C);
  const size_t smem = 2 * L.total;
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return err;
  }
  dim3 grid((H + TH - 1) / TH, N);
  stem_tc_kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(w), static_cast<const uint16_t*>(g),
      static_cast<__nv_bfloat16*>(out), H, W, O, C, L);
  return cudaGetLastError();
}

// --- float32: tensor cores, 3xTF32 -----------------------------------------

constexpr int TH_F32 = 2;            // output rows per block
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

const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
