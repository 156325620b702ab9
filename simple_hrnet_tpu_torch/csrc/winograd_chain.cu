// B3: HRNet's branch-0 chain of 4 BasicBlocks with each 3x3 conv computed
// as Winograd F(2,3) along H (8 stride-1 "same" convs with folded-BN bias,
// ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/winograd_chain.py
// _wino_kernel (behind chain_pallas_grouped_wino), computing its UNPACKED
// function (G = 1). Per conv and output row pair (2t, 2t+1), from the input
// rows 2t-1 .. 2t+2:
//   V0 = x[2t-1] - x[2t+1]  V1 = x[2t] + x[2t+1]
//   V2 = x[2t+1] - x[2t]    V3 = x[2t] - x[2t+2]
//     (each an f32 sum of two bf16 values rounded once to bf16)
//   m_u = sum over kx, ci of V_u[x + kx - 1, ci] * U[u][kx][ci][co]  (f32)
//   y[2t]   = bias + m0 + m1 + m2
//   y[2t+1] = bias + m1 - m2 - m3
// then (conv2 only) the f32 residual of the bf16 block input, ReLU and one
// rounding to bf16 — _wino_kernel's cast points. The f32 sums run in
// another order than the plain version's (the products on the tensor
// cores, m3 accumulated into the odd sum as the products of -V3, the bias
// after the sum), well inside the 2^-6 of max that the checks hold it to.
// Activations are NHWC bf16 with H even; weights (8, 4, 3C, C) bf16
// (pack_winograd_weights: ky transformed by G, kx taps stacked
// [x-1 | x | x+1]); biases (8, C) f32. C is 32 or 64, the widths where the
// JAX package runs its Winograd chain (G * C == 128).
//
// Bounds on the H100 at W32 branch 0 with 32 crops (32, 64, 48, 32):
// operations, 4 terms x 32 row pairs x 48 x 96 x 32 MACs x 8 convs x 32
// crops = 4.83 G MAC = 9.66 GFLOP a chain, 0.0098 ms at the tensor-core
// peak (989 TFLOP/s); the chain must move only 2 x 6.3 MB of activations
// (0.0038 ms). Each conv is its own launch with its input and output in
// device memory, so the 8 launches move 20 passes of the activation.
//
// Design: K2's per-conv machinery (csrc/fused_block.cu) with the Winograd
// terms in place of the 3x3 taps; one conv kernel with the input transform
// and the epilogue fused, launched 8 times a chain.
//   * persistent blocks, one a SM: each stages the conv's U (4 x 3C rows of
//     C output channels) and its bias in shared memory once, then its warps
//     (12 at C = 32, 4 at C = 64) walk their share of 8 x 8-pixel output
//     tiles, 4 row pairs x 8 columns;
//   * a tile reads rows 2t0-1 .. 2t0+8 and columns x0-1 .. x0+8, the same
//     10 x 10 halo as K2's: each warp owns a ring of two halo slots filled
//     by 16-byte cp.async copies (zero-filled past the image), so a tile's
//     loads are in flight while the warp computes the previous one;
//   * products on the tensor cores, mma.sync m16n8k16 bf16 -> f32: the 32
//     row-pair pixels of a tile are 2 m16 fragments. A term's A fragment
//     is formed in registers from the ldmatrix fragments of the two halo
//     rows it combines (the same lane layout, so the work is elementwise:
//     f32 sum, one rounding to bf16), and each B fragment of U (ldmatrix
//     .trans) serves both;
//   * registers bound the tile: the even and odd sums and one term's sum
//     are 3 sets of 2 m16 x 32 output channels of f32 accumulators, so a
//     tile runs in passes of 32 output channels (one at C = 32, two over
//     the same slot at C = 64). m0 accumulates straight into the even sum
//     and -V3's products into the odd sum; m1 and m2 go through the term
//     set, which is added to (m1) or taken from (m2) the odd sum and added
//     to the even one as soon as its products finish;
//   * the epilogue runs from the accumulator registers: a transpose inside
//     each quad of lanes (shuffles) gives a lane 8 consecutive channels of
//     one pixel, which get the bias (from shared memory), the residual
//     (16-byte streaming loads issued before the pass's products), the
//     ReLU and one rounding, and go out in one 16-byte store;
//   * where a block has more tiles than warps, its warps form two teams
//     half a tile apart, so that one warp's products overlap another's
//     epilogue;
//   * each conv after the first is a programmatic dependent launch of the
//     one before: its blocks start, and stage their weights, as the earlier
//     conv's blocks exit, and wait for that grid before touching its output.
// What holds it back (its phases' times, measured one at a time on the
// card by utils/fuse_up_phases.py) is in PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 8;             // output tile side (pixels)
constexpr int HALO = TILE + 2;      // halo tile side
constexpr int SLOTS = 2;            // ring slots a warp
constexpr int MAX_WARPS = 12;       // at most 170 registers a thread
constexpr int NO = 32;              // output channels a pass
constexpr int NJ = NO / 8;          // n8 accumulator tiles a pass
constexpr int SMEM_LIMIT = 232448;  // what one block can use on the H100

// Shared memory rows (a pixel's channels, or a U row's output channels) are
// C + 8 wide: an odd number of 16-byte units, so the 8 rows of each 8 x 8
// ldmatrix fall in 8 different bank groups.
template <int C> struct Tc {
  static constexpr int P = C + 8;                      // row pitch (elements)
  static constexpr int U_BYTES = 12 * C * P * 2;       // U: 4 x 3C rows
  static constexpr int FIXED = U_BYTES + C * 4;        // + bias
  static constexpr int SLOT = HALO * HALO * P;         // elements a slot
  static constexpr int WARP_BYTES = SLOTS * SLOT * 2;  // one warp's ring
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / WARP_BYTES;
  static constexpr int WARPS = FIT < MAX_WARPS ? FIT : MAX_WARPS;
  static constexpr int BYTES = FIXED + WARPS * WARP_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// copies src_bytes (16 or 0) and zero-fills the rest of the 16 bytes;
// through L1 (.ca), where the halos of a block's neighbouring tiles overlap
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a barrier of `threads` threads on named barrier 1, and an arrival at it
__device__ __forceinline__ void team_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void team_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}

struct Conv {
  const bf16* x;      // (B, H, W, C) input
  const bf16* w;      // (4, 3C, C): U of the conv
  const float* bias;  // (C,)
  const bf16* res;    // (B, H, W, C) residual, or null
  bf16* out;          // (B, H, W, C)
  int H, W, tiles_x, tiles_per_image, n_tiles;
};

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Conv& a, int tile) {
  Tile t;
  t.b = tile / a.tiles_per_image;
  const int r = tile - t.b * a.tiles_per_image;
  const int ty = r / a.tiles_x;
  t.y0 = ty * TILE;
  t.x0 = (r - ty * a.tiles_x) * TILE;
  return t;
}

// Start the warp's 16-byte copies of one tile's halo (HALO x HALO pixels, C
// channels) into a ring slot; pixels past the image are zero-filled, the
// conv's "same" padding (and the rows 2t-1 = -1 and 2t+2 = H of the
// Winograd terms).
template <int C>
__device__ __forceinline__ void load_tile(const Conv& a, bf16* slot, int tile,
                                          int lane) {
  constexpr int CH = C / 8;  // 16-byte chunks a pixel
  const Tile t = tile_of(a, tile);
  const bf16* xb = a.x + (size_t)t.b * a.H * a.W * C;
#pragma unroll 4
  for (int i = lane; i < HALO * HALO * CH; i += 32) {
    const int p = i / CH;
    const int k = (i - p * CH) * 8;
    const int py = p / HALO;
    const int gy = t.y0 - 1 + py;
    const int gx = t.x0 - 1 + (p - py * HALO);
    const bool in =
        (unsigned)gy < (unsigned)a.H && (unsigned)gx < (unsigned)a.W;
    const bf16* src = in ? xb + ((size_t)gy * a.W + gx) * C + k : a.x;
    cp_async16_zfill(slot + p * Tc<C>::P + k, src, in ? 16 : 0);
  }
}

// a - b (SUB) or a + b of two bf16 pairs, each in f32 and rounded once to
// bf16 (the low half is the element at the lower address)
template <bool SUB>
__device__ __forceinline__ uint32_t vterm(uint32_t a, uint32_t b) {
  const float al = __uint_as_float(a << 16);
  const float ah = __uint_as_float(a & 0xffff0000u);
  const float bl = __uint_as_float(b << 16);
  const float bh = __uint_as_float(b & 0xffff0000u);
  const __nv_bfloat162 v =
      SUB ? __floats2bfloat162_rn(__fsub_rn(al, bl), __fsub_rn(ah, bh))
          : __floats2bfloat162_rn(__fadd_rn(al, bl), __fadd_rn(ah, bh));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[m][j] += the products of one Winograd term, V = x[row RA] -/+
// x[row RB] (RA, RB: halo row offsets 0..3 of a row pair, i.e. image rows
// 2t-1 .. 2t+2), with U rows uterm.. (3C rows: kx, then input channel) for
// row-pair pixels 16m..16m+15 (row r of m16 tile m is row pair 2m + r / 8,
// column r % 8) and the pass's output channels 8j..8j+7. Per tap kx and 16
// input channels: for each m16 tile two A fragments of halo rows (ldmatrix
// from the slot), combined in registers into the term's fragment, and NO/16
// ldmatrix.trans of U, each giving the B fragments of two n8 tiles that
// serve both m16 tiles. The taps (kx) are not unrolled: that keeps a thread
// within the 170 registers that 12 warps a block leave it.
template <int C, int RA, int RB, bool SUB>
__device__ __forceinline__ void term(uint32_t slot, uint32_t uterm,
                                     float (&acc)[2][NJ][4], int lane) {
  constexpr int P2 = Tc<C>::P * 2;  // row pitch (bytes)
  const int r = lane & 15;
  // A: lane l gives row l % 16 of matrices (l / 8); k half l / 16
  const uint32_t a0 =
      slot + (2 * (r >> 3) * HALO + (r & 7)) * P2 + (lane >> 4) * 16;
  // B: lane l gives U row (input channel) l % 16, output half l / 16
  const uint32_t b0 = uterm + r * P2 + (lane >> 4) * 16;
#pragma unroll 1
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t v[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t da[4], db[4];
        ldsm_x4(a0 + ((4 * m + RA) * HALO + kx) * P2 + kk * 32, da);
        ldsm_x4(a0 + ((4 * m + RB) * HALO + kx) * P2 + kk * 32, db);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[m][i] = vterm<SUB>(da[i], db[i]);
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bfr[4];
        ldsm_x4_trans(b0 + (kx * C + kk * 16) * P2 + jp * 32, bfr);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * jp], v[m], bfr);
          mma_bf16(acc[m][2 * jp + 1], v[m], bfr + 2);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][NJ][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
}

// One pass of a tile (output channels n0..n0+NO-1 of every pixel): the even
// sum ye = m0 + m1 + m2 and the odd sum yo = m1 - m2 - m3, m3 as the
// products of -V3 = x[2t+2] - x[2t].
template <int C>
__device__ __forceinline__ void products(uint32_t slot, uint32_t usm, int n0,
                                         float (&ye)[2][NJ][4],
                                         float (&yo)[2][NJ][4], int lane) {
  constexpr int TERM = 3 * C * Tc<C>::P * 2;  // bytes of a term's U rows
  const uint32_t u = usm + n0 * 2;
  float t[2][NJ][4];
  zero(ye);
  term<C, 0, 2, true>(slot, u, ye, lane);  // V0 = x[2t-1] - x[2t+1]
  zero(t);
  term<C, 1, 2, false>(slot, u + TERM, t, lane);  // V1 = x[2t] + x[2t+1]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ye[m][j][q] += t[m][j][q];
        yo[m][j][q] = t[m][j][q];
      }
  zero(t);
  term<C, 2, 1, true>(slot, u + 2 * TERM, t, lane);  // V2 = x[2t+1] - x[2t]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ye[m][j][q] += t[m][j][q];
        yo[m][j][q] -= t[m][j][q];
      }
  term<C, 3, 1, true>(slot, u + 3 * TERM, yo, lane);  // -V3 = x[2t+2] - x[2t]
}

// Transpose a 4 x 4 of float pairs across the quad of lanes 4g..4g+3: lane t
// holds v[s] = pair t of item s, and ends with v[u] = pair u of item t.
__device__ __forceinline__ void quad_transpose(float2 (&v)[4], int t) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {  // lanes t, t ^ 1
    const bool odd = t & 1;
    const float2 s = odd ? v[i] : v[i + 1];
    float2 r;
    r.x = __shfl_xor_sync(0xffffffffu, s.x, 1);
    r.y = __shfl_xor_sync(0xffffffffu, s.y, 1);
    if (odd) v[i] = r; else v[i + 1] = r;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // lanes t, t ^ 2
    const bool hi = t & 2;
    const float2 s = hi ? v[i] : v[i + 2];
    float2 r;
    r.x = __shfl_xor_sync(0xffffffffu, s.x, 2);
    r.y = __shfl_xor_sync(0xffffffffu, s.y, 2);
    if (hi) v[i] = r; else v[i + 2] = r;
  }
}

// The epilogue's items: lane 4g + t holds, for row-pair pixel row g (h = 0)
// and g + 8 (h = 1) of each m16 tile, channels 8j + 2t, 8j + 2t + 1 of every
// n8 tile j, in the even sum (output row 4m + 2h of the tile) and the odd
// one (4m + 2h + 1), column g. Items (h, j) go by fours (q) through a quad
// transpose, after which lane t owns item 4q + t: 8 consecutive channels of
// one pixel.
constexpr int GQ = 2 * NJ / 4;  // groups of four items an m16 tile
__device__ __forceinline__ int item_h(int i) { return i / NJ; }
__device__ __forceinline__ int item_j(int i) { return i % NJ; }

// The residual of the lane's items of a tile's pass (zeros for a conv
// without one and past the image), rv[m][parity][q], loaded before the
// pass's products so that the loads' latency hides behind them. Streaming
// loads (evict first): the block input is read for the last time here.
template <int C>
__device__ __forceinline__ void load_residual(const Conv& a, int tile, int n0,
                                              int lane,
                                              uint4 (&rv)[2][2][GQ]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < GQ; ++q) rv[m][p][q] = make_uint4(0u, 0u, 0u, 0u);
  if (a.res == nullptr) return;
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  if (tl.x0 + g >= a.W) return;
  const bf16* r =
      a.res + (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * C + n0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        const int h = item_h(4 * q + t), j = item_j(4 * q + t);
        const int row = 4 * m + 2 * h + p;
        if (tl.y0 + row < a.H)
          rv[m][p][q] = __ldcs(reinterpret_cast<const uint4*>(
              r + (row * a.W + g) * C + j * 8));
      }
}

// From the accumulator registers of one sum (p = 0: even rows, ye; 1: odd
// rows, yo), by quad transposes: each item gets the bias, the residual, the
// ReLU and one rounding, and goes out in one 16-byte store.
template <int C>
__device__ __forceinline__ void store_rows(const Conv& a, const float* bsm,
                                           const float (&acc)[2][NJ][4],
                                           const uint4 (&rv)[2][2][GQ], int p,
                                           int n0, int tile, int lane) {
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  const bool col_in = tl.x0 + g < a.W;
  bf16* o = a.out + (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * C + n0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int q = 0; q < GQ; ++q) {
      float2 v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * q + s;
        v[s] = make_float2(acc[m][item_j(i)][2 * item_h(i)],
                           acc[m][item_j(i)][2 * item_h(i) + 1]);
      }
      quad_transpose(v, t);  // every lane takes part: no early exit above
      const int h = item_h(4 * q + t), j = item_j(4 * q + t);
      const int row = 4 * m + 2 * h + p;
      if (!col_in || tl.y0 + row >= a.H) continue;
      const float4 b0 = reinterpret_cast<const float4*>(bsm + n0 + j * 8)[0];
      const float4 b1 = reinterpret_cast<const float4*>(bsm + n0 + j * 8)[1];
      const float f[8] = {v[0].x + b0.x, v[0].y + b0.y, v[1].x + b0.z,
                          v[1].y + b0.w, v[2].x + b1.x, v[2].y + b1.y,
                          v[3].x + b1.z, v[3].y + b1.w};
      const bf16* rb = reinterpret_cast<const bf16*>(&rv[m][p][q]);
      uint4 packed;
      bf16* ob = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ob[k] = __float2bfloat16_rn(
            fmaxf(f[k] + __bfloat162float(rb[k]), 0.f));
      *reinterpret_cast<uint4*>(o + (row * a.W + g) * C + j * 8) = packed;
    }
  }
}

template <int C>
__device__ __forceinline__ void epilogue(const Conv& a, const float* bsm,
                                         const float (&ye)[2][NJ][4],
                                         const float (&yo)[2][NJ][4],
                                         const uint4 (&rv)[2][2][GQ], int n0,
                                         int tile, int lane) {
  store_rows<C>(a, bsm, ye, rv, 0, n0, tile, lane);
  store_rows<C>(a, bsm, yo, rv, 1, n0, tile, lane);
}

// One conv. Block k of the grid takes tiles [k n / grid, (k + 1) n / grid)
// (neighbouring tiles, which share halo rows in the L2); its warp w takes
// the block's tiles w, w + warps, ... Launched as a programmatic dependent
// of the conv before it in the chain, it stages its weights while that conv
// drains, then waits for it (griddepcontrol.wait: that grid has completed
// and its writes are visible) before it reads its input or writes.
template <int C>
__global__ void __launch_bounds__(Tc<C>::WARPS * 32)
    wino_conv_bf16(const Conv a) {
  using T = Tc<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* usm = reinterpret_cast<bf16*>(smem);
  float* bsm = reinterpret_cast<float*>(smem + T::U_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  bf16* ring =
      reinterpret_cast<bf16*>(smem + T::FIXED) + warp * SLOTS * T::SLOT;

  // the next conv's blocks may launch as this conv's blocks exit
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the conv's U, once: 4 x 3C rows of C channels, re-pitched
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < 12 * C * CH; i += blockDim.x) {
    const int row = i / CH;
    const int k = (i - row * CH) * 8;
    cp_async16(usm + row * T::P + k, a.w + (size_t)row * C + k);
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) bsm[i] = a.bias[i];
  cp_async_commit();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lo = (int)((long long)a.n_tiles * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)a.n_tiles * (blockIdx.x + 1) / gridDim.x);
  int tile = lo + warp;
  if (tile < hi) load_tile<C>(a, ring, tile, lane);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's weight copies are in
  __syncthreads();     // ... and every thread's, and the bias

  // Two teams where a block has more tiles than warps: warps [half, warps)
  // start once warps [0, half) have done their first pass's products, so
  // on each SM sub-partition (warp w runs on sub-partition w % 4) one
  // warp's products overlap another's epilogue. With a tile a warp or
  // fewer (W32 branch 0 at 32 crops: 1536 tiles for 132 x 12 warps) the
  // wait would only add half a tile to the conv.
  const int half = warps / 2;
  const bool teams = hi - lo > warps;
  bool arrive = teams && warp < half;
  if (teams && !arrive) team_sync(warps * 32);
  if (arrive && tile >= hi) {
    team_arrive(warps * 32);
    arrive = false;
  }
  const uint32_t u_addr = smem_addr(usm);
  const uint32_t ring_addr = smem_addr(ring);
  for (int n = 0; tile < hi; ++n) {
    const int next = tile + warps;
    __syncwarp();  // every lane is done with the slot refilled next
    if (next < hi)
      load_tile<C>(a, ring + ((n + 1) & 1) * T::SLOT, next, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of the tile are in
    __syncwarp();        // ... and the whole warp's
    const uint32_t slot = ring_addr + (n & 1) * (T::SLOT * 2);
#pragma unroll 1
    for (int n0 = 0; n0 < C; n0 += NO) {
      float ye[2][NJ][4], yo[2][NJ][4];
      uint4 rv[2][2][GQ];
      load_residual<C>(a, tile, n0, lane, rv);
      products<C>(slot, u_addr, n0, ye, yo, lane);
      if (arrive) {
        team_arrive(warps * 32);
        arrive = false;
      }
      epilogue<C>(a, bsm, ye, yo, rv, n0, tile, lane);
    }
    tile = next;
  }
  cp_async_wait<0>();
}

template <int C>
int wino_chain_c(const bf16* x, const bf16* ww, const float* b, bf16* out,
                 bf16* mid, bf16* tmp, int B, int H, int W, cudaStream_t s) {
  using T = Tc<C>;
  // the dynamic shared memory the kernel has been allowed, set once so the
  // launch path stays free of attribute calls inside a CUDA graph capture
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        wino_conv_bf16<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::BYTES);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  // one wave of resident blocks, each walking its share of the tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wino_conv_bf16<C>, T::WARPS * 32, T::BYTES);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Conv a{};
  a.H = H;
  a.W = W;
  a.tiles_x = (W + TILE - 1) / TILE;
  a.tiles_per_image = ((H + TILE - 1) / TILE) * a.tiles_x;
  a.n_tiles = B * a.tiles_per_image;
  const int grid = a.n_tiles < per_sm * sms ? a.n_tiles : per_sm * sms;
  // convs 2-8 are programmatic dependents of the conv before them; the
  // first is launched plainly, as the kernel that wrote the chain's
  // weights or input may be the one before it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(T::WARPS * 32);
  cfg.dynamicSmemBytes = T::BYTES;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  const size_t wstride = (size_t)12 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    a.x = v;
    a.w = ww + (2 * blk) * wstride;
    a.bias = b + (2 * blk) * C;
    a.res = nullptr;
    a.out = mid;
    e = cudaLaunchKernelEx(&cfg, wino_conv_bf16<C>, a);
    if (e != cudaSuccess) return (int)e;
    cfg.numAttrs = 1;
    a.x = mid;
    a.w = ww + (2 * blk + 1) * wstride;
    a.bias = b + (2 * blk + 1) * C;
    a.res = v;
    a.out = block_out[blk];
    e = cudaLaunchKernelEx(&cfg, wino_conv_bf16<C>, a);
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

}  // namespace

// x, out, mid, tmp: (B, H, W, C) NHWC bf16, 16-byte aligned, H even, C 32 or
// 64; ww (8, 4, 3C, C) bf16, 16-byte aligned; b (8, C) f32. mid and tmp are
// scratch the caller allocates. Returns the cudaError_t of the launches (0
// on success).
extern "C" int sht_wino_chain(const void* x, const void* ww, const void* b,
                              void* out, void* mid, void* tmp, int B, int H,
                              int W, int C, void* stream) {
  if (H % 2) return (int)cudaErrorInvalidValue;
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* ws = static_cast<const bf16*>(ww);
  const float* bs = static_cast<const float*>(b);
  bf16* o = static_cast<bf16*>(out);
  bf16* m = static_cast<bf16*>(mid);
  bf16* t = static_cast<bf16*>(tmp);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 32: return wino_chain_c<32>(xs, ws, bs, o, m, t, B, H, W, s);
    case 64: return wino_chain_c<64>(xs, ws, bs, o, m, t, B, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
