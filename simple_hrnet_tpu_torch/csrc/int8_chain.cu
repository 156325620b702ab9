// B4: HRNet's branch-0 chain of 4 BasicBlocks in int8 (8 stride-1 "same"
// 3x3 convs with static per-tensor input scales, per-output-channel weight
// scales, folded-BN bias, ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fused_block.py:241
// _chain_kernel_int8 (behind chain_pallas_int8_grouped, :329), computing
// its UNPACKED function (G = 1), and, with round_handoffs, the XLA chain
// blockdiag_chain_int8_grouped (:153) that the JAX package runs wherever
// the Pallas kernel does not. Arithmetic, in both modes:
//   inva = 1 / ascale[i], alpha = ascale[i] * wscale[i][co]      (f32)
//   conv 0 input: q = clip(rint(x * inva), -127, 127)   from the bf16 input
//   acc (int32, exact) = sum over taps of q * wq
//   conv1: a = relu(acc * alpha + bias)
//   conv2: a = relu(acc * alpha + bias + res)  res = the bf16 block input;
//          stored as bf16
// and the two handoffs of a block (the conv1 output that conv2 quantizes,
// the block output that the next conv1 quantizes):
//   round_handoffs = 0 (the Pallas kernel's cast points): quantized from
//          the f32 value a;
//   round_handoffs = 1 (the XLA chain's): a is rounded to bf16 first and
//          quantized from that.
// Activations are NHWC bf16 with C a multiple of 8 up to 128; wq (8, 3, 3,
// C, C) int8 HWIO; wscale, b (8, C) f32; ascales (8,) f32. Rounding is
// half to even (__float2int_rn, __float2bfloat16_rn), and every product
// and sum of the epilogue is its own IEEE operation (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract acc * alpha + bias into an FMA), so the
// kernel equals its plain version bit for bit.
//
// Bound on the H100: operations. At W32 branch 0 with 32 crops (32, 64, 48,
// 32) one chain is 7.25 G MAC = 14.5 G int8 operations: 7.3 us at the int8
// tensor-core peak (1,979 TOPS); the chain must move only 2 x 6.3 MB of
// bf16 activations (3.8 us at 3.35 TB/s).
//
// Design: K2's per-conv machinery (csrc/fused_block.cu) with int8 products.
// One conv kernel with the quantization fused at both ends, launched 8
// times a chain; the conv1 -> conv2 handoff and each block's quantized
// output live as int8 in device memory, the block outputs as bf16.
//   * persistent blocks, as many as shared memory lets reside: each stages
//     the conv's 3x3 x C x (up to 64) int8 weights once (transposed to rows
//     of input channels, 4 x 4 bytes at a time), with alpha (__fmul_rn) and
//     the bias, then its warps walk their share of 8 x 8-pixel tiles;
//     widths above 64 split the output channels over blockIdx.y;
//   * each warp owns a ring of two 10 x 10-pixel halo slots filled by
//     cp.async copies (16 bytes, or 8 where C % 16 == 8), zero-filled past
//     the image; pixel rows hold the input channels padded with zeros to a
//     multiple of 32 bytes, in a row pitch of an odd number of 16-byte
//     units (C = 32: 48 bytes, C = 48 and 64: 80), so the 8 rows of every
//     ldmatrix fall in 8 different bank groups;
//   * products on the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: a
//     warp computes 64 pixels x the block's output channels, so each B
//     fragment serves the warp's 4 m16 pixel fragments; both operands come
//     by ldmatrix (a b16 ldmatrix.x4 gives exactly the s8 k32 A fragment;
//     the weights sit as rows of input channels, so plain ldmatrix gives
//     the B fragments of two n8 tiles); the padded channels add zeros to
//     the exact int32 sums;
//   * the epilogue runs from the accumulator registers: a transpose inside
//     each quad of lanes gives a lane 8 channels of one pixel, which take
//     acc * alpha + bias, the residual (16-byte loads issued before the
//     tile's products), the ReLU, the bf16 rounding in round_handoffs mode,
//     and go out as 8 bytes of int8 for the next conv and, on conv2, 16
//     bytes of bf16;
//   * the chain's bf16 input is quantized for the first conv by one small
//     kernel ahead of the 8 convs: measured faster (0.0716 against 0.0745
//     ms at (32, 64, 48, 32) on an H100 80GB HBM3 at 700 W, PERF.md
//     section 6) than quantizing it while
//     staging each halo (synchronous 16-byte bf16 loads, 8-byte int8
//     stores into the slot), whose loads no copy overlaps;
//   * where a block has more tiles than warps, its warps form two teams
//     half a tile apart (B3's rule);
//   * each of the 8 convs is a programmatic dependent launch of the kernel
//     before it (cudaLaunchKernelEx): its blocks stage their weights while
//     that kernel drains, then wait for it
//     (griddepcontrol.wait) before touching its output; CUDA graph capture
//     keeps the dependence.
// What still holds it back (its phases' times) is in PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 8;             // output tile side (pixels)
constexpr int HALO = TILE + 2;      // halo tile side
constexpr int SLOTS = 2;            // ring slots a warp
constexpr int SMEM_LIMIT = 232448;  // what one block can use on the H100

// The kernel's shape for a class of widths: KS k32 steps (input channels
// padded with zeros to 32 KS), NJ n8 tiles of output channels a block (NJ
// even: the B fragments of two n8 tiles come in one ldmatrix.x4).
template <int KS, int NJ> struct Tc {
  static constexpr int KP = 32 * KS;             // padded input channels
  static constexpr int P = KP + 16;              // row pitch (bytes)
  static constexpr int NO = 8 * NJ;              // output channels a block
  static constexpr int W_BYTES = 9 * NO * P;     // weights [tap][o][ci]
  static constexpr int FIXED = W_BYTES + 2 * NO * 4;  // + alpha, bias
  static constexpr int SLOT = HALO * HALO * P;   // bytes a slot
  static constexpr int WARP_BYTES = SLOTS * SLOT;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / WARP_BYTES;
  // registers: 170 a thread at 12 warps, 255 at 8 (NJ = 8: 128 int32
  // accumulators and 64 registers of residual)
  static constexpr int MAX_WARPS = NJ <= 4 ? 12 : 8;
  static constexpr int WARPS = FIT < MAX_WARPS ? FIT : MAX_WARPS;
  static constexpr int BYTES = FIXED + WARPS * WARP_BYTES;
  static constexpr int GQ = NJ / 2;  // epilogue groups of four items
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
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

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a barrier of `threads` threads on named barrier 1, and an arrival at it
__device__ __forceinline__ void team_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void team_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}

// clip(rint(v * inva), -127, 127), as an int
__device__ __forceinline__ int quant(float v, float inva) {
  return max(-127, min(__float2int_rn(__fmul_rn(v, inva)), 127));
}

// 8 bf16 (16 bytes) -> 8 int8 (8 bytes) with the conv's 1 / ascale
__device__ __forceinline__ uint2 quant8(const uint4& v, float inva) {
  const bf16* vb = reinterpret_cast<const bf16*>(&v);
  uint2 q;
  int8_t* qb = reinterpret_cast<int8_t*>(&q);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    qb[e] = (int8_t)quant(__bfloat162float(vb[e]), inva);
  return q;
}

struct Conv {
  const int8_t* x;            // (B, H, W, C) int8 input
  const int8_t* w;            // (3, 3, C, C) HWIO
  const float* wscale;        // (C,)
  const float* bias;          // (C,)
  const float* ascale;        // this conv's input scale
  const float* ascale_next;   // the next conv's, or null (no int8 output)
  const bf16* res;            // (B, H, W, C) residual, or null
  bf16* out;                  // (B, H, W, C) bf16 output, or null
  int8_t* qout;               // (B, H, W, C) int8 output, or null
  int H, W, C, tiles_x, tiles_per_image, n_tiles, round_handoffs;
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

// A lane's share of a halo copy: chunks of cw bytes (16, or 8 where C % 16
// == 8), ch chunks a pixel; the warp covers ppi pixels an iteration, this
// lane pixel p0 + k ppi at byte k0.
struct LoadLane {
  int cw, k0, p0, ppi;
  bool on;
};

__device__ __forceinline__ LoadLane load_lane(int C, int lane) {
  LoadLane l;
  l.cw = C % 16 ? 8 : 16;
  const int ch = C / l.cw;
  l.ppi = 32 / ch;
  l.p0 = lane / ch;
  l.k0 = (lane - l.p0 * ch) * l.cw;
  l.on = l.p0 < l.ppi;
  return l;
}

// Start the warp's cp.async copies of one tile's halo (HALO x HALO pixels,
// channels 0 .. C - 1 of each; channels C .. KP - 1 stay zero) into a ring
// slot; pixels past the image are zero-filled, the conv's "same" padding.
template <int KS, int NJ>
__device__ __forceinline__ void load_tile(const Conv& a, const LoadLane& l,
                                          unsigned char* slot, int tile) {
  constexpr int P = Tc<KS, NJ>::P;
  if (!l.on) return;
  const Tile t = tile_of(a, tile);
  const size_t img = (size_t)t.b * a.H * a.W * a.C;
#pragma unroll 4
  for (int p = l.p0; p < HALO * HALO; p += l.ppi) {
    const int py = p / HALO;
    const int gy = t.y0 - 1 + py;
    const int gx = t.x0 - 1 + (p - py * HALO);
    const bool in =
        (unsigned)gy < (unsigned)a.H && (unsigned)gx < (unsigned)a.W;
    const int8_t* src =
        in ? a.x + img + ((size_t)gy * a.W + gx) * a.C + l.k0 : a.x;
    unsigned char* dst = slot + p * P + l.k0;
    if (l.cw == 16)
      cp_async16_zfill(dst, src, in ? 16 : 0);
    else
      cp_async8_zfill(dst, src, in ? 8 : 0);
  }
}

// acc[m][j] += the tile's 3x3 conv for pixels 16m..16m+15 (row r of m16
// tile m is pixel (2m + r / 8, r % 8) of the 8 x 8 tile) and the block's
// output channels 8j..8j+7: per tap and 32 input channels, 4 A fragments
// (ldmatrix from the halo slot) and NJ / 2 ldmatrix of the weight rows,
// each giving the B fragments of two n8 tiles that serve all 4 A
// fragments. The kernel rows (ky) are not unrolled: that keeps the
// residual's registers (live across the products) clear of spills.
template <int KS, int NJ>
__device__ __forceinline__ void products(uint32_t slot, uint32_t wsm,
                                         int (&acc)[4][NJ][4], int lane) {
  using T = Tc<KS, NJ>;
  const int r = lane & 15;
  // A: lane l gives row l % 16 of matrices (l / 8); k half l / 16
  const uint32_t a0 =
      slot + ((r >> 3) * HALO + (r & 7)) * T::P + (lane >> 4) * 16;
  // B: lane l gives the row of output channel 8 (l / 16) + l % 8 (of the
  // pair of n8 tiles), k half (l / 8) % 2
  const uint32_t b0 =
      wsm + ((lane >> 4) * 8 + (lane & 7)) * T::P + ((lane >> 3) & 1) * 16;
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t af[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ldsm_x4(a0 + ((2 * m + ky) * HALO + kx) * T::P + kk * 32, af[m]);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t bfr[4];
          ldsm_x4(b0 + ((ky * 3 + kx) * T::NO + jp * 16) * T::P + kk * 32,
                  bfr);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mma_s8(acc[m][2 * jp], af[m], bfr);
            mma_s8(acc[m][2 * jp + 1], af[m], bfr + 2);
          }
        }
      }
    }
  }
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

// The epilogue's items: lane 4g + t holds, for pixel row g (h = 0) and
// g + 8 (h = 1) of each m16 tile, channels 8j + 2t, 8j + 2t + 1 of every n8
// tile j. Items i = h NJ + j go by fours (q) through a quad transpose,
// after which lane t owns item 4q + t: 8 consecutive channels of one pixel.

// The residual of the lane's items of a tile (zeros for a conv without one
// and past the image), loaded before the tile's products so that the
// loads' latency hides behind them. Streaming loads (evict first): the
// block input is read for the last time here.
template <int KS, int NJ>
__device__ __forceinline__ void load_residual(
    const Conv& a, int oc0, int tile, int lane,
    uint4 (&rv)[4][Tc<KS, NJ>::GQ]) {
  using T = Tc<KS, NJ>;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < T::GQ; ++q) rv[m][q] = make_uint4(0u, 0u, 0u, 0u);
  if (a.res == nullptr) return;
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  if (tl.x0 + g >= a.W) return;
  const bf16* r =
      a.res + (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * a.C + oc0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < T::GQ; ++q) {
      const int h = (4 * q + t) / NJ, j = (4 * q + t) % NJ;
      if (tl.y0 + 2 * m + h < a.H && oc0 + 8 * j < a.C)
        rv[m][q] = __ldcs(reinterpret_cast<const uint4*>(
            r + ((2 * m + h) * a.W + g) * a.C + j * 8));
    }
  }
}

// From the accumulator registers, by quad transposes: each item takes
// acc * alpha + bias, the residual, the ReLU and, in round_handoffs mode,
// the bf16 rounding, and goes out as 8 bytes of int8 (quantized for the
// next conv) and, where the conv has a bf16 output, 16 bytes of bf16.
template <int KS, int NJ>
__device__ __forceinline__ void epilogue(
    const Conv& a, const float* alsm, const float* bsm, float inva_next,
    int oc0, int (&acc)[4][NJ][4], const uint4 (&rv)[4][Tc<KS, NJ>::GQ],
    int tile, int lane) {
  using T = Tc<KS, NJ>;
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  const bool col_in = tl.x0 + g < a.W;
  const size_t base =
      (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * a.C + oc0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < T::GQ; ++q) {
      float2 v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * q + s;
        v[s] = make_float2(__int2float_rn(acc[m][i % NJ][2 * (i / NJ)]),
                           __int2float_rn(acc[m][i % NJ][2 * (i / NJ) + 1]));
      }
      quad_transpose(v, t);  // every lane takes part: no early exit above
      const int h = (4 * q + t) / NJ, j = (4 * q + t) % NJ;
      if (!col_in || tl.y0 + 2 * m + h >= a.H || oc0 + 8 * j >= a.C)
        continue;
      const float f[8] = {v[0].x, v[0].y, v[1].x, v[1].y,
                          v[2].x, v[2].y, v[3].x, v[3].y};
      const float4 al[2] = {reinterpret_cast<const float4*>(alsm + j * 8)[0],
                            reinterpret_cast<const float4*>(alsm + j * 8)[1]};
      const float4 bi[2] = {reinterpret_cast<const float4*>(bsm + j * 8)[0],
                            reinterpret_cast<const float4*>(bsm + j * 8)[1]};
      const float* alf = reinterpret_cast<const float*>(al);
      const float* bif = reinterpret_cast<const float*>(bi);
      const __nv_bfloat162* rb =
          reinterpret_cast<const __nv_bfloat162*>(&rv[m][q]);
      uint4 packed;
      __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&packed);
      int qi[8];
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        float2 y = make_float2(__fadd_rn(__fmul_rn(f[k], alf[k]), bif[k]),
                               __fadd_rn(__fmul_rn(f[k + 1], alf[k + 1]),
                                         bif[k + 1]));
        if (a.res != nullptr) {
          const float2 r = __bfloat1622float2(rb[k / 2]);
          y = make_float2(__fadd_rn(y.x, r.x), __fadd_rn(y.y, r.y));
        }
        y = make_float2(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
        ob[k / 2] = __floats2bfloat162_rn(y.x, y.y);
        if (a.round_handoffs) y = __bfloat1622float2(ob[k / 2]);
        qi[k] = quant(y.x, inva_next);
        qi[k + 1] = quant(y.y, inva_next);
      }
      const uint2 qv = make_uint2(
          __byte_perm(__byte_perm(qi[0], qi[1], 0x0040),
                      __byte_perm(qi[2], qi[3], 0x0040), 0x5410),
          __byte_perm(__byte_perm(qi[4], qi[5], 0x0040),
                      __byte_perm(qi[6], qi[7], 0x0040), 0x5410));
      const size_t oi = base + ((2 * m + h) * a.W + g) * a.C + j * 8;
      if (a.qout != nullptr) *reinterpret_cast<uint2*>(a.qout + oi) = qv;
      if (a.out != nullptr) *reinterpret_cast<uint4*>(a.out + oi) = packed;
    }
  }
}

// One conv. blockIdx.y picks the block's NO output channels. Block k of a
// row of the grid takes tiles [k n / gridDim.x, (k + 1) n / gridDim.x)
// (neighbouring tiles, which share halo rows in the L2); its warp w takes
// the block's tiles w, w + warps, ... Launched as a programmatic dependent
// of the kernel before it in the chain, it stages its weights while that
// kernel drains, then waits for it (griddepcontrol.wait: that grid has
// completed and its writes are visible) before it reads its input or
// writes.
template <int KS, int NJ>
__global__ void __launch_bounds__(Tc<KS, NJ>::WARPS * 32)
    int8_conv_tc(const Conv a) {
  using T = Tc<KS, NJ>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wsm = smem;
  float* alsm = reinterpret_cast<float*>(smem + T::W_BYTES);
  float* bsm = alsm + T::NO;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  unsigned char* ring = smem + T::FIXED + warp * T::WARP_BYTES;
  const int oc0 = blockIdx.y * T::NO;

  // the next conv's blocks may launch as this conv's blocks exit
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the block's weights, once: wsm[tap][o][ci] = w[tap][ci][oc0 + o], by
  // 4 x 4-byte squares (4 input channels of 4 output channels, read as 4
  // words and transposed); zeros past C
  constexpr int C4 = T::KP / 4, O4 = T::NO / 4;
  for (int i = threadIdx.x; i < 9 * C4 * O4; i += blockDim.x) {
    const int o4 = i % O4;
    const int c4 = (i / O4) % C4;
    const int tap = i / (O4 * C4);
    const int ci = 4 * c4, co = oc0 + 4 * o4;
    uint32_t w4[4] = {0u, 0u, 0u, 0u};
    if (ci < a.C && co < a.C) {
      const int8_t* src = a.w + ((size_t)tap * a.C + ci) * a.C + co;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w4[r] = *reinterpret_cast<const uint32_t*>(src + (size_t)r * a.C);
    }
    const uint32_t lo01 = __byte_perm(w4[0], w4[1], 0x5140);
    const uint32_t lo23 = __byte_perm(w4[2], w4[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w4[0], w4[1], 0x7362);
    const uint32_t hi23 = __byte_perm(w4[2], w4[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(lo01, lo23, 0x5410),
                           __byte_perm(lo01, lo23, 0x7632),
                           __byte_perm(hi01, hi23, 0x5410),
                           __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint32_t*>(
          wsm + (tap * T::NO + 4 * o4 + s) * T::P + ci) = o[s];
  }
  const float a_in = *a.ascale;
  for (int i = threadIdx.x; i < T::NO; i += blockDim.x) {
    const int oc = oc0 + i;
    alsm[i] = oc < a.C ? __fmul_rn(a_in, a.wscale[oc]) : 0.f;
    bsm[i] = oc < a.C ? a.bias[oc] : 0.f;
  }
  const float inva_next =
      a.ascale_next != nullptr ? __fdiv_rn(1.0f, *a.ascale_next) : 0.f;
  // input channels C .. KP - 1 of every slot row stay zero
  if (a.C < T::KP)
    for (int i = lane; i < T::WARP_BYTES / 16; i += 32)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  const LoadLane ld = load_lane(a.C, lane);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lo = (int)((long long)a.n_tiles * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)a.n_tiles * (blockIdx.x + 1) / gridDim.x);
  int tile = lo + warp;
  __syncwarp();  // the ring's zeros are in before the copies
  if (tile < hi) load_tile<KS, NJ>(a, ld, ring, tile);
  cp_async_commit();
  __syncthreads();  // the weights, alpha and bias are in

  // Two teams where a block has more tiles than warps: warps [half, warps)
  // start once warps [0, half) have done their first tile's products, so
  // on each SM sub-partition one warp's products overlap another's
  // epilogue. With a tile a warp or fewer the wait would only add half a
  // tile to the conv.
  const int half = warps / 2;
  const bool teams = hi - lo > warps;
  bool arrive = teams && warp < half;
  if (teams && !arrive) team_sync(warps * 32);
  if (arrive && tile >= hi) {
    team_arrive(warps * 32);
    arrive = false;
  }
  const uint32_t w_addr = smem_addr(wsm);
  const uint32_t ring_addr = smem_addr(ring);
  for (int n = 0; tile < hi; ++n) {
    const int next = tile + warps;
    __syncwarp();  // every lane is done with the slot refilled next
    if (next < hi)
      load_tile<KS, NJ>(a, ld, ring + ((n + 1) & 1) * T::SLOT, next);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of the tile are in
    __syncwarp();        // ... and the whole warp's
    int acc[4][NJ][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0;
    uint4 rv[4][T::GQ];
    load_residual<KS, NJ>(a, oc0, tile, lane, rv);
    products<KS, NJ>(ring_addr + (n & 1) * T::SLOT, w_addr, acc, lane);
    if (arrive) {
      team_arrive(warps * 32);
      arrive = false;
    }
    epilogue<KS, NJ>(a, alsm, bsm, inva_next, oc0, acc, rv, tile, lane);
    tile = next;
  }
  cp_async_wait<0>();
}

// The chain's bf16 input quantized for its first conv, 8 values a thread.
__global__ void __launch_bounds__(256)
    int8_quantize(const bf16* __restrict__ x, const float* __restrict__ ascale,
                  int8_t* __restrict__ q, size_t n8) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const float inva = __fdiv_rn(1.0f, *ascale);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x)
    reinterpret_cast<uint2*>(q)[i] =
        quant8(__ldcs(reinterpret_cast<const uint4*>(x) + i), inva);
}

// The dynamic shared memory a kernel has been allowed, set once so that
// the launch path stays free of attribute calls inside a CUDA graph
// capture; and how many of its blocks fit on an SM.
template <int KS, int NJ>
cudaError_t prepare(int* per_sm) {
  using T = Tc<KS, NJ>;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_tc<KS, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::BYTES);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, int8_conv_tc<KS, NJ>, T::WARPS * 32, T::BYTES);
}

template <int KS, int NJ>
int chain_c(const bf16* x, const int8_t* wq, const float* wscale,
            const float* b, const float* ascales, bf16* out, bf16* tmp,
            int8_t* qa, int8_t* qmid, int B, int H, int W, int C,
            int round_handoffs, cudaStream_t s) {
  using T = Tc<KS, NJ>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = prepare<KS, NJ>(&per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Conv a{};
  a.H = H;
  a.W = W;
  a.C = C;
  a.round_handoffs = round_handoffs;
  a.tiles_x = (W + TILE - 1) / TILE;
  a.tiles_per_image = ((H + TILE - 1) / TILE) * a.tiles_x;
  a.n_tiles = B * a.tiles_per_image;
  // one wave of resident blocks over both grid rows, each block walking
  // its share of the tiles
  const int ny = (C + T::NO - 1) / T::NO;
  const int fit = per_sm * sms / ny > 1 ? per_sm * sms / ny : 1;
  const dim3 grid(a.n_tiles < fit ? a.n_tiles : fit, ny);
  // the 8 convs are programmatic dependents of the kernel before them; the
  // quantize kernel is launched plainly, as the kernel that wrote the
  // chain's weights or input may be the one before it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::WARPS * 32);
  cfg.dynamicSmemBytes = T::BYTES;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  const size_t n8 = (size_t)B * H * W * C / 8;
  const size_t want = (n8 + 255) / 256, most = (size_t)sms * 8;
  cudaLaunchConfig_t qcfg = cfg;
  qcfg.gridDim = dim3((unsigned)(want < most ? want : most));
  qcfg.blockDim = dim3(256);
  qcfg.dynamicSmemBytes = 0;
  e = cudaLaunchKernelEx(&qcfg, int8_quantize, x, ascales, qa, n8);
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 1;
  const size_t wstride = (size_t)9 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    const int i1 = 2 * blk, i2 = 2 * blk + 1;
    a.x = qa;
    a.w = wq + i1 * wstride;
    a.wscale = wscale + i1 * C;
    a.bias = b + i1 * C;
    a.ascale = ascales + i1;
    a.ascale_next = ascales + i2;
    a.res = nullptr;
    a.out = nullptr;
    a.qout = qmid;
    e = cudaLaunchKernelEx(&cfg, int8_conv_tc<KS, NJ>, a);
    if (e != cudaSuccess) return (int)e;
    a.x = qmid;
    a.w = wq + i2 * wstride;
    a.wscale = wscale + i2 * C;
    a.bias = b + i2 * C;
    a.ascale = ascales + i2;
    a.ascale_next = blk < 3 ? ascales + i2 + 1 : nullptr;
    a.res = v;
    a.out = block_out[blk];
    a.qout = blk < 3 ? qa : nullptr;
    e = cudaLaunchKernelEx(&cfg, int8_conv_tc<KS, NJ>, a);
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

}  // namespace

// x, out, tmp: (B, H, W, C) NHWC bf16, 16-byte aligned, C a multiple of 8
// up to 128; qa, qmid: (B, H, W, C) int8 scratch, 16-byte aligned; wq (8,
// 3, 3, C, C) int8 HWIO; wscale, b (8, C) f32; ascales (8,) f32;
// round_handoffs 0 (the Pallas kernel's cast points) or 1 (the XLA
// chain's). Returns the cudaError_t of the launches (0 on success).
extern "C" int sht_int8_chain(const void* x, const void* wq,
                              const void* wscale, const void* b,
                              const void* ascales, void* out, void* tmp,
                              void* qa, void* qmid, int B, int H, int W,
                              int C, void* stream, int round_handoffs) {
  if (C <= 0 || C % 8 || C > 128) return (int)cudaErrorInvalidValue;
  const bf16* xs = static_cast<const bf16*>(x);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* ws = static_cast<const float*>(wscale);
  const float* bs = static_cast<const float*>(b);
  const float* as = static_cast<const float*>(ascales);
  bf16* o = static_cast<bf16*>(out);
  bf16* t = static_cast<bf16*>(tmp);
  int8_t* q1 = static_cast<int8_t*>(qa);
  int8_t* q2 = static_cast<int8_t*>(qmid);
  const cudaStream_t s = (cudaStream_t)stream;
  const int r = round_handoffs != 0;
  if (C <= 16)
    return chain_c<1, 2>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
  if (C <= 32)
    return chain_c<1, 4>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
  if (C <= 48)
    return chain_c<2, 6>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
  if (C <= 64)
    return chain_c<2, 8>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
  if (C <= 96)
    return chain_c<3, 8>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
  return chain_c<4, 8>(xs, w, ws, bs, as, o, t, q1, q2, B, H, W, C, r, s);
}
