// K2: HRNet's branch-0 chain of 4 BasicBlocks (8 stride-1 "same" 3x3
// convs with folded-BN bias, ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fused_block.py
// _chain_kernel (behind chain_pallas_grouped / fused_basic_chain), computing
// its UNPACKED function: no block-diagonal image packing (G = 1).
//
// Arithmetic and cast points follow _chain_kernel:
//   acc (f32) = bias + sum over taps of x * w   (x, w in the activation type)
//   conv1: mid = relu(acc)                 rounded to the activation type
//   conv2: out = relu(acc + residual)      residual = the block input, read
//                                          back in the activation type
// The bf16 path sums each tap's products on the tensor cores (f32
// accumulators, taps in (ky, kx) order, 16 input channels at a time) and
// adds the bias after the sum, not before: a different f32 summation order
// from the plain version, well inside the 2^-6 of max that the checks hold
// it to. Activations are NHWC, bf16 or f32; weights (8, 3, 3, C, C) HWIO in
// the activation type; biases (8, C) f32. f32 takes C a multiple of 8,
// bf16 C in {16, 32, 48, 64}.
//
// Bounds on the H100 at the W48 branch-0 shape with 32 crops (32, 96, 72,
// 48), bf16: operations, 73.4 GFLOP a chain, 0.0742 ms at the tensor-core
// peak (989 TFLOP/s). Each conv is its own launch with its input and output
// in device memory, so the 8 launches move 20 passes of the 21.2 MB
// activation (8 inputs, 8 outputs, 4 residuals): 425 MB, 0.127 ms at 3.35
// TB/s, which the L2 (50 MB) partly catches.
//
// bf16 design: one conv kernel with the epilogue fused, launched 8 times a
// chain (intermediates in device memory).
//   * persistent blocks, one a SM: each stages the conv's 3x3xCxC weights
//     and its bias in shared memory once, then its warps walk their share
//     of 8 x 8-pixel output tiles (8 divides every stage width: 72, 48);
//   * each warp owns its tiles and a ring of two halo slots (10 x 10 pixels
//     x C channels) filled by 16-byte cp.async copies (zero-filled past the
//     image), so a tile's loads are in flight while the warp computes the
//     previous one; a warp synchronises only with itself (__syncwarp);
//   * products on the tensor cores, mma.sync m16n8k16 bf16 -> f32: a warp
//     computes 64 pixels x all C output channels (4 m16 x C/8 n8 tiles of
//     accumulators in registers), so each weight fragment serves 4 pixel
//     fragments; both operands come by ldmatrix from rows padded to C + 8
//     channels, an odd number of 16-byte units, so the 8 rows of each 8 x 8
//     matrix fall in 8 different bank groups;
//   * the epilogue runs from the accumulator registers: a transpose inside
//     each quad of lanes (shuffles) gives a lane 8 consecutive channels of
//     one pixel, which get the bias (from shared memory), the residual
//     (16-byte loads issued before the tile's products, so their latency
//     hides behind them), the ReLU and one rounding, and go out in one
//     16-byte store;
//   * the warps of a block form two teams half a tile apart, so that while
//     one warp of an SM sub-partition waits on its epilogue's memory
//     traffic the other keeps the tensor cores busy;
//   * each conv after the first is a programmatic dependent launch of the
//     one before: its blocks start, and stage their weights, as the earlier
//     conv's blocks exit, and wait for that grid before touching its output.
// f32 design: on the CUDA cores (the tensor cores' f32 path is TF32, which
// would not keep f32 results). A block computes a 32 x 8 pixel tile for 16
// output channels, staging 16 input channels at a time.
// What still holds the bf16 path back (its phases' times, measured one at a
// time on the card) is in PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the dynamic shared memory attribute is set per device: a function's
// attribute lives in the current device's context
constexpr int MAX_DEVICES = 64;

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- f32 path

constexpr int TW = 8;    // tile width (pixels)
constexpr int TH = 32;   // tile height (pixels)
constexpr int CK = 16;   // input channels staged per step
constexpr int OCB = 16;  // output channels per block
constexpr int NT = TW * TH;

__global__ void __launch_bounds__(NT)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ res,
            float* __restrict__ out, int H, int W, int C, int n_oc_blocks) {
  __shared__ float xs[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][CK][OCB];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_oc_blocks;
  const int oc0 = (blockIdx.z - b * n_oc_blocks) * OCB;
  const float* xb = x + (size_t)b * H * W * C;

  float acc[OCB];
#pragma unroll
  for (int o = 0; o < OCB; ++o) acc[o] = (oc0 + o < C) ? bias[oc0 + o] : 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous step's reads of xs / ws are done
    for (int t = threadIdx.x; t < (TH + 2) * (TW + 2) * CK; t += NT) {
      const int ci = t % CK;
      const int p = t / CK;
      const int px = p % (TW + 2);
      const int py = p / (TW + 2);
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int gc = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        v = xb[((size_t)gy * W + gx) * C + gc];
      xs[ci][py][px] = v;
    }
    for (int t = threadIdx.x; t < 9 * CK * OCB; t += NT) {
      const int o = t % OCB;
      const int ci = (t / OCB) % CK;
      const int tap = t / (OCB * CK);
      const int gc = c0 + ci;
      const int go = oc0 + o;
      ws[tap][ci][o] =
          (gc < C && go < C) ? w[((size_t)tap * C + gc) * C + go] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll 4
        for (int ci = 0; ci < CK; ++ci) {
          const float xv = xs[ci][ty + ky][tx + kx];
          const float4* wp =
              reinterpret_cast<const float4*>(&ws[ky * 3 + kx][ci][0]);
#pragma unroll
          for (int q = 0; q < OCB / 4; ++q) {
            const float4 wv = wp[q];
            acc[4 * q + 0] += xv * wv.x;
            acc[4 * q + 1] += xv * wv.y;
            acc[4 * q + 2] += xv * wv.z;
            acc[4 * q + 3] += xv * wv.w;
          }
        }
      }
    }
  }

  const int oy = y0 + ty;
  const int ox = x0 + tx;
  if (oy < H && ox < W) {
    const size_t base = (((size_t)b * H + oy) * W + ox) * C;
#pragma unroll
    for (int o = 0; o < OCB; ++o) {
      const int oc = oc0 + o;
      if (oc < C) {
        float v = acc[o];
        if (res != nullptr) v += res[base + oc];
        out[base + oc] = fmaxf(v, 0.f);
      }
    }
  }
}

int chain_f32(const float* x, const float* w, const float* b, float* out,
              float* mid, float* tmp, int B, int H, int W, int C,
              cudaStream_t s) {
  const int nob = (C + OCB - 1) / OCB;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nob);
  const size_t wstride = (size_t)9 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  float* block_out[4] = {tmp, out, tmp, out};
  const float* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    conv3x3_f32<<<grid, NT, 0, s>>>(v, w + (2 * blk) * wstride,
                                    b + (2 * blk) * C, nullptr, mid, H, W, C,
                                    nob);
    conv3x3_f32<<<grid, NT, 0, s>>>(mid, w + (2 * blk + 1) * wstride,
                                    b + (2 * blk + 1) * C, v, block_out[blk],
                                    H, W, C, nob);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

// --------------------------------------------------- bf16 tensor-core path

constexpr int TILE = 8;             // output tile side (pixels): a warp's
constexpr int HALO = TILE + 2;      // halo tile side
constexpr int SLOTS = 2;            // ring slots a warp
constexpr int SMEM_LIMIT = 232448;  // what one block can use on the H100

// Shared memory rows (a pixel's channels, or a weight row's output
// channels) are C + 8 wide: an odd number of 16-byte units for C % 16 == 0.
template <int C> struct Tc {
  static constexpr int P = C + 8;                      // row pitch (elements)
  static constexpr int NJ = C / 8;                     // n8 accumulator tiles
  static constexpr int W_BYTES = 9 * C * P * 2;        // weights
  static constexpr int FIXED = W_BYTES + C * 4;        // + bias
  static constexpr int SLOT = HALO * HALO * P;         // elements a slot
  static constexpr int WARP_BYTES = SLOTS * SLOT * 2;  // one warp's ring
  // the warps whose rings fit beside the weights (at most 16)
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / WARP_BYTES;
  static constexpr int WARPS = FIT < 16 ? FIT : 16;
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
  const bf16* w;      // (3, 3, C, C) HWIO
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
// conv's "same" padding.
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

// acc[m][j] += the tile's 3x3 conv for pixels 16m..16m+15 (row r of m16
// tile m is pixel (2m + r / 8, r % 8) of the 8 x 8 tile) and output channels
// 8j..8j+7: per tap and 16 input channels, 4 A fragments (ldmatrix from the
// halo slot) and C/16 ldmatrix.trans of the weights, each giving the B
// fragments of two n8 tiles that serve all 4 A fragments. The kernel rows
// (ky) are not unrolled: that keeps the residual's registers (rv, live
// across the products) clear of spills.
template <int C>
__device__ __forceinline__ void products(uint32_t slot, uint32_t wsm,
                                         float (&acc)[4][Tc<C>::NJ][4],
                                         int lane) {
  constexpr int P2 = Tc<C>::P * 2;  // row pitch (bytes)
  const int r = lane & 15;
  // A: lane l gives row l % 16 of matrices (l / 8); k half l / 16
  const uint32_t a0 =
      slot + ((r >> 3) * HALO + (r & 7)) * P2 + (lane >> 4) * 16;
  // B: lane l gives weight row (input channel) l % 16, output half l / 16
  const uint32_t b0 = wsm + r * P2 + (lane >> 4) * 16;
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t af[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ldsm_x4(a0 + ((2 * m + ky) * HALO + kx) * P2 + kk * 32, af[m]);
#pragma unroll
        for (int jp = 0; jp < C / 16; ++jp) {
          uint32_t bfr[4];
          ldsm_x4_trans(b0 + ((ky * 3 + kx) * C + kk * 16) * P2 + jp * 32,
                        bfr);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mma_bf16(acc[m][2 * jp], af[m], bfr);
            mma_bf16(acc[m][2 * jp + 1], af[m], bfr + 2);
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
// tile j. Items (h, j) go by fours (q) through a quad transpose, after which
// lane t owns item 4q + t: 8 consecutive channels of one pixel.
template <int C> struct Items {
  static constexpr int NJ = Tc<C>::NJ;
  static constexpr int GQ = 2 * NJ / 4;  // groups of four items an m16 tile
  __device__ static int h(int i) { return i / NJ; }
  __device__ static int j(int i) { return i % NJ; }
};

// The residual of the lane's items of a tile (zeros for a conv without one
// and past the image), loaded before the tile's products so that the
// loads' latency hides behind them. Streaming loads (evict first): the
// block input is read for the last time here.
template <int C>
__device__ __forceinline__ void load_residual(const Conv& a, int tile,
                                              int lane,
                                              uint4 (&rv)[4][Items<C>::GQ]) {
  using I = Items<C>;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < I::GQ; ++q) rv[m][q] = make_uint4(0u, 0u, 0u, 0u);
  if (a.res == nullptr) return;
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  if (tl.x0 + g >= a.W) return;
  const bf16* r = a.res + (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * C;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < I::GQ; ++q) {
      const int h = I::h(4 * q + t), j = I::j(4 * q + t);
      if (tl.y0 + 2 * m + h < a.H)
        rv[m][q] = __ldcs(reinterpret_cast<const uint4*>(
            r + ((2 * m + h) * a.W + g) * C + j * 8));
    }
  }
}

// From the accumulator registers, by quad transposes (Items): each item
// gets the bias, the residual, the ReLU and one rounding, and goes out in
// one 16-byte store.
template <int C>
__device__ __forceinline__ void epilogue(const Conv& a, const float* bsm,
                                         float (&acc)[4][Tc<C>::NJ][4],
                                         const uint4 (&rv)[4][Items<C>::GQ],
                                         int tile, int lane) {
  using I = Items<C>;
  const Tile tl = tile_of(a, tile);
  const int t = lane & 3, g = lane >> 2;
  const bool col_in = tl.x0 + g < a.W;
  bf16* o = a.out + (((size_t)tl.b * a.H + tl.y0) * a.W + tl.x0) * C;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < I::GQ; ++q) {
      float2 v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * q + s;
        v[s] = make_float2(acc[m][I::j(i)][2 * I::h(i)],
                           acc[m][I::j(i)][2 * I::h(i) + 1]);
      }
      quad_transpose(v, t);  // every lane takes part: no early exit above
      const int h = I::h(4 * q + t), j = I::j(4 * q + t);
      if (!col_in || tl.y0 + 2 * m + h >= a.H) continue;
      const float4 b0 = reinterpret_cast<const float4*>(bsm + j * 8)[0];
      const float4 b1 = reinterpret_cast<const float4*>(bsm + j * 8)[1];
      const float f[8] = {v[0].x + b0.x, v[0].y + b0.y, v[1].x + b0.z,
                          v[1].y + b0.w, v[2].x + b1.x, v[2].y + b1.y,
                          v[3].x + b1.z, v[3].y + b1.w};
      const bf16* rb = reinterpret_cast<const bf16*>(&rv[m][q]);
      uint4 packed;
      bf16* ob = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ob[k] = __float2bfloat16_rn(
            fmaxf(f[k] + __bfloat162float(rb[k]), 0.f));
      *reinterpret_cast<uint4*>(o + ((2 * m + h) * a.W + g) * C + j * 8) =
          packed;
    }
  }
}

// One conv. Block k of the grid takes tiles [k n / grid, (k + 1) n / grid)
// (neighbouring tiles, which share halo rows in the L2); its warp w takes
// the block's tiles w, w + warps, ... Launched as a programmatic dependent
// of the conv before it in the chain, it stages its weights while that conv
// drains, then waits for it (griddepcontrol.wait: that grid has completed
// and its writes are visible) before it reads its input or writes.
template <int C>
__global__ void __launch_bounds__(Tc<C>::WARPS * 32)
    conv3x3_bf16_tc(const Conv a) {
  using T = Tc<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  float* bsm = reinterpret_cast<float*>(smem + T::W_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  bf16* ring =
      reinterpret_cast<bf16*>(smem + T::FIXED) + warp * SLOTS * T::SLOT;

  // the next conv's blocks may launch as this conv's blocks exit
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the conv's weights, once: 9 C rows of C channels, re-pitched
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < 9 * C * CH; i += blockDim.x) {
    const int row = i / CH;
    const int k = (i - row * CH) * 8;
    cp_async16(wsm + row * T::P + k, a.w + (size_t)row * C + k);
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

  // Two teams: warps [half, warps) start once warps [0, half) have done
  // their first tile's products, so on each SM sub-partition (warp w runs
  // on sub-partition w % 4) one warp's products overlap another's epilogue.
  const int half = warps / 2;
  bool arrive = warp < half;
  if (!arrive) team_sync(warps * 32);
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
      load_tile<C>(a, ring + ((n + 1) & 1) * T::SLOT, next, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of the tile are in
    __syncwarp();        // ... and the whole warp's
    float acc[4][T::NJ][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
    uint4 rv[4][Items<C>::GQ];
    load_residual<C>(a, tile, lane, rv);
    products<C>(ring_addr + (n & 1) * (T::SLOT * 2), w_addr, acc, lane);
    if (arrive) {
      team_arrive(warps * 32);
      arrive = false;
    }
    epilogue<C>(a, bsm, acc, rv, tile, lane);
    tile = next;
  }
  cp_async_wait<0>();
}

template <int C>
int chain_bf16_c(const bf16* x, const bf16* w, const float* b, bf16* out,
                 bf16* mid, bf16* tmp, int B, int H, int W, cudaStream_t s) {
  using T = Tc<C>;
  // the dynamic shared memory the kernel has been allowed, set once so the
  // launch path stays free of attribute calls inside a CUDA graph capture
  static bool allowed[MAX_DEVICES] = {};
  int cur = 0;
  if (cudaGetDevice(&cur) != cudaSuccess || cur >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!allowed[cur]) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_bf16_tc<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::BYTES);
    if (e != cudaSuccess) return (int)e;
    allowed[cur] = true;
  }
  // one wave of resident blocks, each walking its share of the tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_bf16_tc<C>, T::WARPS * 32, T::BYTES);
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
  const size_t wstride = (size_t)9 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    a.x = v;
    a.w = w + (2 * blk) * wstride;
    a.bias = b + (2 * blk) * C;
    a.res = nullptr;
    a.out = mid;
    e = cudaLaunchKernelEx(&cfg, conv3x3_bf16_tc<C>, a);
    if (e != cudaSuccess) return (int)e;
    cfg.numAttrs = 1;
    a.x = mid;
    a.w = w + (2 * blk + 1) * wstride;
    a.bias = b + (2 * blk + 1) * C;
    a.res = v;
    a.out = block_out[blk];
    e = cudaLaunchKernelEx(&cfg, conv3x3_bf16_tc<C>, a);
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

int chain_bf16(const bf16* x, const bf16* w, const float* b, bf16* out,
               bf16* mid, bf16* tmp, int B, int H, int W, int C,
               cudaStream_t s) {
  switch (C) {
    case 16: return chain_bf16_c<16>(x, w, b, out, mid, tmp, B, H, W, s);
    case 32: return chain_bf16_c<32>(x, w, b, out, mid, tmp, B, H, W, s);
    case 48: return chain_bf16_c<48>(x, w, b, out, mid, tmp, B, H, W, s);
    case 64: return chain_bf16_c<64>(x, w, b, out, mid, tmp, B, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out, mid, tmp: (B, H, W, C) NHWC in the activation type (dtype 0 =
// f32, 1 = bf16), 16-byte aligned, C a multiple of 8 (f32) or one of 16,
// 32, 48, 64 (bf16); w (8, 3, 3, C, C) in the activation type; b (8, C)
// f32. mid and tmp are scratch the caller allocates.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int sht_basic_chain(const void* x, const void* w, const void* b,
                               void* out, void* mid, void* tmp, int B, int H,
                               int W, int C, int dtype, void* stream) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bias = static_cast<const float*>(b);
  if (dtype == 0)
    return chain_f32(static_cast<const float*>(x),
                     static_cast<const float*>(w), bias,
                     static_cast<float*>(out), static_cast<float*>(mid),
                     static_cast<float*>(tmp), B, H, W, C, s);
  if (dtype == 1)
    return chain_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                      bias, static_cast<bf16*>(out), static_cast<bf16*>(mid),
                      static_cast<bf16*>(tmp), B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
