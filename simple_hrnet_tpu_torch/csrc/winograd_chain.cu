// B3: HRNet's branch-0 chain of 4 BasicBlocks with each 3x3 conv computed
// as Winograd F(2,3) along H (8 stride-1 "same" convs with folded-BN bias,
// ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/winograd_chain.py
// _wino_kernel (behind chain_pallas_grouped_wino), computing its UNPACKED
// function (G = 1). Per conv and output row pair (2t, 2t+1), from the input
// rows 2t-1 .. 2t+2:
//   V0 = x[2t-1] - x[2t+1]  V1 = x[2t] + x[2t+1]
//   V2 = x[2t+1] - x[2t]    V3 = x[2t] - x[2t+2]       (each rounded to bf16)
//   m_u = sum over kx, ci of V_u[x + kx - 1, ci] * U[u][kx][ci][co]  (f32)
//   y[2t]   = ((bias + m0) + m1) + m2
//   y[2t+1] = ((bias + m1) - m2) - m3
// then (conv2 only) the f32 residual of the bf16 block input, ReLU and one
// cast to bf16 — _wino_kernel's cast points.
// Activations are NHWC bf16 with H even and C a multiple of 8; weights
// (8, 4, 3C, C) bf16 (pack_winograd_weights: ky transformed by G, kx taps
// stacked [x-1 | x | x+1]); biases (8, C) f32.
//
// Design (simple and right first, K2's structure): one conv kernel with the
// Winograd input transform and the epilogue fused, launched 8 times per
// chain with the intermediates in device memory. One wave of resident
// blocks; each stages the U slice of up to 32 output channels in shared
// memory once, then walks tiles of 8 row pairs x 16 columns: the block
// computes the 4 V terms of the tile (with the 1-column halo, all input
// channels, zero-padded to a multiple of 16) into shared memory, and warp r
// takes row pair r: for each term u, each kx and each 16-channel slice one
// A fragment (16 pixels x 16 channels) against the B fragments of U,
// accumulated per term (WMMA 16x16x16 bf16, f32 accumulation). The four
// term sums meet in the epilogue in the Pallas kernel's order, through a
// per-warp scratch, 8 channels (16 bytes) per lane.
//
// Bound on the H100: operations. At W32 branch 0 with 32 crops (32, 64, 48,
// 32) one chain is 4 terms x 32 row pairs x 48 x 96 x 32 MACs x 8 convs x 32
// crops = 4.83 G MAC = 9.7 GFLOP: 9.8 us at the bf16 tensor-core peak (989
// TFLOP/s); the chain must move only 2 x 6.3 MB of bf16 activations (3.8
// us). This version pays 8 launches, 16 activation round trips through
// device memory, V terms recomputed per output-channel block and mma.sync
// rather than wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MW = 16;          // tile width = the WMMA M dimension
constexpr int NWARPS = 8;
constexpr int TP = NWARPS;      // row pairs per tile, one per warp
constexpr int NT = 32 * NWARPS;
constexpr int MOCB = 32;        // output channels per block (2 fragments)
constexpr int NF = MOCB / 16;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// shared memory: U [4][3][cp][ocp] | V [4][TP][MW+2][cp] (bf16) |
// scratch [NWARPS][16][16] (f32)
__host__ __device__ inline size_t smem_bytes(int cp, int ocp) {
  return ((size_t)12 * cp * ocp + (size_t)4 * TP * (MW + 2) * cp) *
             sizeof(bf16) +
         (size_t)NWARPS * 256 * sizeof(float);
}

__global__ void __launch_bounds__(NT)
wino_conv_bf16(const bf16* __restrict__ x, const bf16* __restrict__ ww,
               const float* __restrict__ bias, const bf16* __restrict__ res,
               bf16* __restrict__ out, int B, int H, int W, int C, int cp,
               int ocp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* us = reinterpret_cast<bf16*>(smem);
  bf16* vs = us + (size_t)12 * cp * ocp;
  float* scratch =
      reinterpret_cast<float*>(vs + (size_t)4 * TP * (MW + 2) * cp);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int oc0 = blockIdx.y * MOCB;
  const int ocn = min(MOCB, C - oc0);
  const int nf = ocp / 16;
  const int ht = H / 2;

  // this block's U slice, once: row (u * 3 + kx) * C + ci of the conv's
  // (4, 3C, C) weights, 8 output channels (16 bytes) at a time
  const int ov = ocp / 8;
  for (int t = threadIdx.x; t < 12 * cp * ov; t += NT) {
    const int o = (t % ov) * 8;
    const int row = t / ov;  // (u * 3 + kx) * cp + ci
    const int ci = row % cp;
    const int ukx = row / cp;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ci < C && o < ocn)
      v = *reinterpret_cast<const uint4*>(ww + ((size_t)ukx * C + ci) * C +
                                          oc0 + o);
    *reinterpret_cast<uint4*>(us + (size_t)row * ocp + o) = v;
  }

  const int tiles_x = (W + MW - 1) / MW;
  const int tiles_y = (ht + TP - 1) / TP;
  const int n_tiles = B * tiles_y * tiles_x;
  const int cv = cp / 8;
  float* sc = scratch + warp * 256;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int r = tile - b * tiles_y * tiles_x;
    const int t0 = (r / tiles_x) * TP;
    const int x0 = (r % tiles_x) * MW;
    const bf16* xb = x + (size_t)b * H * W * C;

    __syncthreads();  // every warp is done with the previous tile's V
    // the V terms: TP row pairs x (MW + 2) columns (x0 - 1 .. x0 + MW) x cp
    // channels, zero outside the image and past C
    for (int t = threadIdx.x; t < TP * (MW + 2) * cv; t += NT) {
      const int ci = (t % cv) * 8;
      const int p = t / cv;  // tp * (MW + 2) + column
      const int tp = p / (MW + 2);
      const int gx = x0 + p % (MW + 2) - 1;
      const int tr = t0 + tp;
      float d[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gy = 2 * tr - 1 + k;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ci < C && tr < ht && gx >= 0 && gx < W && gy >= 0 && gy < H)
          v = *reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * C +
                                              ci);
        const bf16* vb = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[k][e] = __bfloat162float(vb[e]);
      }
      uint4 pk[4];
      bf16* pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) pb[u] = reinterpret_cast<bf16*>(&pk[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pb[0][e] = __float2bfloat16_rn(__fsub_rn(d[0][e], d[2][e]));
        pb[1][e] = __float2bfloat16_rn(__fadd_rn(d[1][e], d[2][e]));
        pb[2][e] = __float2bfloat16_rn(__fsub_rn(d[2][e], d[1][e]));
        pb[3][e] = __float2bfloat16_rn(__fsub_rn(d[1][e], d[3][e]));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<uint4*>(vs + ((size_t)u * TP * (MW + 2) + p) * cp +
                                  ci) = pk[u];
    }
    __syncthreads();

    const int tr = t0 + warp;
    if (tr >= ht) continue;  // warp-uniform; the next tile syncs first
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[u][f], 0.f);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const bf16* va =
            vs + ((size_t)(u * TP + warp) * (MW + 2) + kx) * cp;
        const bf16* ub = us + (size_t)(u * 3 + kx) * cp * ocp;
        for (int c0 = 0; c0 < cp; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, va + c0, cp);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (f < nf) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major> bm;
              wmma::load_matrix_sync(bm, ub + (size_t)c0 * ocp + f * 16, ocp);
              wmma::mma_sync(acc[u][f], a, bm, acc[u][f]);
            }
          }
        }
      }
    }

    // epilogue per 16-channel fragment: lane l finishes column l / 2,
    // channels 8 (l % 2) .. + 8, of both rows of the pair
    const int px = lane >> 1;
    const int c8 = (lane & 1) * 8;
    const int gx = x0 + px;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (f >= nf) continue;
      const int oc = oc0 + f * 16 + c8;  // < C implies < oc0 + ocn
      const bool ok = gx < W && oc < C;
      float ye[8], yo[8];
      const float* sv = sc + px * 16 + c8;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wmma::store_matrix_sync(sc, acc[u][f], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float m = sv[k];
          if (u == 0) {
            ye[k] = __fadd_rn(ok ? bias[oc + k] : 0.f, m);
          } else if (u == 1) {
            ye[k] = __fadd_rn(ye[k], m);
            yo[k] = __fadd_rn(ok ? bias[oc + k] : 0.f, m);
          } else if (u == 2) {
            ye[k] = __fadd_rn(ye[k], m);
            yo[k] = __fsub_rn(yo[k], m);
          } else {
            yo[k] = __fsub_rn(yo[k], m);
          }
        }
        __syncwarp();  // the scratch is read before the next store
      }
      if (!ok) continue;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* y = p == 0 ? ye : yo;
        const size_t oi = (((size_t)b * H + 2 * tr + p) * W + gx) * C + oc;
        uint4 rv = make_uint4(0u, 0u, 0u, 0u);
        if (res != nullptr) rv = *reinterpret_cast<const uint4*>(res + oi);
        const bf16* rb = reinterpret_cast<const bf16*>(&rv);
        uint4 packed;
        bf16* ob = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float a = y[k];
          if (res != nullptr) a = __fadd_rn(a, __bfloat162float(rb[k]));
          ob[k] = __float2bfloat16_rn(fmaxf(a, 0.f));
        }
        *reinterpret_cast<uint4*>(out + oi) = packed;
      }
    }
  }
}

int wino_chain(const bf16* x, const bf16* ww, const float* b, bf16* out,
               bf16* mid, bf16* tmp, int B, int H, int W, int C,
               cudaStream_t s) {
  const int cp = round16(C);
  const int ocp = round16(C < MOCB ? C : MOCB);
  const int nob = (C + MOCB - 1) / MOCB;
  const size_t smem = smem_bytes(cp, ocp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(wino_conv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of resident blocks, each walking its share of the tiles
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wino_conv_bf16,
                                                      NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = B * ((H / 2 + TP - 1) / TP) * ((W + MW - 1) / MW);
  const dim3 grid(n_tiles < per_sm * sms ? n_tiles : per_sm * sms, nob);
  const size_t wstride = (size_t)4 * 3 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    wino_conv_bf16<<<grid, NT, smem, s>>>(v, ww + (2 * blk) * wstride,
                                          b + (2 * blk) * C, nullptr, mid, B,
                                          H, W, C, cp, ocp);
    wino_conv_bf16<<<grid, NT, smem, s>>>(
        mid, ww + (2 * blk + 1) * wstride, b + (2 * blk + 1) * C, v,
        block_out[blk], B, H, W, C, cp, ocp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

}  // namespace

// x, out, mid, tmp: (B, H, W, C) NHWC bf16, 16-byte aligned, H even, C a
// multiple of 8; ww (8, 4, 3C, C) bf16; b (8, C) f32. mid and tmp are
// scratch the caller allocates. Returns the cudaError_t of the launches (0
// on success).
extern "C" int sht_wino_chain(const void* x, const void* ww, const void* b,
                              void* out, void* mid, void* tmp, int B, int H,
                              int W, int C, void* stream) {
  if (C % 8 || H % 2) return (int)cudaErrorInvalidValue;
  return wino_chain(static_cast<const bf16*>(x), static_cast<const bf16*>(ww),
                    static_cast<const float*>(b), static_cast<bf16*>(out),
                    static_cast<bf16*>(mid), static_cast<bf16*>(tmp), B, H, W,
                    C, (cudaStream_t)stream);
}
