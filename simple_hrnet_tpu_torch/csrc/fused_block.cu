// K2: HRNet's branch-0 chain of 4 BasicBlocks (8 stride-1 "same" 3x3
// convs with folded-BN bias, ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fused_block.py
// _chain_kernel (behind chain_pallas_grouped / fused_basic_chain), computing
// its UNPACKED function: no block-diagonal image packing (G = 1), any width.
//
// Arithmetic and cast points follow _chain_kernel:
//   acc (f32) = bias + sum over taps of x * w   (x, w in the activation type)
//   conv1: mid = relu(acc)                 rounded to the activation type
//   conv2: out = relu(acc + residual)      residual = the block input, read
//                                          back in the activation type
// Activations are NHWC, bf16 or f32, with C a multiple of 8 (every HRNet
// branch width is); weights (8, 3, 3, C, C) HWIO in the activation type;
// biases (8, C) f32.
//
// Design (simple and right first): one 3x3 conv kernel with the epilogue
// fused (bias, optional residual, ReLU, one cast at the store), launched 8
// times per chain with the intermediates in device memory.
//   * bf16: an implicit GEMM on the tensor cores (WMMA 16x16x16, f32
//     accumulation). One wave of resident blocks; each stages its slice of
//     up to 64 output channels' weights in shared memory once, then walks
//     16-wide x 16-high pixel tiles: the input tile with its halo (all
//     input channels, zero-padded to a multiple of 16) goes to shared
//     memory, and warp r computes output rows 2r and 2r+1: for each of the
//     9 taps and each 16-channel slice, two A fragments (16 pixels x 16
//     input channels, rows a channel-stride apart) share each B fragment
//     (16 output channels). Each 16 x 16 result goes through a per-warp
//     scratch to the epilogue, 8 channels (16 bytes) per lane.
//   * f32: on the CUDA cores (the tensor cores' f32 path is TF32, which
//     would not keep f32 results). A block computes a 32 x 8 pixel tile for
//     16 output channels, staging 16 input channels at a time.
//
// Bound on the H100: operations. At W48 branch 0 with 8 crops (8, 96, 72,
// 48) one conv is 1.15 G MACs, one chain 18.3 GFLOP: 18.5 us at the bf16
// tensor-core peak (989 TFLOP/s), 274 us at the f32 CUDA-core peak (67
// TFLOP/s); the chain must move only 2 x 5.3 MB of bf16 activations (3 us).
// This version pays 8 launches and 16 activation round trips through device
// memory and mma.sync rather than wgmma; keeping the chain on-chip, TMA and
// wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

constexpr int MW = 16;       // tile width = the WMMA M dimension
constexpr int MWARPS = 8;
constexpr int MH = 2 * MWARPS;  // tile height: two rows per warp
constexpr int MNT = 32 * MWARPS;
constexpr int MOCB = 64;     // output channels per block (4 fragments)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline size_t tc_smem_bytes(int cp, int ocp) {
  return (9 * (size_t)cp * ocp + (size_t)(MH + 2) * (MW + 2) * cp) *
             sizeof(bf16) +
         (size_t)MWARPS * 16 * 16 * sizeof(float);
}

// Persistent over spatial tiles: blockIdx.y picks the output-channel slice
// (its weights are staged once), blockIdx.x walks tiles with a stride of
// gridDim.x. cp: input channels padded to 16; ocp: output channels per
// block padded to 16 (weights past C are zero).
__global__ void __launch_bounds__(MNT)
conv3x3_bf16_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ res,
                bf16* __restrict__ out, int B, int H, int W, int C, int cp,
                int ocp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);                 // [9][cp][ocp]
  bf16* xs = ws + 9 * (size_t)cp * ocp;                     // [MH+2][MW+2][cp]
  float* scratch = reinterpret_cast<float*>(xs + (size_t)(MH + 2) * (MW + 2) *
                                                     cp);   // [warp][16][16]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int oc0 = blockIdx.y * MOCB;
  const int ocn = min(MOCB, C - oc0);
  const int nf = ocp / 16;

  // this block's weight slice, once (C % 8 == 0: 16-byte accesses, 8
  // channels at a time)
  const int ov = ocp / 8;
#pragma unroll 4
  for (int t = threadIdx.x; t < 9 * cp * ov; t += MNT) {
    const int o = (t % ov) * 8;
    const int row = t / ov;  // tap * cp + ci
    const int ci = row % cp;
    const int tap = row / cp;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ci < C && o < ocn)
      v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * C + ci) * C +
                                          oc0 + o);
    *reinterpret_cast<uint4*>(ws + (size_t)row * ocp + o) = v;
  }

  const int tiles_x = (W + MW - 1) / MW;
  const int tiles_y = (H + MH - 1) / MH;
  const int n_tiles = B * tiles_y * tiles_x;
  float* sc = scratch + warp * 256;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int r = tile - b * tiles_y * tiles_x;
    const int y0 = (r / tiles_x) * MH;
    const int x0 = (r % tiles_x) * MW;
    const bf16* xb = x + (size_t)b * H * W * C;

    __syncthreads();  // every warp is done with the previous tile's xs
    const int cv = cp / 8;
#pragma unroll 4
    for (int t = threadIdx.x; t < (MH + 2) * (MW + 2) * cv; t += MNT) {
      const int ci = (t % cv) * 8;
      const int p = t / cv;
      const int gy = y0 + p / (MW + 2) - 1;
      const int gx = x0 + p % (MW + 2) - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ci < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * C +
                                            ci);
      *reinterpret_cast<uint4*>(xs + (size_t)p * cp + ci) = v;
    }
    __syncthreads();

    // warp computes output rows 2*warp and 2*warp+1 (16 pixels each); each
    // B fragment serves both rows
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][MOCB / 16];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int f = 0; f < MOCB / 16; ++f) wmma::fill_fragment(acc[rr][f], 0.f);
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const bf16* wt = ws + (size_t)(ky * 3 + kx) * cp * ocp;
        const bf16* xa =
            xs + ((size_t)(2 * warp + ky) * (MW + 2) + kx) * cp;
        for (int c0 = 0; c0 < cp; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a0, a1;
          wmma::load_matrix_sync(a0, xa + c0, cp);
          wmma::load_matrix_sync(a1, xa + (size_t)(MW + 2) * cp + c0, cp);
#pragma unroll
          for (int f = 0; f < MOCB / 16; ++f) {
            if (f < nf) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major> bm;
              wmma::load_matrix_sync(bm, wt + (size_t)c0 * ocp + f * 16, ocp);
              wmma::mma_sync(acc[0][f], a0, bm, acc[0][f]);
              wmma::mma_sync(acc[1][f], a1, bm, acc[1][f]);
            }
          }
        }
      }
    }

    // epilogue per 16 x 16 fragment through the warp's scratch: lane l
    // finishes pixel l / 2, channels 8 (l % 2) .. + 8
    const int px = lane >> 1;
    const int c8 = (lane & 1) * 8;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int f = 0; f < MOCB / 16; ++f) {
        if (f >= nf) continue;
        wmma::store_matrix_sync(sc, acc[rr][f], 16, wmma::mem_row_major);
        __syncwarp();
        const int gy = y0 + 2 * warp + rr;
        const int gx = x0 + px;
        const int oc = oc0 + f * 16 + c8;  // < C implies < oc0 + ocn
        if (gy < H && gx < W && oc < C) {
          const size_t oi = (((size_t)b * H + gy) * W + gx) * C + oc;
          const float* sv = sc + px * 16 + c8;
          uint4 rv = make_uint4(0u, 0u, 0u, 0u);
          if (res != nullptr) rv = *reinterpret_cast<const uint4*>(res + oi);
          const bf16* rb = reinterpret_cast<const bf16*>(&rv);
          uint4 packed;
          bf16* ob = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float a = sv[k] + bias[oc + k];
            if (res != nullptr) a += __bfloat162float(rb[k]);
            ob[k] = __float2bfloat16_rn(fmaxf(a, 0.f));
          }
          *reinterpret_cast<uint4*>(out + oi) = packed;
        }
        __syncwarp();  // the scratch is read before the next store
      }
    }
  }
}

int chain_bf16(const bf16* x, const bf16* w, const float* b, bf16* out,
               bf16* mid, bf16* tmp, int B, int H, int W, int C,
               cudaStream_t s) {
  const int cp = round16(C);
  const int ocp = round16(C < MOCB ? C : MOCB);
  const int nob = (C + MOCB - 1) / MOCB;
  const size_t smem = tc_smem_bytes(cp, ocp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_bf16_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of resident blocks, each walking its share of the tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      conv3x3_bf16_tc, MNT,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = B * ((H + MH - 1) / MH) * ((W + MW - 1) / MW);
  const dim3 grid(n_tiles < per_sm * sms ? n_tiles : per_sm * sms, nob);
  const size_t wstride = (size_t)9 * C * C;
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    conv3x3_bf16_tc<<<grid, MNT, smem, s>>>(
        v, w + (2 * blk) * wstride, b + (2 * blk) * C, nullptr, mid, B, H, W,
        C, cp, ocp);
    conv3x3_bf16_tc<<<grid, MNT, smem, s>>>(
        mid, w + (2 * blk + 1) * wstride, b + (2 * blk + 1) * C, v,
        block_out[blk], B, H, W, C, cp, ocp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

}  // namespace

// x, out, mid, tmp: (B, H, W, C) NHWC in the activation type (dtype 0 =
// f32, 1 = bf16), 16-byte aligned, C a multiple of 8; w (8, 3, 3, C, C)
// in the activation type; b (8, C) f32. mid and tmp are scratch the caller allocates.
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
