// B4: HRNet's branch-0 chain of 4 BasicBlocks in int8 (8 stride-1 "same"
// 3x3 convs with static per-tensor input scales, per-output-channel weight
// scales, folded-BN bias, ReLU, and a residual on every second conv).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fused_block.py
// _chain_kernel_int8 (behind chain_pallas_int8_grouped), computing its
// UNPACKED function (G = 1), with its cast points:
//   inva = 1 / ascale[i], alpha = ascale[i] * wscale[i][co]      (f32)
//   conv 0 input: q = clip(rint(x * inva), -127, 127)   from the bf16 input
//   acc (int32, exact) = sum over taps of q * wq
//   conv1: a = relu(acc * alpha + bias)        requantized from f32 for conv2
//   conv2: a = relu(acc * alpha + bias + res)  res = the bf16 block input;
//          stored as bf16, and requantized from f32 for the next block
// Activations are NHWC bf16 with C a multiple of 8; wq (8, 3, 3, C, C) int8
// HWIO; wscale, b (8, C) f32; ascales (8,) f32. Rounding is half to even
// (__float2int_rn), and every product and sum is its own IEEE op.
//
// Design (simple and right first, K2's structure): one conv kernel with the
// quantization fused at both ends, launched 8 times per chain; the
// conv1 -> conv2 intermediate and each block's quantized input live as int8
// in device memory, the block outputs as bf16. One wave of resident
// blocks; each stages the int8 weights of up to 32 output channels in
// shared memory once, then walks 16 x 16 pixel tiles: the int8 input tile
// with its halo goes to shared memory (the first conv quantizes the bf16
// input while staging it), and warp r computes output rows 2r and 2r+1:
// for each of the 9 taps and each 16-channel slice, two A fragments share
// each B fragment (WMMA 16x16x16 s8, int32 accumulation). Each 16-channel
// slice of a pixel sits in a 32-byte slot of shared memory, so every
// fragment pointer is 256-bit aligned as WMMA requires. The epilogue reads
// each 16 x 16 result back through a per-warp scratch, 8 channels a lane.
//
// Bound on the H100: operations. At W32 branch 0 with 32 crops (32, 64, 48,
// 32) one chain is 7.25 G MAC = 14.5 G int8 operations: 7.3 us at the int8
// tensor-core peak (1,979 TOPS); the chain must move only 2 x 6.3 MB of
// bf16 activations (3.8 us). This version pays 8 launches, the int8
// intermediates through device memory and mma.sync rather than wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MW = 16;          // tile width = the WMMA M dimension
constexpr int MWARPS = 8;
constexpr int MH = 2 * MWARPS;  // tile height: two rows per warp
constexpr int MNT = 32 * MWARPS;
constexpr int MOCB = 32;        // output channels per block (2 fragments)
constexpr int NF = MOCB / 16;
constexpr int NPIX = (MH + 2) * (MW + 2);
constexpr int SLOT = 32;        // bytes per 16-channel slot

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// shared memory: weights [9][nch][ocp][SLOT] | input [nch][NPIX][SLOT] (int8)
// | scratch [MWARPS][16][16] (int32)
__host__ __device__ inline size_t smem_bytes(int nch, int ocp) {
  return (size_t)9 * nch * ocp * SLOT + (size_t)nch * NPIX * SLOT +
         (size_t)MWARPS * 256 * sizeof(int);
}

__device__ __forceinline__ signed char quant(float v, float inva) {
  int q = __float2int_rn(__fmul_rn(v, inva));
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return (signed char)q;
}

// Persistent over spatial tiles: blockIdx.y picks the output-channel slice
// (its weights are staged once), blockIdx.x walks tiles with a stride of
// gridDim.x. kBf16In: the input is the bf16 block input, quantized with
// 1 / *ascale while staged; otherwise it is int8, already quantized.
template <bool kBf16In>
__global__ void __launch_bounds__(MNT)
conv3x3_int8(const void* __restrict__ xin, const int8_t* __restrict__ w,
             const float* __restrict__ wscale, const float* __restrict__ bias,
             const float* __restrict__ ascale,
             const float* __restrict__ ascale_next,
             const bf16* __restrict__ res, bf16* __restrict__ out,
             int8_t* __restrict__ qout, int B, int H, int W, int C, int nch,
             int ocp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* ws = reinterpret_cast<signed char*>(smem);
  signed char* xs = ws + (size_t)9 * nch * ocp * SLOT;
  int* scratch = reinterpret_cast<int*>(xs + (size_t)nch * NPIX * SLOT);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int oc0 = blockIdx.y * MOCB;
  const int nf = ocp / 16;
  const float a_in = *ascale;
  const float inva = __fdiv_rn(1.0f, a_in);
  const float inva_next =
      ascale_next != nullptr ? __fdiv_rn(1.0f, *ascale_next) : 0.f;

  // this block's weight slice, once: slot (tap, chunk, o) holds input
  // channels 16 chunk .. + 16 of output channel oc0 + o (B column-major)
  for (int t = threadIdx.x; t < 9 * nch * 16 * ocp; t += MNT) {
    const int o = t % ocp;
    const int rest = t / ocp;  // (tap * nch + chunk) * 16 + j
    const int j = rest % 16;
    const int tc = rest / 16;
    const int ci = (tc % nch) * 16 + j;
    const int tap = tc / nch;
    signed char v = 0;
    if (ci < C && oc0 + o < C)
      v = w[((size_t)tap * C + ci) * C + oc0 + o];
    ws[((size_t)tc * ocp + o) * SLOT + j] = v;
  }

  const int tiles_x = (W + MW - 1) / MW;
  const int tiles_y = (H + MH - 1) / MH;
  const int n_tiles = B * tiles_y * tiles_x;
  const int cv = nch * 2;  // 8-channel groups, padded to whole slots
  int* sc = scratch + warp * 256;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int r = tile - b * tiles_y * tiles_x;
    const int y0 = (r / tiles_x) * MH;
    const int x0 = (r % tiles_x) * MW;

    __syncthreads();  // every warp is done with the previous tile's input
    for (int t = threadIdx.x; t < NPIX * cv; t += MNT) {
      const int ci = (t % cv) * 8;
      const int p = t / cv;
      const int gy = y0 + p / (MW + 2) - 1;
      const int gx = x0 + p % (MW + 2) - 1;
      uint2 q = make_uint2(0u, 0u);
      if (ci < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t gi = (((size_t)b * H + gy) * W + gx) * C + ci;
        if (kBf16In) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(static_cast<const bf16*>(xin) +
                                              gi);
          const bf16* vb = reinterpret_cast<const bf16*>(&v);
          signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
          for (int e = 0; e < 8; ++e) qb[e] = quant(__bfloat162float(vb[e]), inva);
        } else {
          q = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(xin) +
                                              gi);
        }
      }
      *reinterpret_cast<uint2*>(xs + ((size_t)(ci / 16) * NPIX + p) * SLOT +
                                ci % 16) = q;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][NF];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[rr][f], 0);
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const int p0 = (2 * warp + ky) * (MW + 2) + kx;
        for (int ch = 0; ch < nch; ++ch) {
          const signed char* xa = xs + ((size_t)ch * NPIX + p0) * SLOT;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a0, a1;
          wmma::load_matrix_sync(a0, xa, SLOT);
          wmma::load_matrix_sync(a1, xa + (MW + 2) * SLOT, SLOT);
          const signed char* wb =
              ws + ((size_t)((ky * 3 + kx) * nch + ch) * ocp) * SLOT;
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (f < nf) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                             wmma::col_major> bm;
              wmma::load_matrix_sync(bm, wb + f * 16 * SLOT, SLOT);
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
      for (int f = 0; f < NF; ++f) {
        if (f >= nf) continue;
        wmma::store_matrix_sync(sc, acc[rr][f], 16, wmma::mem_row_major);
        __syncwarp();
        const int gy = y0 + 2 * warp + rr;
        const int gx = x0 + px;
        const int oc = oc0 + f * 16 + c8;
        if (gy < H && gx < W && oc < C) {
          const size_t oi = (((size_t)b * H + gy) * W + gx) * C + oc;
          const int* sv = sc + px * 16 + c8;
          uint4 rv = make_uint4(0u, 0u, 0u, 0u);
          if (res != nullptr) rv = *reinterpret_cast<const uint4*>(res + oi);
          const bf16* rb = reinterpret_cast<const bf16*>(&rv);
          uint4 packed;
          bf16* ob = reinterpret_cast<bf16*>(&packed);
          uint2 qv;
          signed char* qb = reinterpret_cast<signed char*>(&qv);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float alpha = __fmul_rn(a_in, wscale[oc + k]);
            float a = __fadd_rn(__fmul_rn((float)sv[k], alpha), bias[oc + k]);
            if (res != nullptr) a = __fadd_rn(a, __bfloat162float(rb[k]));
            a = fmaxf(a, 0.f);
            ob[k] = __float2bfloat16_rn(a);
            qb[k] = quant(a, inva_next);
          }
          if (out != nullptr) *reinterpret_cast<uint4*>(out + oi) = packed;
          if (qout != nullptr) *reinterpret_cast<uint2*>(qout + oi) = qv;
        }
        __syncwarp();  // the scratch is read before the next store
      }
    }
  }
}

template <bool kBf16In>
cudaError_t grid_for(int B, int H, int W, size_t smem, int nob, dim3* grid) {
  auto kern = conv3x3_int8<kBf16In>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  // one wave of resident blocks, each walking its share of the tiles
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, MNT,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = B * ((H + MH - 1) / MH) * ((W + MW - 1) / MW);
  *grid = dim3(n_tiles < per_sm * sms ? n_tiles : per_sm * sms, nob);
  return cudaSuccess;
}

int int8_chain(const bf16* x, const int8_t* wq, const float* wscale,
               const float* b, const float* ascales, bf16* out, bf16* tmp,
               int8_t* qa, int8_t* qmid, int B, int H, int W, int C,
               cudaStream_t s) {
  const int nch = (C + 15) / 16;
  const int ocp = round16(C < MOCB ? C : MOCB);
  const int nob = (C + MOCB - 1) / MOCB;
  const size_t smem = smem_bytes(nch, ocp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  dim3 grid_bf16, grid_q;
  cudaError_t e = grid_for<true>(B, H, W, smem, nob, &grid_bf16);
  if (e == cudaSuccess) e = grid_for<false>(B, H, W, smem, nob, &grid_q);
  if (e != cudaSuccess) return (int)e;
  const size_t wstride = (size_t)9 * C * C;
  // block outputs alternate tmp / out so the last lands in out; a conv
  // never writes the buffer it reads
  bf16* block_out[4] = {tmp, out, tmp, out};
  const bf16* v = x;
  for (int blk = 0; blk < 4; ++blk) {
    const int i1 = 2 * blk, i2 = 2 * blk + 1;
    if (blk == 0)
      conv3x3_int8<true><<<grid_bf16, MNT, smem, s>>>(
          x, wq + i1 * wstride, wscale + i1 * C, b + i1 * C, ascales + i1,
          ascales + i2, nullptr, nullptr, qmid, B, H, W, C, nch, ocp);
    else
      conv3x3_int8<false><<<grid_q, MNT, smem, s>>>(
          qa, wq + i1 * wstride, wscale + i1 * C, b + i1 * C, ascales + i1,
          ascales + i2, nullptr, nullptr, qmid, B, H, W, C, nch, ocp);
    conv3x3_int8<false><<<grid_q, MNT, smem, s>>>(
        qmid, wq + i2 * wstride, wscale + i2 * C, b + i2 * C, ascales + i2,
        blk < 3 ? ascales + i2 + 1 : nullptr, v, block_out[blk],
        blk < 3 ? qa : nullptr, B, H, W, C, nch, ocp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    v = block_out[blk];
  }
  return 0;
}

}  // namespace

// x, out, tmp: (B, H, W, C) NHWC bf16, 16-byte aligned, C a multiple of 8;
// qa, qmid: (B, H, W, C) int8 scratch; wq (8, 3, 3, C, C) int8 HWIO;
// wscale, b (8, C) f32; ascales (8,) f32. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int sht_int8_chain(const void* x, const void* wq,
                              const void* wscale, const void* b,
                              const void* ascales, void* out, void* tmp,
                              void* qa, void* qmid, int B, int H, int W,
                              int C, void* stream) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  return int8_chain(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wscale), static_cast<const float*>(b),
      static_cast<const float*>(ascales), static_cast<bf16*>(out),
      static_cast<bf16*>(tmp), static_cast<int8_t*>(qa),
      static_cast<int8_t*>(qmid), B, H, W, C, (cudaStream_t)stream);
}
