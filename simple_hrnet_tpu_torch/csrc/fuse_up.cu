// K3: HRNet's high-resolution fusion output,
//   out = relu(base + sum_j nearest_up_{f_j}(conv1x1(y_j) + b_j)).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fuse_up.py (fuse_up,
// kernel from _make_kernel). On the TPU the W-upsample is a 0/1 interleave
// matmul; here a nearest-upsample read is an index shift (h >> s, w >> s).
//
// Arithmetic follows the TPU kernel: the accumulator starts at
// base + sum_j b_j in f32, each source adds its f32 1x1-conv product (y_j
// and the weights in the activation type, as fuse_up.py casts them), and
// the ReLU and the one cast to the activation type happen at the store.
//
// Design: a block owns an 8 x 8 output tile of one image. Every source
// factor (2, 4 or 8) divides the tile, so the tile covers whole source
// pixels: the block stages those source pixels in shared memory, runs the
// 1x1 convs once per SOURCE pixel (the minimal work, not once per output
// pixel), keeps the f32 products in shared memory, and then writes the 64
// output pixels, each reading its source products by an index shift.
//
// Bound on the H100: bytes. At the W48 stage-4 shape with 8 crops (base
// 8 x 96 x 72 x 48, sources at /2, /4, /8 with 96, 192, 384 channels) the
// kernel must move ~15 MB in bf16: 4.6 us at 3.35 TB/s; its 111 M MACs are
// 0.2 us at the bf16 tensor-core peak. Weights are re-read from L2 by
// every block (64 KB each); the products run on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8;
constexpr int NT = 256;
constexpr int MAX_SRC = 3;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

struct Source {
  const void* y;  // (B, H >> shift, W >> shift, c) activation type
  const void* w;  // (c, C) activation type
  int c;
  int shift;
};

struct Sources {
  Source s[MAX_SRC];
};

template <typename T>
__global__ void __launch_bounds__(NT)
fuse_up_kernel(const T* __restrict__ base, Sources srcs, int n_src,
               const float* __restrict__ bias_sum, T* __restrict__ out,
               int H, int W, int C) {
  extern __shared__ float sm[];
  const int tiles_x = (W + TILE - 1) / TILE;
  const int h0 = (blockIdx.x / tiles_x) * TILE;
  const int w0 = (blockIdx.x % tiles_x) * TILE;
  const int b = blockIdx.y;

  float* ys[MAX_SRC];
  float* ts[MAX_SRC];
  float* p = sm;
  for (int s = 0; s < n_src; ++s) {
    const int e = TILE >> srcs.s[s].shift;
    ys[s] = p;
    p += e * e * srcs.s[s].c;
    ts[s] = p;
    p += e * e * C;
  }

  // stage the source pixels under this tile
  for (int s = 0; s < n_src; ++s) {
    const int sh = srcs.s[s].shift;
    const int cj = srcs.s[s].c;
    const int e = TILE >> sh;
    const int hs = H >> sh, wsz = W >> sh;
    const T* y = static_cast<const T*>(srcs.s[s].y) + (size_t)b * hs * wsz * cj;
    for (int t = threadIdx.x; t < e * e * cj; t += NT) {
      const int k = t % cj;
      const int q = t / cj;
      const int gy = (h0 >> sh) + q / e;
      const int gx = (w0 >> sh) + q % e;
      ys[s][t] = (gy < hs && gx < wsz)
                     ? to_f32(y[((size_t)gy * wsz + gx) * cj + k])
                     : 0.f;
    }
  }
  __syncthreads();

  // 1x1 convs at source resolution, f32 accumulation
  for (int s = 0; s < n_src; ++s) {
    const int cj = srcs.s[s].c;
    const int e = TILE >> srcs.s[s].shift;
    const T* w = static_cast<const T*>(srcs.s[s].w);
    for (int t = threadIdx.x; t < e * e * C; t += NT) {
      const int c = t % C;
      const float* yr = ys[s] + (t / C) * cj;
      float acc = 0.f;
      for (int k = 0; k < cj; ++k) acc += yr[k] * to_f32(w[(size_t)k * C + c]);
      ts[s][t] = acc;
    }
  }
  __syncthreads();

  const T* bb = base + (size_t)b * H * W * C;
  T* ob = out + (size_t)b * H * W * C;
  for (int t = threadIdx.x; t < TILE * TILE * C; t += NT) {
    const int c = t % C;
    const int q = t / C;
    const int py = q / TILE;
    const int px = q % TILE;
    const int gy = h0 + py;
    const int gx = w0 + px;
    if (gy >= H || gx >= W) continue;
    const size_t o = ((size_t)gy * W + gx) * C + c;
    float acc = to_f32(bb[o]) + bias_sum[c];
    for (int s = 0; s < n_src; ++s) {
      const int sh = srcs.s[s].shift;
      const int e = TILE >> sh;
      acc += ts[s][((py >> sh) * e + (px >> sh)) * C + c];
    }
    ob[o] = from_f32<T>(fmaxf(acc, 0.f));
  }
}

template <typename T>
int launch(const void* base, const Sources& srcs, int n_src,
           const float* bias_sum, void* out, int B, int H, int W, int C,
           size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fuse_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  fuse_up_kernel<T><<<dim3(tiles, B), NT, smem, st>>>(
      static_cast<const T*>(base), srcs, n_src, bias_sum,
      static_cast<T*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t sht_fuse_up_smem_bytes(int n_src, const int* c,
                                         const int* shift, int C) {
  size_t floats = 0;
  for (int s = 0; s < n_src; ++s) {
    const size_t e = TILE >> shift[s];
    floats += e * e * (size_t)(c[s] + C);
  }
  return floats * sizeof(float);
}

// base, out: (B, H, W, C) NHWC in the activation type (dtype 0 = f32,
// 1 = bf16); source s: y_s (B, H >> shift_s, W >> shift_s, c_s) and w_s
// (c_s, C) in the activation type, 1 <= shift_s <= 3; bias_sum (C,) f32 =
// the sum of the sources' folded biases. Unused source slots are ignored.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sht_fuse_up(const void* base, int n_src, const void* y0,
                           const void* w0, int c0, int sh0, const void* y1,
                           const void* w1, int c1, int sh1, const void* y2,
                           const void* w2, int c2, int sh2,
                           const void* bias_sum, void* out, int B, int H,
                           int W, int C, int dtype, void* stream) {
  if (n_src < 1 || n_src > MAX_SRC) return (int)cudaErrorInvalidValue;
  Sources srcs;
  srcs.s[0] = Source{y0, w0, c0, sh0};
  srcs.s[1] = Source{y1, w1, c1, sh1};
  srcs.s[2] = Source{y2, w2, c2, sh2};
  const int cs[MAX_SRC] = {c0, c1, c2};
  const int shs[MAX_SRC] = {sh0, sh1, sh2};
  const size_t smem = sht_fuse_up_smem_bytes(n_src, cs, shs, C);
  const float* bs = static_cast<const float*>(bias_sum);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(base, srcs, n_src, bs, out, B, H, W, C, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(base, srcs, n_src, bs, out, B, H, W, C, smem,
                                 st);
  return (int)cudaErrorInvalidValue;
}
