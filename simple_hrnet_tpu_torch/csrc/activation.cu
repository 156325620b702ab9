// K4: the detectors' smooth activations (sigmoid, SiLU, mish) in one
// elementwise pass, rounded to the storage type after every op.
//
// No TPU kernel: on the TPU (and the CPU) these are XLA elementwise
// fusions of the JAX package's jax.nn.sigmoid, jax.nn.silu and
// y * tanh(softplus(y)) (simple_hrnet_tpu/detectors/yolov5.py _conv,
// darknet.py apply). XLA computes such a bf16 chain in f32 and rounds to
// bf16 after every op; PyTorch's F.silu rounds its f32 result once, so a
// third of its bf16 outputs lie one step from the JAX package's. This
// kernel computes exactly the ops of ops/activation.py, its plain version
// (the HLO order):
//   sigmoid(x) = 1 / (exp(-x) + 1)                   rounded after exp, +, /
//   silu(x)    = x * sigmoid(x)                      and after the product
//   mish(x)    = x * tanh(isnan(x) ? x : max(x, 0) + log1p(exp(-|x|)))
//                                                    rounded after each op
// in f32 registers, with a round trip through the storage type
// (__float2bfloat16_rn and back) after each op where the HLO rounds; in
// f32 that round trip is the identity. It calls CUDA's IEEE expf, log1pf
// and tanhf and the _rn add, multiply and divide (no fast math, no
// contraction into FMAs), the functions PyTorch's elementwise CUDA kernels
// call on the plain version's ops, so it equals its plain version bit for
// bit on the card.
//
// Bound on the H100: bytes. It reads each element once and writes it once
// (4 bytes a bf16 element, 8 an f32 one); at YOLOv5m-640's largest
// activation in an 8-frame detect (8 x 48 x 320 x 320 bf16, 78.6 MB each
// way) that is 157 MB, 46.9 us at 3.35 TB/s. Its ~20 f32 operations an
// element (expf and division are a few instructions each) are 13 us at
// the f32 CUDA-core peak.
//
// Design: a grid-stride loop in which each thread loads 16 bytes (8 bf16
// or 4 f32 elements) when both pointers are 16-byte aligned, computes each
// element and stores 16 bytes; the elements past the last whole vector,
// or every element when a pointer is not aligned, go one at a time. The
// layout does not matter: the wrapper passes a dense tensor's storage in
// its own order (NCHW or channels-last) and an output of the same strides.
// The output never aliases the input (the wrapper allocates it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum Act { SIGMOID = 0, SILU = 1, MISH = 2 };

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

// the storage type: its conversions to and from f32, and the rounding that
// follows every op
template <typename T> struct Storage;
template <> struct Storage<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Storage<bf16> {
  static __device__ __forceinline__ float load(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T, int ACT>
__device__ __forceinline__ float activate(float x) {
  using S = Storage<T>;
  if (ACT == MISH) {
    // -|x| and max(x, 0) are exact in either type
    const float e = S::round(expf(-fabsf(x)));
    const float l = S::round(log1pf(e));
    float sp = S::round(__fadd_rn(fmaxf(x, 0.0f), l));
    if (isnan(x)) sp = x;
    return S::round(__fmul_rn(x, S::round(tanhf(sp))));
  }
  const float e = S::round(expf(-x));
  const float d = S::round(__fadd_rn(e, 1.0f));
  const float s = S::round(__fdiv_rn(1.0f, d));
  if (ACT == SIGMOID) return s;
  return S::round(__fmul_rn(x, s));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
activation_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                  bool vec) {
  using S = Storage<T>;
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int64_t tail = 0;
  if (vec) {
    const int64_t nv = n / V;
    for (int64_t i = tid; i < nv; i += stride) {
      __align__(16) T e[V];
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(x)[i];
#pragma unroll
      for (int k = 0; k < V; ++k)
        e[k] = S::store(activate<T, ACT>(S::load(e[k])));
      reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(e);
    }
    tail = nv * V;
  }
  for (int64_t i = tail + tid; i < n; i += stride)
    y[i] = S::store(activate<T, ACT>(S::load(x[i])));
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, int act,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (((uintptr_t)x | (uintptr_t)y) % 16) == 0;
  const int64_t work = vec ? (n + V - 1) / V : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (act) {
    case SIGMOID:
      activation_kernel<T, SIGMOID><<<(unsigned)blocks, THREADS, 0, s>>>(
          xi, yo, n, vec);
      break;
    case SILU:
      activation_kernel<T, SILU><<<(unsigned)blocks, THREADS, 0, s>>>(
          xi, yo, n, vec);
      break;
    case MISH:
      activation_kernel<T, MISH><<<(unsigned)blocks, THREADS, 0, s>>>(
          xi, yo, n, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// y = act(x) over n elements. act: 0 sigmoid, 1 silu, 2 mish; dtype: 0 f32,
// 1 bf16 (ops/cuda/fused_block.py DTYPE_CODES). Returns a cudaError_t.
extern "C" int sht_activation(const void* x, void* y, int64_t n, int act,
                              int dtype, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(x, y, n, act, s);
  if (dtype == 1) return (int)launch<bf16>(x, y, n, act, s);
  return (int)cudaErrorInvalidValue;
}
