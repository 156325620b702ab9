// K1: greedy IoU NMS over a batch of images, as a ranked bitmask and a
// one-warp scan.
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/nms_pallas.py
// (_nms_kernel / _nms_kernel_batched behind nms_pallas). The batch
// dimension is the grid, which takes the place of its custom_vmap rule.
//
// Contract: ops/nms.nms_jax in the JAX package. Scores <= 0 (and NaN
// scores) are padding and are never kept; each of the max_out rounds keeps
// the live box with the highest score (lowest index on ties) and kills
// every box whose IoU with it is > thresh; unused slots hold index 0 and
// valid 0. The IoU arithmetic follows nms_jax exactly:
//   inter / ((area_i + area_j) - inter), no +1 extent,
// with every product, sum and quotient rounded on its own (__fmul_rn and
// friends are never contracted into an FMA) and NaN-propagating min/max
// like jnp.minimum/maximum, so the plain PyTorch version agrees slot for
// slot. The Pallas kernel compares inter > thresh * union
// (nms_pallas.py:57) instead of dividing; this kernel divides, as nms_jax
// does, since the port's tests hold it against nms_jax. Build without
// --use_fast_math.
//
// Bound on the H100: tiny. At the detector's shape (8 images, N = 256,
// max_out = 32) the function reads 40 KB and does ~0.8 M operations, well
// under a microsecond at the card's rates; what sets the time is latency:
// the launches, and the chain of dependent decisions in the greedy phase.
//
// Design: two launches.
//   * nms_mask, grid (image, 32-row tile), one thread per candidate and
//     one warp per 32-column word. Each block ranks the image's live
//     candidates by (score descending, index ascending) by counting (one
//     thread per candidate, the scores' bits compared as unsigned keys in
//     shared memory), puts their boxes and areas in ranked order in shared
//     memory, and computes its tile of the suppression bitmask in ranked
//     order: bit k of word w of row r says that IoU(rank r, rank 32 w + k)
//     > thresh, for ranks r < 32 w + k < L (L = live count). Only that
//     upper triangle is computed or stored: a candidate is only ever
//     suppressed by one ranked before it. Lane l of a warp holds row box l
//     in registers and reads the column boxes as shared-memory broadcasts.
//     The test RN(inter / union) > thresh is decided without the division
//     where inter lies clearly above or below thresh * union (about 2^-20
//     of it away or more: no bit can change, the proof is at the loop), so
//     the loop body has no branch and unrolls; the few pairs it leaves
//     (near the threshold; inverted, empty or NaN boxes; thresholds <= 0)
//     take __fdiv_rn after it, as before. The mask
//     (at most 1024 x 32 words an image) goes to global memory, which the
//     L2 holds; tile 0 also writes the rank -> index order.
//   * nms_scan, one warp an image, a programmatic dependent launch of
//     nms_mask: it counts the live candidates while the mask is computed,
//     then waits for that grid (griddepcontrol.wait) and walks the ranks
//     in chunks of 32. Lane w holds word w of the "removed" bitmap (N <=
//     1024 = 32 lanes x 32 bits); word c is chunk c's removed bits. Chunk
//     c's 32 mask rows are contiguous in ranked order and arrive by
//     cp.async into a two-slot ring in shared memory, one chunk ahead. In
//     a chunk, the first candidate not removed is kept (__ffs), its row's
//     word c is cleared from the chunk's candidates (one shared broadcast)
//     and every lane ORs in its word of the row: no block barrier, no
//     shuffle in the loop. The chunk's keeps are written in parallel at
//     its end. The walk stops at max_out keeps or at rank L; the remaining
//     slots are zeroed. Round r of nms_jax's argmax loop keeps the first
//     live candidate in this order, so the two are the same function.
// What its time is made of at (8, 256, 32) (PERF.md, section 6): the two
// launches' floor, the mask kernel's ranking (every block ranks all N, one
// thread a candidate) and IoU loop, and after it the scan's wait, its first
// chunk's copy and its 32 dependent keep steps.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// NaN-propagating max/min (one instruction each, no branch): NaN if
// either input is NaN, like jnp.maximum/minimum and torch.maximum/minimum.
// The sign of a zero result may differ from theirs; no bit depends on it.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// inter and union of the IoU of boxes a, c with areas aa, ac, each product,
// sum and difference rounded on its own (nms_jax's arithmetic)
__device__ __forceinline__ void iou_terms(float4 a, float aa, float4 c,
                                          float ac, float& inter,
                                          float& uni) {
  const float xx1 = max_nan(a.x, c.x);
  const float yy1 = max_nan(a.y, c.y);
  const float xx2 = min_nan(a.z, c.z);
  const float yy2 = min_nan(a.w, c.w);
  const float iw = max_nan(0.f, __fsub_rn(xx2, xx1));
  const float ih = max_nan(0.f, __fsub_rn(yy2, yy1));
  inter = __fmul_rn(iw, ih);
  uni = __fsub_rn(__fadd_rn(aa, ac), inter);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block (image b, row tile t), words * 32 threads; dynamic shared memory
// n_pad float4 boxes, n_pad u32 keys, n_pad f32 areas (n_pad = 32 words).
__global__ void __launch_bounds__(1024)
    nms_mask(const float4* __restrict__ boxes,
             const float* __restrict__ scores, float thresh, int n,
             int words, uint32_t* __restrict__ mask,
             int* __restrict__ order) {
  extern __shared__ float4 smem4[];
  const int n_pad = words * 32;
  float4* rbx = smem4;                                       // ranked boxes
  uint32_t* key = reinterpret_cast<uint32_t*>(rbx + n_pad);  // by index
  float* rarea = reinterpret_cast<float*>(key + n_pad);      // ranked areas

  // the scan may launch now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int j = threadIdx.x;
  boxes += (size_t)b * n;
  scores += (size_t)b * n;
  mask += (size_t)b * n_pad * words;

  // live scores as unsigned keys: positive floats order as their bits;
  // padding (<= 0, NaN) is 0, below every live key
  bool live = false;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < n) {
    const float s = scores[j];
    live = s > 0.f;
    box = boxes[j];
    key[j] = live ? __float_as_uint(s) : 0u;
  } else {
    key[j] = 0u;
  }
  const int L = __syncthreads_count(live);
  // a tile past the live count has no row to compute (uniform: the block
  // leaves together)
  if (t * 32 >= L) return;

  // rank = live candidates before j: a higher key, or an equal key at a
  // lower index. Per warp the loop bounds are uniform: below the warp's
  // 32 indices ">=", inside them the index decides, above them ">".
  if (live) {
    const uint32_t kj = key[j];
    const int wb = j & ~31;
    // four independent counts, so the adds do not form one chain
    int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
    const uint4* k4 = reinterpret_cast<const uint4*>(key);
#pragma unroll 8
    for (int q = 0; q < wb / 4; ++q) {
      const uint4 v = k4[q];
      r0 += v.x >= kj;
      r1 += v.y >= kj;
      r2 += v.z >= kj;
      r3 += v.w >= kj;
    }
#pragma unroll 8
    for (int q = 0; q < 8; ++q) {
      const uint4 v = k4[wb / 4 + q];
      const int i = wb + 4 * q;
      r0 += v.x > kj || (v.x == kj && i < j);
      r1 += v.y > kj || (v.y == kj && i + 1 < j);
      r2 += v.z > kj || (v.z == kj && i + 2 < j);
      r3 += v.w > kj || (v.w == kj && i + 3 < j);
    }
#pragma unroll 8
    for (int q = (wb + 32) / 4; q < n_pad / 4; ++q) {
      const uint4 v = k4[q];
      r0 += v.x > kj;
      r1 += v.y > kj;
      r2 += v.z > kj;
      r3 += v.w > kj;
    }
    const int rank = (r0 + r1) + (r2 + r3);
    rbx[rank] = box;
    rarea[rank] = __fmul_rn(__fsub_rn(box.z, box.x), __fsub_rn(box.w, box.y));
    if (t == 0) order[(size_t)b * n_pad + rank] = j;
  }
  __syncthreads();

  const int warp = j >> 5;
  const int lane = j & 31;
  const int r = t * 32 + lane;
  // rows past the live count are never read; words left of the diagonal
  // hold only columns ranked before the row
  if (warp < t || r >= L) return;
  const int c0 = warp * 32;
  if (c0 >= L) {  // no live column in this word
    mask[(size_t)r * words + warp] = 0u;
    return;
  }
  const int kend = min(32, L - c0);
  const float4 a = rbx[r];
  const float ai = rarea[r];
  // RN(inter / uni) > thresh, decided without the division where it is
  // clear, and by __fdiv_rn after the loop where it is not. With e = 2^-24
  // (f32's relative rounding error in the normal range), hi = RN(RN(thresh
  // (1 + 2^-20)) uni) >= thresh uni (1 + 2^-20)(1 - e)^2 > thresh uni
  // (1 + 2^-21), so inter > hi puts inter / uni more than 4 ulps above a
  // normal thresh, and its rounding above thresh; likewise inter < lo =
  // RN(RN(thresh (1 - 2^-20)) uni) puts inter / uni below thresh, and its
  // rounding at or below it. That holds for uni > 0, finite inter, lo and
  // hi normal and finite, and thresh in [2^-100, 2^100]; every other pair
  // (inverted, empty or NaN boxes), the pairs between lo and hi and every
  // other thresh (0, negative, ...) take the division.
  const bool fast_ok = thresh >= 0x1p-100f && thresh <= 0x1p100f;
  const float t_hi = __fmul_rn(thresh, 1.f + 0x1p-20f);
  const float t_lo = __fmul_rn(thresh, 1.f - 0x1p-20f);
  // all 32 columns, with no branch, so that the iterations interleave;
  // the columns past the live count (stale shared memory) and, on the
  // diagonal word, those ranked at or before the row are masked after
  uint32_t bits = 0u;
  uint32_t slow = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    float inter, uni;
    iou_terms(a, ai, rbx[c0 + k], rarea[c0 + k], inter, uni);
    const float hi = __fmul_rn(t_hi, uni);
    const float lo = __fmul_rn(t_lo, uni);
    const bool ok = fast_ok && uni > 0.f && inter < INFINITY &&
                    lo >= FLT_MIN && hi < INFINITY;
    bits |= (uint32_t)(ok && inter > hi) << k;
    slow |= (uint32_t)!(ok && (inter > hi || inter < lo)) << k;
  }
  uint32_t cols = kend >= 32 ? 0xffffffffu : (1u << kend) - 1u;
  if (warp == t) cols &= lane == 31 ? 0u : ~0u << (lane + 1);
  bits &= cols;
  slow &= cols;
  while (slow != 0u) {
    const int k = __ffs(slow) - 1;
    slow &= slow - 1u;
    float inter, uni;
    iou_terms(a, ai, rbx[c0 + k], rarea[c0 + k], inter, uni);
    if (__fdiv_rn(inter, uni) > thresh) bits |= 1u << k;
  }
  mask[(size_t)r * words + warp] = bits;
}

// One warp an image; dynamic shared memory: two chunks of 32 mask rows.
__global__ void __launch_bounds__(32)
    nms_scan(const float* __restrict__ scores, int n, int words,
             int max_out, const uint32_t* __restrict__ mask,
             const int* __restrict__ order, int* __restrict__ keep_idx,
             uint8_t* __restrict__ keep_valid) {
  extern __shared__ __align__(16) uint32_t ring[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n_pad = words * 32;
  const int cw = 32 * words;  // u32 in a chunk of 32 rows
  scores += (size_t)b * n;
  keep_idx += (size_t)b * max_out;
  keep_valid += (size_t)b * max_out;

  // the live count reads only the inputs, so it overlaps the mask grid
  int L = 0;
#pragma unroll
  for (int w = 0; w < 32; ++w) {  // all loads in flight at once
    const int q = w * 32 + lane;
    const float s = w < words && q < n ? scores[q] : 0.f;
    L += __popc(__ballot_sync(0xffffffffu, s > 0.f));
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  mask += (size_t)b * n_pad * words;
  order += (size_t)b * n_pad;
  const int chunks = (L + 31) >> 5;
  auto fetch = [&](int c) {
    if (c < chunks) {
      const uint4* src = reinterpret_cast<const uint4*>(mask + (size_t)c * cw);
      uint4* dst = reinterpret_cast<uint4*>(ring + (c & 1) * cw);
      for (int i = lane; i < cw / 4; i += 32) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);

  uint32_t removed = 0u;  // lane w: word w of the removed bitmap
  int kept = 0;
  for (int c = 0; c < chunks && kept < max_out; ++c) {
    const int q = c * 32 + lane;
    const int idx = q < L ? order[q] : 0;
    cp_async_wait<1>();  // this lane's copies of chunk c are in
    __syncwarp();        // and every lane's
    const uint32_t* rows = ring + (c & 1) * cw;
    const int left = L - c * 32;
    uint32_t cand = (left >= 32 ? 0xffffffffu : (1u << left) - 1u) &
                    ~__shfl_sync(0xffffffffu, removed, c);
    uint32_t took = 0u;
    const int base = kept;
    while (cand != 0u && kept < max_out) {
      const int p = __ffs(cand) - 1;
      took |= 1u << p;
      ++kept;
      const uint32_t* row = rows + p * words;
      cand &= cand - 1u;
      cand &= ~row[c];
      if (lane > c && lane < words) removed |= row[lane];
    }
    if ((took >> lane) & 1u) {
      const int slot = base + __popc(took & ((1u << lane) - 1u));
      keep_idx[slot] = idx;
      keep_valid[slot] = 1;
    }
    __syncwarp();  // every lane is done with slot c & 1 before it refills
    fetch(c + 2);
  }
  cp_async_wait<0>();
  for (int s = kept + lane; s < max_out; s += 32) {
    keep_idx[s] = 0;
    keep_valid[s] = 0;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// boxes (batch, n, 4) f32 xyxy, scores (batch, n) f32 -> keep_idx
// (batch, max_out) int32, keep_valid (batch, max_out) bool. scratch holds
// batch * n_pad * (words + 1) int32 (words = ceil(n / 32), n_pad = 32
// words): the ranked masks (batch, n_pad, words), then the rank -> index
// orders (batch, n_pad). Takes n <= 1024. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int sht_nms(const void* boxes, const void* scores, float thresh,
                       int batch, int n, int max_out, void* keep_idx,
                       void* keep_valid, void* stream, void* scratch) {
  const int words = (n + 31) / 32;
  const int n_pad = words * 32;
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* mask = static_cast<uint32_t*>(scratch);
  int* order = reinterpret_cast<int*>(mask + (size_t)batch * n_pad * words);
  const size_t smem = (size_t)n_pad * (sizeof(float4) + 2 * sizeof(float));
  nms_mask<<<dim3(batch, words), n_pad, smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      thresh, n, words, mask, order);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = 2 * 32 * (size_t)words * sizeof(uint32_t);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_scan, static_cast<const float*>(scores),
                         n, words, max_out, (const uint32_t*)mask,
                         (const int*)order, static_cast<int*>(keep_idx),
                         static_cast<uint8_t*>(keep_valid));
  return (int)e;
}

// One empty kernel on the stream: the practical floor of one launch, which
// chip_smoke.py times beside K1.
extern "C" int sht_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
