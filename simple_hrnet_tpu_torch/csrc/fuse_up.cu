// K3: HRNet's high-resolution fusion output,
//   out = relu(base + sum_j nearest_up_{f_j}(conv1x1(y_j) + b_j)).
//
// Replaces the TPU kernel simple_hrnet_tpu/ops/pallas/fuse_up.py (fuse_up,
// kernel from _make_kernel). On the TPU the W-upsample is a 0/1 interleave
// matmul; here a nearest-upsample read is an index shift (h >> s, w >> s).
//
// Arithmetic follows the TPU kernel: the accumulator starts at
// base + sum_j b_j in f32, each source adds its f32 1x1-conv product (y_j
// and the weights in the activation type, as fuse_up.py casts them) in
// source order, and the ReLU and the one cast to the activation type happen
// at the store. Only the order of the k-sums inside each product differs
// from the plain version.
//
// Bound on the H100: bytes. At the W48 stage-4 shape with 32 crops (base
// 32 x 96 x 72 x 48, sources at /2, /4, /8 with 96, 192, 384 channels) the
// kernel must read base (21.2 MB) and the sources (10.6 + 5.3 + 2.65 MB)
// and write out (21.2 MB): 61 MB, 18.2 us at 3.35 TB/s. Its 0.45 G
// multiply-adds are 0.9 us at the bf16 tensor-core peak, but 13 us at the
// f32 CUDA-core peak.
//
// The first design lost 21x to that bound: one block per 8 x 8 output tile
// (3,456 blocks at that shape, each fetching all 64.5 KB of weights from L2
// again), f32 products on the CUDA cores reading a weight from global memory
// for every multiply-add, scalar 2-byte loads and stores, and no overlap of
// a tile's loads with another's compute. This design:
//   * persistent blocks, one wave: each block stages all sources' 1x1
//     weights in shared memory once, then its TEAMS teams of 256 threads
//     each walk their own (image, 16-row x 8-column output tile) work
//     items, synchronising on their own named barrier, so one team's
//     products and stores overlap the other's;
//   * each team has a ring of STAGES slots in shared memory filled by
//     16-byte cp.async copies: a slot holds a tile's base pixels and each
//     source's window under it (32, 8 and 2 source pixels), so the next
//     tile's loads are in flight while the current one computes and stores;
//   * bf16 products on the tensor cores, per tile and source
//     t_j^T = W_j^T y_j^T with mma.sync m16n8k16 (16 output channels x 8
//     source pixels, f32 accumulators), both operands read by ldmatrix from
//     rows padded to an odd number of 16-byte units, so without bank
//     conflicts; each A fragment serves two n-tiles where the window has
//     them. The f32 instantiation (for exact checks) computes the products
//     on the CUDA cores from the same shared memory, with one team and one
//     slot (its weights alone take 129 KB at W48);
//   * the products wait in shared memory as f32; in the epilogue each thread
//     owns 8 channels of two neighbouring pixels, which share every source
//     pixel: base + bias_sum, + t_1, + t_2, + t_3 (each read once, by the
//     index shift), ReLU, one rounding, one 16-byte store per pixel.
// What still holds it back (the phases' times, measured one at a time on
// the card) is in PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the dynamic shared memory attribute is set per device: a function's
// attribute lives in the current device's context
constexpr int MAX_DEVICES = 64;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 16;          // output tile rows
constexpr int LOG_TW = 3;
constexpr int TW = 1 << LOG_TW;  // output tile columns
constexpr int TP = TH * TW;     // output tile pixels
constexpr int TEAM = 256;       // threads of a team (walks its own tiles)
constexpr int TEAM_WARPS = TEAM / 32;
constexpr int MAX_SRC = 3;
constexpr int SMEM_LIMIT = 232448;  // what one block can use on the H100

// Teams per block and ring slots per team. bf16: two teams share the
// staged weights, so one team's products and stores overlap the other's;
// f32: its weights alone take 129 KB at W48, which leaves room for one.
template <typename T> struct Ring;
template <> struct Ring<bf16> {
  static constexpr int TEAMS = 2;
  static constexpr int STAGES = 2;
};
template <> struct Ring<float> {
  static constexpr int TEAMS = 1;
  static constexpr int STAGES = 1;
};

struct Source {
  const void* y;  // (B, H >> shift, W >> shift, c) activation type
  const void* w;  // (c, C) activation type
  int c;
  int shift;
};

// Shared memory: the weights and bias_sum, then one region per team: its
// ring of tile slots and its f32 products. Offsets of arrays of T are in
// elements of T, others in bytes; every offset is a multiple of 16 bytes.
struct Layout {
  int n_src;
  int wpitch;               // weight row pitch (elements; a row is C wide)
  int w_off[MAX_SRC];       // W_j: c_j rows
  int y_off[MAX_SRC];       // y_j's window in a slot (after the base tile)
  int ypitch[MAX_SRC];      // window row pitch (elements; a row is c_j wide)
  int t_off[MAX_SRC];       // t_j (floats): window pixels rows
  int tpitch;               // t row pitch (floats; a row is C wide)
  int slot;                 // elements per ring slot
  int bias_bytes;           // byte offset of bias_sum
  int team_bytes;           // byte offset of team 0's region
  int team_stride;          // bytes per team region
  int t_bytes;              // byte offset of the products in a team region
  int bytes;                // the whole
};

struct Args {
  const void* base;  // (B, H, W, C)
  void* out;         // (B, H, W, C)
  const float* bias_sum;
  Source src[MAX_SRC];
  Layout L;
  int H, W, C;
  int tiles_x, tiles_per_image, n_items;
};

__host__ __device__ inline int window_cols(int shift) { return TW >> shift; }
__host__ __device__ inline int window_pixels(int shift) {
  return (TH >> shift) * (TW >> shift);
}

// Pitches: for ldmatrix (bf16) a row spans an odd number of 16-byte units,
// so the 8 rows of each 8 x 8 matrix fall in 8 different bank groups; the
// f32 products read rows without ldmatrix and take them unpadded.
template <typename T>
Layout make_layout(int n_src, const int* c, const int* shift, int C) {
  const bool tc = sizeof(T) == 2;
  Layout L{};
  L.n_src = n_src;
  L.wpitch = tc ? (C + 15) / 16 * 16 + 8 : C;
  long e = 0;
  for (int j = 0; j < n_src; ++j) {
    L.w_off[j] = (int)e;
    e += (long)c[j] * L.wpitch;
  }
  const long bias_bytes = e * (long)sizeof(T);
  const long team_bytes = bias_bytes + (long)C * 4;
  long s = (long)TP * C;
  for (int j = 0; j < n_src; ++j) {
    L.ypitch[j] = tc ? c[j] + 8 : c[j];
    L.y_off[j] = (int)s;
    s += (long)window_pixels(shift[j]) * L.ypitch[j];
  }
  L.slot = (int)s;
  const long t_bytes = Ring<T>::STAGES * s * (long)sizeof(T);
  L.tpitch = C + 4;  // the products' stores: 4 pixel rows hit 4 bank groups
  long f = 0;
  for (int j = 0; j < n_src; ++j) {
    L.t_off[j] = (int)f;
    f += (long)window_pixels(shift[j]) * L.tpitch;
  }
  const long team_stride = t_bytes + f * 4;
  const long bytes = team_bytes + Ring<T>::TEAMS * team_stride;
  L.bias_bytes = (int)bias_bytes;
  L.team_bytes = (int)team_bytes;
  L.team_stride = (int)team_stride;
  L.t_bytes = (int)t_bytes;
  L.bytes = bytes > (1L << 30) ? 1 << 30 : (int)bytes;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of the TEAM threads of one team (named barrier 1 + team)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(TEAM) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// i / d for 0 <= i < 2^22, given inv = __frcp_rn(d): exact, since
// (i + 0.5) / d lies at least 0.5 / d from an integer and the two roundings
// move it by less. A few instructions instead of an integer division's ~20.
__device__ __forceinline__ int div_by(int i, float inv) {
  return (int)(((float)i + 0.5f) * inv);
}

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int item) {
  Tile t;
  t.b = div_by(item, __frcp_rn((float)a.tiles_per_image));
  const int r = item - t.b * a.tiles_per_image;
  const int ty = div_by(r, __frcp_rn((float)a.tiles_x));
  t.h0 = ty * TH;
  t.w0 = (r - ty * a.tiles_x) * TW;
  return t;
}

// Start the 16-byte copies of one work item's base tile and source windows
// into a ring slot. Pixels past the image are not copied: their slot rows
// keep stale values, which feed only products that no stored pixel reads.
template <typename T>
__device__ __forceinline__ void load_tile(const Args& a, T* slot, int item) {
  constexpr int EPC = 16 / sizeof(T);  // elements per copy
  const Tile t = tile_of(a, item);
  const int C = a.C;
  const int cpp = C / EPC;
  const float inv_cpp = __frcp_rn((float)cpp);
  const T* base =
      static_cast<const T*>(a.base) + (size_t)t.b * a.H * a.W * C;
  for (int i = threadIdx.x % TEAM; i < TP * cpp; i += TEAM) {
    const int p = div_by(i, inv_cpp);
    const int k = (i - p * cpp) * EPC;
    const int gy = t.h0 + p / TW;
    const int gx = t.w0 + p % TW;
    if (gy < a.H && gx < a.W)
      cp_async16(slot + p * C + k, base + ((size_t)gy * a.W + gx) * C + k);
  }
#pragma unroll
  for (int j = 0; j < MAX_SRC; ++j) {
    if (j >= a.L.n_src) break;
    const int s = a.src[j].shift;
    const int cj = a.src[j].c;
    const int npix = window_pixels(s);
    const int hs = a.H >> s, ws = a.W >> s;
    const int cjc = cj / EPC;
    const float inv_cjc = __frcp_rn((float)cjc);
    const T* y =
        static_cast<const T*>(a.src[j].y) + (size_t)t.b * hs * ws * cj;
    T* dst = slot + a.L.y_off[j];
    const int pitch = a.L.ypitch[j];
    for (int i = threadIdx.x % TEAM; i < npix * cjc; i += TEAM) {
      const int p = div_by(i, inv_cjc);
      const int k = (i - p * cjc) * EPC;
      const int gy = (t.h0 >> s) + (p >> (LOG_TW - s));  // / window_cols(s)
      const int gx = (t.w0 >> s) + (p & (window_cols(s) - 1));
      if (gy < hs && gx < ws)
        cp_async16(dst + p * pitch + k, y + ((size_t)gy * ws + gx) * cj + k);
    }
  }
}

// t_j[p][n] = sum_k y_j[p][k] W_j[k][n] for every window pixel p, on the
// tensor cores: a warp's work unit is 16 output channels x 16 window pixels
// (two n-tiles; one where the window is smaller) of one source over all its
// k (A = W_j^T by ldmatrix.trans from the row-major weights, B = y_j^T by
// ldmatrix from the pixel rows). Units are dealt to the warps round-robin,
// the longest sums (the last source) first.
__device__ __forceinline__ void products(const Args& a, const bf16* wsm,
                                         const bf16* slot, float* tsm) {
  const int warp = (threadIdx.x % TEAM) >> 5;
  const int lane = threadIdx.x & 31;
  const int C = a.C;
  const int n_m = (C + 15) / 16;
  int first = 0;
#pragma unroll
  for (int j = MAX_SRC - 1; j >= 0; --j) {
    if (j >= a.L.n_src) continue;
    const int npix = window_pixels(a.src[j].shift);
    const int ksteps = a.src[j].c / 16;
    const int units = n_m * ((npix + 15) / 16);
    const bf16* wj = wsm + a.L.w_off[j];
    const bf16* yj = slot + a.L.y_off[j];
    float* tj = tsm + a.L.t_off[j];
    for (int v = ((warp - first) % TEAM_WARPS + TEAM_WARPS) % TEAM_WARPS;
         v < units; v += TEAM_WARPS) {
      const int mt = v % n_m;
      const int g = v / n_m;  // pixels [16 g, 16 g + 16)
      const bool second = g * 16 + 8 < npix;
      const uint32_t a_addr = smem_addr(
          wj + (size_t)((lane & 7) + ((lane >> 4) & 1) * 8) * a.L.wpitch +
          mt * 16 + ((lane >> 3) & 1) * 8);
      const int px =
          min(g * 16 + (lane & 7) + ((lane >> 4) & 1) * 8, npix - 1);
      const uint32_t b_addr =
          smem_addr(yj + (size_t)px * a.L.ypitch[j] + ((lane >> 3) & 1) * 8);
      const uint32_t a_step = 16u * a.L.wpitch * sizeof(bf16);
      float acc0[4] = {0.f, 0.f, 0.f, 0.f};
      float acc1[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t af[4], bfr[4];
      if (second) {
#pragma unroll 2
        for (int k = 0; k < ksteps; ++k) {
          ldsm_x4_trans(a_addr + k * a_step, af);
          ldsm_x4(b_addr + k * 32u, bfr);
          mma_bf16(acc0, af, bfr);
          mma_bf16(acc1, af, bfr + 2);
        }
      } else {
        int k = 0;
#pragma unroll 2
        for (; k + 1 < ksteps; k += 2) {
          ldsm_x4_trans(a_addr + k * a_step, af);
          ldsm_x2(b_addr + k * 32u, bfr);
          mma_bf16(acc0, af, bfr);
          ldsm_x4_trans(a_addr + (k + 1) * a_step, af);
          ldsm_x2(b_addr + (k + 1) * 32u, bfr);
          mma_bf16(acc1, af, bfr);
        }
        if (k < ksteps) {
          ldsm_x4_trans(a_addr + k * a_step, af);
          ldsm_x2(b_addr + k * 32u, bfr);
          mma_bf16(acc0, af, bfr);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc0[q] += acc1[q];
      }
      const int ch = mt * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = ch + (q >> 1) * 8;
          const int p = g * 16 + h * 8 + 2 * (lane & 3) + (q & 1);
          if (c < C && p < npix)
            tj[p * a.L.tpitch + c] = h ? acc1[q] : acc0[q];
        }
      }
    }
    first += units;
  }
}

// The f32 instantiation's products, on the CUDA cores: one thread per
// (pixel, output channel), weights from shared memory.
__device__ __forceinline__ void products(const Args& a, const float* wsm,
                                         const float* slot, float* tsm) {
  const int C = a.C;
#pragma unroll
  for (int j = 0; j < MAX_SRC; ++j) {
    if (j >= a.L.n_src) break;
    const int npix = window_pixels(a.src[j].shift);
    const int cj = a.src[j].c;
    const float* wj = wsm + a.L.w_off[j];
    const float* yj = slot + a.L.y_off[j];
    float* tj = tsm + a.L.t_off[j];
    for (int i = threadIdx.x % TEAM; i < npix * C; i += TEAM) {
      const int p = i / C;
      const int n = i - p * C;
      const float* yr = yj + p * a.L.ypitch[j];
      float acc = 0.f;
      for (int k = 0; k < cj; ++k) acc += yr[k] * wj[k * a.L.wpitch + n];
      tj[p * a.L.tpitch + n] = acc;
    }
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Each thread finishes 8 channels of two horizontally adjacent pixels at a
// time (an even column and the next: both read the same source pixel of
// every source, so bias and products are read once for the two), in the
// plain version's order: (base + bias_sum) + t_1 + t_2 + t_3, ReLU, one
// cast, one 16-byte store per pixel.
template <typename T>
__device__ __forceinline__ void epilogue(const Args& a, const T* slot,
                                         const float* tsm, const float* bias,
                                         int item) {
  const Tile t = tile_of(a, item);
  const int C = a.C;
  const int cg = C / 8;
  const float inv_cg = __frcp_rn((float)cg);
  T* out = static_cast<T*>(a.out) + (size_t)t.b * a.H * a.W * C;
  for (int i = threadIdx.x % TEAM; i < TP / 2 * cg; i += TEAM) {
    const int pp = div_by(i, inv_cg);
    const int c0 = (i - pp * cg) * 8;
    const int py = pp / (TW / 2);
    const int px = pp % (TW / 2) * 2;
    const int gy = t.h0 + py;
    const int gx = t.w0 + px;
    if (gy >= a.H || gx >= a.W) continue;  // W is even: gx + 1 < W too
    const int p = py * TW + px;
    float acc[2][8], v[8];
    load8(slot + p * C + c0, acc[0]);
    load8(slot + (p + 1) * C + c0, acc[1]);
    load8(bias + c0, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[0][k] += v[k];
      acc[1][k] += v[k];
    }
#pragma unroll
    for (int j = 0; j < MAX_SRC; ++j) {
      if (j >= a.L.n_src) break;
      const int s = a.src[j].shift;
      const int q = (py >> s) * window_cols(s) + (px >> s);
      load8(tsm + a.L.t_off[j] + q * a.L.tpitch + c0, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[0][k] += v[k];
        acc[1][k] += v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[0][k] = fmaxf(acc[0][k], 0.f);
      acc[1][k] = fmaxf(acc[1][k], 0.f);
    }
    T* o = out + ((size_t)gy * a.W + gx) * C + c0;
    store8(o, acc[0]);
    store8(o + C, acc[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(Ring<T>::TEAMS * TEAM)
    fuse_up_kernel(const Args a) {
  constexpr int TEAMS = Ring<T>::TEAMS;
  constexpr int STAGES = Ring<T>::STAGES;
  constexpr int EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);
  float* bias = reinterpret_cast<float*>(smem + a.L.bias_bytes);
  const int team = threadIdx.x / TEAM;
  unsigned char* mine = smem + a.L.team_bytes + team * a.L.team_stride;
  T* ring = reinterpret_cast<T*>(mine);
  float* tsm = reinterpret_cast<float*>(mine + a.L.t_bytes);
  const int C = a.C;

  // every source's weights, once per block (rows re-pitched on the way)
  const int cpp = C / EPC;
#pragma unroll
  for (int j = 0; j < MAX_SRC; ++j) {
    if (j >= a.L.n_src) break;
    const T* wg = static_cast<const T*>(a.src[j].w);
    T* ws = wsm + a.L.w_off[j];
    for (int i = threadIdx.x; i < a.src[j].c * cpp; i += TEAMS * TEAM) {
      const int row = i / cpp;
      const int k = (i - row * cpp) * EPC;
      cp_async16(ws + row * a.L.wpitch + k, wg + (size_t)row * C + k);
    }
  }
  for (int i = threadIdx.x; i < C; i += TEAMS * TEAM) bias[i] = a.bias_sum[i];
  cp_async_commit();
  // team k of block b takes work items b * TEAMS + k + n * stride
  const int first = blockIdx.x * TEAMS + team;
  const int stride = gridDim.x * TEAMS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    const int item = first + s * stride;
    if (item < a.n_items) load_tile<T>(a, ring + s * a.L.slot, item);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // this thread's weight copies are in
  __syncthreads();              // ... and every thread's, of both teams

  for (int n = 0;; ++n) {
    const int item = first + n * stride;
    if (item >= a.n_items) break;
    team_sync(team);  // the team is done with the slot refilled next
    const int ahead = item + (STAGES - 1) * stride;
    if (ahead < a.n_items)
      load_tile<T>(a, ring + ((n + STAGES - 1) % STAGES) * a.L.slot, ahead);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this thread's copies of item are in
    team_sync(team);              // ... and the whole team's
    const T* slot = ring + (n % STAGES) * a.L.slot;
    products(a, wsm, slot, tsm);
    team_sync(team);
    epilogue<T>(a, slot, tsm, bias, item);
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(Args& a, cudaStream_t st) {
  // the dynamic shared memory the kernel has been allowed (once per size
  // above the 48 KB default, so the launch path stays free of API calls
  // that a CUDA graph capture might refuse)
  static int allowed[MAX_DEVICES] = {};
  int cur = 0;
  if (cudaGetDevice(&cur) != cudaSuccess || cur >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const int bytes = a.L.bytes;
  if (bytes > 48 * 1024 && bytes > allowed[cur]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fuse_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    allowed[cur] = bytes;
  }
  // one wave of resident blocks, each walking its share of the work items
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fuse_up_kernel<T>, Ring<T>::TEAMS * TEAM, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (a.n_items + Ring<T>::TEAMS - 1) / Ring<T>::TEAMS;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  fuse_up_kernel<T><<<grid, Ring<T>::TEAMS * TEAM, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

bool valid(int n_src, const int* c, const int* shift, int C) {
  if (n_src < 1 || n_src > MAX_SRC || C <= 0 || C % 8) return false;
  for (int j = 0; j < n_src; ++j)
    if (c[j] <= 0 || c[j] % 16 || shift[j] < 1 || shift[j] > 3) return false;
  return true;
}

size_t smem_bytes(int n_src, const int* c, const int* shift, int C,
                  int dtype) {
  if (!valid(n_src, c, shift, C)) return 0;
  if (dtype == 0) return make_layout<float>(n_src, c, shift, C).bytes;
  if (dtype == 1) return make_layout<bf16>(n_src, c, shift, C).bytes;
  return 0;
}

}  // namespace

// Shared memory one block of the kernel needs (bytes; above 232448 it
// cannot run on the H100), or 0 for arguments the kernel does not take.
extern "C" size_t sht_fuse_up_smem_bytes(int n_src, const int* c,
                                         const int* shift, int C,
                                         int dtype) {
  return smem_bytes(n_src, c, shift, C, dtype);
}

// base, out: (B, H, W, C) NHWC in the activation type (dtype 0 = f32,
// 1 = bf16), C a multiple of 8; source s: y_s (B, H >> shift_s,
// W >> shift_s, c_s) and w_s (c_s, C) in the activation type, c_s a
// multiple of 16, 1 <= shift_s <= 3, H and W multiples of 1 << shift_s;
// bias_sum (C,) f32 = the sum of the sources' folded biases. base, out, y_s
// and w_s 16-byte aligned. Unused source slots are ignored. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sht_fuse_up(const void* base, int n_src, const void* y0,
                           const void* w0, int c0, int sh0, const void* y1,
                           const void* w1, int c1, int sh1, const void* y2,
                           const void* w2, int c2, int sh2,
                           const void* bias_sum, void* out, int B, int H,
                           int W, int C, int dtype, void* stream) {
  const int cs[MAX_SRC] = {c0, c1, c2};
  const int shs[MAX_SRC] = {sh0, sh1, sh2};
  if (!valid(n_src, cs, shs, C) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_src; ++j)
    if (H % (1 << shs[j]) || W % (1 << shs[j]))
      return (int)cudaErrorInvalidValue;
  Args a{};
  a.base = base;
  a.out = out;
  a.bias_sum = static_cast<const float*>(bias_sum);
  a.src[0] = Source{y0, w0, c0, sh0};
  a.src[1] = Source{y1, w1, c1, sh1};
  a.src[2] = Source{y2, w2, c2, sh2};
  a.L = dtype == 0 ? make_layout<float>(n_src, cs, shs, C)
                   : make_layout<bf16>(n_src, cs, shs, C);
  if (a.L.bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  a.H = H;
  a.W = W;
  a.C = C;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_per_image = ((H + TH - 1) / TH) * a.tiles_x;
  a.n_items = B * a.tiles_per_image;
  if (a.n_items == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, st);
  return launch<bf16>(a, st);
}
