// Fused RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, the Pallas kernel
// `_rmsnorm_kernel` behind `rmsnorm` (pallas_call at line 40).  The Pallas
// kernel has no backward (the reference computes the model's norms in jnp,
// so its gradient comes from XLA); the port calls this kernel in the model,
// so it owes the kernel a gradient: `rmsnorm_bwd_kernel` below.
//
// What it computes: y = x * rsqrt(mean(x^2) + eps) * scale over the last
// dim, in fp32, stored in x's dtype (bf16 or fp32); scale is fp32.  The
// input rows may be strided (a row stride in elements, a multiple of 16
// bytes; MLA's latent is the first 512 columns of 576-wide rows); the
// outputs are contiguous.
//
// What bounds it on the H100: bytes.  ~4 operations per element against
// one read and one write of x (2-4 bytes each), far below the card's
// balance point; at a few thousand rows or fewer, the latency of one trip
// to memory and of the launch.
//
// What the design does about it: every row is read from device memory
// once and held in registers between its sum of squares and its write:
// a row slot of `tpr` threads (a warp, or several) holds VPT 16-byte
// vectors a thread (VPT a template parameter; thread t holds vectors t,
// t + tpr, ..., so a warp's loads are contiguous, and a ragged tail of
// vectors is masked).  A block is `slots` such row slots; a slot of one
// warp reduces with shuffles alone, a wider one meets only its own named
// barrier (`bar.sync 1 + slot`), through a double-buffered word a warp in
// shared memory, so one barrier a row.  The host picks the plan
// (`kernels/rmsnorm.py::plan`, chosen on the card): a warp a row for narrow
// rows (d <= 1024 in bf16), a slot wide enough that each thread issues one
// or two loads for decode rows, two vectors a thread for wide rows.  Rows
// of up to 4 KB are walked by a grid of the blocks that fit on the card,
// each slot loading its next row while the current one reduces (WALK);
// wider rows get a slot each, which the block scheduler balances better.
//
// Backward (`repro_rmsnorm_bwd`): with g = dy * scale and r recomputed per
// row, dx = r * g - x * r^3 * mean(x * g) and dscale = sum over rows of
// dy * x * r.  Bound by bytes too (read x and dy, write dx).  The same
// slots and plans, in a grid of the blocks that fit on the card: x and dy
// are read once, into registers (kept packed across the row's sums, so
// the registers go to more blocks an SM and more loads in flight); each
// thread keeps the dscale sums of the columns it owns in registers across
// the rows its slot walks, so the per-element work touches no shared
// memory.  At the end the block adds its slots' sums (through shared
// memory, in slot order) and writes them as its row of an fp32 scratch:
// one row a block.  `rmsnorm_dscale_kernel` then adds the scratch's rows
// column by column, in a fixed order, with each thread's loads in flight
// together and blocks narrow enough to fill the card: no atomics, the same
// bits on every run.
//
// The statistic from outside (`repro_rmsnorm_rowsum`, `repro_rmsnorm_apply`,
// `repro_rmsnorm_apply_bwd`): a row whose columns are split over ranks
// (Mamba2's gated norm over d_inner under tensor parallelism, each rank
// holding its heads' columns) is normalised by the mean square of the
// whole row.  The forward is two kernels with an all-reduce of one fp32 a
// row between them, made by the caller: `rmsnorm_rowsum_kernel` writes
// each row's fp32 sum of squares over this rank's columns (a warp a row),
// `rmsnorm_apply_kernel` normalises by the reduced sum over the whole
// width.  The backward likewise: the row sums of x * dy * scale, the
// all-reduce, then `rmsnorm_apply_bwd_kernel` writes dx from the saved
// forward sums and the reduced dots, and its block's dscale sums as a row
// of the scratch that `rmsnorm_dscale_kernel` adds up (dscale is this
// rank's columns: no exchange).  Both apply kernels are a 2-D grid of
// column tiles (a thread a 16-byte vector, loads of a warp contiguous in
// one row) by row chunks walked with a stride; a simple design, bound by
// bytes like the fused kernels but reading x twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;              // a block's threads
constexpr int kMaxSlots = 16;                 // row slots a block
constexpr int kMaxWarps = kMaxThreads / 32;   // warps a slot
constexpr int kMaxSmem = 200 * 1024;          // the backward's slot sums

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of the fp32 with its bits
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// This thread's VPT vectors of a row (zeros past its end, or for no row).
template <typename T, int VPT>
__device__ __forceinline__ void load_row(const T* row, int nv, int tid,
                                         int tpr, uint4 (&r)[VPT]) {
  constexpr int N = Pack<T>::N;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * tpr + tid;
    r[j] = (row != nullptr && v < nv)
               ? __ldg(reinterpret_cast<const uint4*>(row + v * N))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int N>
__device__ __forceinline__ void load_scale(const float* s, float (&f)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(s) + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The barrier of one row slot's tpr threads (id 0 is __syncthreads').
__device__ __forceinline__ void bar_slot(int slot, int tpr) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(tpr) : "memory");
}

// block (tpr, slots); slot s of block b walks rows b * slots + s, then
// gridDim.x * slots further each time.  WALK: a slot has more than one row,
// so it loads the next while the current one reduces (else the grid has a
// slot for every row, and each thread's registers hold one row's vectors).
template <typename T, int VPT, bool WALK>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, long long ldx,
                   const float* __restrict__ scale, T* __restrict__ y,
                   long long n, int d, float eps) {
  constexpr int N = Pack<T>::N;
  __shared__ float red[kMaxSlots][2][kMaxWarps];
  const int tpr = blockDim.x, tid = threadIdx.x, slot = threadIdx.y;
  const int nv = d / N, nw = tpr / 32, w = tid / 32, lane = tid % 32;
  const long long step = (long long)gridDim.x * blockDim.y;
  long long row = (long long)blockIdx.x * blockDim.y + slot;
  uint4 cur[VPT];
  load_row<T, VPT>(row < n ? x + row * ldx : nullptr, nv, tid, tpr, cur);
  int parity = 0;
  for (; row < n; row += step) {
    const long long next = row + step;
    uint4 nxt[VPT];
    if (WALK)
      load_row<T, VPT>(next < n ? x + next * ldx : nullptr, nv, tid, tpr,
                       nxt);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      float f[N];
      Pack<T>::unpack(cur[j], f);
#pragma unroll
      for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = warp_sum(ss);
    if (nw > 1) {
      // one word a warp, double-buffered: a warp that runs a row ahead
      // writes the other buffer, and cannot run two ahead past the barrier
      if (lane == 0) red[slot][parity][w] = ss;
      bar_slot(slot, tpr);
      ss = 0.f;
      for (int i = 0; i < nw; ++i) ss += red[slot][parity][i];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / float(d) + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + tid;
      if (v < nv) {
        float f[N], s[N];
        Pack<T>::unpack(cur[j], f);
        load_scale<N>(scale + v * N, s);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = f[e] * r * s[e];
        *reinterpret_cast<uint4*>(yr + v * N) = Pack<T>::pack(f);
      }
    }
    if (WALK)
#pragma unroll
      for (int j = 0; j < VPT; ++j) cur[j] = nxt[j];
  }
}

// dx, and the block's dscale sums as row blockIdx.x of the scratch
// `partial` (gridDim.x x d).  Dynamic shared memory: slots x d fp32 when
// slots > 1.
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, long long ldx,
                       const float* __restrict__ scale,
                       const T* __restrict__ dy, long long ldg,
                       T* __restrict__ dx, float* __restrict__ partial,
                       long long n, int d, float eps) {
  constexpr int N = Pack<T>::N;
  extern __shared__ float4 sums4[];
  __shared__ float2 red[kMaxSlots][2][kMaxWarps];
  const int tpr = blockDim.x, tid = threadIdx.x, slot = threadIdx.y;
  const int nv = d / N, nw = tpr / 32, w = tid / 32, lane = tid % 32;
  const long long step = (long long)gridDim.x * blockDim.y;
  float acc[VPT][N];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[j][e] = 0.f;

  int parity = 0;
  for (long long row = (long long)blockIdx.x * blockDim.y + slot; row < n;
       row += step) {
    uint4 xv[VPT], gv[VPT];
    load_row<T, VPT>(x + row * ldx, nv, tid, tpr, xv);
    load_row<T, VPT>(dy + row * ldg, nv, tid, tpr, gv);
    float sxx = 0.f, sxg = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + tid;
      if (v < nv) {
        float f[N], g[N], s[N];
        Pack<T>::unpack(xv[j], f);
        Pack<T>::unpack(gv[j], g);
        load_scale<N>(scale + v * N, s);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          sxx = fmaf(f[e], f[e], sxx);
          sxg = fmaf(f[e], g[e] * s[e], sxg);
        }
      }
    }
    sxx = warp_sum(sxx);
    sxg = warp_sum(sxg);
    if (nw > 1) {
      if (lane == 0) red[slot][parity][w] = make_float2(sxx, sxg);
      bar_slot(slot, tpr);
      sxx = 0.f;
      sxg = 0.f;
      for (int i = 0; i < nw; ++i) {
        const float2 p = red[slot][parity][i];
        sxx += p.x;
        sxg += p.y;
      }
      parity ^= 1;
    }
    const float r = rsqrtf(sxx / float(d) + eps);
    const float k = r * r * r * (sxg / float(d));
    T* dr = dx + row * d;
    // the second pass unpacks x and dy again and reloads scale (an L1
    // hit) rather than keeping the first pass's fp32 values live across the
    // sums: fewer registers, so more blocks an SM and more loads in flight
    const float* sc = scale;
    asm volatile("" : "+l"(sc));
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      asm volatile("" : "+r"(xv[j].x), "+r"(xv[j].y), "+r"(xv[j].z),
                   "+r"(xv[j].w));
      asm volatile("" : "+r"(gv[j].x), "+r"(gv[j].y), "+r"(gv[j].z),
                   "+r"(gv[j].w));
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + tid;
      if (v < nv) {
        float f[N], g[N], s[N], o[N];
        Pack<T>::unpack(xv[j], f);
        Pack<T>::unpack(gv[j], g);
        load_scale<N>(sc + v * N, s);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          o[e] = r * (g[e] * s[e]) - f[e] * k;
          acc[j][e] = fmaf(g[e] * f[e], r, acc[j][e]);
        }
        *reinterpret_cast<uint4*>(dr + v * N) = Pack<T>::pack(o);
      }
    }
  }

  // the block's row of the scratch: its slots' sums, added in slot order
  float* out = partial + (long long)blockIdx.x * d;
  float* mine = blockDim.y == 1 ? out
                                : reinterpret_cast<float*>(sums4) + slot * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * tpr + tid;
    if (v < nv) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        reinterpret_cast<float4*>(mine + v * N)[q] =
            make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                        acc[j][4 * q + 3]);
    }
  }
  if (blockDim.y == 1) return;
  __syncthreads();
  const int d4 = d / 4;
  const float4* s4 = sums4;
  for (int c = slot * tpr + tid; c < d4; c += tpr * blockDim.y) {
    float4 a = s4[c];
    for (int k = 1; k < (int)blockDim.y; ++k) {
      const float4 b = s4[k * d4 + c];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    reinterpret_cast<float4*>(out)[c] = a;
  }
}

// dscale[c] = the sum of column c over the scratch's rows, in a fixed
// order.  Block (cols, lanes): lane l sums rows l, l + lanes, ... with four
// loads in flight, then the lanes' sums are added in lane order.
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_dscale_kernel(const float* __restrict__ partial,
                          float* __restrict__ dscale, int rows, int d) {
  __shared__ float red[kMaxThreads];
  const int cols = blockDim.x, lanes = blockDim.y;
  const int c = blockIdx.x * cols + threadIdx.x;
  float v = 0.f;
  if (c < d) {
    const float* p = partial + c;
    int k = threadIdx.y;
    for (; k + 3 * lanes < rows; k += 4 * lanes) {
      const float a0 = __ldg(p + (long long)k * d);
      const float a1 = __ldg(p + (long long)(k + lanes) * d);
      const float a2 = __ldg(p + (long long)(k + 2 * lanes) * d);
      const float a3 = __ldg(p + (long long)(k + 3 * lanes) * d);
      v += a0;
      v += a1;
      v += a2;
      v += a3;
    }
    for (; k < rows; k += lanes) v += __ldg(p + (long long)k * d);
  }
  red[threadIdx.y * cols + threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
    for (int i = 0; i < lanes; ++i) t += red[i * cols + threadIdx.x];
    dscale[c] = t;
  }
}

// out[row] = the fp32 sum over this row's d columns of x^2 (dy null) or
// of x * dy * scale; a warp a row, the grid's warps walking the rows.
template <typename T>
__global__ void __launch_bounds__(256)
    rmsnorm_rowsum_kernel(const T* __restrict__ x, long long ldx,
                          const T* __restrict__ dy, long long ldg,
                          const float* __restrict__ scale,
                          float* __restrict__ out, long long n, int d) {
  constexpr int N = Pack<T>::N;
  const int lane = threadIdx.x % 32, wpb = blockDim.x / 32;
  const int nv = d / N;
  const long long step = (long long)gridDim.x * wpb;
  for (long long row = (long long)blockIdx.x * wpb + threadIdx.x / 32;
       row < n; row += step) {
    const T* xr = x + row * ldx;
    float acc = 0.f;
    for (int v = lane; v < nv; v += 32) {
      float f[N];
      Pack<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xr + v * N)), f);
      if (dy != nullptr) {
        float g[N], s[N];
        Pack<T>::unpack(
            __ldg(reinterpret_cast<const uint4*>(dy + row * ldg + v * N)), g);
        load_scale<N>(scale + v * N, s);
#pragma unroll
        for (int e = 0; e < N; ++e) acc = fmaf(f[e], g[e] * s[e], acc);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) acc = fmaf(f[e], f[e], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

// y = x * rsqrt(ss[row] / width + eps) * scale.  Block: blockDim.x vectors
// of a row; grid (column tiles, row chunks): block (i, j) walks rows j,
// j + gridDim.y, ...
template <typename T>
__global__ void __launch_bounds__(256)
    rmsnorm_apply_kernel(const T* __restrict__ x, long long ldx,
                         const float* __restrict__ scale,
                         const float* __restrict__ ss, T* __restrict__ y,
                         long long n, int d, float width, float eps) {
  constexpr int N = Pack<T>::N;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= d / N) return;
  float s[N];
  load_scale<N>(scale + v * N, s);
  for (long long row = blockIdx.y; row < n; row += gridDim.y) {
    const float r = rsqrtf(__ldg(ss + row) / width + eps);
    float f[N];
    Pack<T>::unpack(
        __ldg(reinterpret_cast<const uint4*>(x + row * ldx + v * N)), f);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = f[e] * r * s[e];
    *reinterpret_cast<uint4*>(y + row * d + v * N) = Pack<T>::pack(f);
  }
}

// dx = r * dy * scale - x * r^3 * dot[row] / width with r from ss[row];
// the block's dscale sums (of dy * x * r over its rows) as row blockIdx.y
// of the scratch `partial` (gridDim.y x d).  The grid of
// rmsnorm_apply_kernel.
template <typename T>
__global__ void __launch_bounds__(256)
    rmsnorm_apply_bwd_kernel(const T* __restrict__ x, long long ldx,
                             const float* __restrict__ scale,
                             const T* __restrict__ dy, long long ldg,
                             const float* __restrict__ ss,
                             const float* __restrict__ dot,
                             T* __restrict__ dx, float* __restrict__ partial,
                             long long n, int d, float width, float eps) {
  constexpr int N = Pack<T>::N;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= d / N) return;
  float s[N], acc[N];
  load_scale<N>(scale + v * N, s);
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (long long row = blockIdx.y; row < n; row += gridDim.y) {
    const float r = rsqrtf(__ldg(ss + row) / width + eps);
    const float k = r * r * r * (__ldg(dot + row) / width);
    float f[N], g[N], o[N];
    Pack<T>::unpack(
        __ldg(reinterpret_cast<const uint4*>(x + row * ldx + v * N)), f);
    Pack<T>::unpack(
        __ldg(reinterpret_cast<const uint4*>(dy + row * ldg + v * N)), g);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      o[e] = r * (g[e] * s[e]) - f[e] * k;
      acc[e] = fmaf(g[e] * f[e], r, acc[e]);
    }
    *reinterpret_cast<uint4*>(dx + row * d + v * N) = Pack<T>::pack(o);
  }
  float* out = partial + (long long)blockIdx.y * d + v * N;
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = acc[e];
}

template <typename T, bool WALK>
const void* fwd_kernel(int vpt) {
  switch (vpt) {
    case 1: return reinterpret_cast<const void*>(rmsnorm_kernel<T, 1, WALK>);
    case 2: return reinterpret_cast<const void*>(rmsnorm_kernel<T, 2, WALK>);
    case 4: return reinterpret_cast<const void*>(rmsnorm_kernel<T, 4, WALK>);
    case 8: return reinterpret_cast<const void*>(rmsnorm_kernel<T, 8, WALK>);
  }
  return nullptr;
}

template <typename T>
const void* bwd_kernel(int vpt) {
  switch (vpt) {
    case 1: return reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, 2>);
    case 4: return reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, 4>);
    case 8: return reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, 8>);
  }
  return nullptr;
}

// The instance of a plan; the forward's walks rows (and prefetches) when
// the grid has fewer slots than rows.
const void* kernel_of(int backward, int dtype, int vpt, bool walk) {
  if (backward)
    return dtype == 0 ? bwd_kernel<float>(vpt)
                      : bwd_kernel<__nv_bfloat16>(vpt);
  if (dtype == 0)
    return walk ? fwd_kernel<float, true>(vpt) : fwd_kernel<float, false>(vpt);
  return walk ? fwd_kernel<__nv_bfloat16, true>(vpt)
              : fwd_kernel<__nv_bfloat16, false>(vpt);
}

// What a kernel takes (else kBadLayout): 16-byte aligned pointers, d and
// the row strides multiples of a vector, row strides >= d, and a plan
// whose slots cover a row: a multiple of 32 threads a slot, at most
// kMaxThreads a block and kMaxSlots slots, tpr * VPT vectors >= d's.
constexpr int kBadLayout = -1;

bool bad_layout(int dtype, int d, long long ld1, long long ld2,
                const void* const* ptrs, int nptrs, int vpt, int tpr,
                int slots, int blocks) {
  const int vec = dtype == 0 ? 4 : 8;
  if (d % vec || ld1 % vec || ld2 % vec || ld1 < d || ld2 < d) return true;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return true;
  if (vpt != 1 && vpt != 2 && vpt != 4 && vpt != 8) return true;
  if (tpr < 32 || tpr % 32 || slots < 1 || slots > kMaxSlots ||
      tpr * slots > kMaxThreads || blocks < 1)
    return true;
  return (long long)tpr * vpt * vec < d;
}

// The statistic-from-outside kernels' layout (else kBadLayout): 16-byte
// aligned rows (the pointers in ptrs), d and the row strides multiples of a
// vector, row strides >= d.
bool bad_rows(int dtype, int d, long long ld1, long long ld2,
              const void* const* ptrs, int nptrs) {
  const int vec = dtype == 0 ? 4 : 8;
  if (d % vec || ld1 % vec || ld2 % vec || ld1 < d || ld2 < d) return true;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return true;
  return false;
}

constexpr int kApplyThreads = 128;      // vectors of a row a block
constexpr int kRowsumThreads = 256;     // 8 warps, a row each

size_t bwd_smem(int d, int slots) {
  return slots > 1 ? size_t(slots) * d * sizeof(float) : 0;
}

}  // namespace

// Forward.  dtype: 0 = float32, 1 = bfloat16.  x: n rows of d, ldx
// elements apart; y: (n, d) contiguous.  The plan: VPT vectors a thread,
// tpr threads a row slot, slots a block, blocks (any count >= 1: the slots
// stride over the rows).  Returns a cudaError_t (0 on success), or -1 when
// the layout or the plan is not one the kernel takes (bad_layout).
extern "C" int repro_rmsnorm(const void* x, long long ldx, const void* scale,
                             void* y, int dtype, long long n, int d,
                             float eps, int vpt, int tpr, int slots,
                             int blocks, void* stream) {
  if (n <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {x, scale, y};
  if (bad_layout(dtype, d, ldx, d, ptrs, 3, vpt, tpr, slots, blocks))
    return kBadLayout;
  void* args[] = {&x, &ldx, &scale, &y, &n, &d, &eps};
  const bool walk = (long long)blocks * slots < n;
  cudaError_t err = cudaLaunchKernel(
      kernel_of(0, dtype, vpt, walk), dim3(unsigned(blocks)),
      dim3(unsigned(tpr), unsigned(slots)), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return int(err);
}

// Backward: x and dy n rows of d, ldx and ldg elements apart; dx (n, d)
// contiguous in the dtype's type; scale and dscale (d,) fp32; partial a
// (blocks, d) fp32 scratch, one row a block of the row kernel.  The same
// plan and return codes as repro_rmsnorm; two launches: the row kernel and
// the dscale sum.
extern "C" int repro_rmsnorm_bwd(const void* x, long long ldx,
                                 const void* scale, const void* dy,
                                 long long ldg, void* dx, void* partial,
                                 void* dscale, int dtype, long long n, int d,
                                 float eps, int vpt, int tpr, int slots,
                                 int blocks, void* stream) {
  if (n <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {x, scale, dy, dx, partial, dscale};
  if (bad_layout(dtype, d, ldx, ldg, ptrs, 6, vpt, tpr, slots, blocks))
    return kBadLayout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn = kernel_of(1, dtype, vpt, true);
  const size_t smem = bwd_smem(d, slots);
  if (smem > kMaxSmem) return kBadLayout;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&x, &ldx, &scale, &dy, &ldg, &dx, &partial, &n, &d, &eps};
  err = cudaLaunchKernel(fn, dim3(unsigned(blocks)),
                         dim3(unsigned(tpr), unsigned(slots)), args, smem,
                         st);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  // columns a block of the sum: enough blocks to fill the card
  const int cols = d >= 32 * 128 ? 32 : d >= 16 * 128 ? 16 : 8;
  rmsnorm_dscale_kernel<<<dim3(unsigned((d + cols - 1) / cols)),
                          dim3(unsigned(cols), unsigned(kMaxThreads / cols)),
                          0, st>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(dscale), blocks, d);
  return int(cudaGetLastError());
}

// Writes to *blocks the blocks of a plan's instance that fit on one SM at
// once; returns a cudaError_t, or -1 for a plan the kernel does not take.
extern "C" int repro_rmsnorm_blocks_per_sm(int backward, int dtype, int vpt,
                                           int tpr, int slots, int d,
                                           int* blocks) {
  if ((dtype != 0 && dtype != 1) || d <= 0) return kBadLayout;
  if (bad_layout(dtype, d, d, d, nullptr, 0, vpt, tpr, slots, 1))
    return kBadLayout;
  const void* fn = kernel_of(backward, dtype, vpt, true);
  const size_t smem = backward ? bwd_smem(d, slots) : 0;
  if (smem > kMaxSmem) return kBadLayout;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                        tpr * slots, smem);
  return int(err);
}

// Row sums of this rank's columns: out[row] (fp32) = sum of x^2 over the
// row's d columns where dy is null, else of x * dy * scale.  x and dy n
// rows of d, ldx and ldg elements apart.  Returns a cudaError_t, or -1 for
// a layout the kernel does not take.
extern "C" int repro_rmsnorm_rowsum(const void* x, long long ldx,
                                    const void* dy, long long ldg,
                                    const void* scale, void* out, int dtype,
                                    long long n, int d, int blocks,
                                    void* stream) {
  if (n <= 0 || d <= 0 || blocks < 1 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {x, scale, dy};
  if (bad_rows(dtype, d, ldx, dy != nullptr ? ldg : d, ptrs,
               dy != nullptr ? 3 : 2))
    return kBadLayout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rmsnorm_rowsum_kernel<float><<<blocks, kRowsumThreads, 0, st>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(dy),
        ldg, static_cast<const float*>(scale), static_cast<float*>(out), n,
        d);
  else
    rmsnorm_rowsum_kernel<__nv_bfloat16><<<blocks, kRowsumThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx,
        static_cast<const __nv_bfloat16*>(dy), ldg,
        static_cast<const float*>(scale), static_cast<float*>(out), n, d);
  return int(cudaGetLastError());
}

// y (n, d) contiguous = x * rsqrt(ss / width + eps) * scale, ss the
// reduced fp32 sums of squares (n,) over the whole row of width columns;
// row_blocks the grid's row chunks.
extern "C" int repro_rmsnorm_apply(const void* x, long long ldx,
                                   const void* scale, const void* ss,
                                   void* y, int dtype, long long n, int d,
                                   int width, float eps, int row_blocks,
                                   void* stream) {
  if (n <= 0 || d <= 0 || width < d || row_blocks < 1 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {x, scale, y};
  if (bad_rows(dtype, d, ldx, d, ptrs, 3)) return kBadLayout;
  const int nv = d / (dtype == 0 ? 4 : 8);
  const dim3 grid((nv + kApplyThreads - 1) / kApplyThreads,
                  unsigned(row_blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float w = float(width);
  if (dtype == 0)
    rmsnorm_apply_kernel<float><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(scale),
        static_cast<const float*>(ss), static_cast<float*>(y), n, d, w, eps);
  else
    rmsnorm_apply_kernel<__nv_bfloat16><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx,
        static_cast<const float*>(scale), static_cast<const float*>(ss),
        static_cast<__nv_bfloat16*>(y), n, d, w, eps);
  return int(cudaGetLastError());
}

// The backward of repro_rmsnorm_apply: dx (n, d) contiguous from x, dy,
// the forward's reduced sums of squares ss and the reduced row dots
// (repro_rmsnorm_rowsum with dy, then the caller's all-reduce); dscale
// (d,) fp32 through partial, a (row_blocks, d) fp32 scratch.  Two
// launches: the apply and the dscale sum.
extern "C" int repro_rmsnorm_apply_bwd(const void* x, long long ldx,
                                       const void* scale, const void* dy,
                                       long long ldg, const void* ss,
                                       const void* dot, void* dx,
                                       void* partial, void* dscale,
                                       int dtype, long long n, int d,
                                       int width, float eps, int row_blocks,
                                       void* stream) {
  if (n <= 0 || d <= 0 || width < d || row_blocks < 1 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {x, scale, dy, dx};
  if (bad_rows(dtype, d, ldx, ldg, ptrs, 4)) return kBadLayout;
  const int nv = d / (dtype == 0 ? 4 : 8);
  const dim3 grid((nv + kApplyThreads - 1) / kApplyThreads,
                  unsigned(row_blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float w = float(width);
  if (dtype == 0)
    rmsnorm_apply_bwd_kernel<float><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(scale),
        static_cast<const float*>(dy), ldg, static_cast<const float*>(ss),
        static_cast<const float*>(dot), static_cast<float*>(dx),
        static_cast<float*>(partial), n, d, w, eps);
  else
    rmsnorm_apply_bwd_kernel<__nv_bfloat16><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx,
        static_cast<const float*>(scale),
        static_cast<const __nv_bfloat16*>(dy), ldg,
        static_cast<const float*>(ss), static_cast<const float*>(dot),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), n, d,
        w, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int cols = d >= 32 * 128 ? 32 : d >= 16 * 128 ? 16 : 8;
  rmsnorm_dscale_kernel<<<dim3(unsigned((d + cols - 1) / cols)),
                          dim3(unsigned(cols), unsigned(kMaxThreads / cols)),
                          0, st>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(dscale), row_blocks,
                                   d);
  return int(cudaGetLastError());
}
