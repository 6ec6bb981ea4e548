// Fused RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, the Pallas kernel
// `_rmsnorm_kernel` behind `rmsnorm` (pallas_call at line 40).  The Pallas
// kernel has no backward (the reference computes the model's norms in jnp,
// so its gradient comes from XLA); the port calls this kernel in the model,
// so it owes the kernel a gradient: `rmsnorm_bwd_kernel` below.
//
// What it computes: y = x * rsqrt(mean(x^2) + eps) * scale over the last
// dim, in fp32, stored in x's dtype (bf16 or fp32); scale is fp32.
//
// What bounds it on the H100: bytes.  ~4 operations per element against
// one read and one write of x (2-4 bytes each): far below the card's
// balance point, so the best it can do is stream x at the memory rate.
//
// What the design does about it: one pass that reads each row and writes
// it once, 16-byte vector loads and stores (8 bf16 or 4 fp32 per thread and
// step), the fp32 sum of squares reduced with warp shuffles.  A row of
// d <= 1024 gets one warp (8 rows per block of 256 threads); a wider row
// gets a block of 256 threads, whose warps combine their sums through
// shared memory.  The second sweep over the row re-reads x, which a row of
// at most a few KB finds in L1.
//
// Backward (`repro_rmsnorm_bwd`): with g = dy * scale and r recomputed per
// row, dx = r * g - x * r^3 * mean(x * g) and dscale = sum over rows of
// dy * x * r.  Bound by bytes too (read x and dy, write dx).  Same row
// layout and vector loads as the forward; a block walks rows
// blockIdx.x, blockIdx.x + gridDim.x, ... (in slots of blockDim.y rows)
// and sums dy * x * r for the columns its threads own in shared memory, so
// no two threads touch one sum.  Each block writes its sums as one row of an
// fp32 scratch (blocks x d), and `rmsnorm_dscale_kernel` adds those rows in
// a fixed order: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWide = 256;   // threads per row when d > 1024

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// blockDim.x threads per row, blockDim.y rows per block.
template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, long long n, int d,
                               float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int nw = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int step = blockDim.x * N;

  float ss = 0.f;
  if (row < n) {
    const T* xr = x + row * d;
    for (int i = threadIdx.x * N; i < d; i += step) {
      float f[N];
      Vec<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) partial[threadIdx.y * nw + w] = ss;
  __syncthreads();
  if (row >= n) return;
  float total = 0.f;
  for (int i = 0; i < nw; ++i) total += partial[threadIdx.y * nw + i];
  const float r = rsqrtf(total / float(d) + eps);

  const T* xr = x + row * d;
  T* yr = y + row * d;
  for (int i = threadIdx.x * N; i < d; i += step) {
    float f[N], s[N];
    Vec<T>::load(xr + i, f);
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(scale + i + 4 * c);
      s[4 * c] = sv.x;
      s[4 * c + 1] = sv.y;
      s[4 * c + 2] = sv.z;
      s[4 * c + 3] = sv.w;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = f[j] * r * s[j];
    Vec<T>::store(yr + i, f);
  }
}

// dx and this block's dscale sums; blockDim.x threads per row, blockDim.y
// row slots per block; dynamic shared memory: blockDim.y * d floats.
template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const T* __restrict__ dy,
                                   T* __restrict__ dx,
                                   float* __restrict__ partial, long long n,
                                   int d, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 acc4[];
  __shared__ float red[2][32];
  float* acc = reinterpret_cast<float*>(acc4);
  float* mine = acc + threadIdx.y * d;
  const int nw = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int step = blockDim.x * N;
  for (int i = threadIdx.x * N; i < d; i += step) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      *reinterpret_cast<float4*>(mine + i + 4 * c) = make_float4(0, 0, 0, 0);
  }

  // The row loop is uniform over the block: a block of one wide row meets
  // at __syncthreads in every trip.
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long row0 = (long long)blockIdx.x * blockDim.y; row0 < n;
       row0 += stride) {
    const long long row = row0 + threadIdx.y;
    const bool live = row < n;
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float sxx = 0.f, sxg = 0.f;
    if (live) {
      for (int i = threadIdx.x * N; i < d; i += step) {
        float f[N], g[N];
        Vec<T>::load(xr + i, f);
        Vec<T>::load(gr + i, g);
#pragma unroll
        for (int c = 0; c < N / 4; ++c) {
          const float4 sv = *reinterpret_cast<const float4*>(scale + i + 4 * c);
          g[4 * c] *= sv.x;
          g[4 * c + 1] *= sv.y;
          g[4 * c + 2] *= sv.z;
          g[4 * c + 3] *= sv.w;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sxx = fmaf(f[j], f[j], sxx);
          sxg = fmaf(f[j], g[j], sxg);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
      sxg += __shfl_xor_sync(0xffffffffu, sxg, o);
    }
    if (nw > 1) {
      if (lane == 0) {
        red[0][w] = sxx;
        red[1][w] = sxg;
      }
      __syncthreads();
      sxx = 0.f;
      sxg = 0.f;
      for (int i = 0; i < nw; ++i) {
        sxx += red[0][i];
        sxg += red[1][i];
      }
      __syncthreads();  // red is written again by the next row
    }
    if (!live) continue;
    const float r = rsqrtf(sxx / float(d) + eps);
    const float k = r * r * r * (sxg / float(d));
    T* dr = dx + row * d;
    for (int i = threadIdx.x * N; i < d; i += step) {
      float f[N], g[N], s[N], o[N];
      Vec<T>::load(xr + i, f);
      Vec<T>::load(gr + i, g);
#pragma unroll
      for (int c = 0; c < N / 4; ++c) {
        const float4 sv = *reinterpret_cast<const float4*>(scale + i + 4 * c);
        s[4 * c] = sv.x;
        s[4 * c + 1] = sv.y;
        s[4 * c + 2] = sv.z;
        s[4 * c + 3] = sv.w;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = r * (g[j] * s[j]) - f[j] * k;
      Vec<T>::store(dr + i, o);
#pragma unroll
      for (int c = 0; c < N / 4; ++c) {
        float4* a = reinterpret_cast<float4*>(mine + i + 4 * c);
        float4 v = *a;
        v.x = fmaf(g[4 * c] * f[4 * c], r, v.x);
        v.y = fmaf(g[4 * c + 1] * f[4 * c + 1], r, v.y);
        v.z = fmaf(g[4 * c + 2] * f[4 * c + 2], r, v.z);
        v.w = fmaf(g[4 * c + 3] * f[4 * c + 3], r, v.w);
        *a = v;
      }
    }
  }
  __syncthreads();
  // this block's row of the scratch: the sums of its row slots
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  float* out = partial + (long long)blockIdx.x * d;
  for (int c = t; c < d; c += nt) {
    float v = 0.f;
    for (int k = 0; k < (int)blockDim.y; ++k) v += acc[k * d + c];
    out[c] = v;
  }
}

// dscale[c] = sum over the scratch's rows, in a fixed order; block (32, 8)
// takes 32 columns, its 8 rows of threads stride over the scratch's rows.
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dscale, int rows,
                                      int d) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < d)
    for (int k = threadIdx.y; k < rows; k += 8)
      v += partial[(long long)k * d + c];
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += red[k][threadIdx.x];
    dscale[c] = total;
  }
}

// Rows of d <= 1024 get one warp each (8 row slots a block); wider rows a
// block of kWide threads.
dim3 row_block(int d) { return d <= 1024 ? dim3(32, 8) : dim3(kWide, 1); }

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* y, long long n,
                   int d, float eps, cudaStream_t stream) {
  const dim3 block = row_block(d);
  const long long blocks = (n + block.y - 1) / block.y;
  rmsnorm_kernel<T><<<dim3(unsigned(blocks)), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), n, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy,
                       void* dx, float* partial, float* dscale, long long n,
                       int d, float eps, int blocks, cudaStream_t stream) {
  const dim3 block = row_block(d);
  const size_t smem = size_t(block.y) * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_kernel<T><<<dim3(unsigned(blocks)), block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, n, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<<<dim3(unsigned((d + 31) / 32)), dim3(32, 8), 0,
                          stream>>>(partial, dscale, blocks, d);
  return cudaGetLastError();
}

// What a kernel takes: 16-byte aligned rows of d % (16 / itemsize) == 0.
constexpr int kBadLayout = -1;

bool bad_layout(int dtype, int d, std::initializer_list<const void*> ptrs) {
  if (d % (dtype == 0 ? 4 : 8)) return true;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (n, d) contiguous.
// Returns a cudaError_t (0 on success), or -1 when d % (16 / itemsize) != 0
// or a pointer is not 16-byte aligned.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int dtype, long long n, int d, float eps,
                             void* stream) {
  if (n <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (bad_layout(dtype, d, {x, scale, y})) return kBadLayout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float>(x, scale, y, n, d, eps, st));
  return int(launch<__nv_bfloat16>(x, scale, y, n, d, eps, st));
}

// Backward: x, dy and dx are (n, d) contiguous in the dtype's type, scale
// and dscale (d,) fp32, partial a (blocks, d) fp32 scratch with
// 1 <= blocks (any count: rows are strided over the blocks).  Same return
// codes as repro_rmsnorm.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* partial,
                                 void* dscale, int dtype, long long n, int d,
                                 float eps, int blocks, void* stream) {
  if (n <= 0 || d <= 0 || blocks <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (bad_layout(dtype, d, {x, scale, dy, dx})) return kBadLayout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  if (dtype == 0)
    return int(launch_bwd<float>(x, scale, dy, dx, p, ds, n, d, eps, blocks,
                                 st));
  return int(launch_bwd<__nv_bfloat16>(x, scale, dy, dx, p, ds, n, d, eps,
                                       blocks, st));
}
