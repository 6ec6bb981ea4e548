// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, the Pallas kernel
// `_rmsnorm_kernel` behind `rmsnorm` (pallas_call at line 40).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* y, long long n,
                   int d, float eps, cudaStream_t stream) {
  const dim3 block = d <= 1024 ? dim3(32, 8) : dim3(kWide, 1);
  const long long blocks = (n + block.y - 1) / block.y;
  rmsnorm_kernel<T><<<dim3(unsigned(blocks)), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), n, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (n, d) contiguous with
// d % (16 / sizeof(T)) == 0.  Returns a cudaError_t (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int dtype, long long n, int d, float eps,
                             void* stream) {
  if (n <= 0 || d <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d % 4) return int(cudaErrorInvalidValue);
    return int(launch<float>(x, scale, y, n, d, eps, st));
  }
  if (dtype == 1) {
    if (d % 8) return int(cudaErrorInvalidValue);
    return int(launch<__nv_bfloat16>(x, scale, y, n, d, eps, st));
  }
  return int(cudaErrorInvalidValue);
}
