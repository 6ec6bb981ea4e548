// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd.py, the Pallas kernel `_ssd_kernel`
// behind `ssd_scan` (pallas_call at line 85).
//
// What it computes: per (batch, head), from the initial state S (zeros, or
// `init` when given) and per chunk of C = 64 steps, with acs the
// within-chunk cumulative sum of the log decays a (<= 0):
//   y     = (C B^T o exp(segsum a)) x + (C S) o exp(acs)
//   S_new = exp(a_total) S + B^T (x o exp(a_total - acs))
// x (B,H,L,P) is already multiplied by dt, a (B,H,L) is fp32, b/c
// (B,G,L,N) are shared by the H / G heads of a group (head h reads group
// h / (H / G): a broadcast costs no copy).  All arithmetic is fp32; the
// state is fp32 and carried across a sequential chunk loop inside the
// block.  P = N = 64.
//
// Where it differs from the Pallas kernel, and why:
// * It writes the final state, (B,H,P,N) fp32 as the model keeps it: the
//   serving path hands the prefill's state to decode.
// * It takes any L.  Steps past L in the last chunk are masked: their x, b,
//   c and a are zero, so they add nothing to y or the state and do not
//   decay it, and their y is not stored.
// * The chunk is this kernel's tile choice (64 steps, sized to shared
//   memory), not the caller's; the result does not depend on it beyond
//   rounding.
//
// What bounds it on the H100: the four chunk products do
// 2*C*(N+P) + 4*N*P = 32768 operations per step against ~260 bytes moved
// per step in bf16 (x and y of one head, b/c shared by the heads, a).  On
// the CUDA cores in fp32, as this first version runs them, that is above
// the balance point, so the kernel is bound by operations; on the bf16
// tensor cores (mma.sync / wgmma, later work) it would be bound by bytes.
//
// What the design does about it: one block of 256 threads per (batch,
// head), 2 blocks per SM.  Each chunk is staged once in shared memory as
// fp32 (x row-major; b and c transposed so a thread's four rows are one
// 16-byte load), and every product gives each thread a 4 x 4 tile of a
// 64 x 64 result, read as float4 pairs from shared memory (16 FMAs per two
// loads).  The within-chunk product skips the key steps past the thread's
// last row (causal).  The cumulative sums are taken sequentially in one
// order by every thread that needs them, so acs is monotone and every exp
// argument is <= 0 (the reference's stability invariant).  The state
// lives in registers (each thread owns a 4 x 4 tile of the 64 x 64 state)
// and is copied to shared memory once per chunk for the C S product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // steps per chunk
constexpr int P = 64;          // head dim
constexpr int N = 64;          // state dim
constexpr int NT = 256;        // threads per block: a 16 x 16 grid of 4 x 4 tiles
constexpr int LDS = 68;        // row stride (floats) of the 64-wide tiles

struct Params {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  const float* init;           // (B,H,P,N) fp32 or null
  void* y;
  float* state;                // (B,H,P,N) fp32
  long long x_sb, x_sh, x_sl;
  long long a_sb, a_sh, a_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long y_sb, y_sh, y_sl;
  int H, L, heads_per_group;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int V = 4;   // elements per 16-byte load
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store4(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int V = 8;
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
  __device__ static void store4(__nv_bfloat16* p, const float (&f)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Rows [0, 64) of a (rows, 64) slab (row stride rs elements) into shared
// memory as fp32; rows >= nv become zeros.  Row-major (dst[r][k]) with
// neighbouring threads on neighbouring 16-byte pieces of a row, so the
// global loads coalesce.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int nv, int tid) {
  constexpr int V = Io<T>::V;
  constexpr int NCH = 64 / V;
  for (int idx = tid; idx < 64 * NCH; idx += NT) {
    const int r = idx / NCH, ch = idx % NCH;
    float f[V];
    if (r < nv) {
      Io<T>::load(src + r * rs + ch * V, f);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(dst + r * LDS + ch * V + k) =
          make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
  }
}

// The same slab transposed (dst[k][r]); neighbouring threads take
// neighbouring rows, so the transposed stores do not conflict.
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src,
                                            long long rs, int nv, int tid) {
  constexpr int V = Io<T>::V;
  constexpr int NCH = 64 / V;
  for (int idx = tid; idx < 64 * NCH; idx += NT) {
    const int r = idx % 64, ch = idx / 64;
    float f[V];
    if (r < nv) {
      Io<T>::load(src + r * rs + ch * V, f);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) dst[(ch * V + k) * LDS + r] = f[k];
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 u,
                                       const float4 v) {
  const float a[4] = {u.x, u.y, u.z, u.w};
  const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;              // [C][LDS]  x[j][p]
  float* Bt = Xs + C * LDS;      // [N][LDS]  b[j][n] as Bt[n][j]
  float* Ct = Bt + N * LDS;      // [N][LDS]  c[i][n] as Ct[n][i]
  float* Gt = Ct + N * LDS;      // [C][LDS]  masked decayed C B^T, as Gt[j][i]
  float* Ss = Gt + C * LDS;      // [N][LDS]  state S[n][p] at chunk start
  float* As = Ss + N * LDS;      // [C] log decays of the chunk
  float* Ein = As + C;           // [C] exp(acs_i)
  float* Wout = Ein + C;         // [C] exp(a_total - acs_j)
  float* Acs = Wout + C;         // [C] acs
  float* Dec = Acs + C;          // [1] exp(a_total)

  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / p.heads_per_group;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;   // rows of this thread's tiles
  const int c0 = (tid & 15) * 4;   // columns of this thread's tiles

  const T* xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
  const T* bg = static_cast<const T*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.c) + bb * p.c_sb + g * p.c_sg;
  T* yg = static_cast<T*>(p.y) + bb * p.y_sb + h * p.y_sh;
  const long long st_off = (static_cast<long long>(bb) * p.H + h) * P * N;

  // This thread's tile of the state: S[r0 + i][c0 + q] (n = r0 + i,
  // p = c0 + q).  In memory the state is (P, N): element (p, n).
  float s[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.init) v = ld4(p.init + st_off + (c0 + q) * N + r0);
    s[0][q] = v.x;
    s[1][q] = v.y;
    s[2][q] = v.z;
    s[3][q] = v.w;
  }

  const int nchunks = (p.L + C - 1) / C;
  for (int kc = 0; kc < nchunks; ++kc) {
    const int l0 = kc * C;
    const int nv = min(C, p.L - l0);   // steps of this chunk inside L
    __syncthreads();                   // the previous chunk is fully read
    load_rows<T>(Xs, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows_t<T>(Bt, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows_t<T>(Ct, cg + l0 * p.c_sl, p.c_sl, nv, tid);
    if (tid < C) As[tid] = tid < nv ? ag[(l0 + tid) * p.a_sl] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Ss + (r0 + i) * LDS + c0) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // Cumulative log decays, summed in one order by every thread, so that
    // acs is monotone and every exponent below is <= 0.
    if (tid < C) {
      float run = 0.f, mine = 0.f;
      for (int k = 0; k < C; ++k) {
        run += As[k];
        if (k == tid) mine = run;
      }
      Acs[tid] = mine;
      Ein[tid] = expf(mine);
      Wout[tid] = expf(run - mine);
      if (tid == 0) Dec[0] = expf(run);
    }
    __syncthreads();

    // Gt[j][i] = (c_i . b_j) exp(acs_i - acs_j) for j <= i, else 0
    // (this thread: i in r0.., j in c0..).
    {
      float acc[4][4] = {};
      if (c0 <= r0 + 3) {
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          fma4x4(acc, ld4(Ct + n * LDS + r0), ld4(Bt + n * LDS + c0));
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = c0 + jj;
        float v[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = r0 + ii;
          v[ii] = i >= j ? acc[ii][jj] * expf(Acs[i] - Acs[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(Gt + j * LDS + r0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // y[i][p] = sum_{j <= i} Gt[j][i] x[j][p] + exp(acs_i) sum_n c[i][n] S[n][p]
    // (this thread: i in r0.., p in c0..).
    {
      float yd[4][4] = {}, yo[4][4] = {};
      const int jmax = min(r0 + 4, nv);
#pragma unroll 4
      for (int j = 0; j < jmax; ++j)
        fma4x4(yd, ld4(Gt + j * LDS + r0), ld4(Xs + j * LDS + c0));
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        fma4x4(yo, ld4(Ct + n * LDS + r0), ld4(Ss + n * LDS + c0));
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r0 + ii;
        if (i < nv) {
          const float e = Ein[i];
          float out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = fmaf(e, yo[ii][q], yd[ii][q]);
          Io<T>::store4(yg + (l0 + i) * p.y_sl + c0, out);
        }
      }
    }

    // S[n][p] = exp(a_total) S[n][p] + sum_j b[j][n] exp(a_total - acs_j) x[j][p]
    // (this thread: n in r0.., p in c0..), four steps j per pass.
    {
      float upd[4][4] = {};
      for (int j = 0; j < nv; j += 4) {
        const float4 w = ld4(Wout + j);
        const float wj[4] = {w.x, w.y, w.z, w.w};
        float4 bn[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) bn[ii] = ld4(Bt + (r0 + ii) * LDS + j);
        const float bj[4][4] = {{bn[0].x, bn[1].x, bn[2].x, bn[3].x},
                                {bn[0].y, bn[1].y, bn[2].y, bn[3].y},
                                {bn[0].z, bn[1].z, bn[2].z, bn[3].z},
                                {bn[0].w, bn[1].w, bn[2].w, bn[3].w}};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 xv = ld4(Xs + (j + jj) * LDS + c0);
          const float4 bw = make_float4(bj[jj][0] * wj[jj], bj[jj][1] * wj[jj],
                                        bj[jj][2] * wj[jj], bj[jj][3] * wj[jj]);
          fma4x4(upd, bw, xv);
        }
      }
      const float dec = Dec[0];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[i][q] = fmaf(s[i][q], dec, upd[i][q]);
    }
  }

#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(p.state + st_off + (c0 + q) * N + r0) =
        make_float4(s[0][q], s[1][q], s[2][q], s[3][q]);
}

constexpr size_t kSmem = (size_t(5) * 64 * LDS + 4 * C + 4) * sizeof(float);

template <typename T>
cudaError_t launch(dim3 grid, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<grid, NT, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; a, init and state
// are float32.  Strides are in elements: x (b, h, l), a (b, h, l),
// b/c (b, g, l), y (b, h, l); the last dim of x, b, c and y is contiguous;
// init and state are contiguous (B, H, P, N).  init may be null (zeros).
// Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_scan(
    const void* x, const void* a, const void* b, const void* c,
    const void* init, void* y, void* state, int dtype, int B, int H, int G,
    int L, long long x_sb, long long x_sh, long long x_sl, long long a_sb,
    long long a_sh, long long a_sl, long long b_sb, long long b_sg,
    long long b_sl, long long c_sb, long long c_sg, long long c_sl,
    long long y_sb, long long y_sh, long long y_sl, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || L <= 0 || H % G != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.b = b;
  p.c = c;
  p.init = static_cast<const float*>(init);
  p.y = y;
  p.state = static_cast<float*>(state);
  p.x_sb = x_sb;
  p.x_sh = x_sh;
  p.x_sl = x_sl;
  p.a_sb = a_sb;
  p.a_sh = a_sh;
  p.a_sl = a_sl;
  p.b_sb = b_sb;
  p.b_sg = b_sg;
  p.b_sl = b_sl;
  p.c_sb = c_sb;
  p.c_sg = c_sg;
  p.c_sl = c_sl;
  p.y_sb = y_sb;
  p.y_sh = y_sh;
  p.y_sl = y_sl;
  p.H = H;
  p.L = L;
  p.heads_per_group = H / G;
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return int(launch<__nv_bfloat16>(grid, st, p));
  if (dtype == 0) return int(launch<float>(grid, st, p));
  return int(cudaErrorInvalidValue);
}
