// Gradient of the Mamba2 SSD chunk scan for Hopper (sm_90a), on the CUDA
// cores in fp32.
//
// Replaces: the gradient of src/repro/kernels/ssd.py's Pallas kernel
// `_ssd_kernel` (pallas_call at line 85), which has none of its own: the
// reference trains through the jnp `ssd_chunked` (src/repro/models/ssm.py)
// and autodiff, and the port's Mamba2 block calls the forward kernel
// (ssd.cu) there, so the port owes that kernel its backward.
//
// What it computes, from the sequential form S_t = exp(a_t) S_{t-1} +
// x_t b_t^T, y_t = S_t c_t, with the adjoint R_t = dy_t c_t^T +
// exp(a_{t+1}) R_{t+1} (seeded with the final state's gradient, or zeros):
//   dx_t = R_t b_t,  db_t = R_t^T x_t,  dc_t = S_t^T dy_t,
//   da_t = exp(a_t) <R_t, S_{t-1}>,  d_init = exp(a_1) R_1,
// chunked as the forward is (C = 64 steps).  Per chunk, with acs the
// within-chunk cumulative log decays, A their total, G the gradient of the
// chunk's end state and S its start state:
//   Gh = (C B^T) o exp(acs_i - acs_j) [j <= i],  D = (dY X^T) o the same
//   dx = Gh^T dY + diag(exp(A - acs)) B G^T
//   db = D^T C  + diag(exp(A - acs)) X G
//   dc = D B    + diag(exp(acs)) dY S
//   G  <- exp(A) G + (diag(exp(acs)) dY)^T C          (the carry, reversed)
// and da as the within-chunk reverse cumulative sum of the gradient of acs:
// the row sums less the column sums of Gh o (dY X^T) off the diagonal
// (whose exponent acs_i - acs_i is 0 whatever the decays), the terms of the
// state's contribution (c_i . dc_inter_i) and of the carried decays
// (-x_i . dx_inter_i), and on the chunk's last step the gradient of its
// total, exp(A) <G, S> + sum_i x_i . dx_inter_i.  Every exponent is clamped
// at 0 as in the forward, with a zero derivative where the clamp binds.
//
// Design (a simple kernel; a tensor-core backward is later work):
// * One block of 256 threads per (batch, head); every product gives each
//   thread a 4 x 4 tile of a 64 x 64 result, fp32 FMAs from operands in
//   shared memory (bf16 inputs widened on load).  Two passes over the
//   chunks: forward, the chunk-start states S (fp32, P x N) into a
//   transient workspace (B, H, chunks, P, N); then in reverse, carrying G in
//   registers.  Eleven 64 x 64 fp32 tiles (the chunk's x, dy, b and c in the
//   layouts the products read, Gh, D, S and G twice): 196 KB of shared
//   memory, one block an SM.
// * db and dc are sums over the heads of a group.  Each block writes its
//   head's terms into an fp32 buffer (B, H, L, N) and a second kernel sums
//   each group's heads in a fixed order into the result's dtype, so the
//   result does not depend on the blocks' schedule (no atomics).
// * What bounds it: 61,760 operations a step and head (the five causal
//   within-chunk products over 65 x 64 / 2 pairs a chunk, the state
//   products and the state recompute) against ~400 bytes moved a step and
//   head in bf16.  At the inputs' dtype the function is bound by bytes in
//   bf16 (~0.22 ms at zamba2's training shape, B=8, L=2048, H=112, one
//   group) and by operations in fp32 (~1.7 ms at 67 TFLOP/s); this
//   kernel's fp32 arithmetic on the CUDA cores has the latter floor in
//   both dtypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // steps per chunk
constexpr int P = 64;          // head dim
constexpr int N = 64;          // state dim
constexpr int NT = 256;        // threads: a 16 x 16 grid of 4 x 4 tiles
constexpr int LDS = 68;        // row stride (floats) of the 64-wide tiles
constexpr int TILE = 64 * LDS;
constexpr int NTILES = 11;
constexpr int NVEC = 8 * C + 8 * C + 16;   // vectors, column partials, misc
constexpr size_t kSmem = (size_t(NTILES) * TILE + NVEC) * sizeof(float);

struct Params {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  const void* dy;
  const float* init;           // (B,H,P,N) fp32 or null
  const float* dstate;         // (B,H,P,N) fp32 or null (zeros)
  void* dx;
  float* da;                   // (B,H,L) fp32, contiguous
  float* db_h;                 // (B,H,L,N) fp32 per-head terms
  float* dc_h;
  float* d_init;               // (B,H,P,N) fp32 or null
  float* ws;                   // (B,H,chunks,P,N) fp32 chunk-start states
  long long x_sb, x_sh, x_sl;
  long long a_sb, a_sh, a_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long dy_sb, dy_sh, dy_sl;
  long long dx_sb, dx_sh, dx_sl;
  int B, H, G, L, heads_per_group, chunks;
};

template <typename T>
__device__ __forceinline__ float4 ld4g(const T* p);

template <>
__device__ __forceinline__ float4 ld4g<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 ld4g<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ void st4g(T* p, float4 v);

template <>
__device__ __forceinline__ void st4g<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <>
__device__ __forceinline__ void st4g<__nv_bfloat16>(__nv_bfloat16* p,
                                                    float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Rows [0, 64) of a (rows, 64) slab (row stride rs elements) into shared
// memory as fp32, row-major (dst[r][k]); rows >= nv become zeros.
// Neighbouring threads take neighbouring 4-element pieces of a row, so the
// global loads coalesce.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int nv, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int r = idx / 16, ch = idx % 16;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) v = ld4g<T>(src + r * rs + ch * 4);
    *reinterpret_cast<float4*>(dst + r * LDS + ch * 4) = v;
  }
}

// The same slab transposed (dst[k][r]); neighbouring threads take
// neighbouring rows, so the transposed stores do not conflict.
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src,
                                            long long rs, int nv, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int r = idx % 64, ch = idx / 64;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) v = ld4g<T>(src + r * rs + ch * 4);
    dst[(ch * 4 + 0) * LDS + r] = v.x;
    dst[(ch * 4 + 1) * LDS + r] = v.y;
    dst[(ch * 4 + 2) * LDS + r] = v.z;
    dst[(ch * 4 + 3) * LDS + r] = v.w;
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

// Column k of rows r0..r0+3 of a row-major tile (an A operand stored with
// its rows as the product's rows).
__device__ __forceinline__ float4 col4(const float* t, int r0, int k) {
  return make_float4(t[r0 * LDS + k], t[(r0 + 1) * LDS + k],
                     t[(r0 + 2) * LDS + k], t[(r0 + 3) * LDS + k]);
}

// Sum over the 16 lanes of a half-warp (the threads that share r0).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float clamped_exp(float v) {
  return expf(fminf(v, 0.f));
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Xr = smem;              // x[j][p]
  float* Xt = Xr + TILE;         // x as [p][j]
  float* Yr = Xt + TILE;         // dy[i][p]
  float* Br = Yr + TILE;         // b[j][n]
  float* Bt = Br + TILE;         // b as [n][j]
  float* Cr = Bt + TILE;         // c[i][n]
  float* Gh = Cr + TILE;         // (C B^T) o decay, [i][j], j <= i
  float* Dm = Gh + TILE;         // (dY X^T) o decay, [i][j], j <= i
  float* Ss = Dm + TILE;         // chunk-start state S[p][n]
  float* Gs = Ss + TILE;         // end-state gradient G[p][n]
  float* Gt = Gs + TILE;         // G as [n][p]
  float* As = Gt + TILE;         // [C] log decays
  float* Acs = As + C;           // [C] within-chunk cumulative sums
  float* Ein = Acs + C;          // [C] exp(acs_i)
  float* Wv = Ein + C;           // [C] exp(A - acs_i)
  float* RowT = Wv + C;          // [C] row sums of Gh o (dY X^T)
  float* CdC = RowT + C;         // [C] c_i . dc_inter_i
  float* Udx = CdC + C;          // [C] x_i . dx_inter_i
  float* Dacs = Udx + C;         // [C] gradient of acs
  float* ColP = Dacs + C;        // [8][C] per-warp column sums
  float* Red = ColP + 8 * C;     // [8] per-warp <G, S>, [8] exp(A)

  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / p.heads_per_group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (tid >> 4) * 4;   // rows of this thread's tiles
  const int c0 = (tid & 15) * 4;   // columns of this thread's tiles

  const T* xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
  const T* bg = static_cast<const T*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.c) + bb * p.c_sb + g * p.c_sg;
  const T* yg = static_cast<const T*>(p.dy) + bb * p.dy_sb + h * p.dy_sh;
  T* dxg = static_cast<T*>(p.dx) + bb * p.dx_sb + h * p.dx_sh;
  const long long bh = static_cast<long long>(bb) * p.H + h;
  float* dag = p.da + bh * p.L;
  float* dbg = p.db_h + bh * p.L * N;
  float* dcg = p.dc_h + bh * p.L * N;
  float* ws = p.ws + bh * p.chunks * P * N;
  const long long st_off = bh * P * N;

  // ---- forward: the chunk-start states, S tile (p = r0.., n = c0..) -----
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.init) v = ld4(p.init + st_off + (r0 + i) * N + c0);
    s[i][0] = v.x;
    s[i][1] = v.y;
    s[i][2] = v.z;
    s[i][3] = v.w;
  }
  for (int kc = 0; kc < p.chunks; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(ws + kc * P * N + (r0 + i) * N + c0, s[i][0], s[i][1], s[i][2],
          s[i][3]);
    if (kc == p.chunks - 1) break;
    const int l0 = kc * C;
    const int nv = min(C, p.L - l0);
    __syncthreads();                       // the last chunk is fully read
    load_rows<T>(Xr, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows<T>(Br, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    if (tid < C) As[tid] = tid < nv ? ag[(l0 + tid) * p.a_sl] : 0.f;
    __syncthreads();
    if (tid < C) {
      float run = 0.f, mine = 0.f;
      for (int k = 0; k < C; ++k) {
        run += As[k];
        if (k == tid) mine = run;
      }
      Wv[tid] = clamped_exp(run - mine);
      if (tid == 0) Red[8] = clamped_exp(run);
    }
    __syncthreads();
    // S[p][n] = exp(A) S[p][n] + sum_j x[j][p] exp(A - acs_j) b[j][n]
    float upd[4][4] = {};
    for (int j = 0; j < nv; ++j) {
      float4 xv = ld4(Xr + j * LDS + r0);
      const float w = Wv[j];
      xv.x *= w;
      xv.y *= w;
      xv.z *= w;
      xv.w *= w;
      fma4x4(upd, xv, ld4(Br + j * LDS + c0));
    }
    const float dec = Red[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[i][q] = fmaf(s[i][q], dec, upd[i][q]);
  }

  // ---- reverse: G tile (p = r0.., n = c0..) ------------------------------
  float gr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.dstate) v = ld4(p.dstate + st_off + (r0 + i) * N + c0);
    gr[i][0] = v.x;
    gr[i][1] = v.y;
    gr[i][2] = v.z;
    gr[i][3] = v.w;
  }
  for (int kc = p.chunks - 1; kc >= 0; --kc) {
    const int l0 = kc * C;
    const int nv = min(C, p.L - l0);
    __syncthreads();                       // the last chunk is fully read
    load_rows<T>(Xr, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows_t<T>(Xt, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows<T>(Yr, yg + l0 * p.dy_sl, p.dy_sl, nv, tid);
    load_rows<T>(Br, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows_t<T>(Bt, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows<T>(Cr, cg + l0 * p.c_sl, p.c_sl, nv, tid);
    load_rows<float>(Ss, ws + kc * P * N, N, P, tid);
    if (tid < C) As[tid] = tid < nv ? ag[(l0 + tid) * p.a_sl] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st4(Gs + (r0 + i) * LDS + c0, gr[i][0], gr[i][1], gr[i][2], gr[i][3]);
      st4(Gt + (c0 + i) * LDS + r0, gr[0][i], gr[1][i], gr[2][i], gr[3][i]);
    }
    __syncthreads();

    // Cumulative log decays, summed in one order by every thread (acs is
    // monotone, so no exponent below is positive for a <= 0); <G, S>.
    if (tid < C) {
      float run = 0.f, mine = 0.f;
      for (int k = 0; k < C; ++k) {
        run += As[k];
        if (k == tid) mine = run;
      }
      Acs[tid] = mine;
      Ein[tid] = clamped_exp(mine);
      Wv[tid] = clamped_exp(run - mine);
      if (tid == 0) Red[8] = clamped_exp(run);
    }
    {
      float gs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(Ss + (r0 + i) * LDS + c0);
        gs += gr[i][0] * v.x + gr[i][1] * v.y + gr[i][2] * v.z +
              gr[i][3] * v.w;
      }
      gs += __shfl_xor_sync(0xffffffffu, gs, 16);
      gs = half_warp_sum(gs);
      if (lane == 0) Red[warp] = gs;
    }
    __syncthreads();

    // Gh and D tiles (i = r0.., j = c0..) and the row / column sums of
    // T = Gh o (dY X^T), the gradient of the decay exponents acs_i - acs_j.
    {
      float qa[4][4] = {}, pa[4][4] = {};
      if (c0 <= r0 + 3) {
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          fma4x4(qa, col4(Cr, r0, n), ld4(Bt + n * LDS + c0));
#pragma unroll 8
        for (int k = 0; k < P; ++k)
          fma4x4(pa, col4(Yr, r0, k), ld4(Xt + k * LDS + c0));
      }
      float rowp[4] = {}, colp[4] = {};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r0 + ii;
        float gv[4], dv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = c0 + jj;
          const float arg = Acs[i] - Acs[j];
          const float e = i >= j ? clamped_exp(arg) : 0.f;
          gv[jj] = qa[ii][jj] * e;
          dv[jj] = pa[ii][jj] * e;
          // the diagonal's exponent is 0 whatever acs is: its terms would
          // enter the row and the column sum alike and cancel
          const float t = arg <= 0.f && i != j ? gv[jj] * pa[ii][jj] : 0.f;
          rowp[ii] += t;
          colp[jj] += t;
        }
        st4(Gh + i * LDS + c0, gv[0], gv[1], gv[2], gv[3]);
        st4(Dm + i * LDS + c0, dv[0], dv[1], dv[2], dv[3]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float v = half_warp_sum(rowp[ii]);
        if ((tid & 15) == 0) RowT[r0 + ii] = v;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float v = colp[jj] + __shfl_xor_sync(0xffffffffu, colp[jj], 16);
        if (lane < 16) ColP[warp * C + c0 + jj] = v;
      }
    }
    __syncthreads();

    const float dec = Red[8];
    // dx (i = r0.., p = c0..): Gh^T dY + diag(w) B G^T
    {
      float in[4][4] = {}, out[4][4] = {};
#pragma unroll 4
      for (int j = r0; j < nv; ++j)
        fma4x4(in, ld4(Gh + j * LDS + r0), ld4(Yr + j * LDS + c0));
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        fma4x4(out, ld4(Bt + n * LDS + r0), ld4(Gt + n * LDS + c0));
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r0 + ii;
        const float w = Wv[i];
        const float4 xv = ld4(Xr + i * LDS + c0);
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = out[ii][q] * w;
        const float u = half_warp_sum(o[0] * xv.x + o[1] * xv.y +
                                      o[2] * xv.z + o[3] * xv.w);
        if ((tid & 15) == 0) Udx[i] = u;
        if (i < nv)
          st4g<T>(dxg + (l0 + i) * p.dx_sl + c0,
                  make_float4(in[ii][0] + o[0], in[ii][1] + o[1],
                              in[ii][2] + o[2], in[ii][3] + o[3]));
      }
    }
    // db (j = r0.., n = c0..): D^T C + diag(w) X G
    {
      float in[4][4] = {}, out[4][4] = {};
#pragma unroll 4
      for (int i = r0; i < nv; ++i)
        fma4x4(in, ld4(Dm + i * LDS + r0), ld4(Cr + i * LDS + c0));
#pragma unroll 8
      for (int k = 0; k < P; ++k)
        fma4x4(out, ld4(Xt + k * LDS + r0), ld4(Gs + k * LDS + c0));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = r0 + jj;
        const float w = Wv[j];
        if (j < nv)
          st4(dbg + (l0 + j) * N + c0, fmaf(out[jj][0], w, in[jj][0]),
              fmaf(out[jj][1], w, in[jj][1]), fmaf(out[jj][2], w, in[jj][2]),
              fmaf(out[jj][3], w, in[jj][3]));
      }
    }
    // dc (i = r0.., n = c0..): D B + diag(exp(acs)) dY S
    {
      float in[4][4] = {}, out[4][4] = {};
      const int jmax = min(r0 + 4, nv);
#pragma unroll 4
      for (int j = 0; j < jmax; ++j)
        fma4x4(in, col4(Dm, r0, j), ld4(Br + j * LDS + c0));
#pragma unroll 8
      for (int k = 0; k < P; ++k)
        fma4x4(out, col4(Yr, r0, k), ld4(Ss + k * LDS + c0));
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r0 + ii;
        const float e = Ein[i];
        const float4 cv = ld4(Cr + i * LDS + c0);
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = out[ii][q] * e;
        const float v = half_warp_sum(o[0] * cv.x + o[1] * cv.y +
                                      o[2] * cv.z + o[3] * cv.w);
        if ((tid & 15) == 0) CdC[i] = v;
        if (i < nv)
          st4(dcg + (l0 + i) * N + c0, in[ii][0] + o[0], in[ii][1] + o[1],
              in[ii][2] + o[2], in[ii][3] + o[3]);
      }
    }
    // G (p = r0.., n = c0..) <- exp(A) G + sum_i dy[i][p] exp(acs_i) c[i][n]
    {
      float upd[4][4] = {};
#pragma unroll 4
      for (int i = 0; i < nv; ++i) {
        float4 yv = ld4(Yr + i * LDS + r0);
        const float e = Ein[i];
        yv.x *= e;
        yv.y *= e;
        yv.z *= e;
        yv.w *= e;
        fma4x4(upd, yv, ld4(Cr + i * LDS + c0));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) gr[i][q] = fmaf(gr[i][q], dec, upd[i][q]);
    }
    __syncthreads();

    // The gradient of acs, then da as its reverse cumulative sum.
    if (tid < C) {
      const int i = tid;
      const float total = Acs[C - 1];
      float col = 0.f;
      for (int w = 0; w < 8; ++w) col += ColP[w * C + i];
      const float cd = Acs[i] <= 0.f ? CdC[i] : 0.f;
      const float ud = total - Acs[i] <= 0.f ? Udx[i] : 0.f;
      float v = RowT[i] - col + cd - ud;
      if (i == C - 1) {            // the gradient of the chunk's total A
        float gs = 0.f, us = 0.f;
        for (int w = 0; w < 8; ++w) gs += Red[w];
        for (int k = 0; k < C; ++k)
          us += total - Acs[k] <= 0.f ? Udx[k] : 0.f;
        v += (total <= 0.f ? dec * gs : 0.f) + us;
      }
      Dacs[i] = v;
    }
    __syncthreads();
    if (tid < nv) {
      float run = 0.f;
      for (int k = C - 1; k >= tid; --k) run += Dacs[k];
      dag[(l0 + tid)] = run;
    }
  }

  if (p.d_init) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(p.d_init + st_off + (r0 + i) * N + c0, gr[i][0], gr[i][1],
          gr[i][2], gr[i][3]);
  }
}

// db / dc (B, G, L, N) in T: each group's heads' fp32 terms summed in head
// order; four elements a thread.
template <typename T>
__global__ void ssd_bwd_group_sum_kernel(const float* db_h, const float* dc_h,
                                         T* db, T* dc, int B, int H, int G,
                                         int L, int hpg, long long db_sb,
                                         long long db_sg, long long db_sl,
                                         long long dc_sb, long long dc_sg,
                                         long long dc_sl) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = static_cast<long long>(B) * G * L * (N / 4);
  if (e >= total) return;
  const int n = static_cast<int>(e % (N / 4)) * 4;
  long long rest = e / (N / 4);
  const int l = static_cast<int>(rest % L);
  rest /= L;
  const int g = static_cast<int>(rest % G);
  const int bb = static_cast<int>(rest / G);
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < hpg; ++k) {
    const long long off =
        ((static_cast<long long>(bb) * H + g * hpg + k) * L + l) * N + n;
    const float4 vb = ld4(db_h + off), vc = ld4(dc_h + off);
    sb.x += vb.x;
    sb.y += vb.y;
    sb.z += vb.z;
    sb.w += vb.w;
    sc.x += vc.x;
    sc.y += vc.y;
    sc.z += vc.z;
    sc.w += vc.w;
  }
  st4g<T>(db + bb * db_sb + g * db_sg + l * db_sl + n, sb);
  st4g<T>(dc + bb * dc_sb + g * dc_sg + l * dc_sl + n, sc);
}

template <typename T>
cudaError_t launch(const Params& p, T* db, T* dc, long long db_sb,
                   long long db_sg, long long db_sl, long long dc_sb,
                   long long dc_sg, long long dc_sl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmem));
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T><<<dim3(p.H, p.B), NT, kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(p.B) * p.G * p.L * (N / 4);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  ssd_bwd_group_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                stream>>>(
      p.db_h, p.dc_h, db, dc, p.B, p.H, p.G, p.L, p.heads_per_group, db_sb,
      db_sg, db_sl, dc_sb, dc_sg, dc_sl);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c, dy, dx, db and dc): 0 = float32, 1 = bfloat16; a, da,
// init, dstate, d_init and the scratch are float32.  Strides are in
// elements: x, dy, dx (b, h, l), a (b, h, l), b/c and db/dc (b, g, l); the
// last dim of every tensor is contiguous, row strides a multiple of 4.  da
// is contiguous (B, H, L); init, dstate, d_init contiguous (B, H, P, N);
// init, dstate and d_init may be null.  Scratch: ws (B, H, ceil(L/64), P,
// N) and db_h / dc_h (B, H, L, N), all fp32.  Returns a cudaError_t.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* a, const void* b, const void* c,
    const void* dy, const void* init, const void* dstate, void* dx, void* da,
    void* db, void* dc, void* d_init, void* ws, void* db_h, void* dc_h,
    int dtype, int B, int H, int G, int L, long long x_sb, long long x_sh,
    long long x_sl, long long a_sb, long long a_sh, long long a_sl,
    long long b_sb, long long b_sg, long long b_sl, long long c_sb,
    long long c_sg, long long c_sl, long long dy_sb, long long dy_sh,
    long long dy_sl, long long dx_sb, long long dx_sh, long long dx_sl,
    long long db_sb, long long db_sg, long long db_sl, long long dc_sb,
    long long dc_sg, long long dc_sl, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || L <= 0 || H % G != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.b = b;
  p.c = c;
  p.dy = dy;
  p.init = static_cast<const float*>(init);
  p.dstate = static_cast<const float*>(dstate);
  p.dx = dx;
  p.da = static_cast<float*>(da);
  p.db_h = static_cast<float*>(db_h);
  p.dc_h = static_cast<float*>(dc_h);
  p.d_init = static_cast<float*>(d_init);
  p.ws = static_cast<float*>(ws);
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
  p.dy_sb = dy_sb;
  p.dy_sh = dy_sh;
  p.dy_sl = dy_sl;
  p.dx_sb = dx_sb;
  p.dx_sh = dx_sh;
  p.dx_sl = dx_sl;
  p.B = B;
  p.H = H;
  p.G = G;
  p.L = L;
  p.heads_per_group = H / G;
  p.chunks = (L + C - 1) / C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(
        p, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc),
        db_sb, db_sg, db_sl, dc_sb, dc_sg, dc_sl, st));
  if (dtype == 0)
    return int(launch<float>(p, static_cast<float*>(db),
                             static_cast<float*>(dc), db_sb, db_sg, db_sl,
                             dc_sb, dc_sg, dc_sl, st));
  return int(cudaErrorInvalidValue);
}
