// Gradient of the Mamba2 SSD chunk scan for Hopper (sm_90a).
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
// at 0 as in the forward, but its derivative is the unclamped one's, as
// in the reference: with a <= 0 every exponent is at most 0, so a positive
// one is rounding (a decay under one fp32 unit of acs makes acs_i - acs_j
// come out above 0 in the scan's order) and its term still counts.
// db and dc sum over the heads of a group, in a fixed order (no atomics),
// so the result does not depend on the blocks' schedule.
//
// What bounds it: 61,760 operations a step and head (the five causal
// within-chunk products over 65 x 64 / 2 pairs a chunk, the state products
// and the state recompute) against ~400 bytes moved a step and head in
// bf16 (x, dy, dx of one head; b, c, db, dc shared by the group; a, da).
// At the inputs' dtype the function is bound by bytes in bf16 (~0.22 ms at
// zamba2's training shape, B=8, L=2048, H=112, one group) and by
// operations in fp32 (~1.7 ms at 67 TFLOP/s).
//
// bf16 (`ssd_bwd_states_kernel`, `ssd_bwd_wgmma_kernel`, then
// `ssd_bwd_group_sum_kernel`), what the design does about it:
// * Tensor cores with split operands, as the forward (ssd.cu).  Per chunk
//   and head: three m64n64k64 `wgmma` products of exact bf16 inputs (B C^T
//   and X dY^T, both with rows j, giving Gh^T and D^T; dY X^T, rows i,
//   giving D), so every product's fp32 operand comes out of an accumulator
//   in the row order of the product that reads it as a register A
//   operand; and six products with an fp32 operand (Gh^T dY, D^T C, D B
//   from registers; B G^T and X G from G in shared memory; dY S and the
//   carry's (dY o exp(acs))^T C), each split into hi = bf16(v) and lo =
//   bf16(v - hi) and run as two passes into one fp32 accumulator: 15
//   passes of 64 x 64 x 64 a chunk and head where the function needs 7.
//   Rounding those operands once to bf16 fails the bf16 check by 6-15x
//   (tests/test_torch_ssd_bwd_numerics.py).  The decays, the da
//   bookkeeping (T = Gh o (dY X^T) summed by row and column off the
//   diagonal, c . dc_inter, x . dx_inter, <G, S>) and G itself stay fp32
//   in registers and shared memory.
// * Two passes over the chunks, two kernels.  The states kernel walks the
//   chunks forward (the forward kernel's state update, 2 passes a chunk,
//   three heads a block) and writes each chunk's start state S into a
//   scratch as its hi and lo bf16 tiles, already in the 128-byte swizzled
//   layout the reverse kernel's `wgmma` reads: 16 KB a chunk and head,
//   0.47 GB at zamba2's training shape, written once and read once (the
//   chunk-start states that a P x N state a chunk costs either way).
// * Heads of one group share a block, and their db/dc are summed there.
//   The reverse kernel's block is two warpgroups, one head each, sharing
//   each chunk's b and c tiles; warpgroup 1 hands its fp32 db (then dc)
//   tile to warpgroup 0 through shared memory, which adds it to its own
//   and stores one fp32 partial a block (B, G * ceil(hpg / 2), L, N).  A
//   third kernel adds each group's partials in block order into db/dc in
//   the inputs' dtype.  The partials are half the per-head terms of a
//   CUDA-core kernel that sums outside the block: 0.47 GB written and read
//   at zamba2's shape (two heads a block is what fits: 220 KB of shared
//   memory).
// * TMA-fed chunks in a ring of two stages on mbarriers: x, dy, b and c by
//   TMA (128-byte swizzled 64 x 64 tiles, rows past L zero-filled; the
//   model's transposed views and strided b/c slices are read through their
//   strides), each head's S tiles by one bulk copy, completing on the same
//   barrier; the decays by `cp.async` a chunk ahead.  Chunk k - 1 loads
//   while chunk k computes.
// * Scratch at zamba2's training shape: 0.94 GB of states traffic and
//   0.94 GB of partials traffic beside the function's 0.73 GB, and x and b
//   read once more by the states kernel: ~2.8 GB, 0.85 ms at 3.35 TB/s.
//
// fp32 (`ssd_bwd_kernel`, then `ssd_bwd_group_sum_kernel`): the tensor
// cores take no full-precision fp32, so a CUDA-core kernel keeps exact
// fp32 arithmetic (tolerance 2e-3):
// * One block of 256 threads per (batch, head); every product gives each
//   thread a 4 x 4 tile of a 64 x 64 result, fp32 FMAs from operands in
//   shared memory.  Two passes over the chunks: forward, the chunk-start
//   states S (fp32, P x N) into the scratch (B, H, chunks, P, N); then in
//   reverse, carrying G in registers.  Eleven 64 x 64 fp32 tiles (the
//   chunk's x, dy, b and c in the layouts the products read, Gh, D, S and G
//   twice): 196 KB of shared memory, one block an SM.
// * Each block writes its head's db/dc terms into an fp32 scratch (B, H,
//   L, N), which the group-sum kernel adds in head order.

#include "hopper.cuh"

namespace {

constexpr int C = 64;          // steps per chunk
constexpr int P = 64;          // head dim
constexpr int N = 64;          // state dim

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
  float* db_part;              // (B,parts,L,N) fp32 partial sums of db
  float* dc_part;
  float* d_init;               // (B,H,P,N) fp32 or null
  void* ws;                    // chunk-start states, 16 KB a chunk and head
  long long x_sb, x_sh, x_sl;
  long long a_sb, a_sh, a_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long dy_sb, dy_sh, dy_sl;
  long long dx_sb, dx_sh, dx_sl;
  int B, H, G, L, heads_per_group, chunks;
  int Gb;                      // groups the b/c tensor maps hold (1 or G)
  int parts;                   // partials a batch row
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores, exact fp32
// ---------------------------------------------------------------------------

constexpr int NT = 256;        // threads: a 16 x 16 grid of 4 x 4 tiles
constexpr int LDS = 68;        // row stride (floats) of the 64-wide tiles
constexpr int TILE = 64 * LDS;
constexpr int NTILES = 11;
constexpr int NVEC = 8 * C + 8 * C + 16;   // vectors, column partials, misc
constexpr size_t kSmem = (size_t(NTILES) * TILE + NVEC) * sizeof(float);

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
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int nv, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int r = idx / 16, ch = idx % 16;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) v = ld4(src + r * rs + ch * 4);
    *reinterpret_cast<float4*>(dst + r * LDS + ch * 4) = v;
  }
}

// The same slab transposed (dst[k][r]); neighbouring threads take
// neighbouring rows, so the transposed stores do not conflict.
__device__ __forceinline__ void load_rows_t(float* dst, const float* src,
                                            long long rs, int nv, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int r = idx % 64, ch = idx / 64;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) v = ld4(src + r * rs + ch * 4);
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

  const float* xg = static_cast<const float*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
  const float* bg = static_cast<const float*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const float* cg = static_cast<const float*>(p.c) + bb * p.c_sb + g * p.c_sg;
  const float* yg =
      static_cast<const float*>(p.dy) + bb * p.dy_sb + h * p.dy_sh;
  float* dxg = static_cast<float*>(p.dx) + bb * p.dx_sb + h * p.dx_sh;
  const long long bh = static_cast<long long>(bb) * p.H + h;
  float* dag = p.da + bh * p.L;
  float* dbg = p.db_part + bh * p.L * N;
  float* dcg = p.dc_part + bh * p.L * N;
  float* ws = static_cast<float*>(p.ws) + bh * p.chunks * P * N;
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
    load_rows(Xr, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows(Br, bg + l0 * p.b_sl, p.b_sl, nv, tid);
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
    load_rows(Xr, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows_t(Xt, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows(Yr, yg + l0 * p.dy_sl, p.dy_sl, nv, tid);
    load_rows(Br, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows_t(Bt, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows(Cr, cg + l0 * p.c_sl, p.c_sl, nv, tid);
    load_rows(Ss, ws + kc * P * N, N, P, tid);
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
          const float t = i != j ? gv[jj] * pa[ii][jj] : 0.f;
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
          st4g<float>(dxg + (l0 + i) * p.dx_sl + c0,
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
      float col = 0.f;
      for (int w = 0; w < 8; ++w) col += ColP[w * C + i];
      float v = RowT[i] - col + CdC[i] - Udx[i];
      if (i == C - 1) {            // the gradient of the chunk's total A
        float gs = 0.f, us = 0.f;
        for (int w = 0; w < 8; ++w) gs += Red[w];
        for (int k = 0; k < C; ++k) us += Udx[k];
        v += dec * gs + us;
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

// ---------------------------------------------------------------------------
// Both dtypes: db / dc from the fp32 partials
// ---------------------------------------------------------------------------

// db / dc (B, G, L, N) in T: each group's fp32 partials (B, parts, L, N),
// parts / G a group, summed in order; four elements a thread.
template <typename T>
__global__ void ssd_bwd_group_sum_kernel(const float* db_p, const float* dc_p,
                                         T* db, T* dc, int B, int parts,
                                         int G, int L, long long db_sb,
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
  const int ppg = parts / G;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < ppg; ++k) {
    const long long off =
        ((static_cast<long long>(bb) * parts + g * ppg + k) * L + l) * N + n;
    const float4 vb = ld4(db_p + off), vc = ld4(dc_p + off);
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

// ds: db strides (b, g, l), then dc's
template <typename T>
cudaError_t launch_group_sum(const Params& p, T* db, T* dc,
                             const long long (&ds)[6], cudaStream_t stream) {
  const long long total = static_cast<long long>(p.B) * p.G * p.L * (N / 4);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  ssd_bwd_group_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                stream>>>(
      p.db_part, p.dc_part, db, dc, p.B, p.parts, p.G, p.L, ds[0], ds[1],
      ds[2], ds[3], ds[4], ds[5]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, split-bf16 operands
// ---------------------------------------------------------------------------

constexpr int NS = 2;                       // chunk stages in each ring
constexpr int STATE_BYTES = 2 * TILE64;     // a state as its hi and lo tiles

// Accumulator fragments (64 x 64 fp32, 32 a thread): row r or r + 8
// (r = 16 * warp + lane / 4), columns 8q + c2, 8q + c2 + 1 (c2 = 2 * (lane
// % 4)); element 4q + 2 * half + {0, 1}.  The byte offset of that pair in
// a 128-byte swizzled 64 x 64 bf16 tile:
__device__ __forceinline__ uint32_t pair_off(int row, int q, int c2) {
  return row * 128 + ((q ^ (row & 7)) << 4) + c2 * 2;
}

__device__ __forceinline__ float2 bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Inclusive scan of a chunk's 64 log decays by one warp (lane l holds steps
// 2l and 2l + 1): exp(A - acs), exp(A) and A, and with `all` acs and
// exp(acs); exponents clamped at 0.
__device__ __forceinline__ void decay_scan(float2 av, int lane, bool all,
                                           uint32_t acs, uint32_t ein,
                                           uint32_t wout, uint32_t misc) {
  float inc = av.x + av.y;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  const float tot = __shfl_sync(0xffffffffu, inc, 31);
  const float a0 = excl + av.x, a1 = inc;
  if (all) {
    sts_f2(acs + lane * 8, a0, a1);
    sts_f2(ein + lane * 8, __expf(fminf(a0, 0.f)), __expf(fminf(a1, 0.f)));
  }
  sts_f2(wout + lane * 8, __expf(fminf(tot - a0, 0.f)),
         __expf(fminf(tot - a1, 0.f)));
  if (lane == 0) sts_f2(misc, __expf(fminf(tot, 0.f)), tot);
}

// The decays of chunk k of one head into ring slot `slot` (one warp; lane l
// takes steps 2l and 2l + 1; steps past L read as 0).
__device__ __forceinline__ void fetch_decays(const Params& p, int bb, int h,
                                             int k, uint32_t slot, int lane) {
  const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int l = k * C + 2 * lane + e;
    cp_async4(slot + (2 * lane + e) * 4, l < p.L ? ag + l * p.a_sl : ag,
              l < p.L);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A state (P x N fp32 in accumulator fragments) as hi/lo bf16 into two
// 128-byte swizzled tiles: rows p, columns n.
__device__ __forceinline__ void split_state(const float (&s)[32], int r,
                                            int c2, uint32_t hi_tile,
                                            uint32_t lo_tile) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off = pair_off(r + 8 * half, q, c2);
      uint32_t hi, lo;
      split2(s[4 * q + 2 * half], s[4 * q + 2 * half + 1], hi, lo);
      sts_u32(hi_tile + off, hi);
      sts_u32(lo_tile + off, lo);
    }
}

// A swizzled bf16 tile (rows = steps) with each row scaled by the fp32
// vector `scale`, as hi/lo into two tiles at the same offsets.
__device__ __forceinline__ void split_scaled(uint32_t src, uint32_t scale,
                                             uint32_t hi_tile,
                                             uint32_t lo_tile, int tw) {
#pragma unroll 1
  for (int ch = tw; ch < C * 8; ch += 128) {
    const float s = lds_f(scale + (ch >> 3) * 4);
    uint32_t in[4], hi[4], lo[4];
    lds_v4(src + ch * 16, in);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = bf16x2(in[e]);
      split2(f.x * s, f.y * s, hi[e], lo[e]);
    }
    sts_v4(hi_tile + ch * 16, hi);
    sts_v4(lo_tile + ch * 16, lo);
  }
}

// -- the forward pass: chunk-start states -----------------------------------

constexpr int SNC = 3;                         // warpgroups (heads) a block
constexpr int S_THREADS = SNC * 128;
constexpr int S_STAGE = (SNC + 1) * TILE64;    // x of each head, b
constexpr int S_VEC = 3 * C + 4;               // w, exp(A) / A, a ring [2][C]
constexpr int S_SMEM = 1024 + NS * S_STAGE + SNC * STATE_BYTES + 16 * NS +
                       SNC * S_VEC * 4;

// One block: heads h0 .. h0 + SNC - 1 of group g, batch blockIdx.y.  Per
// chunk k: S (the state at its start) as hi/lo tiles to the scratch, then
// S = exp(A) S + (x o w)^T B as the forward kernel updates it.
__global__ void __launch_bounds__(S_THREADS, 1)
    ssd_bwd_states_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_b,
                          const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_buf = base + NS * S_STAGE;          // [SNC] hi, lo
  const uint32_t bar_full = s_buf + SNC * STATE_BYTES; // [NS] chunk landed
  const uint32_t bar_empty = bar_full + 8 * NS;        // [NS] chunk read

  const int nhb = (p.heads_per_group + SNC - 1) / SNC;
  const int g = blockIdx.x / nhb;
  const int h0 = g * p.heads_per_group + (blockIdx.x % nhb) * SNC;
  const int nact = min(SNC, (g + 1) * p.heads_per_group - h0);
  const int gb = p.Gb == 1 ? 0 : g;
  const int bb = blockIdx.y;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int nload = p.chunks - 1;       // the last chunk updates nothing kept

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * nact);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= nact) return;

  auto issue = [&](int k) {
    const int s = k % NS;
    const uint32_t st = base + s * S_STAGE, bar = bar_full + 8 * s;
    mbar_expect_tx(bar, (nact + 1) * TILE64);
    for (int i = 0; i < nact; ++i)
      tma_load_4d(st + i * TILE64, &tm_x, bar, 0, k * C, h0 + i, bb);
    tma_load_4d(st + SNC * TILE64, &tm_b, bar, 0, k * C, gb, bb);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&tm_x);
    prefetch_map(&tm_b);
    for (int k = 0; k < NS && k < nload; ++k) issue(k);
  }

  const int h = h0 + wg;
  const int r = warp * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const uint32_t buf_hi = s_buf + wg * STATE_BYTES, buf_lo = buf_hi + TILE64;
  const uint32_t wout = bar_empty + 8 * NS + wg * S_VEC * 4;
  const uint32_t misc = wout + C * 4, a_ring = misc + 16;
  const long long bh = static_cast<long long>(bb) * p.H + h;
  unsigned char* wsg =
      static_cast<unsigned char*>(p.ws) + bh * p.chunks * STATE_BYTES;

  float s[32];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (p.init)
        v = *reinterpret_cast<const float2*>(p.init + bh * P * N +
                                             (r + 8 * half) * N + 8 * q + c2);
      s[4 * q + 2 * half] = v.x;
      s[4 * q + 2 * half + 1] = v.y;
    }
  if (warp == 0 && nload > 0) fetch_decays(p, bb, h, 0, a_ring, lane);

  for (int k = 0;; ++k) {
    if (threadIdx.x == 0 && k >= 1 && k + NS - 1 < nload) {
      mbar_wait(bar_empty + 8 * ((k - 1) % NS), ((k - 1) / NS) & 1);
      issue(k + NS - 1);
    }
    // the start state of chunk k to the scratch, through the buffer (the
    // last update's wgmma has read it)
    bar_sync(1 + wg, 128);
    split_state(s, r, c2, buf_hi, buf_lo);
    bar_sync(1 + wg, 128);
    for (int i = tw; i < STATE_BYTES / 16; i += 128) {
      uint32_t v[4];
      lds_v4(buf_hi + i * 16, v);
      *reinterpret_cast<uint4*>(wsg + k * STATE_BYTES + i * 16) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (k == nload) break;
    const int st = k % NS;
    const uint32_t x_st = base + st * S_STAGE + wg * TILE64;
    const uint32_t b_st = base + st * S_STAGE + SNC * TILE64;
    bar_sync(1 + wg, 128);                 // the copy has read the buffer
    if (warp == 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      const float2 av = lds_f2(a_ring + ((k & 1) * C + 2 * lane) * 4);
      if (k + 1 < nload)
        fetch_decays(p, bb, h, k + 1, a_ring + ((k + 1) & 1) * C * 4, lane);
      decay_scan(av, lane, false, 0, 0, wout, misc);
    }
    mbar_wait(bar_full + 8 * st, (k / NS) & 1);
    bar_sync(1 + wg, 128);
    split_scaled(x_st, wout, buf_hi, buf_lo, tw);      // x o w, hi and lo
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    const float d = lds_f(misc);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= d;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<1, 1>(s, mnmajor(buf_hi, ks), mnmajor(b_st, ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<1, 1>(s, mnmajor(buf_lo, ks), mnmajor(b_st, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }
}

// -- the reverse pass ---------------------------------------------------------

constexpr int NCB = 2;                         // warpgroups (heads) a block
constexpr int B_THREADS = NCB * 128;
constexpr int HEAD_TILES = 4;                  // x, dy, S hi, S lo
constexpr int B_STAGE = (NCB * HEAD_TILES + 2) * TILE64;   // and b, c
constexpr int XCH = 64 * 64 * 4;               // an fp32 tile handed over
// per warpgroup: acs, exp(acs), exp(A - acs) [C]; exp(A), A [4]; a ring
// [2][C]; column sums of T by warp [4][C]; row sums of T, x . dx_inter,
// c . dc_inter [C]; <G, S> by warp [4]
constexpr int B_VEC = 3 * C + 4 + 2 * C + 4 * C + 3 * C + 4;
constexpr int B_SMEM = 1024 + NS * B_STAGE + NCB * STATE_BYTES + XCH +
                       16 * NS + NCB * B_VEC * 4;
constexpr int BAR_XFULL = 3, BAR_XEMPTY = 4;   // named barriers, both groups

// One block: heads h0, h0 + 1 of group g, batch blockIdx.y, the chunks in
// reverse.  Warpgroup w takes head h0 + w; the stages hold each head's x,
// dy and S tiles and the group's b and c.
__global__ void __launch_bounds__(B_THREADS, 1)
    ssd_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_dy,
                         const __grid_constant__ CUtensorMap tm_b,
                         const __grid_constant__ CUtensorMap tm_c,
                         const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_gbuf = base + NS * B_STAGE;          // [NCB] hi, lo
  const uint32_t s_xch = s_gbuf + NCB * STATE_BYTES;    // warpgroup 1 -> 0
  const uint32_t bar_full = s_xch + XCH;                // [NS] chunk landed
  const uint32_t bar_empty = bar_full + 8 * NS;         // [NS] chunk read

  const int nhb = (p.heads_per_group + NCB - 1) / NCB;
  const int g = blockIdx.x / nhb, hb = blockIdx.x % nhb;
  const int h0 = g * p.heads_per_group + hb * NCB;
  const int nact = min(NCB, (g + 1) * p.heads_per_group - h0);
  const int gb = p.Gb == 1 ? 0 : g;
  const int bb = blockIdx.y;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int nchunks = p.chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * nact);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= nact) return;

  // iteration it takes chunk nchunks - 1 - it into stage it % NS
  auto issue = [&](int it) {
    const int k = nchunks - 1 - it;
    const uint32_t st = base + (it % NS) * B_STAGE;
    const uint32_t bar = bar_full + 8 * (it % NS);
    mbar_expect_tx(bar, (nact * HEAD_TILES + 2) * TILE64);
    for (int i = 0; i < nact; ++i) {
      const uint32_t hs = st + i * HEAD_TILES * TILE64;
      tma_load_4d(hs, &tm_x, bar, 0, k * C, h0 + i, bb);
      tma_load_4d(hs + TILE64, &tm_dy, bar, 0, k * C, h0 + i, bb);
      bulk_load(hs + 2 * TILE64,
                static_cast<const unsigned char*>(p.ws) +
                    ((static_cast<long long>(bb) * p.H + h0 + i) * nchunks +
                     k) * STATE_BYTES,
                STATE_BYTES, bar);
    }
    tma_load_4d(st + NCB * HEAD_TILES * TILE64, &tm_b, bar, 0, k * C, gb, bb);
    tma_load_4d(st + (NCB * HEAD_TILES + 1) * TILE64, &tm_c, bar, 0, k * C,
                gb, bb);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&tm_x);
    prefetch_map(&tm_dy);
    prefetch_map(&tm_b);
    prefetch_map(&tm_c);
    for (int it = 0; it < NS && it < nchunks; ++it) issue(it);
  }

  const int h = h0 + wg;
  const int r = warp * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const uint32_t g_hi = s_gbuf + wg * STATE_BYTES, g_lo = g_hi + TILE64;
  const uint32_t acs = bar_empty + 8 * NS + wg * B_VEC * 4;
  const uint32_t ein = acs + C * 4, wv = ein + C * 4, misc = wv + C * 4;
  const uint32_t a_ring = misc + 16, colp = a_ring + 2 * C * 4;
  const uint32_t rowt = colp + 4 * C * 4, udx = rowt + C * 4;
  const uint32_t cdc = udx + C * 4, gsp = cdc + C * 4;
  const long long bh = static_cast<long long>(bb) * p.H + h;
  uint16_t* dxg = static_cast<uint16_t*>(p.dx) + bb * p.dx_sb + h * p.dx_sh;
  float* dag = p.da + bh * p.L;
  const long long part =
      (static_cast<long long>(bb) * p.parts + g * nhb + hb) * p.L * N;

  // G, the gradient of the current chunk's end state: rows p, columns n
  float gr[32];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (p.dstate)
        v = *reinterpret_cast<const float2*>(p.dstate + bh * P * N +
                                             (r + 8 * half) * N + 8 * q + c2);
      gr[4 * q + 2 * half] = v.x;
      gr[4 * q + 2 * half + 1] = v.y;
    }
  if (warp == 0) fetch_decays(p, bb, h, nchunks - 1, a_ring, lane);

  // db or dc of the block's heads, summed in head order (warpgroup 1's tile
  // through shared memory), stored as the block's fp32 partial.  `n_x`
  // counts the hand-overs so far: warpgroup 1 waits for warpgroup 0 to
  // have read the previous one, which does not signal after the last.
  int n_x = 0;
  auto store_sum = [&](float (&v)[32], float* dst, int l0, int nv) {
    if (nact > 1) {
      if (wg == 1) {
        if (n_x > 0) bar_sync(BAR_XEMPTY, B_THREADS);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           s_xch + (i * 128 + tw) * 16),
                       "f"(v[4 * i]), "f"(v[4 * i + 1]), "f"(v[4 * i + 2]),
                       "f"(v[4 * i + 3])
                       : "memory");
        bar_arrive(BAR_XFULL, B_THREADS);
        ++n_x;
        return;
      }
      bar_sync(BAR_XFULL, B_THREADS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float o[4];
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3])
                     : "r"(s_xch + (i * 128 + tw) * 16)
                     : "memory");
#pragma unroll
        for (int e = 0; e < 4; ++e) v[4 * i + e] += o[e];
      }
      if (++n_x < 2 * nchunks) bar_arrive(BAR_XEMPTY, B_THREADS);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r + 8 * half;
        if (i < nv)
          *reinterpret_cast<float2*>(dst + (l0 + i) * N + 8 * q + c2) =
              make_float2(v[4 * q + 2 * half], v[4 * q + 2 * half + 1]);
      }
  };

  for (int it = 0; it < nchunks; ++it) {
    const int k = nchunks - 1 - it, st = it % NS;
    const int l0 = k * C, nv = min(C, p.L - l0);
    const uint32_t hs = base + st * B_STAGE + wg * HEAD_TILES * TILE64;
    const uint32_t x_st = hs, dy_st = hs + TILE64;
    const uint32_t s_hi = hs + 2 * TILE64, s_lo = hs + 3 * TILE64;
    const uint32_t b_st = base + st * B_STAGE + NCB * HEAD_TILES * TILE64;
    const uint32_t c_st = b_st + TILE64;

    // refill the stage the last chunk used with the chunk NS - 1 ahead
    if (threadIdx.x == 0 && it >= 1 && it + NS - 1 < nchunks) {
      mbar_wait(bar_empty + 8 * ((it - 1) % NS), ((it - 1) / NS) & 1);
      issue(it + NS - 1);
    }

    // every read of the buffer and the vectors by the last chunk is done
    bar_sync(1 + wg, 128);
    if (warp == 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      const float2 av = lds_f2(a_ring + ((it & 1) * C + 2 * lane) * 4);
      if (it + 1 < nchunks)
        fetch_decays(p, bb, h, k - 1, a_ring + ((it + 1) & 1) * C * 4, lane);
      decay_scan(av, lane, true, acs, ein, wv, misc);
    }
    split_state(gr, r, c2, g_hi, g_lo);        // G as hi/lo: rows p, cols n
    fence_proxy_async();
    mbar_wait(bar_full + 8 * st, (it / NS) & 1);
    bar_sync(1 + wg, 128);

    // <G, S>, S from its hi and lo tiles
    {
      float gs = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t off = pair_off(r + 8 * half, q, c2);
          const float2 hi = bf16x2(lds_u32(s_hi + off));
          const float2 lo = bf16x2(lds_u32(s_lo + off));
          gs += gr[4 * q + 2 * half] * (hi.x + lo.x) +
                gr[4 * q + 2 * half + 1] * (hi.y + lo.y);
        }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        gs += __shfl_xor_sync(0xffffffffu, gs, m);
      if (lane == 0) sts_f(gsp + warp * 4, gs);
    }

    // B C^T and X dY^T (rows j, columns i)
    float qa[32], pa[32], acc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(qa, kmajor(b_st, ks), kmajor(c_st, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(pa, kmajor(x_st, ks), kmajor(dy_st, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(qa);
    fence_regs(pa);

    // B G^T, dx's carried term, run beside the fragments below
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(acc, kmajor(b_st, ks), kmajor(g_hi, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(acc, kmajor(b_st, ks), kmajor(g_lo, ks), 1);
    wgmma_commit();

    // Gh^T = (B C^T) o exp(acs_i - acs_j) and D^T = (X dY^T) o the same for
    // i >= j, as hi/lo A fragments (k-step q / 2 holds columns 16 (q / 2)
    // .. + 15); T = Gh^T o (X dY^T) for i > j summed by row (j) and by
    // column (i)
    uint32_t ghi[4][4], glo[4][4], dhi[4][4], dlo[4][4];
    {
      const float aj[2] = {lds_f(acs + r * 4), lds_f(acs + (r + 8) * 4)};
      float rows[2] = {0.f, 0.f}, cols[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = 8 * q + c2;
        const float2 ai = lds_f2(acs + i * 4);
        float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = r + 8 * half, x = 4 * q + 2 * half;
          const float s0 = ai.x - aj[half], s1 = ai.y - aj[half];
          const float e0 = i >= j ? __expf(fminf(s0, 0.f)) : 0.f;
          const float e1 = i + 1 >= j ? __expf(fminf(s1, 0.f)) : 0.f;
          const float g0 = qa[x] * e0, g1 = qa[x + 1] * e1;
          const float t0 = i > j ? g0 * pa[x] : 0.f;
          const float t1 = i + 1 > j ? g1 * pa[x + 1] : 0.f;
          rows[half] += t0 + t1;
          cs0 += t0;
          cs1 += t1;
          const int fq = q >> 1, fr = (q & 1) * 2 + half;
          split2(g0, g1, ghi[fq][fr], glo[fq][fr]);
          split2(pa[x] * e0, pa[x + 1] * e1, dhi[fq][fr], dlo[fq][fr]);
        }
        cols[2 * q] = cs0;
        cols[2 * q + 1] = cs1;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(rows[half]);
        if ((lane & 3) == 0) sts_f(rowt + (r + 8 * half) * 4, v);
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        float v = cols[m];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4)
          sts_f(colp + (warp * C + 8 * (m >> 1) + c2 + (m & 1)) * 4, v);
      }
    }

    // dx's carried term times exp(A - acs_j); x_j . (that) for da
    wgmma_wait<0>();
    fence_regs(acc);
    {
      const float w[2] = {lds_f(wv + r * 4), lds_f(wv + (r + 8) * 4)};
      float u[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * q + 2 * half;
          const float2 xv = bf16x2(lds_u32(x_st + pair_off(r + 8 * half, q,
                                                           c2)));
          acc[x] *= w[half];
          acc[x + 1] *= w[half];
          u[half] += xv.x * acc[x] + xv.y * acc[x + 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(u[half]);
        if ((lane & 3) == 0) sts_f(udx + (r + 8 * half) * 4, v);
      }
    }

    // dx += Gh^T dY (dY read MN-major).  (Each group of products below is
    // waited for before the next is issued where two would hold more than
    // 128 accumulator and fragment registers beside G: the kernel runs at
    // the 255-register limit.)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc, ghi[ks], mnmajor(dy_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc, glo[ks], mnmajor(dy_st, ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r + 8 * half;
        if (i < nv)
          *reinterpret_cast<uint32_t*>(dxg + (l0 + i) * p.dx_sl + 8 * q +
                                       c2) =
              pack_bf16(acc[4 * q + 2 * half], acc[4 * q + 2 * half + 1]);
      }

    // db's carried term X G (G read MN-major), times exp(A - acs_j)
    float acc2[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 1>(acc2, kmajor(x_st, ks), mnmajor(g_hi, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 1>(acc2, kmajor(x_st, ks), mnmajor(g_lo, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc2);
    {
      const float w0 = lds_f(wv + r * 4), w1 = lds_f(wv + (r + 8) * 4);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[i] *= (i & 2) ? w1 : w0;
    }

    // db += D^T C; dY X^T (rows i), for D
    float pd[32];
    fence_regs(acc2);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc2, dhi[ks], mnmajor(c_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc2, dlo[ks], mnmajor(c_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(pd, kmajor(dy_st, ks), kmajor(x_st, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc2);
    fence_regs(pd);

    // dc's carried term dY S (S read MN-major), run beside D's fragments
    // and db's sum over the block
    float acc3[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 1>(acc3, kmajor(dy_st, ks), mnmajor(s_hi, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 1>(acc3, kmajor(dy_st, ks), mnmajor(s_lo, ks), 1);
    wgmma_commit();

    // D = (dY X^T) o exp(acs_i - acs_j) for j <= i (rows i) as hi/lo A
    // fragments
    {
      const float ai[2] = {lds_f(acs + r * 4), lds_f(acs + (r + 8) * 4)};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = 8 * q + c2;
        const float2 aj = lds_f2(acs + j * 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r + 8 * half, x = 4 * q + 2 * half;
          const float e0 = i >= j ? __expf(fminf(ai[half] - aj.x, 0.f)) : 0.f;
          const float e1 =
              i >= j + 1 ? __expf(fminf(ai[half] - aj.y, 0.f)) : 0.f;
          split2(pd[x] * e0, pd[x + 1] * e1, ghi[q >> 1][(q & 1) * 2 + half],
                 glo[q >> 1][(q & 1) * 2 + half]);
        }
      }
    }
    store_sum(acc2, p.db_part + part, l0, nv);
    wgmma_wait<0>();
    fence_regs(acc3);

    // dc's carried term times exp(acs_i); c_i . (that) for da
    {
      const float e[2] = {lds_f(ein + r * 4), lds_f(ein + (r + 8) * 4)};
      float u[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * q + 2 * half;
          const float2 cv = bf16x2(lds_u32(c_st + pair_off(r + 8 * half, q,
                                                           c2)));
          acc3[x] *= e[half];
          acc3[x + 1] *= e[half];
          u[half] += cv.x * acc3[x] + cv.y * acc3[x + 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(u[half]);
        if ((lane & 3) == 0) sts_f(cdc + (r + 8 * half) * 4, v);
      }
    }

    // dY o exp(acs) as hi/lo into the buffer (B G^T and X G have read G)
    split_scaled(dy_st, ein, g_hi, g_lo, tw);
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    // dc += D B (b read MN-major); G = exp(A) G + (dY o exp(acs))^T C
    {
      const float d = lds_f(misc);
#pragma unroll
      for (int i = 0; i < 32; ++i) gr[i] *= d;
    }
    fence_regs(acc3);
    fence_regs(gr);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc3, ghi[ks], mnmajor(b_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64(acc3, glo[ks], mnmajor(b_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<1, 1>(gr, mnmajor(g_hi, ks), mnmajor(c_st, ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<1, 1>(gr, mnmajor(g_lo, ks), mnmajor(c_st, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc3);
    fence_regs(gr);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // this warp read it
    store_sum(acc3, p.dc_part + part, l0, nv);

    // the gradient of acs, then da as its reverse cumulative sum (warp 0;
    // lane l takes steps 2l and 2l + 1)
    bar_sync(1 + wg, 128);
    if (warp == 0) {
      const float em = lds_f(misc);             // exp(A)
      float gs = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) gs += lds_f(gsp + w * 4);
      float dv[2], us = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        float col = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) col += lds_f(colp + (w * C + i) * 4);
        const float ud = lds_f(udx + i * 4);
        dv[e] = col - lds_f(rowt + i * 4) + lds_f(cdc + i * 4) - ud;
        us += ud;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        us += __shfl_xor_sync(0xffffffffu, us, o);
      if (lane == 31) dv[1] += em * gs + us;
      const float pair = dv[0] + dv[1];
      float suf = pair;                         // steps 2l .. 63
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += t;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float d1 = after + dv[1], d0 = d1 + dv[0];
      if (2 * lane < nv) dag[l0 + 2 * lane] = d0;
      if (2 * lane + 1 < nv) dag[l0 + 2 * lane + 1] = d1;
    }
  }

  if (p.d_init) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(p.d_init + bh * P * N +
                                   (r + 8 * half) * N + 8 * q + c2) =
            make_float2(gr[4 * q + 2 * half], gr[4 * q + 2 * half + 1]);
  }
}

cudaError_t launch_bf16(const Params& p, __nv_bfloat16* db, __nv_bfloat16* dc,
                        const long long (&ds)[6], cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tdy, tb, tc;
  if ((err = tensor_map_4d(&tx, encode, p.x, P, p.L, p.H, p.B, p.x_sl,
                           p.x_sh, p.x_sb, C)) ||
      (err = tensor_map_4d(&tdy, encode, p.dy, P, p.L, p.H, p.B, p.dy_sl,
                           p.dy_sh, p.dy_sb, C)) ||
      (err = tensor_map_4d(&tb, encode, p.b, N, p.L, p.Gb, p.B, p.b_sl,
                           p.b_sg, p.b_sb, C)) ||
      (err = tensor_map_4d(&tc, encode, p.c, N, p.L, p.Gb, p.B, p.c_sl,
                           p.c_sg, p.c_sb, C)))
    return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_states_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  S_SMEM)) ||
      (err = cudaFuncSetAttribute(ssd_bwd_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  B_SMEM)))
    return err;
  const int hpg = p.heads_per_group;
  ssd_bwd_states_kernel<<<dim3(p.G * ((hpg + SNC - 1) / SNC), p.B),
                          S_THREADS, S_SMEM, stream>>>(tx, tb, p);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_wgmma_kernel<<<dim3(p.G * ((hpg + NCB - 1) / NCB), p.B),
                         B_THREADS, B_SMEM, stream>>>(tx, tdy, tb, tc, p);
  if ((err = cudaGetLastError())) return err;
  return launch_group_sum(p, db, dc, ds, stream);
}

cudaError_t launch_f32(const Params& p, float* db, float* dc,
                       const long long (&ds)[6], cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmem));
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<<<dim3(p.H, p.B), NT, kSmem, stream>>>(p);
  if ((err = cudaGetLastError())) return err;
  return launch_group_sum(p, db, dc, ds, stream);
}

}  // namespace

// The fp32 db/dc partials a batch row that repro_ssd_scan_bwd writes for
// dtype (0 = float32, 1 = bfloat16), H heads and G groups, so the caller
// sizes its scratch (B, parts, L, N) twice: one a head in fp32, one a
// block of NCB heads of a group in bf16.  -1 for an unknown dtype or
// H % G != 0.
extern "C" int repro_ssd_bwd_partials(int dtype, int H, int G) {
  if (H <= 0 || G <= 0 || H % G != 0 || (dtype != 0 && dtype != 1))
    return -1;
  return dtype == 0 ? H : G * ((H / G + NCB - 1) / NCB);
}

// dtype (of x, b, c, dy, dx, db and dc): 0 = float32, 1 = bfloat16; a, da,
// init, dstate, d_init and the partials are float32.  Strides are in
// elements: x, dy, dx (b, h, l), a (b, h, l), b/c and db/dc (b, g, l); the
// last dim of every tensor is contiguous.  fp32: row strides a multiple of
// 4.  bf16: x, dy, b and c are read through TMA maps (strides a multiple of
// 8 elements, none 0, 16-byte aligned), b/c as `bc_groups` groups (1: every
// group reads group 0's b/c, as a zero group stride broadcasts it; or G).
// da is contiguous (B, H, L); init, dstate, d_init contiguous (B, H, P, N);
// init, dstate and d_init may be null.  Scratch: ws, ceil(L/64) * 16 KB a
// (batch, head); db_part / dc_part (B, parts, L, N) fp32, parts as
// repro_ssd_bwd_partials gives it.  Returns a cudaError_t.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* a, const void* b, const void* c,
    const void* dy, const void* init, const void* dstate, void* dx, void* da,
    void* db, void* dc, void* d_init, void* ws, void* db_part, void* dc_part,
    int dtype, int B, int H, int G, int L, int bc_groups,
    long long x_sb, long long x_sh, long long x_sl, long long a_sb,
    long long a_sh, long long a_sl, long long b_sb, long long b_sg,
    long long b_sl, long long c_sb, long long c_sg, long long c_sl,
    long long dy_sb, long long dy_sh, long long dy_sl, long long dx_sb,
    long long dx_sh, long long dx_sl, long long db_sb, long long db_sg,
    long long db_sl, long long dc_sb, long long dc_sg, long long dc_sl,
    void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || L <= 0 || H % G != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  const int parts = repro_ssd_bwd_partials(dtype, H, G);
  if (parts < 0 || (dtype == 1 && bc_groups != 1 && bc_groups != G))
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
  p.db_part = static_cast<float*>(db_part);
  p.dc_part = static_cast<float*>(dc_part);
  p.d_init = static_cast<float*>(d_init);
  p.ws = ws;
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
  p.Gb = bc_groups;
  p.parts = parts;
  const long long ds[6] = {db_sb, db_sg, db_sl, dc_sb, dc_sg, dc_sl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch_bf16(p, static_cast<__nv_bfloat16*>(db),
                           static_cast<__nv_bfloat16*>(dc), ds, st));
  if (dtype == 0)
    return int(launch_f32(p, static_cast<float*>(db), static_cast<float*>(dc),
                          ds, st));
  return int(cudaErrorInvalidValue);
}
