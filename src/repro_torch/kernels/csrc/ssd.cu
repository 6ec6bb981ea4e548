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
// h / (H / G): a broadcast costs no copy).  The state is fp32, carried
// across a sequential chunk loop inside the block, P = N = 64.
//
// Where it differs from the Pallas kernel, and why:
// * It writes the final state, (B,H,P,N) fp32 as the model keeps it: the
//   serving path hands the prefill's state to decode.
// * It takes any L.  Steps past L in the last chunk are masked: their x, b,
//   c and a are zero, so they add nothing to y or the state and do not
//   decay it, and their y is not stored.
// * The chunk is this kernel's tile choice (64 steps), not the caller's;
//   the result does not depend on it beyond rounding.
// * Every exponent is clamped at 0 (the reference's invariant that every
//   exp argument is <= 0), so a cumulative sum that is not monotone by an
//   ulp cannot overflow.
//
// What bounds it on the H100: the four chunk products do
// 2*C*(N+P) + 4*N*P = 32768 operations per step against ~260 bytes moved
// per step in bf16 (x and y of one head, b/c shared by the heads, a).  On
// the bf16 tensor cores that is below the balance point (~295 operations a
// byte), so bf16 is bound by bytes: 0.0726 ms at zamba2's served shape
// (B=8, L=910, H=112, one group).  fp32 runs on the CUDA cores, where the
// same work is bound by operations.
//
// bf16 (`ssd_wgmma_kernel`), what the design does about it:
// * Tensor cores with split operands.  Per chunk and head, G = C B^T comes
//   from the bf16 inputs in one m64n64k64 `wgmma` product (exact products,
//   fp32 sums).  The other three products each have an fp32 operand -- the
//   masked, decayed G_h = G o exp(acs_i - acs_j) [i >= j], the chunk-start
//   state S, and x o w with w_j = exp(a_total - acs_j) -- and rounding that
//   operand once to bf16 fails the bf16 check (2e-2 against the sequential
//   recurrence) at the served length.  Each is split into hi = bf16(v) and
//   lo = bf16(v - hi) and run as two products into one fp32 accumulator:
//   7 passes of 64 x 64 x 64 a chunk where the function needs 4, ~0.05 ms
//   of tensor-core time at the served shape, under the bytes bound.
// * The state lives in `wgmma` accumulator registers (fp32, P x N, the
//   model's layout, so `init` loads into it and the final state stores out
//   of it) for the whole chunk loop.  Once a chunk its hi/lo parts go to
//   shared memory as the K-major B operand of y = C S^T; the rows of that
//   product are scaled by exp(acs_i) in registers, and G_h x accumulates
//   into the same registers with G_h's hi/lo parts as the register A
//   operand (no shared memory).  The update S = exp(a_total) S +
//   (x o w)^T B reads x o w (written as hi/lo into the buffer that held S)
//   and b transposed from shared memory: `wgmma` reads bf16 operands in
//   either major order, so nothing is transposed by hand.
// * Heads of one group share b and c.  A block of three warpgroups takes
//   three heads of one (batch, group); each chunk's b and c tiles are
//   loaded once for all three.  Each warpgroup computes its own C B^T (one
//   pass of its seven: sharing it would move 16 KB of fp32 through shared
//   memory a chunk).  One block an SM (133 KB of shared memory, 168
//   registers a thread, no spills): zamba2's 896 (batch, head) items run
//   as 304 blocks (38 a batch, the last with one head) in 2.3 waves.  Two
//   blocks of two warpgroups an SM ran ~10% faster but need <= 128
//   registers, where ptxas spills.
// * TMA-fed chunks.  x, b and c arrive by TMA (128-byte swizzled 64 x 64
//   tiles, rows past L zero-filled) into a ring of two chunk stages, each
//   completed on an mbarrier; one thread refills the stage the last chunk
//   used as soon as every warpgroup has released it, so chunk k + 1 loads
//   while chunk k computes.  The decays are fp32 with stride H along L in
//   the served layout and come by `cp.async`, a chunk ahead.
// * Cumulative decays by a warp scan (5 shuffle steps) instead of a serial
//   loop; exponents clamped at 0 as above.
//
// fp32 (`ssd_f32_kernel`): the tensor cores take no full-precision fp32,
// so a CUDA-core kernel keeps exact fp32 arithmetic (tolerance 2e-3): one
// block of 256 threads per (batch, head), 2 blocks per SM.  Each chunk is
// staged in shared memory (x row-major; b and c transposed so a thread's
// four rows are one 16-byte load), and every product gives each thread a
// 4 x 4 tile of a 64 x 64 result.  The within-chunk product skips the key
// steps past the thread's last row (causal).  The cumulative sums are taken
// sequentially in one order by every thread that needs them, so acs is
// monotone.  The state lives in registers (a 4 x 4 tile per thread) and is
// copied to shared memory once per chunk for the C S product.

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
  const float* init;           // (B,H,P,N) fp32 or null
  void* y;
  float* state;                // (B,H,P,N) fp32
  long long x_sb, x_sh, x_sl;
  long long a_sb, a_sh, a_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long y_sb, y_sh, y_sl;
  int B, H, G, L, heads_per_group;
};

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, split-bf16 operands
// ---------------------------------------------------------------------------

constexpr int NC = 3;                      // warpgroups (heads) per block
constexpr int NS = 2;                      // chunk stages in the ring
constexpr int WG_THREADS = NC * 128;
constexpr int TILE = C * 128;              // one 64 x 64 bf16 tile, bytes
constexpr int STAGE = (NC + 2) * TILE;     // x of each head, b, c
constexpr int BUF = 2 * TILE;              // a warpgroup's hi/lo operand
constexpr int VEC = 5 * C + 4;             // acs, exp(acs), w, exp(a_total),
                                           // a of two chunks
constexpr int WG_SMEM = 1024 + NS * STAGE + NC * BUF + 16 * NS +
                        NC * VEC * 4;

// One block: heads h0 .. h0 + NC - 1 of group g, batch blockIdx.y;
// warpgroup w takes head h0 + w (a warpgroup past the group's last head
// leaves at once).  Accumulator fragments (64 x 64 fp32, 32 a thread): row
// r or r + 8 (r = 16 * warp + lane / 4), columns 8q + c2, 8q + c2 + 1
// (c2 = 2 * (lane % 4)); element 4q + 2 * half + {0, 1}.
__global__ void __launch_bounds__(WG_THREADS, 1)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_buf = base + NS * STAGE;            // [NC] hi, lo
  const uint32_t bar_full = s_buf + NC * BUF;          // [NS] chunk landed
  const uint32_t bar_empty = bar_full + 8 * NS;        // [NS] chunk read

  const int nhb = (p.heads_per_group + NC - 1) / NC;
  const int g = blockIdx.x / nhb;
  const int h0 = g * p.heads_per_group + (blockIdx.x % nhb) * NC;
  const int nact = min(NC, (g + 1) * p.heads_per_group - h0);
  const int bb = blockIdx.y;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int nchunks = (p.L + C - 1) / C;

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

  // chunk k into stage k % NS: x of each live head, b and c (one thread)
  auto issue = [&](int k) {
    const int s = k % NS;
    const uint32_t st = base + s * STAGE, bar = bar_full + 8 * s;
    mbar_expect_tx(bar, (nact + 2) * TILE);
    for (int i = 0; i < nact; ++i)
      tma_load_4d(st + i * TILE, &tm_x, bar, 0, k * C, h0 + i, bb);
    tma_load_4d(st + NC * TILE, &tm_b, bar, 0, k * C, g, bb);
    tma_load_4d(st + (NC + 1) * TILE, &tm_c, bar, 0, k * C, g, bb);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&tm_x);
    prefetch_map(&tm_b);
    prefetch_map(&tm_c);
    for (int k = 0; k < NS && k < nchunks; ++k) issue(k);
  }

  const int h = h0 + wg;
  const int r = warp * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const uint32_t buf_hi = s_buf + wg * BUF, buf_lo = buf_hi + TILE;
  // fp32 vectors of the chunk: acs, exp(acs_i), exp(a_total - acs_j),
  // exp(a_total)
  const uint32_t acs = bar_empty + 8 * NS + wg * VEC * 4;
  const uint32_t ein = acs + C * 4, wout = ein + C * 4, dec = wout + C * 4;
  const uint32_t a_ring = dec + 16;                    // [2][C] log decays

  // the state, S[p][n] (rows p, columns n)
  float s[32];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (p.init)
        v = *reinterpret_cast<const float2*>(
            p.init + (static_cast<long long>(bb) * p.H + h) * P * N +
            (r + 8 * half) * N + 8 * q + c2);
      s[4 * q + 2 * half] = v.x;
      s[4 * q + 2 * half + 1] = v.y;
    }

  // this head's decays of chunk k into ring slot k % 2 (warp 0; lane l
  // takes steps 2l and 2l + 1; steps past L read as 0)
  auto fetch_a = [&](int k) {
    const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = k * C + 2 * lane + e;
      cp_async4(a_ring + ((k & 1) * C + 2 * lane + e) * 4,
                l < p.L ? ag + l * p.a_sl : ag, l < p.L);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (warp == 0) fetch_a(0);

  for (int k = 0; k < nchunks; ++k) {
    const int st = k % NS;
    const uint32_t ph = (k / NS) & 1;
    const int l0 = k * C, nv = min(C, p.L - l0);
    const uint32_t x_st = base + st * STAGE + wg * TILE;
    const uint32_t b_st = base + st * STAGE + NC * TILE;
    const uint32_t c_st = b_st + TILE;

    // refill the stage chunk k - 1 used with chunk k + NS - 1
    if (threadIdx.x == 0 && k >= 1 && k + NS - 1 < nchunks) {
      mbar_wait(bar_empty + 8 * ((k - 1) % NS), ((k - 1) / NS) & 1);
      issue(k + NS - 1);
    }

    // every read of the buffer and the decays by the last chunk is done
    bar_sync(1 + wg, 128);
    if (warp == 0) {
      // inclusive scan of the chunk's log decays
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      const float2 av = lds_f2(a_ring + ((k & 1) * C + 2 * lane) * 4);
      if (k + 1 < nchunks) fetch_a(k + 1);
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
      sts_f2(acs + lane * 8, a0, a1);
      sts_f2(ein + lane * 8, __expf(fminf(a0, 0.f)), __expf(fminf(a1, 0.f)));
      sts_f2(wout + lane * 8, __expf(fminf(tot - a0, 0.f)),
             __expf(fminf(tot - a1, 0.f)));
      if (lane == 0) sts_f2(dec, __expf(fminf(tot, 0.f)), 0.f);
    }
    // S as hi/lo bf16 into the buffer: row p, columns n, 128-byte swizzle
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r + 8 * half;
        const int off = row * 128 + ((q ^ (row & 7)) << 4) + c2 * 2;
        uint32_t hi, lo;
        split2(s[4 * q + 2 * half], s[4 * q + 2 * half + 1], hi, lo);
        sts_u32(buf_hi + off, hi);
        sts_u32(buf_lo + off, lo);
      }
    fence_proxy_async();
    mbar_wait(bar_full + 8 * st, ph);
    bar_sync(1 + wg, 128);

    // G = C B^T (bf16 inputs, one pass)
    float gacc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(gacc, kmajor(c_st, ks), kmajor(b_st, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gacc);

    // G_h = G o exp(acs_i - acs_j) for j <= i as hi/lo A fragments (k-step
    // q / 2 holds columns 16 (q / 2) .. + 15)
    uint32_t ghi[4][4], glo[4][4];
    {
      const float ai[2] = {lds_f(acs + r * 4), lds_f(acs + (r + 8) * 4)};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = 8 * q + c2;
        const float2 aj = lds_f2(acs + j * 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r + 8 * half;
          const float v0 = gacc[4 * q + 2 * half] *
                           __expf(fminf(ai[half] - aj.x, 0.f)) *
                           (i >= j ? 1.f : 0.f);
          const float v1 = gacc[4 * q + 2 * half + 1] *
                           __expf(fminf(ai[half] - aj.y, 0.f)) *
                           (i >= j + 1 ? 1.f : 0.f);
          split2(v0, v1, ghi[q >> 1][(q & 1) * 2 + half],
                 glo[q >> 1][(q & 1) * 2 + half]);
        }
      }
    }

    // y = C S_hi^T + C S_lo^T, rows times exp(acs_i)
    float y[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(y, kmajor(c_st, ks), kmajor(buf_hi, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(y, kmajor(c_st, ks), kmajor(buf_lo, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    {
      const float e0 = lds_f(ein + r * 4), e1 = lds_f(ein + (r + 8) * 4);
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] *= (i & 2) ? e1 : e0;
    }

    // y += G_h x, x (steps x P) read as an MN-major B
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs_n64(y, ghi[ks], mnmajor(x_st, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs_n64(y, glo[ks], mnmajor(x_st, ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    uint16_t* yg = static_cast<uint16_t*>(p.y) + bb * p.y_sb + h * p.y_sh;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r + 8 * half;
        if (i < nv)
          *reinterpret_cast<uint32_t*>(yg + (l0 + i) * p.y_sl + 8 * q + c2) =
              pack_bf16(y[4 * q + 2 * half], y[4 * q + 2 * half + 1]);
      }

    // x o w as hi/lo into the buffer (C S^T has read it): same swizzled
    // offsets as the x tile, rows scaled by w_j
#pragma unroll 1
    for (int ch = tw; ch < C * 8; ch += 128) {
      const float wj = lds_f(wout + (ch >> 3) * 4);
      uint32_t in[4], hi[4], lo[4];
      lds_v4(x_st + ch * 16, in);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        split2(f.x * wj, f.y * wj, hi[e], lo[e]);
      }
      sts_v4(buf_hi + ch * 16, hi);
      sts_v4(buf_lo + ch * 16, lo);
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    // S = exp(a_total) S + (x o w)^T B: A = (x o w) and B = b, both
    // MN-major (steps down the rows)
    const float d = lds_f(dec);
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

  float* sg = p.state + (static_cast<long long>(bb) * p.H + h) * P * N;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(sg + (r + 8 * half) * N + 8 * q + c2) =
          make_float2(s[4 * q + 2 * half], s[4 * q + 2 * half + 1]);
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tb, tc;
  if ((err = tensor_map_4d(&tx, encode, p.x, P, p.L, p.H, p.B, p.x_sl,
                           p.x_sh, p.x_sb, C)) ||
      (err = tensor_map_4d(&tb, encode, p.b, N, p.L, p.G, p.B, p.b_sl,
                           p.b_sg, p.b_sb, C)) ||
      (err = tensor_map_4d(&tc, encode, p.c, N, p.L, p.G, p.B, p.c_sl,
                           p.c_sg, p.c_sb, C)))
    return err;
  err = cudaFuncSetAttribute(ssd_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.G * ((p.heads_per_group + NC - 1) / NC), p.B);
  ssd_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(tx, tb, tc, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, exact fp32
// ---------------------------------------------------------------------------

constexpr int NT = 256;        // threads per block: a 16 x 16 grid of 4 x 4 tiles
constexpr int LDS = 68;        // row stride (floats) of the 64-wide tiles

// Rows [0, 64) of a (rows, 64) slab (row stride rs elements) into shared
// memory; rows >= nv become zeros.  Row-major (dst[r][k]) with
// neighbouring threads on neighbouring 16-byte pieces of a row, so the
// global loads coalesce.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int nv, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int r = idx / 16, ch = idx % 16;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) v = *reinterpret_cast<const float4*>(src + r * rs + ch * 4);
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
    if (r < nv) v = *reinterpret_cast<const float4*>(src + r * rs + ch * 4);
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(NT, 2) ssd_f32_kernel(Params p) {
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

  const float* xg = static_cast<const float*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const float* ag = p.a + bb * p.a_sb + h * p.a_sh;
  const float* bg = static_cast<const float*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const float* cg = static_cast<const float*>(p.c) + bb * p.c_sb + g * p.c_sg;
  float* yg = static_cast<float*>(p.y) + bb * p.y_sb + h * p.y_sh;
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
    load_rows(Xs, xg + l0 * p.x_sl, p.x_sl, nv, tid);
    load_rows_t(Bt, bg + l0 * p.b_sl, p.b_sl, nv, tid);
    load_rows_t(Ct, cg + l0 * p.c_sl, p.c_sl, nv, tid);
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
          float4 out;
          out.x = fmaf(e, yo[ii][0], yd[ii][0]);
          out.y = fmaf(e, yo[ii][1], yd[ii][1]);
          out.z = fmaf(e, yo[ii][2], yd[ii][2]);
          out.w = fmaf(e, yo[ii][3], yd[ii][3]);
          *reinterpret_cast<float4*>(yg + (l0 + i) * p.y_sl + c0) = out;
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

constexpr size_t kSmemF32 = (size_t(5) * 64 * LDS + 4 * C + 4) * sizeof(float);

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmemF32));
  if (err != cudaSuccess) return err;
  ssd_f32_kernel<<<dim3(p.H, p.B), NT, kSmemF32, stream>>>(p);
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
  p.B = B;
  p.H = H;
  p.G = G;
  p.L = L;
  p.heads_per_group = H / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return int(launch_bf16(p, st));
  if (dtype == 0) return int(launch_f32(p, st));
  return int(cudaErrorInvalidValue);
}
