// Flash attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, the Pallas kernel
// `_attn_kernel` behind `flash_attention` (pallas_call at line 114).
//
// What it computes: blocked online-softmax GQA attention.  q (B,H,S,D),
// k/v (B,KV,S,D), head h reads kv head h / (H/KV); scale 1/sqrt(D); fp32
// running max m, sum l and accumulator acc; causal and sliding-window masks
// as the Pallas kernel (k <= q, k > q - window); masked scores are
// NEG_INF = -2^30; KV tiles that the masks leave empty are skipped; the
// result is acc / max(l, 1e-30) cast to q's dtype.  Unlike the Pallas
// kernel it masks the ragged edge (keys >= S, no store of rows >= S), so
// any S works.  Tensors are addressed through (b, h, s) strides with the
// head dim contiguous, so the model's (B,S,H,D) activations need no copy.
//
// What bounds it on the H100: at the prefill shapes (S ~ 1k, D = 128) the
// two matrix products do ~S/2 multiply-adds per byte moved, far above the
// card's ~295 flop/byte balance point: the kernel is bound by operations,
// i.e. by how close it comes to the tensor cores' rate.
//
// What the design does about it:
// * bf16: each of 4 warps owns 16 query rows of a 64-row tile and runs
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) for S = Q K^T and for
//   O += P V.  Q stays in registers as A fragments for the whole KV loop;
//   the S accumulator fragment is re-packed in registers as the A fragment
//   of P (no shared-memory round trip); the 64-key K and V tiles are staged
//   in shared memory as bf16 with a padded row (D + 8 elements) so the
//   fragment loads are free of bank conflicts (D = 64, 112 and 128).  P is rounded to bf16 for
//   the PV product (the Pallas kernel keeps it fp32); the error stays far
//   inside the bf16 tolerance of 2e-2.
// * fp32: the tensor cores take no full-precision fp32, so a CUDA-core
//   kernel keeps exact fp32 arithmetic (tolerance 2e-5): 128 threads, each
//   owning a 4 x 8 block of the 64 x 64 score tile and 4 rows of the
//   output (columns 32j + 4tx .. +3, the last group cut at D when D is not
//   a multiple of 32, as for D = 112), with Q and K transposed in shared
//   memory for 16-byte loads.
// * Both keep the scores in the log2 domain (scale * log2(e), exp2f).
// Not yet: cp.async/TMA double buffering and wgmma (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1073741824.0f;   // -2^30, as the reference
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int H, KV, S;
  int causal, window;
  float scale_log2;   // log2(e) / sqrt(D)
};

__device__ __forceinline__ bool key_ok(int row, int col, const Params& p) {
  bool ok = col < p.S;
  if (p.causal) ok = ok && col <= row;
  if (p.window) ok = ok && col > row - p.window;
  return ok;
}

// Block-level skip, as the Pallas kernel's `live` test.
__device__ __forceinline__ bool tile_live(int q0, int k0, const Params& p) {
  bool live = true;
  if (p.causal) live = live && (k0 <= q0 + BQ - 1);
  if (p.window) live = live && (k0 + BK - 1 > q0 - p.window);
  return live;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) of a (S, D) bf16 slab into shared memory
// (row stride LD), 16 bytes per thread and step; rows >= S become zeros.
template <int D>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src,
                                               long long row_stride, int row0,
                                               int S, int tid) {
  constexpr int LD = D + 8;
  constexpr int NCH = D / 8;
  for (int c = tid; c < 64 * NCH; c += NTHREADS) {
    const int r = c / NCH, ch = c % NCH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride +
                                            ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;   // k-steps of Q K^T
  constexpr int ND = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Ks = Qs + BQ * LD;
  uint16_t* Vs = Ks + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const uint16_t* qg = static_cast<const uint16_t*>(p.q) + b * p.qs.b +
                       h * p.qs.h;
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) + b * p.ks.b +
                       kvh * p.ks.h;
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) + b * p.vs.b +
                       kvh * p.vs.h;

  load_tile_bf16<D>(Qs, qg, p.qs.s, q0, p.S, tid);
  __syncthreads();

  // A fragments of this warp's 16 query rows, kept for the whole KV loop.
  const int r0 = warp * 16 + g;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = ld32(Qs + r0 * LD + kc * 16 + t * 2);
    qa[kc][1] = ld32(Qs + (r0 + 8) * LD + kc * 16 + t * 2);
    qa[kc][2] = ld32(Qs + r0 * LD + kc * 16 + 8 + t * 2);
    qa[kc][3] = ld32(Qs + (r0 + 8) * LD + kc * 16 + 8 + t * 2);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};   // this thread's partial row sums
  const int row_a = q0 + r0, row_b = row_a + 8;

  const int nkt = (p.S + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(q0, k0, p)) continue;   // uniform across the block
    __syncthreads();                       // previous tile fully read
    load_tile_bf16<D>(Ks, kg, p.ks.s, k0, p.S, tid);
    load_tile_bf16<D>(Vs, vg, p.vs.s, k0, p.S, tid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* kr = Ks + (nt * 8 + g) * LD + kc * 16 + t * 2;
        mma_bf16(s[nt], qa[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask, row max (rows g and g+8; a quad shares a row).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? row_a : row_b;
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const float x = key_ok(row, col, p) ? s[nt][e] * p.scale_log2 : NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = pv;
        rs[e >> 1] += pv;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: the S fragments of keys [16j, 16j+16) are the A fragment.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        // B fragment (k = key, n = head-dim column): keys 2t, 2t+1 (+8).
        const uint16_t* vc = Vs + (j * 16 + t * 2) * LD + nd * 8 + g;
        const uint32_t b0 = uint32_t(vc[0]) | (uint32_t(vc[LD]) << 16);
        const uint32_t b1 = uint32_t(vc[8 * LD]) | (uint32_t(vc[9 * LD]) << 16);
        mma_bf16(acc[nd], pa, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + t * 2;
    if (row_a < p.S)
      *reinterpret_cast<uint32_t*>(og + row_a * p.os.s + col) =
          pack_bf16(acc[nd][0] * inv[0], acc[nd][1] * inv[0]);
    if (row_b < p.S)
      *reinterpret_cast<uint32_t*>(og + row_b * p.os.s + col) =
          pack_bf16(acc[nd][2] * inv[1], acc[nd][3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, exact fp32
// ---------------------------------------------------------------------------

constexpr int LDT = 64 + 4;   // row stride of the transposed tiles (floats)

// Rows [row0, row0 + 64) of a (S, D) fp32 slab into shared memory,
// transposed (dst[d * LDT + r]); rows >= S become zeros.  Consecutive
// threads take consecutive rows, so the transposed stores do not conflict.
template <int D>
__device__ __forceinline__ void load_tile_t_f32(float* dst, const float* src,
                                                long long row_stride, int row0,
                                                int S, int tid) {
  constexpr int NCH = D / 4;
  for (int c = tid; c < 64 * NCH; c += NTHREADS) {
    const int r = c % 64, ch = c / 64;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride +
                                             ch * 4);
    dst[(ch * 4 + 0) * LDT + r] = val.x;
    dst[(ch * 4 + 1) * LDT + r] = val.y;
    dst[(ch * 4 + 2) * LDT + r] = val.z;
    dst[(ch * 4 + 3) * LDT + r] = val.w;
  }
}

// Rows [row0, row0 + 64) of a (S, D) fp32 slab, row-major (stride D + 4).
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int S, int tid) {
  constexpr int NCH = D / 4;
  for (int c = tid; c < 64 * NCH; c += NTHREADS) {
    const int r = c / NCH, ch = c % NCH;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride +
                                             ch * 4);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + ch * 4) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_f32_kernel(Params p) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  constexpr int NJ = (D + 31) / 32;   // output column groups of 4 per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);   // [D][LDT]
  float* Kt = Qt + D * LDT;                         // [D][LDT]
  float* Vs = Kt + D * LDT;                         // [64][D + 4]
  float* Pt = Vs + 64 * (D + 4);                    // [64 keys][LDT]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows 4*ty .. 4*ty+3 of the tile
  const int tx = tid & 7;    // score columns 4*tx+i and 32+4*tx+i

  const float* qg = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  load_tile_t_f32<D>(Qt, qg, p.qs.s, q0, p.S, tid);

  float acc[4][NJ * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) acc[r][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int nkt = (p.S + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(q0, k0, p)) continue;   // uniform across the block
    __syncthreads();                       // previous tile fully read
    load_tile_t_f32<D>(Kt, kg, p.ks.s, k0, p.S, tid);
    load_tile_f32<D>(Vs, vg, p.vs.s, k0, p.S, tid);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * LDT + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * LDT + tx * 4);
      const float4 kb =
          *reinterpret_cast<const float4*>(Kt + d * LDT + 32 + tx * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + (c < 4 ? tx * 4 + c : 32 + tx * 4 + (c - 4));
        const float x = key_ok(row, col, p) ? s[r][c] * p.scale_log2 : NEG_INF;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        rs += s[r][c];
      }
      l[r] = l[r] * alpha[r] + rs;
#pragma unroll
      for (int c = 0; c < NJ * 4; ++c) acc[r][c] *= alpha[r];
    }

    // P^T into shared memory: Pt[key][row], 4 rows per 16-byte store.
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int key = c < 4 ? tx * 4 + c : 32 + tx * 4 + (c - 4);
      *reinterpret_cast<float4*>(Pt + key * LDT + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + key * LDT + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j * 32 + tx * 4 < D) {   // false only in a cut last group
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + key * (D + 4) + j * 32 + tx * 4);
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[r][j * 4 + i] = fmaf(pr[r], vc[i], acc[r][j * 4 + i]);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = q0 + ty * 4 + r;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j * 32 + tx * 4 < D)
          *reinterpret_cast<float4*>(og + row * p.os.s + j * 32 + tx * 4) =
            make_float4(acc[r][j * 4] * inv, acc[r][j * 4 + 1] * inv,
                        acc[r][j * 4 + 2] * inv, acc[r][j * 4 + 3] * inv);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr size_t smem_bf16(int D) { return size_t(3) * 64 * (D + 8) * 2; }
constexpr size_t smem_f32(int D) {
  return (size_t(2) * D * LDT + size_t(64) * (D + 4) + size_t(64) * LDT) * 4;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int D,
    int B, int H, int KV, int S, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = {q_sb, q_sh, q_ss};
  p.ks = {k_sb, k_sh, k_ss};
  p.vs = {v_sb, v_sh, v_ss};
  p.os = {o_sb, o_sh, o_ss};
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = LOG2E / sqrtf(float(D));
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && D == 64)
    err = launch(flash_bf16_kernel<64>, grid, smem_bf16(64), st, p);
  else if (dtype == 1 && D == 112)
    err = launch(flash_bf16_kernel<112>, grid, smem_bf16(112), st, p);
  else if (dtype == 1 && D == 128)
    err = launch(flash_bf16_kernel<128>, grid, smem_bf16(128), st, p);
  else if (dtype == 0 && D == 64)
    err = launch(flash_f32_kernel<64>, grid, smem_f32(64), st, p);
  else if (dtype == 0 && D == 112)
    err = launch(flash_f32_kernel<112>, grid, smem_f32(112), st, p);
  else if (dtype == 0 && D == 128)
    err = launch(flash_f32_kernel<128>, grid, smem_f32(128), st, p);
  return int(err);
}
