// Flash attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, the Pallas kernel
// `_attn_kernel` behind `flash_attention` (pallas_call at line 114).
//
// What it computes: blocked online-softmax GQA attention.  q (B,H,S,D),
// k/v (B,KV,S,D), head h reads kv head h / (H/KV); scale 1/sqrt(D); fp32
// running max m, sum l and accumulator acc; causal and sliding-window masks
// as the Pallas kernel (k <= q, k > q - window); masked scores are
// NEG_INF = -2^30 in the log2-scaled domain; KV tiles that the masks leave
// empty are skipped; the result is acc / max(l, 1e-30) cast to q's dtype.
// Unlike the Pallas kernel it masks the ragged edge (keys >= S, no store of
// rows >= S), so any S works.  Tensors are addressed through (b, h, s)
// strides with the head dim contiguous, so the model's (B,S,H,D) activations
// need no copy.  Head dims 64, 112, 128 and 192.
//
// What bounds it on the H100: at the prefill shapes (S ~ 1k, D = 112-128)
// the two matrix products do ~S/2 multiply-adds per byte moved, above the
// card's ~295 flop/byte balance point, so the bound is the tensor cores'
// rate (bf16 989 TFLOP/s).  Only `wgmma` reaches that rate, and only when
// its operands arrive in shared memory ahead of it and the exp2 work of the
// softmax (16 a clock per SM) runs beside the products, not between them.
// In practice three more things limit it: the K/V tiles every q-tile
// re-reads go through L2 (zamba2's 104 MB of K/V does not fit the 50 MB
// L2), the latency of each copy, and the per-item prologue of a short
// sequence (S = 910 is 8 q-tiles).
//
// What the design does about it (bf16, `flash_wgmma_kernel`):
// * Warp specialisation.  A block of 3 warpgroups takes 128 query rows of
//   one (batch, head) at a time.  Warpgroup 2 is the producer: one thread
//   issues every copy, and the warpgroup gives its registers up
//   (`setmaxnreg` 24).  Warpgroups 0 and 1 are consumers, 64 query rows
//   each, with 240 registers (the 64 x D fp32 accumulator, the 64 x 128
//   score tile and P).
// * TMA into a ring.  The Q tile is loaded once per item; the K and V tiles
//   (128 keys) of each live KV step go into a ring of 3 shared-memory
//   stages (225 KB in all at D = 128; at D = 192 the tile is 64 keys, since
//   three 128-key stages would need 336 KB), each completed on its own
//   `mbarrier` (K and V apart, so Q K^T starts before V lands).  Consumers hand a
//   stage back through an "empty" barrier and the Q tile through a "Q read"
//   barrier.  The tensor maps are rank 4 over (D, S, heads, B) with the
//   caller's byte strides, so contiguous (B,H,S,D) tensors and transposed
//   (B,S,H,D) views are read alike; K/V are indexed by kv head, and rows
//   past S come in as zeros.  The head dim is loaded as 64-column boxes
//   with 128-byte swizzle; at D = 112 the second box runs past the tensor's
//   112 columns and TMA fills columns 112-127 with zeros.
// * `wgmma`.  S = Q K^T is m64n128k16 (m64n64k16 at D = 192) with both
//   operands in shared memory (K is K-major, no transpose; D/16 k-steps, 7
//   at D = 112).  O += P V is m64nDk16 with P from registers: at D = 192 the
//   96 accumulators, 32 scores and 16 P words leave room in the 240
//   registers a consumer holds.  The fp32 score fragment of keys
//   16j..16j+15, packed pairwise to bf16, is the A fragment of k-step j, so
//   P never touches shared memory.  V (keys x D) is MN-major for this
//   product and is read with the transpose bit.
// * Softmax beside the products.  Each consumer issues S = Q K^T of tile j
//   and O += P V of tile j - 1 back to back, then runs the softmax of tile j
//   while P V is still in flight (the ordering of FlashAttention-3); O is
//   rescaled just before its next P V is issued.
// * Masks only where needed.  A KV tile is masked element by element only
//   for a warpgroup whose rows it crosses on the diagonal, at the window's
//   left edge, or at S; interior tiles go straight to the softmax, which
//   keeps the raw scores and folds the scale into one FFMA per exp2.
// * Persistent, in an L2-friendly order.  One block per SM walks the work
//   items (q-tile, batch, head) round-robin.  The items come in groups of 8
//   (batch, head) pairs, so a group's K/V stays in L2 while its q-tiles
//   run, and inside a group the heaviest q-tiles (the last, which see the
//   most keys under a causal mask) come first.  The producer runs ahead
//   across items, so the next item's Q and K/V land while the consumers
//   finish the current one.
// * P is rounded to bf16 for the P V product (the Pallas kernel keeps it
//   fp32); the error stays far inside the bf16 tolerance of 2e-2.
// fp32 (`flash_f32_kernel`): the tensor cores take no full-precision fp32,
// so a CUDA-core kernel keeps exact fp32 arithmetic (tolerance 2e-5): 128
// threads, each owning a 4 x 8 block of the 64 x 64 score tile and 4 rows of
// the output (columns 32j + 4tx .. +3, the last group cut at D when D is not
// a multiple of 32, as for D = 112), with Q and K transposed in shared
// memory for 16-byte loads.  Both kernels keep the scores in the log2
// domain (scale * log2(e), exp2).

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // fp32 kernel tile
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
  int B, H, KV, S;
  int causal, window;
  float scale_log2;   // log2(e) / sqrt(D)
  float neg_raw;      // NEG_INF / scale_log2: a masked raw score
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
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BM = 128;               // query rows per block
constexpr int NCONS = 2;              // consumer warpgroups (64 rows each)
constexpr int WS_THREADS = (NCONS + 1) * 128;
constexpr int ORDER_GROUP = 8;        // (batch, head) pairs per item group
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;    // 128*24 + 256*240 <= 65536

// Keys per KV tile and ring depth by head dim: 128 keys in 3 stages up to
// D = 128 (225 KB at D = 128); at D = 192 a 128-key stage is 48 KB, so 3 of
// them (336 KB) or 2 (240 KB) pass the 227 KB a block may hold, and the
// tile is 64 keys in 3 stages (193 KB).  Fewer than 2 stages cannot work:
// a consumer waits for K of tile j before it releases V of tile j - 1.
template <int D>
struct Cfg {
  static constexpr int BN = D > 128 ? 64 : 128;  // keys per KV tile
  static constexpr int NSTAGE = 3;               // K/V ring depth
  static constexpr int NS = BN / 2;              // score floats a thread
  static constexpr int PK = BN / 16;             // k-steps of P V
  static constexpr int DP = (D + SPAN - 1) / SPAN * SPAN;   // padded head dim
  static constexpr int NCH = DP / SPAN;          // 64-column boxes per row
  static constexpr int KSTEPS = D / 16;          // k-steps of Q K^T
  static constexpr int TILE_Q = NCH * BM * 128;  // bytes
  static constexpr int TILE_KV = NCH * BN * 128;
  static constexpr int NBAR = 2 + 3 * NSTAGE;    // q, q read, k[], v[], empty[]
  static constexpr int SMEM = 1024 + TILE_Q + 2 * NSTAGE * TILE_KV + 8 * NBAR;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 112, fp32) += A (64 x 16, registers) * B (16 x 112, smem,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// D (64 x 192, fp32) += A (64 x 16, registers) * B (16 x 192, smem,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The work items: (q-tile, batch, head).  They come in groups of
// ORDER_GROUP (batch, head) pairs, so that the K/V a group reads stays in L2
// while its q-tiles run; inside a group the heaviest q-tiles come first
// (the last q-tile sees the most keys under a causal mask), and the heads of
// one q-tile are adjacent, so heads sharing a kv head run together.
struct Item {
  int q0, b, h, kt_lo, kt_hi;   // live KV tiles: [kt_lo, kt_hi)
};

template <int BN>
__device__ __forceinline__ Item work_item(int t, const Params& p) {
  const int nbh = p.B * p.H;
  const int nqt = (p.S + BM - 1) / BM;
  const int grp = t / (ORDER_GROUP * nqt);
  const int within = t - grp * ORDER_GROUP * nqt;
  const int gsize = min(ORDER_GROUP, nbh - grp * ORDER_GROUP);
  const int bh = grp * ORDER_GROUP + within % gsize;
  Item w;
  w.q0 = (nqt - 1 - within / gsize) * BM;
  w.b = bh / p.H;
  w.h = bh % p.H;
  // the KV tiles the masks leave live form one range (the Pallas kernel's
  // `live` test: k0 <= q0 + BM - 1 if causal, k0 + BN - 1 > q0 - window)
  const int nkt = (p.S + BN - 1) / BN;
  w.kt_hi = p.causal ? min(nkt, (w.q0 + BM - 1) / BN + 1) : nkt;
  const int lo = w.q0 - p.window - BN + 2;   // least live k0
  w.kt_lo = (p.window && lo > 0) ? (lo + BN - 1) / BN : 0;
  return w;
}

// Scale-folded online softmax of one 64 x BN score tile (raw scores in
// `s`, NS = BN / 2 a thread, turned into unnormalised probabilities), after
// the masks; returns the factor the accumulator must be rescaled by, per
// fragment row.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sc) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float msc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    alpha[j] = ex2((m[j] - mx[j]) * sc);
    m[j] = mx[j];
    msc[j] = mx[j] * sc;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2(fmaf(s[i], sc, -msc[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// Masks of one tile for one warpgroup's rows: applied only where the tile
// crosses the diagonal, the window's left edge or S.
template <int NS>
__device__ __forceinline__ void mask_tile(float (&s)[NS], int k0, int row_lo,
                                          int r, int c2, const Params& p) {
  constexpr int BN = 2 * NS;
  const bool edge = (k0 + BN > p.S) || (p.causal && k0 + BN - 1 > row_lo) ||
                    (p.window && k0 <= row_lo + 63 - p.window);
  if (!edge) return;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int row = row_lo + r + ((i >> 1) & 1) * 8;
    const int col = k0 + (i >> 2) * 8 + c2 + (i & 1);
    if (!key_ok(row, col, p)) s[i] = p.neg_raw;
  }
}

// P as bf16 A fragments: k-step j of P V takes the keys 16j .. 16j + 15.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS],
                                       uint32_t (&pa)[NS / 8][4]) {
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

// S = Q K^T for one warpgroup: 64 rows x BN keys, both operands K-major in
// shared memory; issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<D>::NS], uint32_t q_wg,
                                         uint32_t k_st) {
  constexpr int BN = Cfg<D>::BN;
#pragma unroll
  for (int ks = 0; ks < Cfg<D>::KSTEPS; ++ks) {
    const uint32_t off = (ks & 3) * 32;   // 16 columns = 32 bytes
    const uint64_t da =
        sw128_desc(q_wg + (ks >> 2) * BM * 128 + off, 16, 1024);
    const uint64_t db =
        sw128_desc(k_st + (ks >> 2) * BN * 128 + off, 16, 1024);
    if constexpr (BN == 128)
      wgmma_ss_n128(s, da, db, ks > 0);
    else
      wgmma_ss_n64<0, 0>(s, da, db, ks > 0);
  }
}

// O += P V, V (keys x D) MN-major in shared memory, read transposed;
// issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Cfg<D>::PK][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int j = 0; j < Cfg<D>::PK; ++j) {
    const uint64_t dv =
        sw128_desc(v_st + j * 16 * 128, Cfg<D>::BN * 128, 1024);
    if constexpr (D == 192)
      wgmma_rs_n192(o, pa[j], dv);
    else if constexpr (D == 128)
      wgmma_rs_n128(o, pa[j], dv);
    else if constexpr (D == 112)
      wgmma_rs_n112(o, pa[j], dv);
    else
      wgmma_rs_n64(o, pa[j], dv);
  }
}

// Persistent: gridDim.x blocks (at most one per SM) walk the work items
// t = blockIdx.x + n * gridDim.x.  The producer runs ahead across items,
// so the next item's Q and first K/V tiles land while the consumers finish
// the current one.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  using C = Cfg<D>;
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  const uint32_t s_q = (smem_u32(smem_ws) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + C::TILE_Q;                // stage st: + st*TILE_KV
  const uint32_t s_v = s_k + NSTAGE * C::TILE_KV;
  const uint32_t bar_q = s_v + NSTAGE * C::TILE_KV;    // Q landed
  const uint32_t bar_qe = bar_q + 8;                   // Q read by all
  const uint32_t bar_k = bar_qe + 8;                   // [NSTAGE]
  const uint32_t bar_v = bar_k + 8 * NSTAGE;           // [NSTAGE]
  const uint32_t bar_e = bar_v + 8 * NSTAGE;           // [NSTAGE] K/V read
  const int items = ((p.S + BM - 1) / BM) * p.B * p.H;

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 4 * NCONS);            // one arrival per consumer warp
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 4 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tw == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      int it = 0;   // K/V tiles issued, over all items
      for (int t = blockIdx.x, n = 0; t < items; t += gridDim.x, ++n) {
        const Item w = work_item<C::BN>(t, p);
        const int kvh = w.h / (p.H / p.KV);
        mbar_wait(bar_qe, (n & 1) ^ 1);      // the first pass is free
        mbar_expect_tx(bar_q, C::TILE_Q);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(s_q + c * BM * 128, &tm_q, bar_q, c * SPAN, w.q0, w.h,
                      w.b);
        for (int kt = w.kt_lo; kt < w.kt_hi; ++kt, ++it) {
          const int st = it % NSTAGE;
          const uint32_t ph = (it / NSTAGE) & 1;
          mbar_wait(bar_e + 8 * st, ph ^ 1);
          mbar_expect_tx(bar_k + 8 * st, C::TILE_KV);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(s_k + st * C::TILE_KV + c * C::BN * 128, &tm_k,
                        bar_k + 8 * st, c * SPAN, kt * C::BN, kvh, w.b);
          mbar_expect_tx(bar_v + 8 * st, C::TILE_KV);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(s_v + st * C::TILE_KV + c * C::BN * 128, &tm_v,
                        bar_v + 8 * st, c * SPAN, kt * C::BN, kvh, w.b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tw / 32, lane = tw % 32;
    const int r = warp * 16 + (lane >> 2);   // fragment rows r and r + 8
    const int c2 = (lane & 3) * 2;           // fragment columns c2, c2 + 1
    const float sc = p.scale_log2;
    const uint32_t q_wg = s_q + wg * 64 * 128;   // this warpgroup's rows
    int it = 0;                                  // K/V tiles consumed
    for (int t = blockIdx.x, n = 0; t < items; t += gridDim.x, ++n) {
      const Item w = work_item<C::BN>(t, p);
      const int row_lo = w.q0 + 64 * wg;
      mbar_wait(bar_q, n & 1);
      if (row_lo >= p.S) {
        // rows all past S: keep pace with the ring, compute nothing
        for (int kt = w.kt_lo; kt < w.kt_hi; ++kt, ++it) {
          const int st = it % NSTAGE;
          const uint32_t ph = (it / NSTAGE) & 1;
          mbar_wait(bar_k + 8 * st, ph);
          mbar_wait(bar_v + 8 * st, ph);
          if (lane == 0) mbar_arrive(bar_e + 8 * st);
        }
        if (lane == 0) mbar_arrive(bar_qe);
        continue;
      }

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {p.neg_raw, p.neg_raw};   // running max, raw scores
      float l[2] = {0.f, 0.f};               // this thread's partial sums
      float s[C::NS], alpha[2];
      uint32_t pa[C::PK][4];                 // P of the previous tile

      // first tile: S, softmax, P (the accumulator is still zero)
      int st = it % NSTAGE;
      uint32_t ph = (it / NSTAGE) & 1;
      mbar_wait(bar_k + 8 * st, ph);
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, q_wg, s_k + st * C::TILE_KV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mask_tile(s, w.kt_lo * C::BN, row_lo, r, c2, p);
      softmax_tile(s, m, l, alpha, sc);
      pack_p(s, pa);

      // steady state: S of tile kt and O += P V of tile kt - 1 in flight
      // together; the softmax of kt runs while P V of kt - 1 still does
      for (int kt = w.kt_lo + 1; kt < w.kt_hi; ++kt) {
        const int pst = st;
        const uint32_t pph = ph;
        ++it;
        st = it % NSTAGE;
        ph = (it / NSTAGE) & 1;
        mbar_wait(bar_k + 8 * st, ph);
        fence_regs(s);
        wgmma_fence();
        issue_qk<D>(s, q_wg, s_k + st * C::TILE_KV);
        wgmma_commit();
        fence_regs(s);
        // O to the max of tile kt - 1, then O += P V of tile kt - 1
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        mbar_wait(bar_v + 8 * pst, pph);
        fence_regs(o);
        wgmma_fence();
        issue_pv<D>(o, pa, s_v + pst * C::TILE_KV);
        wgmma_commit();
        fence_regs(o);
        wgmma_wait<1>();                     // S of kt is ready
        fence_regs(s);
        mask_tile(s, kt * C::BN, row_lo, r, c2, p);
        softmax_tile(s, m, l, alpha, sc);
        wgmma_wait<0>();                     // P V of kt - 1 is done
        fence_regs(o);
        if (lane == 0) mbar_arrive(bar_e + 8 * pst);
        pack_p(s, pa);
      }
      if (lane == 0) mbar_arrive(bar_qe);    // every S of this item is done

      // last P V
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      mbar_wait(bar_v + 8 * st, ph);
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, s_v + st * C::TILE_KV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_e + 8 * st);
      ++it;

      // epilogue: 1 / l over the quad's partial sums, bf16 stores of the D
      // real columns of rows < S
      float inv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
        inv[j] = 1.f / fmaxf(l[j], 1e-30f);
      }
      uint16_t* og =
          static_cast<uint16_t*>(p.o) + w.b * p.os.b + w.h * p.os.h;
      const int row_a = row_lo + r, row_b = row_a + 8;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + c2;
        if (row_a < p.S)
          *reinterpret_cast<uint32_t*>(og + row_a * p.os.s + col) =
              pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        if (row_b < p.S)
          *reinterpret_cast<uint32_t*>(og + row_b * p.os.s + col) =
              pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
      }
    }
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

constexpr size_t smem_f32(int D) {
  return (size_t(2) * D * LDT + size_t(64) * (D + 4) + size_t(64) * LDT) * 4;
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = tensor_map_4d(&tq, encode, p.q, D, p.S, p.H, p.B, p.qs.s,
                           p.qs.h, p.qs.b, BM)) ||
      (err = tensor_map_4d(&tk, encode, p.k, D, p.S, p.KV, p.B, p.ks.s,
                           p.ks.h, p.ks.b, Cfg<D>::BN)) ||
      (err = tensor_map_4d(&tv, encode, p.v, D, p.S, p.KV, p.B, p.vs.s,
                           p.vs.h, p.vs.b, Cfg<D>::BN)))
    return err;
  auto kernel = flash_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const int items = (p.S + BM - 1) / BM * p.H * p.B;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const int grid = items < sms ? items : sms;   // persistent: <= 1 per SM
  kernel<<<grid, WS_THREADS, Cfg<D>::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
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
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = LOG2E / sqrtf(float(D));
  p.neg_raw = NEG_INF / p.scale_log2;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && D == 64)
    err = launch_bf16<64>(p, st);
  else if (dtype == 1 && D == 112)
    err = launch_bf16<112>(p, st);
  else if (dtype == 1 && D == 128)
    err = launch_bf16<128>(p, st);
  else if (dtype == 1 && D == 192)
    err = launch_bf16<192>(p, st);
  else if (dtype == 0 && D == 64)
    err = launch(flash_f32_kernel<64>, grid, smem_f32(64), st, p);
  else if (dtype == 0 && D == 112)
    err = launch(flash_f32_kernel<112>, grid, smem_f32(112), st, p);
  else if (dtype == 0 && D == 128)
    err = launch(flash_f32_kernel<128>, grid, smem_f32(128), st, p);
  else if (dtype == 0 && D == 192)
    err = launch(flash_f32_kernel<192>, grid, smem_f32(192), st, p);
  return int(err);
}
