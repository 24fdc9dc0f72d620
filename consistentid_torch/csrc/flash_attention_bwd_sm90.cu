// Flash-attention backward for Hopper (sm_90a): K3 and K4 fused into one
// kernel, dQ, dK and dV from one pass over the scores, with wgmma for all
// five products and a TMA ring of Q/dO tiles.
//
// Replaces the JAX package's two Pallas TPU kernels `_flash_bwd_dq_kernel`
// (K3, consistentid_tpu/ops/flash_attention.py:273) and
// `_flash_bwd_dkv_kernel` (K4, same file, :308), both launched by
// `_flash_backward` from the custom VJP's `_flash_diff_bwd`. Same function
// as the mma.sync pair in flash_attention_bwd.cu, which keeps the shapes
// this one does not take: with P = exp(s Q K^T - lse) recomputed from the
// forward's logsumexp (K2), dP = dO V^T, dS = P o (dP - delta) and delta =
// rowsum(dO o O) (fp32, computed before the launch),
//   dQ = s dS K,   dK = s dS^T Q,   dV = P^T dO,
// with P and dS rounded to the input type before their products, fp32
// accumulation, outputs in the input type. The pair computed S, dP and the
// exps twice (7 products, 2 passes of exps); this kernel once (5, 1).
//
// What bounds it on an H100 at the SD1.5 training shapes (bf16, (B*H, S, D)
// = (16, 4096, 40) and (16, 1024, 80)): the tensor-core FLOPs, 10 * BH * Sq
// * Sk * D at 989 TFLOP/s (0.1086 ms and 0.0136 ms), then the exps, one
// per score at 16 per clock per SM (0.0688 ms at level 0). The bytes of
// q, k, v, dO, lse, delta in and dq, dk, dv out are two orders below. The
// implementation adds the dQ reduction: Sk / 128 partial sums of every dq
// row, 806 MB of 64-bit integers at level 0 with the depth padded to 48
// (see below).
//
// Design, and what it answers:
//   - One CTA per (b*h, 128 keys): two warpgroups of 64 keys (256 threads),
//     one CTA per SM (182-232 registers a thread at depths 48-80). K and V
//     of the block are loaded once by TMA through 3-D tensor maps (d, S,
//     B*H), as in the forward: head_dim is padded to 48, 64, 80 or 128 in
//     shared memory only, columns past d and rows past Sk zero-filled by the
//     hardware. (64-key CTAs of one warpgroup were no faster at level 0 and
//     slower at level 1.)
//   - The CTA walks every q tile of 64 rows. Q, dO and the tile's 64 lse
//     and delta values come through a ring of 4 stages (2 at depth 128)
//     with full/empty mbarriers; no producer warp (its registers would cost
//     every thread, as in the forward): thread 0 refills the stage of tile
//     it - 1 after the dS barrier of tile it, where every warp has released
//     it, so it never waits there. The time fell from 2 stages to 3 and
//     from 3 to 4. The CTAs of one head start at different q tiles, so
//     they do not add into the same dQ rows at the same time.
//   - Per q tile and warpgroup: S^T = K Q^T and dP^T = V dO^T (wgmma
//     m64n64k16, both operands K-major in shared memory); P^T = 2^(S^T c -
//     lse2) with c = scale * log2(e) and lse2 = lse * log2(e) by column;
//     dV += P^T dO and dK += dS^T Q (wgmma with A from registers: the fp32
//     accumulator layout of S^T is the 16-bit A layout, so P^T and dS^T are
//     rounded and packed in place; dO and Q are MN-major B operands through
//     the transpose bit, as V in the forward). dK and dV stay in registers
//     over the whole loop and are written once, so they are deterministic.
//   - dQ: both warpgroups write dS^T (16-bit, 128 keys x 64 q, 128-byte
//     swizzle) to shared memory and meet at a named barrier; each then
//     computes half the depth of the tile's partial dS K (wgmma with A = dS
//     and B = K both MN-major; at depth 80 both compute 48 columns, as a
//     half would start inside a 32-byte swizzle span), stages its half in
//     shared memory in accumulator order and adds it into a workspace with
//     one bulk reduce (cp.reduce.async.bulk, done in L2). The workspace
//     holds each (b*h, q tile) as 64 x depth words in that order; a pass in
//     this file then scales it by s, puts it back in (row, column) order
//     and casts it to q's dtype.
//   - dQ does not depend on the order the key blocks' sums arrive in, as
//     the reference's does not (one program sums the key blocks of a q
//     tile in order): the partial sums are added as 64-bit fixed-point
//     integers (.add.u64), and integer addition is exact, so the workspace
//     ends as the same bits whatever the order, equal to the sum in any
//     fixed order. The unit of head b*h is a power of two, 2^(e - 58) with
//     2^e > B = 4 d max|dO| max|K| max|V| (over the head) >= 2 |dq| and
//     every partial of it: dS_ij = P_ij (dP_ij - delta_i), |dP_ij| and
//     |delta_i| <= |dO_i| |V_j| <= d max|dO| max|V|, sum_j P_ij = 1. So a
//     partial rounds to within B 2^-58 and fits in 2^57 units, and a row's
//     sum over Sk / 128 key blocks is within Sk / 128 B 2^-58 of exact:
//     below fp32's rounding of the same sum unless B overstates that row
//     of dq by more than 2^30 (the rows of a head whose dO is that much
//     smaller than its largest). The set-up kernel takes the maxima in
//     blocks beside its other work, and each CTA reduces its head's
//     (maxima are exact, in no order either); a head with a non-finite
//     bound gets NaN.
//     The 64-bit words double the reduce's bytes (25 MB of workspace at
//     level 0, still in the L2), and the conversions run beside the exps.
//     (A semaphore per q tile, key blocks adding fp32 in turn, kept the
//     reference's kind of order but was far slower: every CTA waits for
//     the one before it at every tile, PERF.md.) kFixedDq =
//     false, kept for the variants script, adds fp32 in arrival order,
//     whose last bits may change from run to run.
//   - Overlap: the next tile's S^T and dP^T are issued right behind this
//     tile's dV, dK and dQ products, into registers dead since the packing,
//     so the tensor cores have them queued while the warpgroup stages dQ.
//     Both warpgroups issue the same wgmma sequence on every iteration (on
//     the last, the next scores are computed on a stale stage and never
//     read): a product issued on one warpgroup only, or under a branch,
//     made ptxas serialise every wgmma of the kernel (remark C7518).
//   - Masking: keys past Sk are zero-filled, and their P^T is set to 0 in
//     the last key block (a zero key row gives S = 0 and P = exp(-lse),
//     which may overflow); their rows are never stored. q rows past Sq get
//     lse2 = +inf in the staged statistics, so P = 0 there, and delta = 0.
//   - Every mbarrier wait is bounded (about 10 s), then traps.
// What the time goes to at the training shapes, by ablation, and the dQ
// reduction's share: PERF.md, scripts/flash_bwd_sm90_variants.py.
//
// C interface: cid_flash_attention_backward_sm90(...) launches three kernels
// on the given stream (the set-up: statistics, the dq workspace zeroed and
// the maxima of dO, K and V in blocks; the fused kernel; the dq pass) and
// returns a cudaError_t, cudaErrorInvalidValue for
// what it does not take: dtype other than bf16 (1) or fp16 (2), d not a
// multiple of 8 in 8..128, a pointer off 16 bytes, a scale that is not
// positive. The caller allocates the workspace of
// bh * ceil(sq / 64) * (128 * padded depth + 128) + 97 * bh floats.

#include <cfloat>
#include <algorithm>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kBwdBlockQ = 64;   // q rows per tile of the ring
constexpr int kBwdBlockK = 128;  // keys per CTA: two warpgroups of 64
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPassThreads = 256;  // the set-up kernel and the dq pass
constexpr int kPassWarps = kPassThreads / 32;
// dQ's partial sums as fixed-point integers (see the header)
constexpr bool kFixedDq = true;
using DqWord = std::conditional_t<kFixedDq, unsigned long long, float>;
using DqPair = std::conditional_t<kFixedDq, ulonglong2, float2>;
// per q row of a tile: lse * log2(e), delta
constexpr int kStats = 2;
// blocks per head of the maxima kernel
constexpr int kMaxBlocks = 32;

// The shared-memory layout at padded depth DP: the swizzle span of the K/V
// and Q/dO tiles (as the forward's), byte offsets in the CTA's dynamic
// shared memory (base aligned to 1024); and the split of the dQ product
// between the warpgroups: each computes kDqN columns of dS K, warpgroup 1
// from column kDqCol1, and keeps DP / 2 of them (at depth 80 the halves
// would start inside a 32-byte swizzle span, so both compute 48 columns,
// 0-47 and 32-79, and warpgroup 1 drops its first 8).
template <int DP>
struct BwdLayout {
  static constexpr int kSwizzle = DP == 80 ? 32 : 128;
  static constexpr int kRowBytes = kSwizzle;
  static constexpr int kBoxCols = kSwizzle / 2;  // 16-bit columns per box
  static constexpr int kBoxes = (DP + kBoxCols - 1) / kBoxCols;
  static constexpr int kDqN = DP == 80 ? 48 : DP / 2;
  static constexpr int kDqCol1 = DP == 80 ? 32 : DP / 2;
  static constexpr int kDqSkip = (DP / 2 - kDqCol1) / 8;  // n8 blocks, wg 1
  static constexpr int kStages = DP == 128 ? 2 : 4;
  static constexpr int kKBytes = kBoxes * kBwdBlockK * kRowBytes;   // K or V
  static constexpr int kTileBytes = kBoxes * kBwdBlockQ * kRowBytes;  // Q, dO
  static constexpr int kStatBytes = kStats * kBwdBlockQ * 4;
  static constexpr int kDsBytes = kBwdBlockK * 128;  // dS^T, keys x 64 q
  static constexpr int kDqHalfBytes =
      kBwdBlockQ * DP / 2 * static_cast<int>(sizeof(DqWord));
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kRing = kV + kKBytes;  // stage st: Q, then dO
  static constexpr int kDs = kRing + kStages * 2 * kTileBytes;  // 2 buffers
  static constexpr int kDq = kDs + 2 * kDsBytes;  // one half per warpgroup
  static constexpr int kStat = kDq + 2 * kDqHalfBytes;  // one per stage
  static constexpr int kBar = kStat + kStages * kStatBytes;  // kv, full, empty
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kAlloc <= 232448, "shared memory of one CTA");
};

#define CID_WGMMA_SS_TT_N24(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n24k16.f32" TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, " \
      "%12, %13, p, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define CID_WGMMA_SS_TT_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define CID_WGMMA_SS_TT_N48(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32" TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, " \
      "%24, %25, p, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define CID_WGMMA_SS_TT_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(N == 24 || N == 32 || N == 48 || N == 64, "wgmma width");
  if constexpr (N == 24) {
    if constexpr (kHalf<T>) { CID_WGMMA_SS_TT_N24(".f16.f16"); }
    else { CID_WGMMA_SS_TT_N24(".bf16.bf16"); }
  } else if constexpr (N == 32) {
    if constexpr (kHalf<T>) { CID_WGMMA_SS_TT_N32(".f16.f16"); }
    else { CID_WGMMA_SS_TT_N32(".bf16.bf16"); }
  } else if constexpr (N == 48) {
    if constexpr (kHalf<T>) { CID_WGMMA_SS_TT_N48(".f16.f16"); }
    else { CID_WGMMA_SS_TT_N48(".bf16.bf16"); }
  } else {
    if constexpr (kHalf<T>) { CID_WGMMA_SS_TT_N64(".f16.f16"); }
    else { CID_WGMMA_SS_TT_N64(".bf16.bf16"); }
  }
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// `bytes` contiguous bytes from global to shared memory, completion on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Add `bytes` of dQ words from shared memory into global memory (in L2).
__device__ __forceinline__ void bulk_reduce_add(DqWord* dst, uint32_t src,
                                                uint32_t bytes) {
  if constexpr (kFixedDq) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 "
        "[%0], [%1], %2;\n" ::"l"(dst),
        "r"(src), "r"(bytes)
        : "memory");
  } else {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(dst),
        "r"(src), "r"(bytes)
        : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// The fixed-point scale of a head (its unit's inverse): 2^(58 - e), 2^e >
// the bound B (see the header); NaN when B is not finite.
__device__ __forceinline__ float dq_scale(float bound) {
  if (!(bound <= FLT_MAX)) return __int_as_float(0x7fc00000);
  int e;
  frexpf(bound, &e);  // bound < 2^e (e = 0 for 0)
  return ldexpf(1.0f, min(58 - e, 126));
}

// A pair of dQ partials as words of the workspace: in units of 1 / f, or
// as they are (fp32); and back (unit = 1 / f).
__device__ __forceinline__ void to_words(ulonglong2& out, float x, float y,
                                         float f) {
  out = make_ulonglong2(static_cast<unsigned long long>(__float2ll_rn(x * f)),
                        static_cast<unsigned long long>(__float2ll_rn(y * f)));
}
__device__ __forceinline__ void to_words(float2& out, float x, float y,
                                         float) {
  out = make_float2(x, y);
}
__device__ __forceinline__ float2 from_words(const ulonglong2& w,
                                             double unit) {
  return make_float2(static_cast<float>(static_cast<long long>(w.x) * unit),
                     static_cast<float>(static_cast<long long>(w.y) * unit));
}
__device__ __forceinline__ float2 from_words(const float2& w, double) {
  return w;
}

// This thread's bulk operations have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d (64 rows of A x 64 rows of B) = A B^T over the padded depth, both tiles
// K-major in boxes of one swizzle span; a_box, b_box: the byte stride
// between a tile's boxes.
template <typename T, int DP>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a,
                                          int a_box, uint32_t b, int b_box) {
  using L = BwdLayout<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int box = kk * 16 / L::kBoxCols;
    const int col = (kk * 16 % L::kBoxCols) * 2;
    wgmma_ss_n64<T>(
        d, gmma_desc<L::kSwizzle>(a + box * a_box + col, 16, 8 * L::kRowBytes),
        gmma_desc<L::kSwizzle>(b + box * b_box + col, 16, 8 * L::kRowBytes),
        kk > 0);
  }
  wgmma_commit();
}

// acc (64 keys x DP) += X (64 keys x 64 q, packed 16-bit pairs) times the
// Q or dO tile (64 q x DP), MN-major: one k-step per 16 q rows.
template <typename T, int DP>
__device__ __forceinline__ void issue_xt(float (&acc)[DP / 2],
                                         const uint32_t (&x)[16],
                                         uint32_t tile) {
  using L = BwdLayout<DP>;
#pragma unroll
  for (int kk = 0; kk < kBwdBlockQ / 16; ++kk) {
    wgmma_rs<T, DP>(acc, &x[4 * kk],
                    gmma_desc<L::kSwizzle>(tile + kk * 16 * L::kRowBytes,
                                           kBwdBlockQ * L::kRowBytes,
                                           8 * L::kRowBytes));
  }
  wgmma_commit();
}

// dq (64 q x kDqN) = dS (64 q x 128 keys) times columns [col0, col0 + kDqN)
// of K (128 keys x DP): dS from its (keys, q) buffer and K from its block,
// both MN-major; one k-step per 16 keys. col0 is 0 or kDqCol1: a whole box,
// or (at depths 48 and 64) whole 16-byte chunks inside the one box.
template <typename T, int DP>
__device__ __forceinline__ void issue_dq(float (&dq)[BwdLayout<DP>::kDqN / 2],
                                         uint32_t ds, uint32_t k_s,
                                         int col0) {
  using L = BwdLayout<DP>;
  const uint32_t k_cols = k_s +
                          col0 / L::kBoxCols * kBwdBlockK * L::kRowBytes +
                          col0 % L::kBoxCols * 2;
#pragma unroll
  for (int kk = 0; kk < kBwdBlockK / 16; ++kk) {
    wgmma_ss_tt<T, L::kDqN>(
        dq, gmma_desc<128>(ds + kk * 16 * 128, L::kDsBytes, 8 * 128),
        gmma_desc<L::kSwizzle>(k_cols + kk * 16 * L::kRowBytes,
                               kBwdBlockK * L::kRowBytes, 8 * L::kRowBytes),
        kk > 0);
  }
  wgmma_commit();
}

// Pairs [SKIP, SKIP + PAIRS / 2) of n8 blocks of a dQ accumulator, both
// row halves each, into the staging as dQ words: pair i of thread tid at
// 128 i + tid, f the head's fixed-point scale.
template <int SKIP, int PAIRS, int N>
__device__ __forceinline__ void stage_dq(DqPair* stage, const float (&dq)[N],
                                         int tid, float f) {
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int r = 2 * (i / 2 + SKIP) + i % 2;  // pair of the accumulator
    to_words(stage[128 * i + tid], dq[2 * r], dq[2 * r + 1], f);
  }
}

// Q and dO tile `tile` and its statistics into ring stage `st`.
template <int DP>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* q_map,
                                            const CUtensorMap* do_map,
                                            const float* stats, uint32_t ring,
                                            uint32_t stat_s, uint32_t full,
                                            int st, int tile, int q_tiles,
                                            int bh) {
  using L = BwdLayout<DP>;
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, 2 * L::kTileBytes + L::kStatBytes);
  const uint32_t q_t = ring + st * 2 * L::kTileBytes;
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b) {
    const uint32_t off = b * kBwdBlockQ * L::kRowBytes;
    tma_load(q_t + off, q_map, bar, b * L::kBoxCols, tile * kBwdBlockQ, bh);
    tma_load(q_t + L::kTileBytes + off, do_map, bar, b * L::kBoxCols,
             tile * kBwdBlockQ, bh);
  }
  bulk_load(stat_s + st * L::kStatBytes,
            stats + (static_cast<int64_t>(bh) * q_tiles + tile) * kStats *
                        kBwdBlockQ,
            L::kStatBytes, bar);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ stats,
                      const unsigned* __restrict__ part,
                      float* __restrict__ head_scale,
                      DqWord* __restrict__ dq_acc, T* __restrict__ dk,
                      T* __restrict__ dv, int sk, int d, int q_tiles,
                      int k_blocks, float scale_log2, float sm_scale) {
  using L = BwdLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);  // generic view of base
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t ring = base + L::kRing;
  const uint32_t stat_s = base + L::kStat;
  const uint32_t kv_bar = base + L::kBar;
  const uint32_t full = kv_bar + 8;  // full[st] at full + 8 st
  const uint32_t empty = full + 8 * L::kStages;

  const int bh = blockIdx.x / k_blocks;
  const int kb = blockIdx.x % k_blocks;
  const int k0 = kb * kBwdBlockK;
  // this CTA's first q tile: the key blocks of a head start spread out
  const int first = static_cast<int>(static_cast<int64_t>(kb) * q_tiles /
                                     k_blocks);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;  // in the warpgroup
  const int g = lane >> 2;
  const int c = lane & 3;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
#pragma unroll
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kBwdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * L::kKBytes);
    for (int b = 0; b < L::kBoxes; ++b) {
      const uint32_t off = b * kBwdBlockK * L::kRowBytes;
      tma_load(k_s + off, &k_map, kv_bar, b * L::kBoxCols, k0, bh);
      tma_load(v_s + off, &v_map, kv_bar, b * L::kBoxCols, k0, bh);
    }
    for (int j = 0; j < L::kStages && j < q_tiles; ++j) {
      load_q_tile<DP>(&q_map, &do_map, stats, ring, stat_s, full, j,
                      (first + j) % q_tiles, q_tiles, bh);
    }
  }

  // warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64); in the
  // accumulators, warp w of it holds keys 16 w + g and 16 w + g + 8
  const int row0 = wg * 64 + (warp % 4) * 16 + g;  // in the block
  const bool ragged = k0 + kBwdBlockK > sk;
  const bool valid0 = k0 + row0 < sk;
  const bool valid1 = k0 + row0 + 8 < sk;
  const uint32_t k_rows = k_s + wg * 64 * L::kRowBytes;
  const uint32_t v_rows = v_s + wg * 64 * L::kRowBytes;
  const float cs = scale_log2;
  // this warpgroup's columns of the dQ product, its half of the staging
  const int dq_col0 = wg == 0 ? 0 : L::kDqCol1;
  const uint32_t stage_s = base + L::kDq + wg * L::kDqHalfBytes;
  DqPair* const stage = reinterpret_cast<DqPair*>(smem + L::kDq +
                                                  wg * L::kDqHalfBytes);
  // the head's fixed-point scale, from the set-up's block maxima; key
  // block 0 keeps it for the dq pass
  __shared__ unsigned head_part[3 * kMaxBlocks];
  __shared__ float head_f;
  if (kFixedDq) {
    if (threadIdx.x < 3 * kMaxBlocks) {
      head_part[threadIdx.x] = part[bh * 3 * kMaxBlocks + threadIdx.x];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned m[3] = {0u, 0u, 0u};
      for (int b = 0; b < kMaxBlocks; ++b) {
#pragma unroll
        for (int j = 0; j < 3; ++j) m[j] = max(m[j], head_part[3 * b + j]);
      }
      head_f = dq_scale(4.0f * static_cast<float>(d) * __uint_as_float(m[0]) *
                        __uint_as_float(m[1]) * __uint_as_float(m[2]));
      if (kb == 0) head_scale[bh] = head_f;
    }
    __syncthreads();
  }
  const float dq_f = kFixedDq ? head_f : 1.0f;

  // S^T = K Q^T and dP^T = V dO^T of the tile in ring stage st
  auto issue_scores = [&](float (&s)[32], float (&dp)[32], int st) {
    const uint32_t q_t = ring + st * 2 * L::kTileBytes;
    wgmma_fence();
    issue_abt<T, DP>(s, k_rows, kBwdBlockK * L::kRowBytes, q_t,
                     kBwdBlockQ * L::kRowBytes);
    issue_abt<T, DP>(dp, v_rows, kBwdBlockK * L::kRowBytes,
                     q_t + L::kTileBytes, kBwdBlockQ * L::kRowBytes);
  };

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  float s[32], dp[32];
  mbar_wait(kv_bar, 0);
  mbar_wait(full, 0);
  issue_scores(s, dp, 0);

  for (int it = 0; it < q_tiles; ++it) {
    const int st = it % L::kStages;
    const int tile = (first + it) % q_tiles;
    const uint32_t q_t = ring + st * 2 * L::kTileBytes;
    const uint32_t do_t = q_t + L::kTileBytes;
    const float* stat = reinterpret_cast<const float*>(
        smem + L::kStat + st * L::kStatBytes);
    // in flight here: this tile's S^T and dP^T
    wgmma_wait<1>();  // S^T has landed
    fence_regs(s);
    // P^T: the thread holds, per 8-column group j, q columns 8j + 2c and
    // 8j + 2c + 1 of key rows g and g + 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * c);
      s[4 * j] = ex2(fmaf(s[4 * j], cs, -l2.x));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], cs, -l2.y));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], cs, -l2.x));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], cs, -l2.y));
    }
    if (ragged) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!valid0) s[4 * j] = s[4 * j + 1] = 0.0f;
        if (!valid1) s[4 * j + 2] = s[4 * j + 3] = 0.0f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t p16[16], ds16[16];
    pack_p<T>(p16, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(
          stat + kBwdBlockQ + 8 * j + 2 * c);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - dl.x);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dl.y);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dl.x);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dl.y);
    }
    pack_p<T>(ds16, dp);
    wgmma_fence();
    issue_xt<T, DP>(dv_acc, p16, do_t);  // dV += P^T dO
    issue_xt<T, DP>(dk_acc, ds16, q_t);  // dK += dS^T Q

    // dS^T into buffer it % 2, rows of 64 q (128 bytes), 16-byte chunks
    // swizzled by the row's low three bits (the 128-byte swizzle): pair
    // 2j (key row0) and 2j + 1 (row0 + 8) hold q 8j + 2c, 8j + 2c + 1.
    // The buffer was last read by the dQ products of tile it - 2, which
    // both warpgroups waited for before the barrier of tile it - 1.
    const int b = it & 1;
    uint8_t* ds_buf = smem + L::kDs + b * L::kDsBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = ((j ^ g) << 4) + 4 * c;
      *reinterpret_cast<uint32_t*>(ds_buf + row0 * 128 + off) = ds16[2 * j];
      *reinterpret_cast<uint32_t*>(ds_buf + (row0 + 8) * 128 + off) =
          ds16[2 * j + 1];
    }
    fence_async_shared();  // the generic writes, before wgmma reads them
    // the staging: free once the last bulk reduce has read it
    if (tid == 0) bulk_wait_read();
    named_barrier(1, kBwdThreads);  // every key's dS^T is written
    float dq[L::kDqN / 2];
    wgmma_fence();
    issue_dq<T, DP>(dq, base + L::kDs + b * L::kDsBytes, k_s, dq_col0);

    // the stage of tile it - 1 takes tile it - 1 + kStages: every warp
    // released it before the barrier above, so thread 0 does not wait
    const int refill = it - 1 + L::kStages;
    if (threadIdx.x == 0 && it > 0 && refill < q_tiles) {
      const int prev = (it - 1) % L::kStages;
      mbar_wait(empty + 8 * prev, ((it - 1) / L::kStages) & 1);
      load_q_tile<DP>(&q_map, &do_map, stats, ring, stat_s, full, prev,
                      (first + refill) % q_tiles, q_tiles, bh);
    }
    // the next tile's S^T and dP^T go in behind, into s and dp (dead since
    // the packing). After the last tile they are issued all the same, on
    // whatever the stage holds, and never read: the same wgmma sequence on
    // every iteration keeps ptxas from serialising the products.
    const int st1 = (it + 1) % L::kStages;
    if (it + 1 < q_tiles) {
      mbar_wait(full + 8 * st1, ((it + 1) / L::kStages) & 1);
    }
    issue_scores(s, dp, st1);
    fence_regs(s);  // in flight until the next iteration's waits
    fence_regs(dp);
    wgmma_wait<2>();  // dV, dK and dQ of this tile have landed
    fence_regs(dq);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p16);
    fence_regs(ds16);
    if (lane == 0) mbar_arrive(empty + 8 * st);  // Q, dO, stats consumed

    // this warpgroup's DP / 2 columns of the tile's dQ, staged in
    // accumulator order, then added into the workspace
    if (wg == 0) {
      stage_dq<0, DP / 8>(stage, dq, tid, dq_f);
    } else {
      stage_dq<L::kDqSkip, DP / 8>(stage, dq, tid, dq_f);
    }
    fence_async_shared();
    named_barrier(2 + wg, 128);  // the staging is written
    if (tid == 0) {
      bulk_reduce_add(dq_acc + (static_cast<int64_t>(bh) * q_tiles + tile) *
                                   (kBwdBlockQ * DP) +
                          wg * (kBwdBlockQ * DP / 2),
                      stage_s, L::kDqHalfBytes);
    }
  }
  wgmma_wait<0>();
  if (tid == 0) bulk_wait();  // the last reduce has read its staging

  const int key0 = k0 + row0;
  const int key1 = key0 + 8;
  const int64_t kv_off = static_cast<int64_t>(bh) * sk * d;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (8 * i < d) {  // d is a multiple of 8
      if (key0 < sk) {
        const int64_t at = kv_off + static_cast<int64_t>(key0) * d + col;
        *reinterpret_cast<uint32_t*>(dk + at) = TypeOps<T>::pack(
            dk_acc[4 * i] * sm_scale, dk_acc[4 * i + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            TypeOps<T>::pack(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
      if (key1 < sk) {
        const int64_t at = kv_off + static_cast<int64_t>(key1) * d + col;
        *reinterpret_cast<uint32_t*>(dk + at) = TypeOps<T>::pack(
            dk_acc[4 * i + 2] * sm_scale, dk_acc[4 * i + 3] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            TypeOps<T>::pack(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  }
}

// max|.| over 8 elements of T in 16 bytes, as fp32 bits (a NaN, its sign
// cleared, compares above every number).
template <typename T>
__device__ __forceinline__ unsigned max_abs8(const uint4& w, unsigned m) {
  const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) m = max(m, __float_as_uint(fabsf(to_f32(x[i]))));
  return m;
}

// Block `block` of head `head`: max|dO|, max|K|, max|V| over its share
// of the head's elements (16 bytes a load), as fp32 bits into
// part[(head * kMaxBlocks + block) * 3 + {0, 1, 2}].
template <typename T>
__device__ void block_maxima(const T* __restrict__ dout,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             unsigned* __restrict__ part, int64_t q_vec,
                             int64_t k_vec, int head, int block) {
  const uint4* q4 = reinterpret_cast<const uint4*>(dout) + head * q_vec;
  const uint4* k4 = reinterpret_cast<const uint4*>(k) + head * k_vec;
  const uint4* v4 = reinterpret_cast<const uint4*>(v) + head * k_vec;
  const int64_t start = block * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(kMaxBlocks) * blockDim.x;
  unsigned m[3] = {0u, 0u, 0u};
  for (int64_t i = start; i < q_vec; i += stride) {
    m[0] = max_abs8<T>(q4[i], m[0]);
  }
  for (int64_t i = start; i < k_vec; i += stride) {
    m[1] = max_abs8<T>(k4[i], m[1]);
    m[2] = max_abs8<T>(v4[i], m[2]);
  }
  __shared__ unsigned warp_max[3][kPassWarps];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    m[j] = __reduce_max_sync(0xffffffffu, m[j]);
    if (threadIdx.x % 32 == 0) warp_max[j][threadIdx.x / 32] = m[j];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned r = 0u;
    for (int w = 0; w < kPassWarps; ++w) r = max(r, warp_max[threadIdx.x][w]);
    part[(head * kMaxBlocks + block) * 3 + threadIdx.x] = r;
  }
}

// The fused kernel's inputs beside q, k, v and dO, from one launch: blocks
// [0, prep_blocks) stage per (b*h, q tile) the 64 rows' lse * log2(e)
// (+inf past sq, so P = 0 there) and delta (0 past sq) and set the dq
// workspace to zero; each of the kMaxBlocks blocks per head after them
// takes its share of the maxima (`block_maxima`), which the fused kernel
// reduces to the head's fixed-point scale.
template <typename T>
__global__ void bwd_setup_kernel(const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const T* __restrict__ dout,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 unsigned* __restrict__ part,
                                 float* __restrict__ stats,
                                 float4* __restrict__ dq_acc, int sq,
                                 int q_tiles, int prep_blocks, int64_t rows,
                                 int64_t acc_vec4, int64_t q_vec,
                                 int64_t k_vec) {
  if (static_cast<int>(blockIdx.x) >= prep_blocks) {
    const int b = blockIdx.x - prep_blocks;
    block_maxima<T>(dout, k, v, part, q_vec, k_vec, b / kMaxBlocks,
                    b % kMaxBlocks);
    return;
  }
  const int64_t stride = static_cast<int64_t>(prep_blocks) * blockDim.x;
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x;
  for (int64_t i = first; i < rows; i += stride) {
    const int64_t h = i / (static_cast<int64_t>(q_tiles) * kBwdBlockQ);
    const int r = static_cast<int>(i % (q_tiles * kBwdBlockQ));
    const bool in = r < sq;
    const int64_t src = h * sq + r;
    float* out = stats +
                 (h * q_tiles + r / kBwdBlockQ) * kStats * kBwdBlockQ +
                 r % kBwdBlockQ;
    out[0] = in ? lse[src] * kLog2e : INFINITY;
    out[kBwdBlockQ] = in ? delta[src] : 0.0f;
  }
  for (int64_t i = first; i < acc_vec4; i += stride) {
    dq_acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// dq = s * the workspace (in the head's fixed-point unit), from its
// accumulator order (pair i of thread t of warpgroup w's half of a (b*h, q
// tile) block: row 16 (t / 32) + (t % 32) / 4 + 8 (i % 2), column w DP / 2
// + 8 (i / 2) + 2 (t % 4)) to (row, column) order, cast to T.
template <typename T, int DP>
__global__ void dq_convert_kernel(const DqPair* __restrict__ acc,
                                  const float* __restrict__ head_scale,
                                  T* __restrict__ dq, int sq, int d,
                                  int q_tiles, float sm_scale, int64_t pairs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       p < pairs; p += stride) {
    const int t = static_cast<int>(p % 128);
    const int i = static_cast<int>(p / 128 % (DP / 8));
    const int w = static_cast<int>(p / (128 * (DP / 8)) % 2);
    const int64_t block = p / (128 * (DP / 4));
    const int tile = static_cast<int>(block % q_tiles);
    const int64_t bh = block / q_tiles;
    const int row = tile * kBwdBlockQ + 16 * (t / 32) + (t % 32) / 4 +
                    8 * (i % 2);
    const int col = w * (DP / 2) + 8 * (i / 2) + 2 * (t % 4);
    if (row < sq && col < d) {
      const double unit = kFixedDq ? 1.0 / head_scale[bh] : 1.0;
      const float2 v = from_words(acc[p], unit);
      *reinterpret_cast<uint32_t*>(dq + (bh * sq + row) * d + col) =
          TypeOps<T>::pack(v.x * sm_scale, v.y * sm_scale);
    }
  }
}

// --------------------------------------------------------------------- host

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* workspace;
  int bh, sq, sk, d;
  float sm_scale;
  cudaStream_t stream;
};


int pass_blocks(int64_t n) {
  return static_cast<int>(
      std::min<int64_t>((n + kPassThreads - 1) / kPassThreads, 132 * 16));
}

template <typename T, int DP>
int launch_bwd_sm90(const BwdArgs& a) {
  using L = BwdLayout<DP>;
  const int dtype = kHalf<T> ? 2 : 1;
  const int q_tiles = (a.sq + kBwdBlockQ - 1) / kBwdBlockQ;
  const int k_blocks = (a.sk + kBwdBlockK - 1) / kBwdBlockK;
  CUtensorMap qm, km, vm, dom;
  if (!encode_map<L::kSwizzle>(&qm, a.q, a.bh, a.sq, a.d, kBwdBlockQ,
                               dtype) ||
      !encode_map<L::kSwizzle>(&dom, a.dout, a.bh, a.sq, a.d, kBwdBlockQ,
                               dtype) ||
      !encode_map<L::kSwizzle>(&km, a.k, a.bh, a.sk, a.d, kBwdBlockK,
                               dtype) ||
      !encode_map<L::kSwizzle>(&vm, a.v, a.bh, a.sk, a.d, kBwdBlockK,
                               dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the workspace: dq partial sums (64-bit words, room for them either
  // way), the statistics, the blocks' maxima, the heads' scales
  const int64_t blocks = static_cast<int64_t>(a.bh) * q_tiles;
  DqWord* dq_acc = reinterpret_cast<DqWord*>(a.workspace);
  float* stats = a.workspace + blocks * kBwdBlockQ * DP * 2;
  unsigned* part =
      reinterpret_cast<unsigned*>(stats + blocks * kStats * kBwdBlockQ);
  float* head_scale = reinterpret_cast<float*>(part) +
                      static_cast<int64_t>(a.bh) * kMaxBlocks * 3;
  const int64_t rows = blocks * kBwdBlockQ;
  const int prep_blocks = pass_blocks(rows);
  bwd_setup_kernel<T><<<prep_blocks + a.bh * kMaxBlocks, kPassThreads, 0,
                        a.stream>>>(
      a.lse, a.delta, static_cast<const T*>(a.dout),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), part, stats,
      reinterpret_cast<float4*>(dq_acc), a.sq, q_tiles, prep_blocks, rows,
      rows * DP * static_cast<int64_t>(sizeof(DqWord)) / 16,
      static_cast<int64_t>(a.sq) * a.d / 8,
      static_cast<int64_t>(a.sk) * a.d / 8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = flash_bwd_sm90_kernel<T, DP>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<k_blocks * a.bh, kBwdThreads, L::kAlloc, a.stream>>>(
      qm, km, vm, dom, stats, part, head_scale, dq_acc,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sk, a.d, q_tiles,
      k_blocks, a.sm_scale * kLog2e, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t pairs = rows * DP / 2;
  dq_convert_kernel<T, DP><<<pass_blocks(pairs), kPassThreads, 0,
                             a.stream>>>(
      reinterpret_cast<const DqPair*>(dq_acc), head_scale,
      static_cast<T*>(a.dq), a.sq, a.d, q_tiles, a.sm_scale, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_depth(const BwdArgs& a) {
  if (a.d <= 48) return launch_bwd_sm90<T, 48>(a);
  if (a.d <= 64) return launch_bwd_sm90<T, 64>(a);
  if (a.d <= 80) return launch_bwd_sm90<T, 80>(a);
  return launch_bwd_sm90<T, 128>(a);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16. q, dout, dq contiguous (bh, sq, d); k,
// v, dk, dv (bh, sk, d); lse and delta (bh, sq) fp32; workspace of
// bh * ceil(sq / 64) * (128 * padded depth + 128) + 97 * bh floats (padded
// depth 48, 64, 80 or 128: the first that holds d), overwritten. Returns a
// cudaError_t.
extern "C" int cid_flash_attention_backward_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    void* workspace, int bh, int sq, int sk, int d, float sm_scale,
    int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      (dtype != 1 && dtype != 2) || !(sm_scale > 0.0f) ||
      static_cast<int64_t>(sk + kBwdBlockK - 1) / kBwdBlockK * bh >
          INT32_MAX ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
      !aligned16(workspace) || lse == nullptr || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q,  k,  v,  dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), dq, dk, dv,
            static_cast<float*>(workspace), bh, sq, sk, d, sm_scale,
            static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? launch_depth<__nv_bfloat16>(a)
                    : launch_depth<__half>(a);
}
