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
// row, 403 MB of fp32 at level 0 with the depth padded to 48 (see below).
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
//     shared memory in accumulator order and adds it into an fp32 workspace
//     with one bulk reduce (cp.reduce.async.bulk .add.f32, done in L2). The
//     workspace holds each (b*h, q tile) as 64 x depth floats in that
//     order; a pass in this file then scales it by s, puts it back in (row,
//     column) order and casts it to q's dtype. The sums of the key blocks
//     arrive in no fixed order, so dq may differ from run to run in its
//     last bits (dk and dv do not).
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
// on the given stream (the statistics and workspace set-up, the fused
// kernel, the dq pass) and returns a cudaError_t, cudaErrorInvalidValue for
// what it does not take: dtype other than bf16 (1) or fp16 (2), d not a
// multiple of 8 in 8..128, a pointer off 16 bytes, a scale that is not
// positive. The caller allocates the fp32 workspace
// (bh * ceil(sq / 64) * (64 * padded depth + 128) floats).

#include <algorithm>

#include "sm90_common.cuh"

namespace {

constexpr int kBwdBlockQ = 64;   // q rows per tile of the ring
constexpr int kBwdBlockK = 128;  // keys per CTA: two warpgroups of 64
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

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
  static constexpr int kStatBytes = 2 * kBwdBlockQ * 4;  // lse2, delta
  static constexpr int kDsBytes = kBwdBlockK * 128;  // dS^T, keys x 64 q
  static constexpr int kDqHalfBytes = kBwdBlockQ * DP / 2 * 4;
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

// Add `bytes` of fp32 from shared memory into global memory (in L2).
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
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
// row halves each, into the staging: pair i of thread tid at 2 (128 i + tid).
template <int SKIP, int PAIRS, int N>
__device__ __forceinline__ void stage_dq(float2* stage, const float (&dq)[N],
                                         int tid) {
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int r = 2 * (i / 2 + SKIP) + i % 2;  // pair of the accumulator
    stage[128 * i + tid] = make_float2(dq[2 * r], dq[2 * r + 1]);
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
            stats + (static_cast<int64_t>(bh) * q_tiles + tile) * 2 *
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
                      float* __restrict__ dq_acc, T* __restrict__ dk,
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
  float2* const stage = reinterpret_cast<float2*>(smem + L::kDq +
                                                  wg * L::kDqHalfBytes);

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
      stage_dq<0, DP / 8>(stage, dq, tid);
    } else {
      stage_dq<L::kDqSkip, DP / 8>(stage, dq, tid);
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

// The fused kernel's inputs beside q, k, v and dO: per (b*h, q tile) the
// 64 rows' lse * log2(e) (+inf past sq, so P = 0 there) and delta (0 past
// sq); and the dq workspace set to zero.
__global__ void bwd_prep_kernel(const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ stats,
                                float4* __restrict__ dq_acc, int sq,
                                int q_tiles, int64_t rows, int64_t acc_vec4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < rows; i += stride) {
    const int64_t bh = i / (static_cast<int64_t>(q_tiles) * kBwdBlockQ);
    const int r = static_cast<int>(i % (q_tiles * kBwdBlockQ));
    const bool in = r < sq;
    const int64_t src = bh * sq + r;
    float* out = stats + (bh * q_tiles + r / kBwdBlockQ) * 2 * kBwdBlockQ +
                 r % kBwdBlockQ;
    out[0] = in ? lse[src] * kLog2e : INFINITY;
    out[kBwdBlockQ] = in ? delta[src] : 0.0f;
  }
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < acc_vec4; i += stride) {
    dq_acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// dq = s * the workspace, from its accumulator order (pair i of thread t of
// warpgroup w's half of a (b*h, q tile) block: row 16 (t / 32) + (t % 32) /
// 4 + 8 (i % 2), column w DP / 2 + 8 (i / 2) + 2 (t % 4)) to (row, column)
// order, cast to T.
template <typename T, int DP>
__global__ void dq_convert_kernel(const float2* __restrict__ acc,
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
      const float2 v = acc[p];
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

constexpr int kPassThreads = 256;

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
  // the workspace: dq partial sums, then the statistics
  const int64_t blocks = static_cast<int64_t>(a.bh) * q_tiles;
  float* dq_acc = a.workspace;
  float* stats = a.workspace + blocks * kBwdBlockQ * DP;
  const int64_t rows = blocks * kBwdBlockQ;
  bwd_prep_kernel<<<pass_blocks(rows), kPassThreads, 0, a.stream>>>(
      a.lse, a.delta, stats, reinterpret_cast<float4*>(dq_acc), a.sq, q_tiles,
      rows, rows * DP / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = flash_bwd_sm90_kernel<T, DP>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<k_blocks * a.bh, kBwdThreads, L::kAlloc, a.stream>>>(
      qm, km, vm, dom, stats, dq_acc, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sk, a.d, q_tiles, k_blocks,
      a.sm_scale * kLog2e, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t pairs = rows * DP / 2;
  dq_convert_kernel<T, DP><<<pass_blocks(pairs), kPassThreads, 0,
                             a.stream>>>(
      reinterpret_cast<const float2*>(dq_acc), static_cast<T*>(a.dq), a.sq,
      a.d, q_tiles, a.sm_scale, pairs);
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
// v, dk, dv (bh, sk, d); lse and delta (bh, sq) fp32; workspace fp32 of
// bh * ceil(sq / 64) * (64 * padded depth + 128) floats (padded depth 48,
// 64, 80 or 128: the first that holds d), overwritten. Returns a
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
