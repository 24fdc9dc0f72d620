// Flash-attention forward (K1) and forward with logsumexp (K2), redesigned
// for Hopper (sm_90a): wgmma for both products, a TMA-fed ring of K/V tiles
// and the softmax of one key tile under the products of the next.
//
// K1 replaces the JAX package's Pallas TPU kernel `_flash_kernel`
// (consistentid_tpu/ops/flash_attention.py:63, launched by `_flash_forward`);
// K2 replaces `_flash_fwd_lse_kernel` (same file, :234, launched by
// `_flash_forward_lse` from the custom VJP's forward). Same function as the
// mma.sync kernels in flash_attention.cu, which keep the shapes this one does
// not take: non-causal O = softmax(s Q K^T) V per (batch*head), an online
// softmax over key tiles, fp32 running max, sum and accumulator, P rounded to
// the input type before P V, keys past Sk masked, output in q's dtype; K2
// also writes lse = m + log(l) in natural-log units, fp32, from which the
// backward kernels (flash_attention_bwd.cu) recompute P.
//
// What bounds it on an H100 at the SD1.5 shapes (bf16; serving (B*H, S, D) =
// (64, 4096, 40) and (64, 1024, 80), training (16, ...)): the exps, one per
// score, at 16 per clock per SM (3.9 T/s: 0.275 ms at (64, 4096, 40)), and
// the tensor-core FLOPs, 4 * BH * Sq * Sk * depth at 989 TFLOP/s. The bytes
// (q, k, v, o once) are an order of magnitude below both.
//
// Padded depth (head_dim rounded up in shared memory only, never in device
// memory: the JAX docstring records that padding in HBM cost 33% of a UNet
// step). wgmma's k-step is 16 deep, so S = Q K^T needs a multiple of 16:
//   d = 40 -> 48: 4 * 64 * 4096^2 * 48 / 989e12 = 0.208 ms of FLOPs, under
//                 the 0.275 ms exp bound (depth 64 would cost 0.278 ms);
//   d = 80 -> 80: 0.0217 ms against 0.0172 ms of exps, FLOP-bound already;
//                 128 would cost 1.6x;
//   d = 64 -> 64, any other multiple of 8 up to 128 -> 48, 64, 80 or 128,
//   the first that holds it (only four instantiations per type, to keep the
//   build short; d = 88..128 are on no path of the models).
//
// Design, and what it answers:
//   - One CTA per (b*h, 128 q rows): two warpgroups of 64 rows (256
//     threads). A warpgroup's wgmma reads each K/V tile from shared memory
//     once for its 64 rows (the mma.sync kernel read it once per 16-row
//     warp, and shared-memory reads set its pace).
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major. O += P V is m64n{depth}k16 with P in registers: the fp32
//     accumulator layout of S is the 16-bit A-register layout, so P is
//     rounded and packed in place, no trip through shared memory. V is the B
//     operand as it lies in memory, (keys, d) with d contiguous: the
//     MN-major B, through wgmma's transpose bit.
//   - Loads: TMA (cp.async.bulk.tensor) through 3-D tensor maps (d, S, B*H),
//     one per tensor: the columns between d and the padded depth and the
//     rows past Sq or Sk of a head are zero-filled by the hardware, and no
//     tile reads the next head's rows. Boxes are one swizzle span wide: 128
//     bytes (64 columns) at depths 48, 64 and 128, 32 bytes at depth 80
//     (SmLayout). 32-byte boxes take three times the TMA requests and were
//     slower at depths 48 and 128; at depth 80, where 128-byte boxes would
//     load 128 columns for 80, they were faster at the serving shape and
//     slower at the training one; a request makes 250 launches at depth 80,
//     a train step 5 (PERF.md, scripts/flash_sm90_variants.py).
//   - Q once per CTA, K and V through a ring of 4 stages with full/empty
//     mbarriers. There is no producer warp: thread 0 fills the ring, and in
//     the loop refills the stage of tile j-1 with tile j+3 once all 8 warps
//     have released it. A producer warp would cost its registers on every
//     thread: with 288 threads, two CTAs on an SM left the consumer warps
//     too few registers; they spilled and ptxas serialised their wgmma.
//     Shared memory per CTA: 83,016 bytes at depths 48 and 64, 103,496 at
//     80, 164,936 at 128 (SmLayout::kAlloc).
//   - Overlap: within a warpgroup, S(j) = Q K(j)^T and O += P(j-1) V(j-1)
//     are issued together; the softmax of S(j) runs while P V is in flight
//     (wait_group 1), and O is rescaled after it lands (wait_group 0). At
//     depth <= 80 two CTAs fit an SM (2 x 256 threads, at most 128
//     registers each; 98-117 used), so up to four warpgroups interleave on
//     the tensor cores and the special-function units (measured no faster
//     than one CTA per SM at the models' shapes, and no slower).
//   - Softmax in the exp2 domain: p = ex2.approx.ftz(s * c - m * c), one FFMA
//     and one MUFU per score, with c = scale * log2(e) and m the running max
//     of the raw scores (so the scale must be positive; the wrapper routes
//     only such calls here). Only the last key tile, when Sk is ragged, pays
//     for the key mask. Every key tile holds a valid key, so the max is
//     finite; rows past Sq are computed on zeros and never stored.
//   - Every mbarrier wait is bounded (about 10 s of clock), then traps: a
//     phase bug becomes a launch error the wrapper raises, not a hung card.
//     The bound is kept deliberately; its cost is one clock read per failed
//     poll.
//   - The tensor-map encoder, cuTensorMapEncodeTiled, lives in libcuda, not
//     in the runtime: it is looked up once in the libcuda the process has
//     already loaded (dlopen/dlsym), so the library links only the runtime.
//   - These helpers (mbarriers, TMA loads, wgmma descriptors and wrappers,
//     the tensor-map encoder) are in sm90_common.cuh, shared with the fused
//     backward (flash_attention_bwd_sm90.cu).
//
// C interface: cid_flash_attention_forward_sm90(...) (K1) and
// cid_flash_attention_forward_lse_sm90(...) (K2), with the signatures of
// flash_attention.cu's entry points; they launch on the given stream and
// return a cudaError_t (0 on success), cudaErrorInvalidValue for what they
// do not take: dtype other than bf16 (1) or fp16 (2), d not a multiple of 8
// in 8..128, a base pointer off 16 bytes, a scale that is not positive.

#include "sm90_common.cuh"

namespace {

constexpr int kSmBlockQ = 128;        // q rows per CTA
constexpr int kSmBlockK = 64;         // keys per K/V tile
constexpr int kSmStages = 4;          // K/V ring depth
constexpr int kSmWarps = 8;           // two warpgroups
constexpr int kSmThreads = kSmWarps * 32;

// The shared-memory tiles of depth DP: the swizzle span (bytes), the boxes
// of one span's width each tile is loaded as (rows one span apart), and
// byte offsets in the CTA's dynamic shared memory (its base aligned to
// 1024). The span per depth is the one measured faster at the serving
// shapes (see the header).
template <int DP>
struct SmLayout {
  static constexpr int kSwizzle = DP == 80 ? 32 : 128;
  static constexpr int kRowBytes = kSwizzle;
  static constexpr int kBoxCols = kSwizzle / 2;  // 16-bit columns per box
  static constexpr int kBoxes = (DP + kBoxCols - 1) / kBoxCols;
  static constexpr int kQBytes = kBoxes * kSmBlockQ * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kSmBlockK * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kSmStages * kTileBytes;
  static constexpr int kBar = kV + kSmStages * kTileBytes;  // full, empty, q
  static constexpr int kBytes = kBar + (2 * kSmStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// s (64 q rows x 64 keys) = Q K^T over the padded depth, one k-step per 16
// columns. q_rows: this warpgroup's 64 rows of the Q tile.
template <typename T, int DP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_rows,
                                         uint32_t k_tile) {
  using L = SmLayout<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // the box of this k-step, and its 32-byte column step inside the box
    const int box = kk * 16 / L::kBoxCols;
    const int col = (kk * 16 % L::kBoxCols) * 2;
    wgmma_ss_n64<T>(
        s,
        gmma_desc<L::kSwizzle>(q_rows + box * kSmBlockQ * L::kRowBytes + col,
                               16, 8 * L::kRowBytes),
        gmma_desc<L::kSwizzle>(k_tile + box * kSmBlockK * L::kRowBytes + col,
                               16, 8 * L::kRowBytes),
        kk > 0);
  }
  wgmma_commit();
}

// acc (64 x DP) += P (64 x 64 keys, packed 16-bit pairs) V: one k-step per
// 16 keys; in V's tile, 8-key groups are 8 rows apart, boxes a box apart.
template <typename T, int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&p)[16],
                                         uint32_t v_tile) {
  using L = SmLayout<DP>;
#pragma unroll
  for (int kk = 0; kk < kSmBlockK / 16; ++kk) {
    wgmma_rs<T, DP>(acc, &p[4 * kk],
                    gmma_desc<L::kSwizzle>(v_tile + kk * 16 * L::kRowBytes,
                                           kSmBlockK * L::kRowBytes,
                                           8 * L::kRowBytes));
  }
  wgmma_commit();
}

// Keys at or past sk in the tile that starts at key k0: -inf. The thread
// holds, per 8-key group j, keys 8j + 2c and 8j + 2c + 1 of rows g, g + 8.
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int sk,
                                          int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k0 + 8 * j + 2 * c + e >= sk) {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
}

// Online softmax of one tile for rows g (m0, l0) and g + 8 (m1, l1): the
// running max of the raw scores, the factors alpha that rescale what came
// before, s replaced by p = 2^(s c - m c), l by l alpha + this thread's
// partial row sums. c = scale * log2(e) > 0.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1,
                                             float c) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // the first tile: m = -inf, so alpha = 2^-inf = 0 and nothing is kept
  alpha0 = ex2((m0 - mx0) * c);
  alpha1 = ex2((m1 - mx1) * c);
  m0 = mx0;
  m1 = mx1;
  const float b0 = mx0 * c, b1 = mx1 * c;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -b1));
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

// K and V tile `tile` into ring stage `st`, completion on full[st].
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        uint32_t k_s, uint32_t v_s,
                                        uint32_t full, int st, int tile,
                                        int bh) {
  using L = SmLayout<DP>;
  mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b) {
    const uint32_t off = st * L::kTileBytes + b * kSmBlockK * L::kRowBytes;
    tma_load(k_s + off, k_map, full + 8 * st, b * L::kBoxCols,
             tile * kSmBlockK, bh);
    tma_load(v_s + off, v_map, full + 8 * st, b * L::kBoxCols,
             tile * kSmBlockK, bh);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kSmThreads, DP <= 80 ? 2 : 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      T* __restrict__ o, float* __restrict__ lse, int sq,
                      int sk, int d, int q_tiles, float scale_log2) {
  using L = SmLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t full = base + L::kBar;  // full[st] at full + 8 st
  const uint32_t empty = full + 8 * kSmStages;
  const uint32_t q_bar = empty + 8 * kSmStages;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kSmBlockQ;
  const int n_tiles = (sk + kSmBlockK - 1) / kSmBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kSmStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kSmWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads Q and fills the ring; later it refills each stage once
  // all 8 warps have released it (in the loop below)
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, L::kQBytes);
    for (int b = 0; b < L::kBoxes; ++b) {
      tma_load(q_s + b * kSmBlockQ * L::kRowBytes, &q_map, q_bar,
               b * L::kBoxCols, q0, bh);
    }
    for (int j = 0; j < kSmStages && j < n_tiles; ++j) {
      load_kv<DP>(&k_map, &v_map, k_s, v_s, full, j, j, bh);
    }
  }

  // warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); in
  // the accumulators, warp w of it holds rows 16 w + g and 16 w + g + 8
  const int wg = warp / 4;
  const int g = lane >> 2;
  const int c = lane & 3;
  const uint32_t q_rows = q_s + wg * 64 * L::kRowBytes;
  const float cs = scale_log2;
  const bool ragged = sk % kSmBlockK != 0;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float s[32];
  uint32_t p[16];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float alpha0, alpha1;

  mbar_wait(q_bar, 0);
  mbar_wait(full, 0);
  wgmma_fence();
  issue_qk<T, DP>(s, q_rows, k_s);
  wgmma_wait<0>();
  fence_regs(s);
  if (n_tiles == 1 && ragged) mask_keys(s, 0, sk, c);
  softmax_tile(s, m0, m1, l0, l1, alpha0, alpha1, cs);
  pack_p<T>(p, s);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kSmStages;
    const int prev = (j - 1) % kSmStages;
    mbar_wait(full + 8 * st, (j / kSmStages) & 1);
    wgmma_fence();
    issue_qk<T, DP>(s, q_rows, k_s + st * L::kTileBytes);
    issue_pv<T, DP>(acc, p, v_s + prev * L::kTileBytes);
    wgmma_wait<1>();  // S(j) has landed; P(j-1) V(j-1) may be in flight
    fence_regs(s);
    if (j == n_tiles - 1 && ragged) mask_keys(s, j * kSmBlockK, sk, c);
    softmax_tile(s, m0, m1, l0, l1, alpha0, alpha1, cs);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(empty + 8 * prev);  // tile j-1 consumed
    // once all 8 warps have released it, tile j-1's stage takes tile
    // j-1+kSmStages
    const int next = j - 1 + kSmStages;
    if (threadIdx.x == 0 && next < n_tiles) {
      mbar_wait(empty + 8 * prev, ((j - 1) / kSmStages) & 1);
      load_kv<DP>(&k_map, &v_map, k_s, v_s, full, prev, next, bh);
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[4 * i] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }
    pack_p<T>(p, s);
  }
  wgmma_fence();
  issue_pv<T, DP>(acc, p, v_s + ((n_tiles - 1) % kSmStages) * L::kTileBytes);
  wgmma_wait<0>();
  fence_regs(acc);

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;
  const int r1 = r0 + 8;
  if (lse != nullptr && c == 0) {
    // m is the raw max; lse in natural-log units of the scaled scores
    float* out = lse + static_cast<int64_t>(bh) * sq;
    if (r0 < sq) out[r0] = m0 * cs * kLn2 + logf(l0);
    if (r1 < sq) out[r1] = m1 * cs * kLn2 + logf(l1);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  T* ob = o + static_cast<int64_t>(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (8 * i < d) {  // d is a multiple of 8
      if (r0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r0) * d +
                                     col) =
            TypeOps<T>::pack(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      }
      if (r1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r1) * d +
                                     col) =
            TypeOps<T>::pack(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
  }
}

// --------------------------------------------------------------------- host

struct SmArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, sq, sk, d;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, int DP>
int launch_sm90(const SmArgs& a) {
  using L = SmLayout<DP>;
  const int dtype = kHalf<T> ? 2 : 1;
  CUtensorMap qm, km, vm;
  if (!encode_map<L::kSwizzle>(&qm, a.q, a.bh, a.sq, a.d, kSmBlockQ, dtype) ||
      !encode_map<L::kSwizzle>(&km, a.k, a.bh, a.sk, a.d, kSmBlockK, dtype) ||
      !encode_map<L::kSwizzle>(&vm, a.v, a.bh, a.sk, a.d, kSmBlockK, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (a.sq + kSmBlockQ - 1) / kSmBlockQ;
  kernel<<<q_tiles * a.bh, kSmThreads, L::kAlloc, a.stream>>>(
      qm, km, vm, static_cast<T*>(a.o), a.lse, a.sq, a.sk, a.d, q_tiles,
      a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_depth(const SmArgs& a) {
  if (a.d <= 48) return launch_sm90<T, 48>(a);
  if (a.d <= 64) return launch_sm90<T, 64>(a);
  if (a.d <= 80) return launch_sm90<T, 80>(a);
  return launch_sm90<T, 128>(a);
}

int forward_sm90(const void* q, const void* k, const void* v, void* o,
                 float* lse, int bh, int sq, int sk, int d, float sm_scale,
                 int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      (dtype != 1 && dtype != 2) || !(sm_scale > 0.0f) ||
      static_cast<int64_t>(sq + kSmBlockQ - 1) / kSmBlockQ * bh > INT32_MAX ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.bh = bh;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.scale_log2 = sm_scale * kLog2e;
  a.stream = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_depth<__nv_bfloat16>(a) : launch_depth<__half>(a);
}

}  // namespace

// K1. dtype: 1 = bfloat16, 2 = float16. Tensors are contiguous (bh, sq, d)
// for q and o, (bh, sk, d) for k and v. Returns a cudaError_t.
extern "C" int cid_flash_attention_forward_sm90(const void* q, const void* k,
                                                const void* v, void* o, int bh,
                                                int sq, int sk, int d,
                                                float sm_scale, int dtype,
                                                void* stream) {
  return forward_sm90(q, k, v, o, nullptr, bh, sq, sk, d, sm_scale, dtype,
                      stream);
}

// K2: as cid_flash_attention_forward_sm90, and lse (bh, sq) fp32.
extern "C" int cid_flash_attention_forward_lse_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, int bh,
    int sq, int sk, int d, float sm_scale, int dtype, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward_sm90(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d,
                      sm_scale, dtype, stream);
}
