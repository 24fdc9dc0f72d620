// Flash-attention forward (K1) and forward with logsumexp (K2) for Hopper,
// sm_90a.
//
// K1 replaces the JAX package's Pallas TPU kernel `_flash_kernel`
// (consistentid_tpu/ops/flash_attention.py, launched by `_flash_forward`).
// K2 replaces `_flash_fwd_lse_kernel` (same file, launched by
// `_flash_forward_lse` from the custom VJP's forward `_flash_diff_fwd`).
// Same function: non-causal O = softmax(s * Q K^T) V per (batch*head), with an
// online softmax over key tiles, fp32 running max / sum / accumulator, key
// columns past the true key length masked out, output in q's dtype. K2 also
// writes the per-row logsumexp lse = m + log(l) in natural-log units, fp32,
// which the backward kernels (flash_attention_bwd.cu) recompute P from.
//
// What bounds it on an H100 at the SD1.5 shapes (bf16, (B*H, S, D) =
// (64, 4096, 40) and (64, 1024, 80) serving, (16, ...) training):
//   - exp count B*H*Sq*Sk against ~3.9 T/s of special-function throughput,
//   - 4*B*H*Sq*Sk*D tensor-core FLOPs against 989 TFLOP/s (bf16 dense),
//   - q, k, v, o (and lse) bytes against 3.35 TB/s.
// At head_dim 40 the exps weigh most (about 1.6x the FLOP time); at head_dim
// 80 FLOPs and exps are close. The bytes are an order of magnitude below
// both. So the kernel keeps every (Sq, Sk) score on chip and spends its
// effort on the MMA and exp issue rate, never on extra device-memory passes.
//
// Design (simple and right first; wgmma/TMA pipelines are later work):
//   - one CTA of 4 warps per (b*h, 64-row q tile); each warp owns 16 q rows;
//   - K/V tiles of 64 rows staged through shared memory, read from device
//     memory as they lie: (rows, d) with no padding in device memory. The
//     ragged Sq / Sk tails are bounds-masked in the kernel, head_dim is padded
//     to the MMA depth of 16 (40 -> 48) with zeros in shared memory only;
//   - bf16/fp16: mma.sync m16n8k16 with fp32 accumulate. Q fragments stay in
//     registers for the whole CTA; S = Q K^T and P V reuse the accumulator
//     layout (P is re-packed from the S accumulators, no shared-memory trip);
//     V's B fragments come from ldmatrix.trans;
//   - the softmax runs in the exp2 domain (scores pre-multiplied by log2 e);
//     K2 converts its running max back to natural-log units when it writes
//     lse. Every key tile holds at least one valid key, so the max is finite
//     and no row's lse can be NaN; rows past Sq are never stored;
//   - fp32 inputs (not on the main path): a SIMT kernel, 4 threads per q row,
//     fp32 FMAs throughout, so fp32 results keep fp32 accuracy;
//   - the padded head dim is a template parameter (48, 64, 80 and a generic
//     128 for any d <= 128); the true d is a runtime bound.
//
// C interface: cid_flash_attention_forward(...) (K1) and
// cid_flash_attention_forward_lse(...) (K2) launch on the given stream and
// return cudaGetLastError() (0 on success). They allocate nothing.

#include "flash_common.cuh"

namespace {

// ------------------------------------------ bf16 / fp16 tensor-core kernel

template <typename T, int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int d,
                     int q_tiles, float scale_log2, bool vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head_dim");
  constexpr int LD = DP + kPad;  // shared row stride (16-byte multiple)
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int NTILES = kBlockK / 8;

  __shared__ __align__(16) T ks[kBlockK * LD];
  __shared__ __align__(16) T vs[kBlockK * LD];

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const int64_t base_q = static_cast<int64_t>(bh) * sq * d;
  const int64_t base_kv = static_cast<int64_t>(bh) * sk * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row within the 8-row half
  const int c = lane & 3;   // accumulator column pair
  const int wr = warp * 16;

  // Q tile -> shared (through the K buffer) -> A fragments in registers.
  load_tile<T, kBlockQ, DP>(ks, LD, q + base_q, q0, sq, d, vec);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  load_a_frags<T, KSTEPS, LD>(qf, ks, wr, g, c);

  float acc[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;
  }
  // running max (log2 units) and partial row sums for rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.0f, l1 = 0.0f;

  const int k_tiles = (sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile (or the Q staging) fully consumed
    load_tile<T, kBlockK, DP>(ks, LD, k + base_kv, k0, sk, d, vec);
    load_tile<T, kBlockK, DP>(vs, LD, v + base_kv, k0, sk, d, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NTILES][4];
    mma_abt<T, KSTEPS, LD, NTILES>(s, qf, ks, g, c);

    // scale into log2 units, mask the key tail, row max over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * c + (e & 1);
        s[nt][e] = key < sk ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // O += P V: the S accumulators of key tiles (2j, 2j+1) are the A
    // fragment of a 16-deep k-step
    mma_pv<T, DTILES, LD, NTILES>(acc, s, vs, lane);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);

  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  if (kLse && c == 0) {
    // m is in log2 units of the scaled scores; lse in natural-log units
    float* out = lse + static_cast<int64_t>(bh) * sq;
    if (r0 < sq) out[r0] = m0 * kLn2 + logf(l0);
    if (r1 < sq) out[r1] = m1 * kLn2 + logf(l1);
  }
  // store acc / l: fold the two row scales into the accumulators first
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    acc[dn][0] /= l0;
    acc[dn][1] /= l0;
    acc[dn][2] /= l1;
    acc[dn][3] /= l1;
  }
  store_strip<T, DTILES>(o + base_q, acc, 1.0f, q0 + wr, sq, d, g, c);
}

// ------------------------------------------------------ fp32 SIMT kernel

template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int d,
                     int q_tiles, float scale_log2, bool vec) {
  constexpr int PER = DP / 4;  // columns per thread: j * 4 + t4
  __shared__ __align__(16) float ks[kF32Block * DP];
  __shared__ __align__(16) float vs[kF32Block * DP];

  const int bh = blockIdx.x / q_tiles;
  const int row = (blockIdx.x % q_tiles) * kF32Block + threadIdx.x / 4;
  const int t4 = threadIdx.x % 4;
  const int64_t base_q = static_cast<int64_t>(bh) * sq * d;
  const int64_t base_kv = static_cast<int64_t>(bh) * sk * d;

  float qr[PER], acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = j * 4 + t4;
    qr[j] = (row < sq && col < d)
                ? q[base_q + static_cast<int64_t>(row) * d + col] * scale_log2
                : 0.0f;
    acc[j] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  const int k_tiles = (sk + kF32Block - 1) / kF32Block;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kF32Block;
    __syncthreads();
    load_tile_f32<DP>(ks, k + base_kv, k0, sk, d, vec);
    load_tile_f32<DP>(vs, v + base_kv, k0, sk, d, vec);
    __syncthreads();

    float s[kF32Block];
    float mx = -INFINITY;
#pragma unroll
    for (int kj = 0; kj < kF32Block; ++kj) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        part = fmaf(qr[j], ks[kj * DP + j * 4 + t4], part);
      }
      part = quad_sum(part);
      s[kj] = (k0 + kj < sk) ? part : -INFINITY;
      mx = fmaxf(mx, s[kj]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] *= alpha;
#pragma unroll
    for (int kj = 0; kj < kF32Block; ++kj) {
      const float p = exp2f(s[kj] - mn);
      ps += p;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        acc[j] = fmaf(p, vs[kj * DP + j * 4 + t4], acc[j]);
      }
    }
    l = l * alpha + ps;
  }

  if (row < sq) {
    l = fmaxf(l, 1e-30f);
    const float inv = 1.0f / l;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int col = j * 4 + t4;
      if (col < d) {
        o[base_q + static_cast<int64_t>(row) * d + col] = acc[j] * inv;
      }
    }
    if (kLse && t4 == 0) {
      lse[static_cast<int64_t>(bh) * sq + row] = m * kLn2 + logf(l);
    }
  }
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int bh, sq, sk, d, dtype;
  float scale_log2;
  bool vec16, vec_f32;
  cudaStream_t stream;
};

template <typename T, int DP, bool kLse>
void launch_mma(const FwdArgs& a) {
  const int q_tiles = (a.sq + kBlockQ - 1) / kBlockQ;
  flash_fwd_mma_kernel<T, DP, kLse><<<q_tiles * a.bh, kThreads, 0,
                                      a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.sq, a.sk,
      a.d, q_tiles, a.scale_log2, a.vec16);
}

template <int DP, bool kLse>
void launch_f32(const FwdArgs& a) {
  const int q_tiles = (a.sq + kF32Block - 1) / kF32Block;
  flash_fwd_f32_kernel<DP, kLse><<<q_tiles * a.bh, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.sq,
      a.sk, a.d, q_tiles, a.scale_log2, a.vec_f32);
}

template <bool kLse>
struct LaunchFwd {
  template <int DP>
  static void run(const FwdArgs& a) {
    if (a.dtype == 1) {
      launch_mma<__nv_bfloat16, DP, kLse>(a);
    } else if (a.dtype == 2) {
      launch_mma<__half, DP, kLse>(a);
    } else {
      launch_f32<DP, kLse>(a);
    }
  }
};

template <int DP>
void fwd_plain(const FwdArgs& a) { LaunchFwd<false>::run<DP>(a); }
template <int DP>
void fwd_lse(const FwdArgs& a) { LaunchFwd<true>::run<DP>(a); }

int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int bh, int sq, int sk, int d, float sm_scale, int dtype,
            void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || dtype < 0 ||
      dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v);
  FwdArgs a{q, k, v, o, lse, bh, sq, sk, d, dtype, sm_scale * kLog2e,
            aligned && d % 8 == 0,   // 8 x 16-bit per uint4
            aligned && d % 4 == 0,   // 4 x fp32 per float4
            static_cast<cudaStream_t>(stream)};
  if (lse != nullptr) {
    CID_DISPATCH_HEAD_DIM(d, fwd_lse, a);
  } else {
    CID_DISPATCH_HEAD_DIM(d, fwd_plain, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Tensors are contiguous
// (bh, sq, d) for q and o, (bh, sk, d) for k and v. Returns a cudaError_t.
extern "C" int cid_flash_attention_forward(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int sq, int sk, int d,
                                           float sm_scale, int dtype,
                                           void* stream) {
  return forward(q, k, v, o, nullptr, bh, sq, sk, d, sm_scale, dtype, stream);
}

// K2: as cid_flash_attention_forward, and lse (bh, sq) fp32.
extern "C" int cid_flash_attention_forward_lse(const void* q, const void* k,
                                               const void* v, void* o,
                                               void* lse, int bh, int sq,
                                               int sk, int d, float sm_scale,
                                               int dtype, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d,
                 sm_scale, dtype, stream);
}
