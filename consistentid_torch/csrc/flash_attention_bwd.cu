// Flash-attention backward for Hopper, sm_90a: dQ (K3) and dK/dV (K4).
//
// K3 replaces the JAX package's Pallas TPU kernel `_flash_bwd_dq_kernel`,
// K4 replaces `_flash_bwd_dkv_kernel` (consistentid_tpu/ops/flash_attention.py,
// both launched by `_flash_backward` from the custom VJP's `_flash_diff_bwd`).
// Both recompute the probabilities from the forward's logsumexp (K2), so no
// (Sq, Sk) matrix ever reaches device memory:
//   P  = exp(s * Q K^T - lse),  dP = dO V^T,  dS = P o (dP - delta),
//   K3: dQ = s * dS K                       (one CTA per 64 q rows)
//   K4: dV = P^T dO,  dK = s * dS^T Q       (one CTA per 64 key rows)
// with delta = rowsum(dO o O) in fp32, computed before the launch. Each output
// is written once by one CTA: no atomics, so the gradients are deterministic.
//
// What bounds them on an H100 at the SD1.5 training shapes (bf16, batch 2,
// (B*H, S, D) = (16, 4096, 40) and (16, 1024, 80)):
//   - K3: 6*B*H*Sq*Sk*D tensor-core FLOPs (S, dP, dQ) and B*H*Sq*Sk exps;
//   - K4: 8*B*H*Sq*Sk*D FLOPs (S, dV, dP, dK) and the same exps;
//   - the bytes (q, k, v, dO, lse, delta in; dq or dk, dv out) are two
//     orders of magnitude below.
// At head_dim 40 the exps and the FLOPs of K3 are even, K4's FLOPs weigh
// more; at head_dim 80 the FLOPs bound both. So, as in K1, every score stays
// on chip and the design spends its effort on MMA issue.
//
// Design (simple and right first; wgmma/TMA pipelines are later work):
//   - 4 warps per CTA, each owning 16 rows of the CTA's 64 (q rows in K3, key
//     rows in K4). The owned operands (Q and dO in K3, K and V in K4) stay in
//     registers as mma.sync A fragments; the streamed operands (K and V in
//     K3; Q, dO, lse and delta in K4) pass through shared memory 64 rows at a
//     time;
//   - K3 computes S and dP in C layout (S = Q K^T, dP = dO V^T, V in K's
//     place), re-packs dS as the A operand of dQ += dS K, with K's B
//     fragments from ldmatrix.trans (as V's in K1);
//   - K4 computes S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are
//     already A operands of dV += P^T dO and dK += dS^T Q, with dO's and Q's
//     B fragments from ldmatrix.trans;
//   - P and dS are rounded to the input type before their products (fp32
//     accumulate), as in any tensor-core flash backward;
//   - ragged tails: the port reads q, k, v, dO in place (the JAX package pads
//     them with zeros in HBM). Key columns past Sk get P = 0 in K3 (the -inf
//     mask of K1); q rows past Sq get P = 0 and a zero-loaded dO in K4, so
//     they add nothing; rows past the end are never stored;
//   - head_dim is padded to the MMA depth (40 -> 48) in shared memory only;
//   - fp32 inputs (not on the main path): SIMT kernels, 4 threads per owned
//     row, fp32 FMAs throughout;
//   - sm_scale is applied once, to the finished dQ and dK.
// Shared memory at head_dim 128: two 64 x 136 16-bit tiles (34 KB) plus 512
// bytes of lse/delta, inside the 48 KB static limit.
//
// C interface: cid_flash_attention_backward_dq(...) (K3) and
// cid_flash_attention_backward_dkv(...) (K4) launch on the given stream and
// return cudaGetLastError() (0 on success). They allocate nothing.

#include "flash_common.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int bh, sq, sk, d, dtype;
  float sm_scale, scale_log2;
  bool vec16, vec_f32;
  cudaStream_t stream;
};

// --------------------------------------------------- K3, tensor cores: dQ

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int d, int q_tiles, float sm_scale,
                        float scale_log2, bool vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head_dim");
  constexpr int LD = DP + kPad;
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
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wr = warp * 16;

  // Q and dO tiles -> shared (through the K and V buffers) -> A fragments.
  load_tile<T, kBlockQ, DP>(ks, LD, q + base_q, q0, sq, d, vec);
  load_tile<T, kBlockQ, DP>(vs, LD, dout + base_q, q0, sq, d, vec);
  __syncthreads();
  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  load_a_frags<T, KSTEPS, LD>(qf, ks, wr, g, c);
  load_a_frags<T, KSTEPS, LD>(dof, vs, wr, g, c);

  // lse (log2 units) and delta of rows g and g + 8; rows past sq are never
  // stored, zeros keep their arithmetic finite
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * sq;
  const float lse0 = r0 < sq ? lse_bh[r0] * kLog2e : 0.0f;
  const float lse1 = r1 < sq ? lse_bh[r1] * kLog2e : 0.0f;
  const float dl0 = r0 < sq ? delta_bh[r0] : 0.0f;
  const float dl1 = r1 < sq ? delta_bh[r1] : 0.0f;

  float acc[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;
  }

  const int k_tiles = (sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile (or the Q / dO staging) consumed
    load_tile<T, kBlockK, DP>(ks, LD, k + base_kv, k0, sk, d, vec);
    load_tile<T, kBlockK, DP>(vs, LD, v + base_kv, k0, sk, d, vec);
    __syncthreads();

    float s[NTILES][4], dp[NTILES][4];
    mma_abt<T, KSTEPS, LD, NTILES>(s, qf, ks, g, c);
    mma_abt<T, KSTEPS, LD, NTILES>(dp, dof, vs, g, c);

    // dS = P o (dP - delta), P = exp2(s * scale_log2 - lse_log2), masked
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * c + (e & 1);
        const bool hi = e >= 2;
        const float p = key < sk
            ? exp2f(s[nt][e] * scale_log2 - (hi ? lse1 : lse0)) : 0.0f;
        s[nt][e] = p * (dp[nt][e] - (hi ? dl1 : dl0));
      }
    }
    // dQ += dS K: K's B fragments from ldmatrix.trans
    mma_pv<T, DTILES, LD, NTILES>(acc, s, ks, lane);
  }
  store_strip<T, DTILES>(dq + base_q, acc, sm_scale, q0 + wr, sq, d, g, c);
}

// ----------------------------------------------- K4, tensor cores: dK, dV

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq,
                         int sk, int d, int k_tiles, float sm_scale,
                         float scale_log2, bool vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head_dim");
  constexpr int LD = DP + kPad;
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int NTILES = kBlockQ / 8;  // n-tiles over the streamed q rows

  __shared__ __align__(16) T qs[kBlockQ * LD];
  __shared__ __align__(16) T dos[kBlockQ * LD];
  __shared__ float lse_s[kBlockQ];    // log2 units
  __shared__ float delta_s[kBlockQ];

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBlockK;
  const int64_t base_q = static_cast<int64_t>(bh) * sq * d;
  const int64_t base_kv = static_cast<int64_t>(bh) * sk * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wr = warp * 16;

  // K and V tiles -> shared (through the Q and dO buffers) -> A fragments.
  load_tile<T, kBlockK, DP>(qs, LD, k + base_kv, k0, sk, d, vec);
  load_tile<T, kBlockK, DP>(dos, LD, v + base_kv, k0, sk, d, vec);
  __syncthreads();
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_a_frags<T, KSTEPS, LD>(kf, qs, wr, g, c);
  load_a_frags<T, KSTEPS, LD>(vf, dos, wr, g, c);

  float dk_acc[DTILES][4], dv_acc[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.0f;
  }

  const float* lse_bh = lse + static_cast<int64_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * sq;
  const int q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < q_tiles; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // previous tile (or the K / V staging) consumed
    load_tile<T, kBlockQ, DP>(qs, LD, q + base_q, q0, sq, d, vec);
    load_tile<T, kBlockQ, DP>(dos, LD, dout + base_q, q0, sq, d, vec);
    for (int i = threadIdx.x; i < kBlockQ; i += blockDim.x) {
      const bool in = q0 + i < sq;
      lse_s[i] = in ? lse_bh[q0 + i] * kLog2e : 0.0f;
      delta_s[i] = in ? delta_bh[q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 q rows
    float st[NTILES][4], dpt[NTILES][4];
    mma_abt<T, KSTEPS, LD, NTILES>(st, kf, qs, g, c);
    mma_abt<T, KSTEPS, LD, NTILES>(dpt, vf, dos, g, c);

    // P^T, with q columns past sq forced to 0
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * c + (e & 1);
        st[nt][e] = q0 + col < sq
            ? exp2f(st[nt][e] * scale_log2 - lse_s[col]) : 0.0f;
      }
    }
    // dV += P^T dO
    mma_pv<T, DTILES, LD, NTILES>(dv_acc, st, dos, lane);
    // dS^T = P^T o (dP^T - delta), then dK += dS^T Q
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * c + (e & 1);
        st[nt][e] *= dpt[nt][e] - delta_s[col];
      }
    }
    mma_pv<T, DTILES, LD, NTILES>(dk_acc, st, qs, lane);
  }
  store_strip<T, DTILES>(dk + base_kv, dk_acc, sm_scale, k0 + wr, sk, d, g,
                         c);
  store_strip<T, DTILES>(dv + base_kv, dv_acc, 1.0f, k0 + wr, sk, d, g, c);
}

// ------------------------------------------------ fp32 SIMT: K3 and K4

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int d,
                        int q_tiles, float sm_scale, float scale_log2,
                        bool vec) {
  constexpr int PER = DP / 4;  // columns per thread: j * 4 + t4
  __shared__ __align__(16) float ks[kF32Block * DP];
  __shared__ __align__(16) float vs[kF32Block * DP];

  const int bh = blockIdx.x / q_tiles;
  const int row = (blockIdx.x % q_tiles) * kF32Block + threadIdx.x / 4;
  const int t4 = threadIdx.x % 4;
  const bool in = row < sq;
  const int64_t base_q = static_cast<int64_t>(bh) * sq * d;
  const int64_t base_kv = static_cast<int64_t>(bh) * sk * d;
  const int64_t row_off = base_q + static_cast<int64_t>(row) * d;

  float qr[PER], dor[PER], acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = j * 4 + t4;
    const bool ok = in && col < d;
    qr[j] = ok ? q[row_off + col] * scale_log2 : 0.0f;
    dor[j] = ok ? dout[row_off + col] : 0.0f;
    acc[j] = 0.0f;
  }
  const int64_t stat = static_cast<int64_t>(bh) * sq + row;
  const float lse2 = in ? lse[stat] * kLog2e : 0.0f;
  const float dl = in ? delta[stat] : 0.0f;

  const int k_tiles = (sk + kF32Block - 1) / kF32Block;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kF32Block;
    __syncthreads();
    load_tile_f32<DP>(ks, k + base_kv, k0, sk, d, vec);
    load_tile_f32<DP>(vs, v + base_kv, k0, sk, d, vec);
    __syncthreads();
#pragma unroll 4
    for (int kj = 0; kj < kF32Block; ++kj) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        s = fmaf(qr[j], ks[kj * DP + j * 4 + t4], s);
        dp = fmaf(dor[j], vs[kj * DP + j * 4 + t4], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float p = k0 + kj < sk ? exp2f(s - lse2) : 0.0f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        acc[j] = fmaf(ds, ks[kj * DP + j * 4 + t4], acc[j]);
      }
    }
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int col = j * 4 + t4;
      if (col < d) dq[row_off + col] = acc[j] * sm_scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int d, int k_tiles, float sm_scale,
                         float scale_log2, bool vec) {
  constexpr int PER = DP / 4;
  __shared__ __align__(16) float qs[kF32Block * DP];
  __shared__ __align__(16) float dos[kF32Block * DP];
  __shared__ float lse_s[kF32Block];
  __shared__ float delta_s[kF32Block];

  const int bh = blockIdx.x / k_tiles;
  const int key = (blockIdx.x % k_tiles) * kF32Block + threadIdx.x / 4;
  const int t4 = threadIdx.x % 4;
  const bool in = key < sk;
  const int64_t base_q = static_cast<int64_t>(bh) * sq * d;
  const int64_t base_kv = static_cast<int64_t>(bh) * sk * d;
  const int64_t key_off = base_kv + static_cast<int64_t>(key) * d;

  float kr[PER], vr[PER], dk_acc[PER], dv_acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = j * 4 + t4;
    const bool ok = in && col < d;
    kr[j] = ok ? k[key_off + col] * scale_log2 : 0.0f;
    vr[j] = ok ? v[key_off + col] : 0.0f;
    dk_acc[j] = dv_acc[j] = 0.0f;
  }

  const float* lse_bh = lse + static_cast<int64_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * sq;
  const int q_tiles = (sq + kF32Block - 1) / kF32Block;
  for (int qt = 0; qt < q_tiles; ++qt) {
    const int q0 = qt * kF32Block;
    __syncthreads();
    load_tile_f32<DP>(qs, q + base_q, q0, sq, d, vec);
    load_tile_f32<DP>(dos, dout + base_q, q0, sq, d, vec);
    if (threadIdx.x < kF32Block) {
      const int i = threadIdx.x;
      const bool qin = q0 + i < sq;
      lse_s[i] = qin ? lse_bh[q0 + i] * kLog2e : 0.0f;
      delta_s[i] = qin ? delta_bh[q0 + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int qi = 0; qi < kF32Block; ++qi) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        s = fmaf(kr[j], qs[qi * DP + j * 4 + t4], s);
        dp = fmaf(vr[j], dos[qi * DP + j * 4 + t4], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float p = q0 + qi < sq ? exp2f(s - lse_s[qi]) : 0.0f;
      const float ds = p * (dp - delta_s[qi]);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        dv_acc[j] = fmaf(p, dos[qi * DP + j * 4 + t4], dv_acc[j]);
        dk_acc[j] = fmaf(ds, qs[qi * DP + j * 4 + t4], dk_acc[j]);
      }
    }
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int col = j * 4 + t4;
      if (col < d) {
        dk[key_off + col] = dk_acc[j] * sm_scale;
        dv[key_off + col] = dv_acc[j];
      }
    }
  }
}

// ------------------------------------------------------------- launches

template <typename T, int DP>
void launch_dq_mma(const BwdArgs& a) {
  const int q_tiles = (a.sq + kBlockQ - 1) / kBlockQ;
  flash_bwd_dq_mma_kernel<T, DP><<<q_tiles * a.bh, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.sq, a.sk, a.d, q_tiles, a.sm_scale,
      a.scale_log2, a.vec16);
}

template <typename T, int DP>
void launch_dkv_mma(const BwdArgs& a) {
  const int k_tiles = (a.sk + kBlockK - 1) / kBlockK;
  flash_bwd_dkv_mma_kernel<T, DP><<<k_tiles * a.bh, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.d,
      k_tiles, a.sm_scale, a.scale_log2, a.vec16);
}

template <int DP>
void dq_dispatch(const BwdArgs& a) {
  if (a.dtype == 1) {
    launch_dq_mma<__nv_bfloat16, DP>(a);
  } else if (a.dtype == 2) {
    launch_dq_mma<__half, DP>(a);
  } else {
    const int q_tiles = (a.sq + kF32Block - 1) / kF32Block;
    flash_bwd_dq_f32_kernel<DP><<<q_tiles * a.bh, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk, a.d, q_tiles,
        a.sm_scale, a.scale_log2, a.vec_f32);
  }
}

template <int DP>
void dkv_dispatch(const BwdArgs& a) {
  if (a.dtype == 1) {
    launch_dkv_mma<__nv_bfloat16, DP>(a);
  } else if (a.dtype == 2) {
    launch_dkv_mma<__half, DP>(a);
  } else {
    const int k_tiles = (a.sk + kF32Block - 1) / kF32Block;
    flash_bwd_dkv_f32_kernel<DP><<<k_tiles * a.bh, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.sq, a.sk, a.d, k_tiles, a.sm_scale, a.scale_log2, a.vec_f32);
  }
}

bool valid(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && sq >= 1 && sk >= 1 && d >= 1 && d <= 128 && dtype >= 0 &&
         dtype <= 2;
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  int bh, int sq, int sk, int d, float sm_scale, int dtype,
                  void* stream) {
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) &&
                       aligned16(dout);
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, nullptr, nullptr,
            bh, sq, sk, d, dtype, sm_scale, sm_scale * kLog2e,
            aligned && d % 8 == 0, aligned && d % 4 == 0,
            static_cast<cudaStream_t>(stream)};
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, dout and dq are
// contiguous (bh, sq, d); k, v, dk, dv (bh, sk, d); lse and delta (bh, sq)
// fp32. Outputs are in the input dtype. Each returns a cudaError_t.
extern "C" int cid_flash_attention_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int d, float sm_scale, int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a = make_args(q, k, v, dout, lse, delta, bh, sq, sk, d, sm_scale,
                        dtype, stream);
  a.dq = dq;
  CID_DISPATCH_HEAD_DIM(d, dq_dispatch, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cid_flash_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, float sm_scale, int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a = make_args(q, k, v, dout, lse, delta, bh, sq, sk, d, sm_scale,
                        dtype, stream);
  a.dk = dk;
  a.dv = dv;
  CID_DISPATCH_HEAD_DIM(d, dkv_dispatch, a);
  return static_cast<int>(cudaGetLastError());
}
