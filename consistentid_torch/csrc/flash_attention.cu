// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_flash_kernel`
// (consistentid_tpu/ops/flash_attention.py, launched by `_flash_forward`).
// Same function: non-causal O = softmax(s * Q K^T) V per (batch*head), with an
// online softmax over key tiles, fp32 running max / sum / accumulator, key
// columns past the true key length masked out, output in q's dtype.
//
// What bounds it on an H100 at the SD1.5 main-path shapes (bf16,
// (B*H, S, D) = (64, 4096, 40) and (64, 1024, 80)):
//   - exp count B*H*Sq*Sk against ~3.9 T/s of special-function throughput,
//   - 4*B*H*Sq*Sk*D tensor-core FLOPs against 989 TFLOP/s (bf16 dense),
//   - q, k, v, o bytes against 3.35 TB/s.
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
//   - fp32 inputs (not on the main path): a SIMT kernel, 4 threads per q row,
//     fp32 FMAs throughout, so fp32 results keep fp32 accuracy;
//   - the padded head dim is a template parameter (48, 64, 80 and a generic
//     128 for any d <= 128); the true d is a runtime bound.
//
// C interface: cid_flash_attention_forward(...) launches on the given stream
// and returns cudaGetLastError() (0 on success). It allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per CTA (tensor-core kernel)
constexpr int kBlockK = 64;    // key rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // shared-memory row padding, in elements
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- helpers

template <typename T>
struct TypeOps;

template <>
struct TypeOps<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct TypeOps<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half(x);
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem_ptr) {
  uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// Copy rows [row0, row0 + kRows) of a (seq, d) matrix into a (kRows, DP)
// shared tile of row stride `ld`, zero-filling rows past `seq` and columns
// past `d`. 16-byte vector loads when the rows allow them.
template <typename T, int kRows, int DP>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld,
                                          const T* __restrict__ src, int row0,
                                          int seq, int d, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = DP / kVec;  // chunks per padded row
    for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
      int r = i / kChunks;
      int c = (i % kChunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < seq && c < d) {
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(row0 + r) * d + c);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += blockDim.x) {
      int r = i / DP;
      int c = i % DP;
      T val = T(0.0f);
      if (row0 + r < seq && c < d) {
        val = src[static_cast<int64_t>(row0 + r) * d + c];
      }
      dst[r * ld + c] = val;
    }
  }
}

// ------------------------------------------ bf16 / fp16 tensor-core kernel

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int sk, int d, int q_tiles, float scale_log2, bool vec) {
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
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * c;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&ks[(wr + g) * LD + col]);
    qf[kk][1] =
        *reinterpret_cast<const uint32_t*>(&ks[(wr + g + 8) * LD + col]);
    qf[kk][2] =
        *reinterpret_cast<const uint32_t*>(&ks[(wr + g) * LD + col + 8]);
    qf[kk][3] =
        *reinterpret_cast<const uint32_t*>(&ks[(wr + g + 8) * LD + col + 8]);
  }

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
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const T* krow = &ks[(nt * 8 + g) * LD];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&krow[kk * 16 + 2 * c]);
        b[1] = *reinterpret_cast<const uint32_t*>(&krow[kk * 16 + 8 + 2 * c]);
        TypeOps<T>::mma(s[nt], qf[kk], b);
      }
    }

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
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
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

    // O += P V: the S accumulator layout of key tiles (2j, 2j+1) is the A
    // fragment layout of a 16-deep k-step
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      a[0] = TypeOps<T>::pack(s[2 * j][0], s[2 * j][1]);
      a[1] = TypeOps<T>::pack(s[2 * j][2], s[2 * j][3]);
      a[2] = TypeOps<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = TypeOps<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3]);
      const T* vrow = &vs[(j * 16 + (lane & 15)) * LD];
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        uint32_t b[2];
        ldmatrix_x2_trans(b[0], b[1], vrow + dn * 8);
        TypeOps<T>::mma(acc[dn], a, b);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);

  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  T* out = o + base_q;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    const int col = dn * 8 + 2 * c;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e < d) {
        if (r0 < sq) {
          out[static_cast<int64_t>(r0) * d + col + e] =
              TypeOps<T>::from_float(acc[dn][e] * inv0);
        }
        if (r1 < sq) {
          out[static_cast<int64_t>(r1) * d + col + e] =
              TypeOps<T>::from_float(acc[dn][2 + e] * inv1);
        }
      }
    }
  }
}

// ------------------------------------------------------ fp32 SIMT kernel

constexpr int kF32BlockQ = 32;   // q rows per CTA, 4 threads per row
constexpr int kF32BlockK = 32;   // key rows per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int sk, int d, int q_tiles, float scale_log2,
                     bool vec) {
  constexpr int PER = DP / 4;  // columns per thread: j * 4 + t4
  __shared__ __align__(16) float ks[kF32BlockK * DP];
  __shared__ __align__(16) float vs[kF32BlockK * DP];

  const int bh = blockIdx.x / q_tiles;
  const int row = (blockIdx.x % q_tiles) * kF32BlockQ + threadIdx.x / 4;
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

  const int k_tiles = (sk + kF32BlockK - 1) / kF32BlockK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kF32BlockK;
    __syncthreads();
    if (vec) {
      constexpr int kChunks = DP / 4;
      for (int i = threadIdx.x; i < kF32BlockK * kChunks; i += blockDim.x) {
        const int r = i / kChunks;
        const int col = (i % kChunks) * 4;
        float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vv4 = kv4;
        if (k0 + r < sk && col < d) {
          const int64_t off = base_kv + static_cast<int64_t>(k0 + r) * d + col;
          kv4 = *reinterpret_cast<const float4*>(k + off);
          vv4 = *reinterpret_cast<const float4*>(v + off);
        }
        *reinterpret_cast<float4*>(&ks[r * DP + col]) = kv4;
        *reinterpret_cast<float4*>(&vs[r * DP + col]) = vv4;
      }
    } else {
      for (int i = threadIdx.x; i < kF32BlockK * DP; i += blockDim.x) {
        const int r = i / DP;
        const int col = i % DP;
        float kv1 = 0.0f, vv1 = 0.0f;
        if (k0 + r < sk && col < d) {
          const int64_t off = base_kv + static_cast<int64_t>(k0 + r) * d + col;
          kv1 = k[off];
          vv1 = v[off];
        }
        ks[i] = kv1;
        vs[i] = vv1;
      }
    }
    __syncthreads();

    float s[kF32BlockK];
    float mx = -INFINITY;
#pragma unroll
    for (int kj = 0; kj < kF32BlockK; ++kj) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        part = fmaf(qr[j], ks[kj * DP + j * 4 + t4], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
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
    for (int kj = 0; kj < kF32BlockK; ++kj) {
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
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int col = j * 4 + t4;
      if (col < d) {
        o[base_q + static_cast<int64_t>(row) * d + col] = acc[j] * inv;
      }
    }
  }
}

template <typename T, int DP>
void launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int sk, int d, float scale_log2, bool vec,
                cudaStream_t stream) {
  const int q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  flash_fwd_mma_kernel<T, DP><<<q_tiles * bh, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, q_tiles,
      scale_log2, vec);
}

template <int DP>
void launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int sk, int d, float scale_log2, bool vec,
                cudaStream_t stream) {
  const int q_tiles = (sq + kF32BlockQ - 1) / kF32BlockQ;
  flash_fwd_f32_kernel<DP><<<q_tiles * bh, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, d,
      q_tiles, scale_log2, vec);
}

template <int DP>
void launch_dtype(int dtype, const void* q, const void* k, const void* v,
                  void* o, int bh, int sq, int sk, int d, float scale_log2,
                  bool vec16, bool vec_f32, cudaStream_t stream) {
  if (dtype == 1) {
    launch_mma<__nv_bfloat16, DP>(q, k, v, o, bh, sq, sk, d, scale_log2,
                                  vec16, stream);
  } else if (dtype == 2) {
    launch_mma<__half, DP>(q, k, v, o, bh, sq, sk, d, scale_log2, vec16,
                           stream);
  } else {
    launch_f32<DP>(q, k, v, o, bh, sq, sk, d, scale_log2, vec_f32, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Tensors are contiguous
// (bh, sq, d) for q and o, (bh, sk, d) for k and v. Returns a cudaError_t.
extern "C" int cid_flash_attention_forward(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int sq, int sk, int d,
                                           float sm_scale, int dtype,
                                           void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || dtype < 0 ||
      dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = sm_scale * kLog2e;
  const uintptr_t addr_or = reinterpret_cast<uintptr_t>(q) |
                            reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v);
  const bool aligned = (addr_or & 15u) == 0;
  const bool vec16 = aligned && d % 8 == 0;   // 8 x 16-bit per uint4
  const bool vec_f32 = aligned && d % 4 == 0;  // 4 x fp32 per float4
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 48) {
    launch_dtype<48>(dtype, q, k, v, o, bh, sq, sk, d, scale_log2, vec16,
                     vec_f32, s);
  } else if (d <= 64) {
    launch_dtype<64>(dtype, q, k, v, o, bh, sq, sk, d, scale_log2, vec16,
                     vec_f32, s);
  } else if (d <= 80) {
    launch_dtype<80>(dtype, q, k, v, o, bh, sq, sk, d, scale_log2, vec16,
                     vec_f32, s);
  } else {
    launch_dtype<128>(dtype, q, k, v, o, bh, sq, sk, d, scale_log2, vec16,
                      vec_f32, s);
  }
  return static_cast<int>(cudaGetLastError());
}
