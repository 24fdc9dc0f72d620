// Building blocks shared by the flash-attention kernels (K1, K2 in
// flash_attention.cu; K3, K4 in flash_attention_bwd.cu): tile sizes, the
// mma.sync m16n8k16 wrappers for bf16 and fp16, ldmatrix, fragment loads and
// the shared-memory tile loaders. Fragment layouts are PTX's for
// mma.m16n8k16.row.col: with g = lane / 4 and c = lane % 4,
//   A (16 x 16): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)
//   B (16 x 8):  b0 (k 2c..2c+1, n g), b1 (k 2c+8..2c+9, n g)
//   C (16 x 8):  c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// so the C layout of two adjacent n-tiles is the A layout of one 16-deep
// k-step: a product's accumulators feed the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per CTA (tensor-core kernels)
constexpr int kBlockK = 64;    // key rows per CTA or shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // shared-memory row padding, in elements
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kF32Block = 32;  // rows per CTA and per tile, fp32 SIMT kernels

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

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of the 16-row strip starting at `row` of a (rows, LD) shared
// tile, for every 16-deep k-step of the padded head dim.
template <typename T, int KSTEPS, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KSTEPS][4],
                                             const T* tile, int row, int g,
                                             int c) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * c;
    f[kk][0] = lds32(&tile[(row + g) * LD + col]);
    f[kk][1] = lds32(&tile[(row + g + 8) * LD + col]);
    f[kk][2] = lds32(&tile[(row + g) * LD + col + 8]);
    f[kk][3] = lds32(&tile[(row + g + 8) * LD + col + 8]);
  }
}

// acc[nt] (16 x 8 per n-tile) = A (16 x DP, registers) times the transpose
// of the (kBlockK, DP) row-major shared tile: X Y^T with Y's rows as the
// n index, read straight from shared memory (no transpose needed).
template <typename T, int KSTEPS, int LD, int NTILES>
__device__ __forceinline__ void mma_abt(float (&acc)[NTILES][4],
                                        const uint32_t (&a)[KSTEPS][4],
                                        const T* tile, int g, int c) {
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    const T* row = &tile[(nt * 8 + g) * LD];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t b[2];
      b[0] = lds32(&row[kk * 16 + 2 * c]);
      b[1] = lds32(&row[kk * 16 + 8 + 2 * c]);
      TypeOps<T>::mma(acc[nt], a[kk], b);
    }
  }
}

// out[dn] (16 x 8 per d-tile) += P (16 x kBlockK, given as accumulators in
// C layout, rounded to T) times the (kBlockK, DP) row-major shared tile. The
// tile's B fragments come from ldmatrix.trans.
template <typename T, int DTILES, int LD, int NTILES>
__device__ __forceinline__ void mma_pv(float (&out)[DTILES][4],
                                       const float (&p)[NTILES][4],
                                       const T* tile, int lane) {
#pragma unroll
  for (int j = 0; j < NTILES / 2; ++j) {
    uint32_t a[4];
    a[0] = TypeOps<T>::pack(p[2 * j][0], p[2 * j][1]);
    a[1] = TypeOps<T>::pack(p[2 * j][2], p[2 * j][3]);
    a[2] = TypeOps<T>::pack(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = TypeOps<T>::pack(p[2 * j + 1][2], p[2 * j + 1][3]);
    const T* row = &tile[(j * 16 + (lane & 15)) * LD];
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      uint32_t b[2];
      ldmatrix_x2_trans(b[0], b[1], row + dn * 8);
      TypeOps<T>::mma(out[dn], a, b);
    }
  }
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

// Store the 16-row strip of C-layout accumulators `acc` (scaled by `scale`)
// into rows [row, row + 16) of a (seq, d) matrix, skipping rows past `seq`
// and columns past `d`.
template <typename T, int DTILES>
__device__ __forceinline__ void store_strip(T* __restrict__ dst,
                                            const float (&acc)[DTILES][4],
                                            float scale, int row, int seq,
                                            int d, int g, int c) {
  const int r0 = row + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    const int col = dn * 8 + 2 * c;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e < d) {
        if (r0 < seq) {
          dst[static_cast<int64_t>(r0) * d + col + e] =
              TypeOps<T>::from_float(acc[dn][e] * scale);
        }
        if (r1 < seq) {
          dst[static_cast<int64_t>(r1) * d + col + e] =
              TypeOps<T>::from_float(acc[dn][2 + e] * scale);
        }
      }
    }
  }
}

// fp32 (kF32Block, DP) tile, row stride DP, zero-filled past `seq` / `d`.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int row0, int seq, int d,
                                              bool vec) {
  if (vec) {
    constexpr int kChunks = DP / 4;
    for (int i = threadIdx.x; i < kF32Block * kChunks; i += blockDim.x) {
      const int r = i / kChunks;
      const int col = (i % kChunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < seq && col < d) {
        val = *reinterpret_cast<const float4*>(
            src + static_cast<int64_t>(row0 + r) * d + col);
      }
      *reinterpret_cast<float4*>(&dst[r * DP + col]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kF32Block * DP; i += blockDim.x) {
      const int r = i / DP;
      const int col = i % DP;
      float val = 0.0f;
      if (row0 + r < seq && col < d) {
        val = src[static_cast<int64_t>(row0 + r) * d + col];
      }
      dst[i] = val;
    }
  }
}

// Sum over the 4 lanes that share a row in the fp32 kernels.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launch the template `F<DP>` for the padded head dim that holds d (<= 128).
#define CID_DISPATCH_HEAD_DIM(d, F, ...)  \
  do {                                    \
    if ((d) <= 48) {                      \
      F<48>(__VA_ARGS__);                 \
    } else if ((d) <= 64) {               \
      F<64>(__VA_ARGS__);                 \
    } else if ((d) <= 80) {               \
      F<80>(__VA_ARGS__);                 \
    } else {                              \
      F<128>(__VA_ARGS__);                \
    }                                     \
  } while (0)
