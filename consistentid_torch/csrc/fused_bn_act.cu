// Fused BatchNorm + activation for Hopper, sm_90a: per-channel batch moments
// (K5) and the normalize + affine + activation pass (K6) over NHWC tensors.
//
// K5 replaces the JAX package's Pallas TPU kernel `_moments_kernel`
// (consistentid_tpu/ops/fused_bn_act.py, launched by `batch_moments`); K6
// replaces `_normalize_kernel` (same file, launched by `apply_bn_act`).
// Same functions:
//   K5: over all rows = B*H*W of an (rows, C) tensor of fp32, bf16 or fp16,
//       fp32 sums S = sum x and Q = sum x^2 per channel; then, as JAX does
//       outside its kernel, mean = S / rows and the biased
//       var = Q / rows - mean^2, unclamped;
//   K6: y = ((x - mean) * inv) * scale + bias in fp32 with inv =
//       rsqrt(var + eps) computed by the caller, then leaky_relu
//       (y >= 0 ? y : y * slope), relu, silu or identity, stored in x's
//       dtype. The normalized tensor before the activation is never written.
//
// What bounds them on an H100: bytes. K5 reads x once (at BiSeNet's stem,
// (16, 224, 224, 64) fp32, 205.5 MB: 61.3 us at 3.35 TB/s); K6 reads x once
// and writes y once (122.7 us). Their arithmetic is 2-6 fp32 operations per
// element, two orders of magnitude under the 67 TFLOP/s of the fp32 units.
// So the design spends nothing on arithmetic and everything on keeping enough
// coalesced loads in flight, and never pads or copies x (JAX pads rows to 512
// and C to 128 in device memory; here ragged rows and any C are masked in the
// kernel).
//
// Layout of a CTA (both kernels): 256 threads; C is read as vectors of VEC
// channels (16 bytes: 4 fp32 or 8 bf16/fp16 when C and the pointer allow,
// else 1), and the CV = C / VEC vectors of a row are spread over CVP lanes
// (CVP = the power of two >= CV, at most 32), so 256 / CVP rows are read side
// by side and a warp reads whole rows (or 32 vectors of one row) from
// contiguous memory. blockIdx.y walks tiles of CVP vectors when CV > 32. A
// thread keeps its channels fixed for its whole life: K6 loads its mean,
// inv, scale and bias once into registers.
//
// K5 runs in two passes, with no atomics, deterministically:
//   1. blockIdx.x is a chunk of rows_per_chunk rows. Each thread sums its
//      rows (4 rows in flight), the CTA adds its row lanes in a fixed tree in
//      shared memory, and writes fp32 partials (2, n_chunks, C);
//   2. one CTA per 8 channels, 32 lanes each: lane j adds chunks j, j+32,
//      ... in order, a fixed tree adds the lanes, and lane 0 writes mean and
//      var with JAX's formula (no Welford, no clamp).
// The chunk count (enough CTAs to fill the 132 SMs several times) is the
// caller's, who allocates the partials.
//
// C interface: cid_bn_moments(...) (K5) and cid_bn_apply(...) (K6) launch on
// the given stream and return cudaGetLastError() (0 on success). They
// allocate nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// channels of T in one 16-byte load
template <typename T>
constexpr int kWide = static_cast<int>(16 / sizeof(T));
constexpr int kFinalChannels = 8;  // pass 2: channels per CTA
constexpr int kFinalLanes = kThreads / kFinalChannels;

enum Activation { kLeakyRelu = 0, kRelu = 1, kSilu = 2, kIdentity = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements at p (16-byte aligned when VEC * sizeof(T) == 16) as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(v[i]);
  }
}

// ------------------------------------------------------ K5, pass 1: partials

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_partial_kernel(const T* __restrict__ x, float* __restrict__ psum,
                          float* __restrict__ psq, int64_t rows, int c,
                          int cvp, int64_t rows_per_chunk) {
  __shared__ float red_s[VEC][kThreads];
  __shared__ float red_q[VEC][kThreads];
  const int t = threadIdx.x;
  const int lane_c = t % cvp;
  const int lane_r = t / cvp;
  const int rpb = kThreads / cvp;
  const int cv = blockIdx.y * cvp + lane_c;
  const bool active = cv < c / VEC;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t end = r0 + rows_per_chunk;
  const int64_t r1 = end < rows ? end : rows;

  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (active) {
    const T* base = x + static_cast<int64_t>(cv) * VEC;
    int64_t r = r0 + lane_r;
    for (; r + 3 * rpb < r1; r += 4 * rpb) {  // 4 rows in flight
      float v[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_vec<T, VEC>(base + (r + u * rpb) * c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += v[u][i];
          q[i] = fmaf(v[u][i], v[u][i], q[i]);
        }
      }
    }
    for (; r < r1; r += rpb) {
      float v[VEC];
      load_vec<T, VEC>(base + r * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red_s[i][t] = s[i];
    red_q[i][t] = q[i];
  }
  __syncthreads();
  // a fixed tree over the row lanes: lane_r adds lane_r + stride
  for (int stride = rpb / 2; stride > 0; stride /= 2) {
    if (lane_r < stride) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        red_s[i][t] += red_s[i][t + stride * cvp];
        red_q[i][t] += red_q[i][t + stride * cvp];
      }
    }
    __syncthreads();
  }
  if (lane_r == 0 && active) {
    const int64_t out = static_cast<int64_t>(blockIdx.x) * c + cv * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      psum[out + i] = red_s[i][t];
      psq[out + i] = red_q[i][t];
    }
  }
}

// ---------------------------------------------- K5, pass 2: mean and var

__global__ void __launch_bounds__(kThreads)
bn_moments_final_kernel(const float* __restrict__ psum,
                        const float* __restrict__ psq, float* __restrict__ mean,
                        float* __restrict__ var, int n_chunks, int c,
                        float rows) {
  __shared__ float red_s[kFinalLanes][kFinalChannels];
  __shared__ float red_q[kFinalLanes][kFinalChannels];
  const int ci = threadIdx.x % kFinalChannels;
  const int lane = threadIdx.x / kFinalChannels;
  const int ch = blockIdx.x * kFinalChannels + ci;
  float s = 0.f, q = 0.f;
  if (ch < c) {
    int j = lane;
    for (; j + 3 * kFinalLanes < n_chunks; j += 4 * kFinalLanes) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = psum[static_cast<int64_t>(j + u * kFinalLanes) * c + ch];
        b[u] = psq[static_cast<int64_t>(j + u * kFinalLanes) * c + ch];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s += a[u];
        q += b[u];
      }
    }
    for (; j < n_chunks; j += kFinalLanes) {
      s += psum[static_cast<int64_t>(j) * c + ch];
      q += psq[static_cast<int64_t>(j) * c + ch];
    }
  }
  red_s[lane][ci] = s;
  red_q[lane][ci] = q;
  __syncthreads();
  for (int stride = kFinalLanes / 2; stride > 0; stride /= 2) {
    if (lane < stride) {
      red_s[lane][ci] += red_s[lane + stride][ci];
      red_q[lane][ci] += red_q[lane + stride][ci];
    }
    __syncthreads();
  }
  if (lane == 0 && ch < c) {
    // JAX's formula, each operation rounded on its own (no FMA contraction)
    const float m = __fdiv_rn(red_s[0][ci], rows);
    mean[ch] = m;
    var[ch] = __fsub_rn(__fdiv_rn(red_q[0][ci], rows), __fmul_rn(m, m));
  }
}

// ------------------------------------------------------ K6: normalize + act

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if constexpr (ACT == kLeakyRelu) {
    return y >= 0.f ? y : __fmul_rn(y, slope);
  } else if constexpr (ACT == kRelu) {
    return y < 0.f ? 0.f : y;
  } else if constexpr (ACT == kSilu) {
    return __fmul_rn(y, 1.f / (1.f + expf(-y)));
  } else {
    return y;
  }
}

template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out,
                int64_t rows, int c, int cvp, float slope) {
  const int lane_c = threadIdx.x % cvp;
  const int lane_r = threadIdx.x / cvp;
  const int rpb = kThreads / cvp;
  const int cv = blockIdx.y * cvp + lane_c;
  if (cv >= c / VEC) return;
  const int c0 = cv * VEC;
  float m[VEC], iv[VEC], sc[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = mean[c0 + i];
    iv[i] = inv[c0 + i];
    sc[i] = scale[c0 + i];
    b[i] = bias[c0 + i];
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * rpb;
  int64_t r = static_cast<int64_t>(blockIdx.x) * rpb + lane_r;
  for (; r + step < rows; r += 2 * step) {  // two rows in flight
    float v[2][VEC];
    load_vec<T, VEC>(x + r * c + c0, v[0]);
    load_vec<T, VEC>(x + (r + step) * c + c0, v[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // JAX's order of operations, each rounded on its own
        const float y = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[u][i], m[i]), iv[i]), sc[i]),
            b[i]);
        v[u][i] = activate<ACT>(y, slope);
      }
    }
    store_vec<T, VEC>(out + r * c + c0, v[0]);
    store_vec<T, VEC>(out + (r + step) * c + c0, v[1]);
  }
  if (r < rows) {
    float v[VEC];
    load_vec<T, VEC>(x + r * c + c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[i], m[i]), iv[i]), sc[i]), b[i]);
      v[i] = activate<ACT>(y, slope);
    }
    store_vec<T, VEC>(out + r * c + c0, v);
  }
}

// ------------------------------------------------------------------ launch

bool valid_layout(int64_t rows, int c, int vec, int cvp, int dtype) {
  if (rows < 1 || c < 1 || dtype < 0 || dtype > 2) return false;
  const int wide = dtype == 0 ? 4 : 8;  // 16 bytes of the element type
  if (vec != 1 && vec != wide) return false;
  if (c % vec != 0) return false;
  if (cvp < 1 || cvp > 32 || (cvp & (cvp - 1)) != 0) return false;
  const int cv = c / vec;
  return cv > 32 ? cvp == 32 : cvp >= cv && cvp < 2 * cv;
}

int c_tiles(int c, int vec, int cvp) { return (c / vec + cvp - 1) / cvp; }

template <typename T, int VEC>
void moments_typed(const void* x, float* psum, float* psq, float* mean,
                   float* var, int64_t rows, int c, int cvp,
                   int64_t rows_per_chunk, int n_chunks, cudaStream_t s) {
  dim3 grid(n_chunks, c_tiles(c, VEC, cvp));
  bn_moments_partial_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), psum, psq, rows, c, cvp, rows_per_chunk);
  bn_moments_final_kernel<<<(c + kFinalChannels - 1) / kFinalChannels,
                            kThreads, 0, s>>>(psum, psq, mean, var, n_chunks,
                                              c, static_cast<float>(rows));
}

template <typename T>
void moments_dispatch(int vec, const void* x, float* psum, float* psq,
                      float* mean, float* var, int64_t rows, int c, int cvp,
                      int64_t rpc, int n_chunks, cudaStream_t s) {
  if (vec == 1) {
    moments_typed<T, 1>(x, psum, psq, mean, var, rows, c, cvp, rpc, n_chunks,
                        s);
  } else {
    moments_typed<T, kWide<T>>(x, psum, psq, mean, var, rows, c, cvp, rpc,
                               n_chunks, s);
  }
}

template <typename T, int VEC>
void apply_typed(int act, const void* x, const float* mean, const float* inv,
                 const float* scale, const float* bias, void* out,
                 int64_t rows, int c, int cvp, int blocks, float slope,
                 cudaStream_t s) {
  dim3 grid(blocks, c_tiles(c, VEC, cvp));
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (act) {
    case kLeakyRelu:
      bn_apply_kernel<T, VEC, kLeakyRelu><<<grid, kThreads, 0, s>>>(
          xi, mean, inv, scale, bias, o, rows, c, cvp, slope);
      break;
    case kRelu:
      bn_apply_kernel<T, VEC, kRelu><<<grid, kThreads, 0, s>>>(
          xi, mean, inv, scale, bias, o, rows, c, cvp, slope);
      break;
    case kSilu:
      bn_apply_kernel<T, VEC, kSilu><<<grid, kThreads, 0, s>>>(
          xi, mean, inv, scale, bias, o, rows, c, cvp, slope);
      break;
    default:
      bn_apply_kernel<T, VEC, kIdentity><<<grid, kThreads, 0, s>>>(
          xi, mean, inv, scale, bias, o, rows, c, cvp, slope);
  }
}

template <typename T>
void apply_dispatch(int vec, int act, const void* x, const float* mean,
                    const float* inv, const float* scale, const float* bias,
                    void* out, int64_t rows, int c, int cvp, int blocks,
                    float slope, cudaStream_t s) {
  if (vec == 1) {
    apply_typed<T, 1>(act, x, mean, inv, scale, bias, out, rows, c, cvp,
                      blocks, slope, s);
  } else {
    apply_typed<T, kWide<T>>(act, x, mean, inv, scale, bias, out, rows, c,
                             cvp, blocks, slope, s);
  }
}

}  // namespace

// K5. x: contiguous (rows, c) of dtype 0 = float32, 1 = bfloat16,
// 2 = float16; psum, psq: fp32 (n_chunks, c) scratch; mean, var: fp32 (c,).
// vec: channels per load (1, or 16 bytes' worth), cvp: vector lanes per row
// (see the header); chunk i covers rows [i * rows_per_chunk, ...), and
// n_chunks * rows_per_chunk must cover rows. Returns a cudaError_t.
extern "C" int cid_bn_moments(const void* x, void* psum, void* psq,
                              void* mean, void* var, int64_t rows, int c,
                              int vec, int cvp, int64_t rows_per_chunk,
                              int n_chunks, int dtype, void* stream) {
  if (!valid_layout(rows, c, vec, cvp, dtype) || rows_per_chunk < 1 ||
      n_chunks < 1 || (n_chunks - 1) * rows_per_chunk >= rows ||
      n_chunks * rows_per_chunk < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  if (dtype == 0) {
    moments_dispatch<float>(vec, x, ps, pq, m, v, rows, c, cvp,
                            rows_per_chunk, n_chunks, s);
  } else if (dtype == 1) {
    moments_dispatch<__nv_bfloat16>(vec, x, ps, pq, m, v, rows, c, cvp,
                                    rows_per_chunk, n_chunks, s);
  } else {
    moments_dispatch<__half>(vec, x, ps, pq, m, v, rows, c, cvp,
                             rows_per_chunk, n_chunks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6. x, out: contiguous (rows, c) of dtype (as K5); mean, inv, scale, bias:
// fp32 (c,); activation 0 = leaky_relu, 1 = relu, 2 = silu, 3 = identity;
// blocks: CTAs along the rows (a grid-stride loop covers the rest).
// Returns a cudaError_t.
extern "C" int cid_bn_apply(const void* x, const void* mean, const void* inv,
                            const void* scale, const void* bias, void* out,
                            int64_t rows, int c, int vec, int cvp, int blocks,
                            int activation, float slope, int dtype,
                            void* stream) {
  if (!valid_layout(rows, c, vec, cvp, dtype) || blocks < 1 ||
      activation < 0 || activation > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    apply_dispatch<float>(vec, activation, x, m, iv, sc, b, out, rows, c, cvp,
                          blocks, slope, s);
  } else if (dtype == 1) {
    apply_dispatch<__nv_bfloat16>(vec, activation, x, m, iv, sc, b, out, rows,
                                  c, cvp, blocks, slope, s);
  } else {
    apply_dispatch<__half>(vec, activation, x, m, iv, sc, b, out, rows, c,
                           cvp, blocks, slope, s);
  }
  return static_cast<int>(cudaGetLastError());
}
