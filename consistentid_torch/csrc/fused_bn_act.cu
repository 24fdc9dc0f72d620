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
//   K6: y = ((x - mean) * inv) * scale + bias in fp32, inv = rsqrt(var +
//       eps), then leaky_relu (y >= 0 ? y : y * slope), relu, silu or
//       identity, stored in x's dtype. The normalized tensor before the
//       activation is never written.
//
// What bounds them on an H100: bytes. K5 reads x once (at BiSeNet's stem,
// (16, 224, 224, 64) fp32, 205.5 MB: 61.3 us at 3.35 TB/s); K6 reads x once
// and writes y once (122.7 us). Their arithmetic is 2-6 fp32 operations per
// element, two orders of magnitude under the 67 TFLOP/s of the fp32 units.
// At the parser's (1, 256, 256, 64) the bytes take 2.5-10 us, and what a
// call costs besides them decides as much: the launch, the wait between two
// kernels, and, for a reduction, the chain of dependent steps after its
// last load. So the design keeps enough 16-byte loads in flight, never pads
// or copies x (JAX pads rows to 512 and C to 128 in device memory; here
// ragged rows and any C are masked), and makes each function one launch.
//
// Layout of a CTA (both kernels): 256 threads; C is read as vectors of VEC
// channels (16 bytes: 4 fp32 or 8 bf16/fp16 when C and the pointer allow,
// else 1), and the CV = C / VEC vectors of a row are spread over CVP lanes
// (CVP = the power of two >= CV, at most 32), so RPB = 256 / CVP rows are
// read side by side and a warp reads whole rows (or 32 vectors of one row)
// from contiguous memory. blockIdx.y walks tiles of CVP vectors when CV >
// 32. A thread keeps its channels fixed while it loads.
//
// K5, one launch, no atomics on the sums:
//   1. a persistent grid of about two CTAs an SM (at most three fit, so
//      that every cluster is resident at once), launched as thread block
//      clusters of up to 8 along the rows. CTA i sums the contiguous span
//      of rows [i * rows_per_cta, ...): a thread takes rows RPB apart, 4 in
//      flight, each added to its fp32 S and Q in row order; the CTA adds
//      its row lanes in a fixed pairwise tree (shuffles within a warp, then
//      the 8 warps through shared memory). From here the CTA works on the
//      tile's 2 * VEC * CVP values (S and Q of each channel), one a thread;
//   2. every CTA writes its values into rank 0's shared memory (DSMEM)
//      and arrives on the cluster barrier (its first phase, arrived at the
//      start, guarantees rank 0 has started); it may then leave. Rank 0
//      waits, adds the ranks' values in rank order, and writes one partial
//      row (S, Q) of the cluster's channels;
//   3. rank 0 then draws a ticket (one acq_rel atomicAdd on a counter per
//      channel tile, after a barrier). The cluster that draws the last
//      ticket sums each value over the partial rows: up to 32 lanes of one
//      warp, lane f taking rows f, f + lanes, ... in order, 16 in flight,
//      then a pairwise tree by shuffles; it writes mean and var with JAX's
//      formula, each operation rounded on its own, and sets the counter
//      back to 0. A grid of one cluster skips the partial row and the
//      ticket (the same bits: the last cluster would add its values to
//      zeros).
// Every sum is taken in an order fixed by the shape and the launch (never
// by which CTA finishes first), so a call is bit-for-bit repeatable and
// `moments_in_kernel_order` (consistentid_torch/testing.py) gives the same
// bits in plain torch. The counters live in a workspace the caller zeroes
// once; the kernel leaves them zeroed. What is left above the bytes at the
// parser's shape is that chain after the last load: the CTA's tree, the
// cluster barrier, the partial row's stores, the ticket's round trip, the
// last cluster's loads and the final stores (PERF.md, section 6).
//
// K6, one launch: each thread computes inv = rsqrtf(var + eps) for its
// channels once, in its prologue (no separate kernels for it), then
// streams rows, 4 in flight (8 for 16-bit x). Its grid holds at most 8 CTAs an SM, the
// fewest that take the row groups in as few grid-stride rounds (no CTA
// takes more than one group above another). Launched with programmatic
// dependent launch (`pdl`, in fused_bn_act and sync_batch_norm_act), it
// may start while the kernel before it ends: K5 lets its dependents launch
// once its partial rows are written, and K6 issues its first loads of x
// (which the kernel just before it never writes), then waits
// (griddepcontrol.wait) before it reads anything else, mean and var above
// all. Its launch, set-up and first loads so overlap K5's last cluster.
//
// C interface: cid_bn_moments(...) (K5) and cid_bn_apply(...) (K6) launch on
// the given stream and return the launch's cudaError_t (0 on success). They
// allocate nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMomentRows = 4;   // K5: rows a thread keeps in flight
constexpr int kFinalRows = 16;   // K5: partial rows a lane of the last
                                 // cluster keeps in flight
constexpr int kMaxCluster = 8;   // the portable cluster size

// channels of T in one 16-byte load
template <typename T>
constexpr int kWide = static_cast<int>(16 / sizeof(T));
// K6: rows a thread keeps in flight (16-bit rows take half the registers)
template <typename T>
constexpr int kApplyRows = sizeof(T) == 4 ? 4 : 8;

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

// VEC elements of T as loaded (16 bytes, one load, when VEC * sizeof(T) ==
// 16): the kernels keep rows of them in flight and convert each element to
// fp32 only where they use it, so a bf16 row takes 4 registers, not 8.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Packet {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Packet<T, VEC> load_packet(
    const T* __restrict__ p) {
  Packet<T, VEC> out;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(&out) =
        __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.e[i] = p[i];
  }
  return out;
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

// Programmatic dependent launch (PTX griddepcontrol): both are no-ops for a
// grid launched without it.
__device__ __forceinline__ void wait_for_prior_grids() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ------------------------------------------------------------------- K5

// The cluster barrier in two halves (PTX barrier.cluster): a CTA arrives,
// may work on, and waits for the others' arrivals later.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A tile's sums as values: value k of the 2 * VEC * CVP is S (h = 0) or Q
// (h = 1) of channel i of the channel vector in lane l, with h = k / (VEC *
// CVP), i = (k / CVP) % VEC, l = k % CVP. After the CTA's loads K5 works on
// values, one a thread (two when there are 512), so that the tail of the
// reduction is spread over the CTA's threads.
struct Value {
  int h, i, l;
};
template <int VEC>
__device__ __forceinline__ Value value_of(int k, int cvp) {
  return Value{k / (VEC * cvp), (k / cvp) % VEC, k % cvp};
}

// The CTA's sums s, q (each thread's, VEC channels) added over its RPB row
// lanes in a fixed pairwise tree: lane l adds lane l + stride for l a
// multiple of 2 * stride, stride = 1, 2, ... RPB / 2. The strides within a
// warp (W = 32 / CVP row lanes) go by shuffles; the 8 warps' sums then meet
// through shared memory, where the thread of value k adds them in the same
// pairs. Returns value k's sum (k = t, and t + 256 in `second`).
template <int VEC>
__device__ __forceinline__ void tree_over_row_lanes(
    float (&s)[VEC], float (&q)[VEC], float (&warp_sums)[2][VEC][kWarps][32],
    int t, int cvp, float (&out)[2]) {
  for (int stride = cvp; stride < 32; stride *= 2) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = __fadd_rn(s[i], __shfl_down_sync(0xffffffffu, s[i], stride));
      q[i] = __fadd_rn(q[i], __shfl_down_sync(0xffffffffu, q[i], stride));
    }
  }
  const int warp = t / 32;
  const int lane = t % 32;
  if (lane < cvp) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      warp_sums[0][i][warp][lane] = s[i];
      warp_sums[1][i][warp][lane] = q[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int k = t + n * kThreads;
    if (k < 2 * VEC * cvp) {
      const Value v = value_of<VEC>(k, cvp);
      float w[kWarps];
#pragma unroll
      for (int j = 0; j < kWarps; ++j) w[j] = warp_sums[v.h][v.i][j][v.l];
#pragma unroll
      for (int stride = 1; stride < kWarps; stride *= 2) {
#pragma unroll
        for (int j = 0; j < kWarps; j += 2 * stride) {
          w[j] = __fadd_rn(w[j], w[j + stride]);
        }
      }
      out[n] = w[0];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
bn_moments_kernel(const T* __restrict__ x, float* __restrict__ psum,
                  float* __restrict__ psq, unsigned int* __restrict__ tickets,
                  float* __restrict__ mean, float* __restrict__ var,
                  int64_t rows, int c, int cvp, int64_t rows_per_cta,
                  int cluster_size, int final_lanes) {
  __shared__ float warp_sums[2][VEC][kWarps][32];
  __shared__ float slots[kMaxCluster][2][VEC][32];   // rank 0's: each rank's
  __shared__ float sums[2][VEC][32];                 // the tile's S and Q
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  // the barrier's first phase: every CTA of the cluster has started before
  // any writes into rank 0's shared memory
  cluster_arrive_relaxed();
  const int t = threadIdx.x;
  const int lane_c = t % cvp;
  const int lane_r = t / cvp;
  const int rpb = kThreads / cvp;
  const int cvs = c / VEC;
  const int cv = blockIdx.y * cvp + lane_c;
  const bool active = cv < cvs;
  const int n_values = 2 * VEC * cvp;

  // 1. this CTA's span of rows, each thread in row order, kMomentRows in
  // flight
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t end = r0 + rows_per_cta;
  const int64_t r1 = end < rows ? end : rows;
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (active) {
    const T* base = x + static_cast<int64_t>(cv) * VEC;
    for (int64_t r = r0 + lane_r; r < r1; r += kMomentRows * rpb) {
      Packet<T, VEC> v[kMomentRows];
#pragma unroll
      for (int u = 0; u < kMomentRows; ++u) {
        if (r + u * rpb < r1) {
          v[u] = load_packet<T, VEC>(base + (r + u * rpb) * c);
        }
      }
#pragma unroll
      for (int u = 0; u < kMomentRows; ++u) {
        if (r + u * rpb < r1) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float a = to_f(v[u].e[i]);
            s[i] = __fadd_rn(s[i], a);
            q[i] = __fadd_rn(q[i], __fmul_rn(a, a));
          }
        }
      }
    }
  }
  float val[2];
  tree_over_row_lanes<VEC>(s, q, warp_sums, t, cvp, val);

  // 2. each CTA puts its values into rank 0's slot of its rank (DSMEM);
  // rank 0 adds the slots in rank order
  const unsigned int rank = cluster.block_rank();
  cluster_wait();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int k = t + n * kThreads;
    if (k < n_values) {
      const Value v = value_of<VEC>(k, cvp);
      *cluster.map_shared_rank(&slots[rank][v.h][v.i][v.l], 0) = val[n];
    }
  }
  cluster_arrive_release();
  if (rank != 0) {   // nothing reads this CTA's shared memory: it may leave
    let_dependents_launch();
    return;
  }
  cluster_wait();
  const int64_t cluster_id = blockIdx.x / cluster_size;
  const unsigned int n_clusters = gridDim.x / cluster_size;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int k = t + n * kThreads;
    if (k < n_values) {
      const Value v = value_of<VEC>(k, cvp);
      float acc = slots[0][v.h][v.i][v.l];
      for (int r = 1; r < cluster_size; ++r) {
        acc = __fadd_rn(acc, slots[r][v.h][v.i][v.l]);
      }
      const int cvk = blockIdx.y * cvp + v.l;
      if (n_clusters == 1) {
        sums[v.h][v.i][v.l] = acc;
      } else if (cvk < cvs) {   // the cluster's partial row
        (v.h == 0 ? psum : psq)[cluster_id * c + cvk * VEC + v.i] = acc;
      }
    }
  }
  let_dependents_launch();

  if (n_clusters > 1) {
    // 3. the ticket (its atomic releases the CTA's partial row, and
    // acquires the others'): the last cluster of this channel tile sums
    // the partial rows, value k over `final_lanes` lanes, lane f taking
    // rows f, f + final_lanes, ... in order, then a pairwise tree (lane f
    // adds lane f + stride for f a multiple of 2 * stride)
    __syncthreads();
    if (t == 0) {
      unsigned int ticket;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                   : "=r"(ticket) : "l"(&tickets[blockIdx.y]) : "memory");
      last = ticket == n_clusters - 1;
    }
    __syncthreads();
    if (!last) return;
    // value k's lanes are neighbouring threads, t = k * final_lanes + f
    // (final_lanes <= 32: one warp), so their tree goes by shuffles
    for (int t0 = 0; t0 < n_values * final_lanes; t0 += kThreads) {
      const int k = (t0 + t) / final_lanes;
      const int f = (t0 + t) % final_lanes;
      float acc = 0.f;
      if (k < n_values) {
        const Value v = value_of<VEC>(k, cvp);
        const int cvk = blockIdx.y * cvp + v.l;
        const float* p = (v.h == 0 ? psum : psq) + cvk * VEC + v.i;
        if (cvk < cvs) {
          for (int64_t j = f; j < n_clusters;
               j += kFinalRows * final_lanes) {
            float a[kFinalRows];
#pragma unroll
            for (int u = 0; u < kFinalRows; ++u) {
              if (j + u * final_lanes < n_clusters) {
                a[u] = __ldcg(p + (j + u * final_lanes) * c);
              }
            }
#pragma unroll
            for (int u = 0; u < kFinalRows; ++u) {
              if (j + u * final_lanes < n_clusters) acc = __fadd_rn(acc, a[u]);
            }
          }
        }
      }
      for (int stride = 1; stride < final_lanes; stride *= 2) {
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, stride));
      }
      if (k < n_values && f == 0) {
        const Value v = value_of<VEC>(k, cvp);
        sums[v.h][v.i][v.l] = acc;
      }
    }
    if (t == 0) tickets[blockIdx.y] = 0u;
  }
  // (one cluster: its sums are the tile's, the bits the last cluster
  // would give, adding them to zeros)
  __syncthreads();
  if (t < cvp && active) {
    const float n = static_cast<float>(rows);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // JAX's formula, each operation rounded on its own (no FMA)
      const float m = __fdiv_rn(sums[0][i][t], n);
      mean[cv * VEC + i] = m;
      var[cv * VEC + i] =
          __fsub_rn(__fdiv_rn(sums[1][i][t], n), __fmul_rn(m, m));
    }
  }
}

// ------------------------------------------------------------------- K6

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
                const float* __restrict__ var, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out,
                int64_t rows, int c, int cvp, float eps, float slope) {
  const int lane_c = threadIdx.x % cvp;
  const int lane_r = threadIdx.x / cvp;
  const int rpb = kThreads / cvp;
  const int cv = blockIdx.y * cvp + lane_c;
  const int c0 = cv * VEC;
  const bool active = cv < c / VEC;
  const int64_t group = static_cast<int64_t>(rpb) * kApplyRows<T>;
  const int64_t step = static_cast<int64_t>(gridDim.x) * group;
  int64_t r = static_cast<int64_t>(blockIdx.x) * group + lane_r;
  // The first rows' loads go out before the wait: x is never written by
  // the kernel just before K6 (K5, or the wrapper's conversions of the
  // statistics), so under programmatic dependent launch they overlap K5's
  // end. Nothing else (mean and var above all) is read before the wait.
  Packet<T, VEC> v[kApplyRows<T>];
#pragma unroll
  for (int u = 0; u < kApplyRows<T>; ++u) {
    if (active && r + u * rpb < rows) {
      v[u] = load_packet<T, VEC>(x + (r + u * rpb) * c + c0);
    }
  }
  wait_for_prior_grids();
  if (!active) return;
  float m[VEC], iv[VEC], sc[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = mean[c0 + i];
    iv[i] = rsqrtf(__fadd_rn(var[c0 + i], eps));
    sc[i] = scale[c0 + i];
    b[i] = bias[c0 + i];
  }
  for (; r < rows; r += step) {
#pragma unroll
    for (int u = 0; u < kApplyRows<T>; ++u) {
      if (r + u * rpb < rows) {
        float y[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // JAX's order of operations, each rounded on its own
          y[i] = activate<ACT>(
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(v[u].e[i]), m[i]),
                                            iv[i]),
                                  sc[i]),
                        b[i]),
              slope);
        }
        store_vec<T, VEC>(out + (r + u * rpb) * c + c0, y);
      }
    }
#pragma unroll
    for (int u = 0; u < kApplyRows<T>; ++u) {   // the next rows
      if (r + step + u * rpb < rows) {
        v[u] = load_packet<T, VEC>(x + (r + step + u * rpb) * c + c0);
      }
    }
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

// One launch through cudaLaunchKernelEx: as a grid of clusters of
// `cluster` CTAs along x (0: no cluster attribute), and with programmatic
// stream serialization when `pdl`.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int cluster,
                   bool pdl, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attrs[2];
  unsigned int n = 0;
  if (cluster > 0) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int VEC>
cudaError_t moments_typed(const void* x, float* psum, float* psq,
                          unsigned int* tickets, float* mean, float* var,
                          int64_t rows, int c, int cvp, int64_t rows_per_cta,
                          int ctas, int cluster, int final_lanes,
                          cudaStream_t s) {
  return launch(bn_moments_kernel<T, VEC>, dim3(ctas, c_tiles(c, VEC, cvp)),
                cluster, false, s, static_cast<const T*>(x), psum, psq,
                tickets, mean, var, rows, c, cvp, rows_per_cta, cluster,
                final_lanes);
}

template <typename T>
cudaError_t moments_dispatch(int vec, const void* x, float* psum, float* psq,
                             unsigned int* tickets, float* mean, float* var,
                             int64_t rows, int c, int cvp, int64_t per,
                             int ctas, int cluster, int final_lanes,
                             cudaStream_t s) {
  if (vec == 1) {
    return moments_typed<T, 1>(x, psum, psq, tickets, mean, var, rows, c,
                               cvp, per, ctas, cluster, final_lanes, s);
  }
  return moments_typed<T, kWide<T>>(x, psum, psq, tickets, mean, var, rows, c,
                                    cvp, per, ctas, cluster, final_lanes, s);
}

template <typename T, int VEC, int ACT>
cudaError_t apply_act(const void* x, const float* mean, const float* var,
                      const float* scale, const float* bias, void* out,
                      int64_t rows, int c, int cvp, int blocks, float eps,
                      float slope, bool pdl, cudaStream_t s) {
  return launch(bn_apply_kernel<T, VEC, ACT>,
                dim3(blocks, c_tiles(c, VEC, cvp)), 0, pdl, s,
                static_cast<const T*>(x), mean, var, scale, bias,
                static_cast<T*>(out), rows, c, cvp, eps, slope);
}

template <typename T, int VEC>
cudaError_t apply_typed(int act, const void* x, const float* mean,
                        const float* var, const float* scale,
                        const float* bias, void* out, int64_t rows, int c,
                        int cvp, int blocks, float eps, float slope, bool pdl,
                        cudaStream_t s) {
  switch (act) {
    case kLeakyRelu:
      return apply_act<T, VEC, kLeakyRelu>(x, mean, var, scale, bias, out,
                                           rows, c, cvp, blocks, eps, slope,
                                           pdl, s);
    case kRelu:
      return apply_act<T, VEC, kRelu>(x, mean, var, scale, bias, out, rows, c,
                                      cvp, blocks, eps, slope, pdl, s);
    case kSilu:
      return apply_act<T, VEC, kSilu>(x, mean, var, scale, bias, out, rows, c,
                                      cvp, blocks, eps, slope, pdl, s);
    default:
      return apply_act<T, VEC, kIdentity>(x, mean, var, scale, bias, out,
                                          rows, c, cvp, blocks, eps, slope,
                                          pdl, s);
  }
}

template <typename T>
cudaError_t apply_dispatch(int vec, int act, const void* x, const float* mean,
                           const float* var, const float* scale,
                           const float* bias, void* out, int64_t rows, int c,
                           int cvp, int blocks, float eps, float slope,
                           bool pdl, cudaStream_t s) {
  if (vec == 1) {
    return apply_typed<T, 1>(act, x, mean, var, scale, bias, out, rows, c,
                             cvp, blocks, eps, slope, pdl, s);
  }
  return apply_typed<T, kWide<T>>(act, x, mean, var, scale, bias, out, rows,
                                  c, cvp, blocks, eps, slope, pdl, s);
}

}  // namespace

// K5. x: contiguous (rows, c) of dtype 0 = float32, 1 = bfloat16,
// 2 = float16; psum, psq: fp32 (ctas / cluster, c) scratch, one partial row
// a cluster; tickets: uint32, one per channel tile, zero on entry (and left
// zero); mean, var: fp32 (c,). vec: channels per load (1, or 16 bytes'
// worth), cvp: vector lanes per row (see the header); CTA i sums rows
// [i * rows_per_cta, ...) (a CTA past the end sums none); ctas CTAs along
// the rows in clusters of `cluster` (1, 2, 4 or 8, dividing ctas); the last
// cluster sums each value of the partial rows over `final_lanes` lanes (a
// power of two, at most 32). Returns a cudaError_t.
extern "C" int cid_bn_moments(const void* x, void* psum, void* psq,
                              void* tickets, void* mean, void* var,
                              int64_t rows, int c, int vec, int cvp,
                              int64_t rows_per_cta, int ctas, int cluster,
                              int final_lanes, int dtype, void* stream) {
  if (!valid_layout(rows, c, vec, cvp, dtype) || rows_per_cta < 1 ||
      ctas < 1 || static_cast<int64_t>(ctas) * rows_per_cta < rows ||
      cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || ctas % cluster != 0 ||
      final_lanes < 1 || (final_lanes & (final_lanes - 1)) != 0 ||
      final_lanes > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  cudaError_t err;
  if (dtype == 0) {
    err = moments_dispatch<float>(vec, x, ps, pq, tk, m, v, rows, c, cvp,
                                  rows_per_cta, ctas, cluster, final_lanes,
                                  s);
  } else if (dtype == 1) {
    err = moments_dispatch<__nv_bfloat16>(vec, x, ps, pq, tk, m, v, rows, c,
                                          cvp, rows_per_cta, ctas, cluster,
                                          final_lanes, s);
  } else {
    err = moments_dispatch<__half>(vec, x, ps, pq, tk, m, v, rows, c, cvp,
                                   rows_per_cta, ctas, cluster, final_lanes,
                                   s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K6. x, out: contiguous (rows, c) of dtype (as K5); mean, var, scale,
// bias: fp32 (c,); inv = rsqrt(var + eps) is computed in the kernel;
// activation 0 = leaky_relu, 1 = relu, 2 = silu, 3 = identity; blocks: CTAs
// along the rows, each taking groups of rows_in_flight * 256 / cvp rows
// (a grid-stride loop covers the rest); rows_in_flight must be the
// kernel's: 4 for float32, 8 for 16-bit x. pdl != 0: launched with programmatic stream serialization.
// Returns a cudaError_t.
extern "C" int cid_bn_apply(const void* x, const void* mean, const void* var,
                            const void* scale, const void* bias, void* out,
                            int64_t rows, int c, int vec, int cvp, int blocks,
                            int rows_in_flight, int activation, float eps,
                            float slope, int dtype, int pdl, void* stream) {
  if (!valid_layout(rows, c, vec, cvp, dtype) || blocks < 1 ||
      rows_in_flight != (dtype == 0 ? 4 : 8) || activation < 0 ||
      activation > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* vr = static_cast<const float*>(var);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const bool p = pdl != 0;
  cudaError_t err;
  if (dtype == 0) {
    err = apply_dispatch<float>(vec, activation, x, m, vr, sc, b, out, rows, c,
                                cvp, blocks, eps, slope, p, s);
  } else if (dtype == 1) {
    err = apply_dispatch<__nv_bfloat16>(vec, activation, x, m, vr, sc, b, out,
                                        rows, c, cvp, blocks, eps, slope, p,
                                        s);
  } else {
    err = apply_dispatch<__half>(vec, activation, x, m, vr, sc, b, out, rows,
                                 c, cvp, blocks, eps, slope, p, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
