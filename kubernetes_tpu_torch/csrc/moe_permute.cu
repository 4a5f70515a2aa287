// The MoE layer's permutation between tokens and their rows in expert
// order (workloads/moe.py: Dispatch, Combine), forward and backward.
//
// Replaces no TPU kernel: the JAX package's MoE dispatches and combines by
// dense one-hot einsums over [E, C] capacity buffers
// (kubernetes_tpu/workloads/moe.py:191,199) and has no sorted path. The
// port's plain versions (moe.gather_reduce_plain, moe.scatter_rows_plain)
// index by `pos`, sum over a token's picks in f32 and cast once; these
// kernels repeat that arithmetic in the same order.
//
// n tokens, k picks a token, R = n k rows in expert order, d columns, bf16.
// pos [k, n] (int32): the row of token t's j-th pick is pos[j, t]; every
// row is the pick of exactly one (j, t).
//
// - moe_gather_reduce: out[t] = bf16(sum_j w[r_j] rows[r_j]), r_j = pos[j,
//   t], each product and the running sum rounded to f32 in j order (no w:
//   the rows summed as they are). Combine's forward (w the sorted combine
//   weights) and Dispatch's backward (no w).
// - moe_scatter_rows: out[r_j] = src[t] (Dispatch's forward); with `scale`
//   and `rows`, out[r_j] = bf16(scale[r_j] src[t]) and dot[r_j] = sum_i
//   src[t, i] rows[r_j, i] in f32 (Combine's backward: the rows' gradient
//   and the combine weights').
//
// Bound: bytes. A call moves each of the R rows once, each token's row
// once, and 4 bytes an index or weight: at n 16384, k 4, d 2048 the gather-
// reduce 335.5 MB (0.100 ms at 3.35 TB/s), the scatter 335.5 MB, with the
// dot 604 MB (0.180 ms), for one f32 operation a byte or less. The design
// is about bytes: one block per token, which reads each row it needs once
// and writes each output once, so there are no atomics, no f32 buffer in
// device memory and no second pass; 16-byte accesses (8 bf16 a thread, a
// row of 2048 in one pass of 256 threads); the k rows of a token all in
// flight before the first is summed (64 bytes a thread at k 4, ~128 KB an
// SM at 8 blocks of 256 threads); streaming loads (__ldcs), since nothing
// is read twice. A row whose width or base does not allow 16-byte accesses
// (d not a multiple of 8, a view off alignment) runs one element a thread.
// Each dot is a block reduction in a fixed order (a thread's elements, then
// warp shuffles, then the warps in order), so the same inputs give the same
// bits on every run, where an index_add_'s atomics did not.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWarp = 32;
// Picks whose rows a thread has in flight at once; more picks a token run
// in groups of this many, in order.
constexpr int kGroup = 8;

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint16_t round_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// Two bf16 in one 32-bit word, the first in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return round_bf16(a) | (static_cast<uint32_t>(round_bf16(b)) << 16);
}

// N bf16 elements as one memory access: a 16-byte vector, or one element.
template <int N>
struct Unit;

template <>
struct Unit<8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const uint16_t* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void store(uint16_t* p, Raw v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ void widen(Raw v, float (&f)[8]) {
    f[0] = lo(v.x);
    f[1] = hi(v.x);
    f[2] = lo(v.y);
    f[3] = hi(v.y);
    f[4] = lo(v.z);
    f[5] = hi(v.z);
    f[6] = lo(v.w);
    f[7] = hi(v.w);
  }
  static __device__ __forceinline__ Raw narrow(const float (&f)[8]) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

template <>
struct Unit<1> {
  using Raw = uint16_t;
  static __device__ __forceinline__ Raw load(const uint16_t* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void store(uint16_t* p, Raw v) { *p = v; }
  static __device__ __forceinline__ void widen(Raw v, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ Raw narrow(const float (&f)[1]) {
    return round_bf16(f[0]);
  }
};

// Block t: out[t] from the rows of token t's k picks.
template <int N, bool kWeighted>
__global__ void __launch_bounds__(kMaxThreads)
moe_gather_reduce_kernel(const uint16_t* __restrict__ rows,
                         const int* __restrict__ pos,
                         const float* __restrict__ w,
                         uint16_t* __restrict__ out, int n, int k,
                         int64_t d) {
  using U = Unit<N>;
  const int64_t t = blockIdx.x;
  const int64_t units = d / N;
  for (int64_t c = threadIdx.x; c < units; c += blockDim.x) {
    float acc[N];
    for (int j0 = 0; j0 < k; j0 += kGroup) {
      typename U::Raw raw[kGroup];
      float wj[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j0 + j < k) {
          const int64_t r = pos[static_cast<int64_t>(j0 + j) * n + t];
          raw[j] = U::load(rows + r * d + c * N);
          if constexpr (kWeighted) wj[j] = w[r];
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j0 + j < k) {
          float f[N];
          U::widen(raw[j], f);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float term = kWeighted ? __fmul_rn(f[i], wj[j]) : f[i];
            acc[i] = j0 + j == 0 ? term : __fadd_rn(acc[i], term);
          }
        }
      }
    }
    U::store(out + t * d + c * N, U::narrow(acc));
  }
}

// The block's sum of each thread's v[j], j < count, into total[j] (read by
// every thread), in a fixed order: warp shuffles, then the warps in order.
__device__ __forceinline__ void block_sums(float (&v)[kGroup], int count,
                                           float (*smem)[kMaxThreads / kWarp],
                                           float (&total)[kGroup]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = (blockDim.x + kWarp - 1) / kWarp;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < count) {
      float s = v[j];
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) smem[j][warp] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < count) {
      float s = smem[j][0];
      for (int i = 1; i < warps; ++i) s += smem[j][i];
      total[j] = s;
    }
  }
  __syncthreads();  // smem free for the next group
}

// Block t: token t's row to each of its picks' rows; kWeighted, scaled,
// and each pick's dot of that row with rows[r].
template <int N, bool kWeighted>
__global__ void __launch_bounds__(kMaxThreads)
moe_scatter_rows_kernel(const uint16_t* __restrict__ src,
                        const int* __restrict__ pos,
                        const float* __restrict__ scale,
                        const uint16_t* __restrict__ rows,
                        uint16_t* __restrict__ out, float* __restrict__ dot,
                        int n, int k, int64_t d) {
  using U = Unit<N>;
  __shared__ float smem[kWeighted ? kGroup : 1][kMaxThreads / kWarp];
  const int64_t t = blockIdx.x;
  const int64_t units = d / N;
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    const int count = k - j0 < kGroup ? k - j0 : kGroup;
    int64_t r[kGroup];
    float s[kGroup], part[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < count) {
        r[j] = pos[static_cast<int64_t>(j0 + j) * n + t];
        if constexpr (kWeighted) s[j] = scale[r[j]];
        part[j] = 0.f;
      }
    }
    for (int64_t c = threadIdx.x; c < units; c += blockDim.x) {
      const typename U::Raw x = U::load(src + t * d + c * N);
      typename U::Raw other[kGroup];
      if constexpr (kWeighted) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j < count) other[j] = U::load(rows + r[j] * d + c * N);
        }
      }
      float f[N];
      U::widen(x, f);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < count) {
          if constexpr (kWeighted) {
            float g[N], o[N];
            U::widen(other[j], o);
#pragma unroll
            for (int i = 0; i < N; ++i) {
              g[i] = __fmul_rn(f[i], s[j]);
              part[j] = __fmaf_rn(f[i], o[i], part[j]);
            }
            U::store(out + r[j] * d + c * N, U::narrow(g));
          } else {
            U::store(out + r[j] * d + c * N, x);
          }
        }
      }
    }
    if constexpr (kWeighted) {
      float total[kGroup];
      block_sums(part, count, smem, total);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j < count) dot[r[j]] = total[j];
        }
      }
    }
  }
}

// Threads a block: enough for a row's units, in whole warps, at most
// kMaxThreads.
int threads_for(int64_t units) {
  const int64_t warps = (units + kWarp - 1) / kWarp;
  return static_cast<int>(warps * kWarp < kMaxThreads ? warps * kWarp
                                                      : kMaxThreads);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int check(int n, int k, int64_t d, const void* pos) {
  if (n <= 0 || k <= 0 || d <= 0 || pos == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int N, bool kWeighted>
int gather_reduce(const void* rows, const void* pos, const void* w, void* out,
                  int n, int k, int64_t d, void* stream) {
  moe_gather_reduce_kernel<N, kWeighted>
      <<<static_cast<unsigned>(n), threads_for(d / N), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(rows), static_cast<const int*>(pos),
          static_cast<const float*>(w), static_cast<uint16_t*>(out), n, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool kWeighted>
int scatter_rows(const void* src, const void* pos, const void* scale,
                 const void* rows, void* out, void* dot, int n, int k,
                 int64_t d, void* stream) {
  moe_scatter_rows_kernel<N, kWeighted>
      <<<static_cast<unsigned>(n), threads_for(d / N), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(src), static_cast<const int*>(pos),
          static_cast<const float*>(scale), static_cast<const uint16_t*>(rows),
          static_cast<uint16_t*>(out), static_cast<float*>(dot), n, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [n, d] bf16 from rows [n k, d] bf16, pos [k, n] int32 and w [n k] f32
// (or null: no weights); one kernel on `stream`. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for n, k or d under 1.
extern "C" int moe_gather_reduce(const void* rows, const void* pos,
                                 const void* w, void* out, int n, int k,
                                 int64_t d, int device, void* stream) {
  if (const int rc = check(n, k, d, pos)) return rc;
  if (rows == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const bool vec = d % 8 == 0 && aligned16(rows) && aligned16(out);
  if (vec) {
    return w ? gather_reduce<8, true>(rows, pos, w, out, n, k, d, stream)
             : gather_reduce<8, false>(rows, pos, w, out, n, k, d, stream);
  }
  return w ? gather_reduce<1, true>(rows, pos, w, out, n, k, d, stream)
           : gather_reduce<1, false>(rows, pos, w, out, n, k, d, stream);
}

// out [n k, d] bf16 from src [n, d] bf16 and pos [k, n] int32; with scale
// [n k] f32 and rows [n k, d] bf16 (both or neither) each row scaled and
// dot [n k] f32. One kernel on `stream`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for n, k or d under 1 or scale, rows and dot not
// all given or all null.
extern "C" int moe_scatter_rows(const void* src, const void* pos,
                                const void* scale, const void* rows, void* out,
                                void* dot, int n, int k, int64_t d, int device,
                                void* stream) {
  if (const int rc = check(n, k, d, pos)) return rc;
  const bool weighted = scale != nullptr;
  if (src == nullptr || out == nullptr || (rows != nullptr) != weighted ||
      (dot != nullptr) != weighted) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const bool vec = d % 8 == 0 && aligned16(src) && aligned16(rows) &&
                   aligned16(out);
  if (vec) {
    return weighted
               ? scatter_rows<8, true>(src, pos, scale, rows, out, dot, n, k,
                                       d, stream)
               : scatter_rows<8, false>(src, pos, scale, rows, out, dot, n, k,
                                        d, stream);
  }
  return weighted ? scatter_rows<1, true>(src, pos, scale, rows, out, dot, n,
                                          k, d, stream)
                  : scatter_rows<1, false>(src, pos, scale, rows, out, dot, n,
                                           k, d, stream);
}
