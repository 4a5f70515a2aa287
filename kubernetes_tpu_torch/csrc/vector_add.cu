// o = x + y, elementwise: the device-proof payload.
//
// Replaces the Pallas kernel `_add_kernel` launched by `vector_add`
// (kubernetes_tpu/workloads/vector_add.py:17-26), which adds two arrays
// in one block.
//
// Bound: bytes. Each element is read twice and written once (12 bytes
// per f32 element, 6 per bf16) for one addition, far below the ~295
// operations per byte where an H100 stops being limited by its 3.35 TB/s
// of device memory. At that rate and ~0.6-1 us of memory latency an SM
// needs some 15-25 KB of loads in flight (Little's law), so the design
// is about bytes in flight and nothing else:
// - 16-byte accesses: a thread loads a float4 (4 f32) or a uint4 (8 bf16)
//   of each operand, where one 4-byte load per element gave 4 bytes.
//   Blocks of 256 threads at no more than 32 registers fill an SM with
//   2048 threads, so 64 KB of loads are in flight per SM. Four vectors
//   per thread were measured too: no faster at 2^26 elements, slower at
//   2^16 (a quarter of the blocks, on a quarter of the SMs).
// - Streaming hints: loads by __ldcs and stores by __stcs (evict first).
//   Neither operand is read again, so neither should push other data out
//   of the caches.
// - The grid: as many blocks as the data needs, each on a contiguous
//   chunk. A grid of one wave (SM count times resident blocks, with a
//   grid-stride loop) was measured first and ran behind PyTorch's own
//   kernel at 2^26 elements, with contiguous chunks or without: the
//   hardware's block scheduler balances better than a fixed wave. The
//   payload's 2^16 f32 takes 64 blocks.
// - Alignment: the vector path only when x, y and o are all 16-byte
//   aligned. Anything else (a view at an odd offset, such as x[1:]) takes
//   the same kernel on single elements, four per thread so as to keep 16
//   bytes of each operand in flight. The ragged tail of the vector path,
//   fewer than one vector, is done in the same launch by the first
//   threads of block 0.
// bf16 adds in f32 and rounds once to bf16 (__float2bfloat16_rn), which
// is what PyTorch's own `x + y` does, so the two agree bit for bit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Blocks an SM holds at once at full occupancy (2048 threads): asks ptxas
// for at most 32 registers a thread.
constexpr int kBlocksPerSm = 2048 / kThreads;

// bf16 is carried as its 16 bits. Widening to f32 (the bits in the high
// half) is exact; the sum rounds once, to nearest even.
__device__ __forceinline__ uint32_t round_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
  return static_cast<uint16_t>(
      round_bf16(__uint_as_float(static_cast<uint32_t>(a) << 16) +
                 __uint_as_float(static_cast<uint32_t>(b) << 16)));
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Two bf16 in one 32-bit word, element 0 in the low half.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi =
      __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  return round_bf16(lo) | (round_bf16(hi) << 16);
}

__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
  return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y),
                    add_bf16x2(a.z, b.z), add_bf16x2(a.w, b.w));
}

// T: the element (float, or uint16_t for bf16). V: the unit each access
// moves, a 16-byte vector of kPer elements or the element itself. U:
// units per thread, kThreads apart in the block's chunk of kThreads * U.
template <typename T, typename V, int U>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
add_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ o,
           int64_t n) {
  constexpr int kPer = sizeof(V) / sizeof(T);
  const int64_t units = n / kPer;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* yv = reinterpret_cast<const V*>(y);
  V* ov = reinterpret_cast<V*>(o);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads * U + threadIdx.x;
  V a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = first + u * kThreads;
    if (i < units) {
      a[u] = __ldcs(xv + i);
      b[u] = __ldcs(yv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = first + u * kThreads;
    if (i < units) __stcs(ov + i, add(a[u], b[u]));
  }
  // The tail past the last whole vector: fewer than kPer elements.
  const int64_t t = units * kPer + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    __stcs(o + t, add(__ldcs(x + t), __ldcs(y + t)));
  }
}

template <typename T, typename V, int U>
int launch_as(const void* x, const void* y, void* o, int64_t n,
              cudaStream_t stream) {
  constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * U;
  constexpr int kPer = sizeof(V) / sizeof(T);
  int64_t blocks = (n / kPer + kChunk - 1) / kChunk;
  if (blocks < 1) blocks = 1;  // a tail alone
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  add_kernel<T, V, U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o),
      n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename V>
int launch(const void* x, const void* y, void* o, int64_t n, void* stream) {
  if (n == 0) return 0;  // nothing to add: no launch
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(o);
  return any % 16 == 0 ? launch_as<T, V, 1>(x, y, o, n, s)
                       : launch_as<T, T, 4>(x, y, o, n, s);
}

}  // namespace

// x, y, o: n contiguous elements each. Launches one kernel on `stream`
// (none for n = 0) and returns cudaGetLastError().
extern "C" int vector_add_f32(const void* x, const void* y, void* o, int64_t n,
                              void* stream) {
  return launch<float, float4>(x, y, o, n, stream);
}

extern "C" int vector_add_bf16(const void* x, const void* y, void* o, int64_t n,
                               void* stream) {
  return launch<uint16_t, uint4>(x, y, o, n, stream);
}
