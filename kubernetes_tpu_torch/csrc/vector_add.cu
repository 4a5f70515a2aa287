// o = x + y, elementwise: the device-proof payload.
//
// Replaces the Pallas kernel `_add_kernel` launched by `vector_add`
// (kubernetes_tpu/workloads/vector_add.py:17-26), which adds two arrays
// in one block.
//
// Bound: bytes. Each element is read twice and written once (12 bytes
// per f32 element, 6 per bf16) for one addition, far below the ~295
// operations per byte where an H100 stops being limited by its 3.35 TB/s
// of device memory. The design keeps every load coalesced: a
// grid-stride loop in which neighbouring threads touch neighbouring
// elements. bf16 adds in f32 and rounds once to bf16, which is what
// PyTorch's own `x + y` does, so the two agree bit for bit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
add_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ o,
           int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    o[i] = add(x[i], y[i]);
  }
}

template <typename T>
int launch(const void* x, const void* y, void* o, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest.
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  add_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vector_add_f32(const void* x, const void* y, void* o, int64_t n,
                              void* stream) {
  return launch<float>(x, y, o, n, stream);
}

extern "C" int vector_add_bf16(const void* x, const void* y, void* o, int64_t n,
                               void* stream) {
  return launch<__nv_bfloat16>(x, y, o, n, stream);
}
