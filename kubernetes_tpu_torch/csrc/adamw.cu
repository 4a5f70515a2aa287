// AdamW's update of many leaves in one pass over device memory.
//
// Replaces no TPU kernel: the JAX package leaves AdamW (optax.adamw) to
// XLA, which fuses it into one loop. The port's plain version is a chain
// of torch._foreach_* passes (workloads/adamw.py, adamw_plain), a dozen
// reads and writes of f32 temporaries per parameter plus the gradients'
// f32 cast and the cast back to the bf16 params. This kernel is that
// chain's arithmetic, element by element in f32, in one launch per 64
// leaves:
//
//   mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
//   p -= lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd p)
//
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t, in the foreach chain's order
// of operations and with its roundings on the card, so that the two agree
// bit for bit there. Two instances, by the dtypes:
// - bf16 gradient, f32 master, mu and nu updated in place, and the bf16
//   param written from the new master, rounded to nearest even (what
//   p.copy_(master) gives);
// - f32 gradient, the f32 param its own master, mu and nu in place.
//
// Bound: bytes. Each parameter moves the gradient in, the master, mu and
// nu in and out, and the bf16 param out: 28 bytes (f32: 4 + 24), for some
// 20 f32 operations, far below the ~295 operations per byte where an H100
// stops waiting on its 3.35 TB/s. So the design is about bytes in flight:
// - 16-byte accesses: a thread moves 4 elements at a time, a float4 of the
//   master, mu and nu, 8 bytes of bf16 gradient (or a float4 of f32) and 8
//   bytes of bf16 param; two such vectors in flight, 112 bytes of loads a
//   thread, some 100 KB an SM at the occupancy 256-thread blocks of under
//   64 registers allow, well over what HBM3's latency asks (Little's law:
//   ~20-40 KB an SM).
// - Streaming hints (__ldcs, __stcs): nothing is read again, so nothing
//   should push other data out of the caches.
// - Multi-tensor launch: a table of up to 64 leaves (pointers, lengths)
//   goes in the kernel's parameters (3.4 KB of the 4 KB they may hold), a
//   launch for each 64 leaves of the list;
//   the grid runs over (leaf, chunk) pairs, 16384 elements a chunk, and a
//   block finds its leaf by a binary search over the table's prefix sums
//   of chunks (uniform in the block, 6 reads of the constant bank). A
//   model of 150 leaves and 1.9 G parameters takes 3 launches, where the
//   foreach chain took a dozen per 24-odd leaves and a cast per leaf.
// - Alignment: a leaf whose master, mu, nu, gradient and output are 16-,
//   16-, 16-, 8- (f32: 16-) and 8-byte aligned at one element index takes
//   the vector path from there; the few elements before it (the head,
//   fewer than 4) are done by the leaf's first block and the ragged tail by
//   its last, one element a thread. A leaf that no index aligns (views at
//   different offsets) runs whole on single elements. Every contiguous
//   leaf is taken.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Elements a vector carries; vectors a thread has in flight; passes of
// the block over its chunk.
constexpr int kPer = 4;
constexpr int kUnroll = 2;
constexpr int kPasses = 8;
constexpr int64_t kChunkVectors =
    static_cast<int64_t>(kThreads) * kUnroll * kPasses;
constexpr int64_t kChunk = kChunkVectors * kPer;
// Leaves a launch takes.
constexpr int kLeaves = 64;

struct Leaf {
  const void* g;
  float* p;
  float* mu;
  float* nu;
  uint16_t* out;  // bf16, or null
  int64_t n;
};

// start[i]: the first block of leaf i; start[count]: the grid's size.
struct Table {
  Leaf leaf[kLeaves];
  int start[kLeaves + 1];
  int count;
};

// Each factor once, in f32, as the foreach chain takes its Python floats:
// 1 - b1, 1 - b2 and the reciprocals of the bias corrections are
// computed on the host in double and rounded once.
struct Hyper {
  float neg_lr, b1, omb1, b2, omb2, eps, wd, rbc1, rbc2;
};

// Each rounding spelled out, as PyTorch's foreach kernels round on the
// card: a product by a scalar, then `a + alpha * b` as one fma (and
// addcmul's `a + value * (b * c)`); a division by a scalar as the product
// by its reciprocal (rounded once from double), a division of two leaves
// and the square root to nearest.
__device__ __forceinline__ void adamw(float g, float& p, float& m, float& v,
                                      const Hyper& h) {
  m = __fmaf_rn(h.omb1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.rbc2)), h.eps);
  const float u = __fmaf_rn(h.wd, p, __fdiv_rn(__fmul_rn(m, h.rbc1), den));
  p = __fmaf_rn(h.neg_lr, u, p);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint16_t round_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two bf16 in one 32-bit word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return round_bf16(a) | (static_cast<uint32_t>(round_bf16(b)) << 16);
}

// The gradient: its element as f32, and the vector of kPer elements.
__device__ __forceinline__ float widen(float g) { return g; }
__device__ __forceinline__ float widen(uint16_t g) {
  return __uint_as_float(static_cast<uint32_t>(g) << 16);
}

template <typename G>
struct GradVector;

template <>
struct GradVector<float> {
  using type = float4;
  static __device__ __forceinline__ void unpack(float4 v, float (&g)[kPer]) {
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  }
};

// Four bf16 in two 32-bit words, element 0 in the low half of x.
template <>
struct GradVector<uint16_t> {
  using type = uint2;
  static __device__ __forceinline__ void unpack(uint2 v, float (&g)[kPer]) {
    g[0] = __uint_as_float(v.x << 16);
    g[1] = __uint_as_float(v.x & 0xffff0000u);
    g[2] = __uint_as_float(v.y << 16);
    g[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

template <typename G, bool kOut>
__device__ __forceinline__ void one(const G* g, float* p, float* mu, float* nu,
                                    uint16_t* out, int64_t i, const Hyper& h) {
  float pp = __ldcs(p + i), m = __ldcs(mu + i), v = __ldcs(nu + i);
  adamw(widen(__ldcs(g + i)), pp, m, v, h);
  __stcs(p + i, pp);
  __stcs(mu + i, m);
  __stcs(nu + i, v);
  if (kOut) __stcs(out + i, round_bf16(pp));
}

template <typename G, bool kOut>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table table, const Hyper h) {
  using GV = typename GradVector<G>::type;
  const int b = blockIdx.x;
  int lo = 0, hi = table.count - 1;  // the last leaf that starts at b or before
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& leaf = table.leaf[lo];
  const G* g = static_cast<const G*>(leaf.g);
  float* p = leaf.p;
  float* mu = leaf.mu;
  float* nu = leaf.nu;
  uint16_t* out = leaf.out;
  const int64_t n = leaf.n;
  const int64_t chunk = b - table.start[lo];
  const bool last = b + 1 == table.start[lo + 1];

  // The first element at which the master is 16-byte aligned, and whether
  // every other array is aligned for its vector there too.
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
  const int64_t head = ((16 - pa % 16) % 16) / sizeof(float);
  const bool vec =
      pa % sizeof(float) == 0 && head <= n &&
      reinterpret_cast<uintptr_t>(mu + head) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(nu + head) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g + head) % sizeof(GV) == 0 &&
      (!kOut || reinterpret_cast<uintptr_t>(out + head) % 8 == 0);
  if (!vec) {
    const int64_t end = min64(n, (chunk + 1) * kChunk);
    for (int64_t i = chunk * kChunk + threadIdx.x; i < end; i += kThreads) {
      one<G, kOut>(g, p, mu, nu, out, i, h);
    }
    return;
  }
  const int64_t nv = (n - head) / kPer;
  const int64_t tail = head + nv * kPer;
  if (chunk == 0 && threadIdx.x < head) {
    one<G, kOut>(g, p, mu, nu, out, threadIdx.x, h);
  }
  if (last && tail + threadIdx.x < n) {
    one<G, kOut>(g, p, mu, nu, out, tail + threadIdx.x, h);
  }
  float4* pv = reinterpret_cast<float4*>(p + head);
  float4* mv = reinterpret_cast<float4*>(mu + head);
  float4* vv = reinterpret_cast<float4*>(nu + head);
  const GV* gv = reinterpret_cast<const GV*>(g + head);
  uint2* ov = kOut ? reinterpret_cast<uint2*>(out + head) : nullptr;
  const int64_t end = min64(nv, (chunk + 1) * kChunkVectors);
  for (int64_t base = chunk * kChunkVectors + threadIdx.x; base < end;
       base += kThreads * kUnroll) {
    float4 P[kUnroll], M[kUnroll], V[kUnroll];
    GV G4[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < end) {
        P[u] = __ldcs(pv + i);
        M[u] = __ldcs(mv + i);
        V[u] = __ldcs(vv + i);
        G4[u] = __ldcs(gv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < end) {
        float gr[kPer];
        GradVector<G>::unpack(G4[u], gr);
        adamw(gr[0], P[u].x, M[u].x, V[u].x, h);
        adamw(gr[1], P[u].y, M[u].y, V[u].y, h);
        adamw(gr[2], P[u].z, M[u].z, V[u].z, h);
        adamw(gr[3], P[u].w, M[u].w, V[u].w, h);
        __stcs(pv + i, P[u]);
        __stcs(mv + i, M[u]);
        __stcs(vv + i, V[u]);
        if (kOut) {
          __stcs(ov + i, make_uint2(pack_bf16(P[u].x, P[u].y),
                                    pack_bf16(P[u].z, P[u].w)));
        }
      }
    }
  }
}

// rows: `count` (at most kLeaves) rows of six int64, (g, p, mu, nu, out,
// n) of each leaf; adds the launch, if any, to *launches.
template <typename G, bool kOut>
int launch(const int64_t* rows, int count, const Hyper& h, void* stream,
           int* launches) {
  Table table{};
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* r = rows + 6 * i;
    const int64_t n = r[5];
    if (n < 0 || r[0] == 0 || r[1] == 0 || r[2] == 0 || r[3] == 0 || (kOut && r[4] == 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    table.leaf[i] = Leaf{reinterpret_cast<const void*>(r[0]),
                         reinterpret_cast<float*>(r[1]),
                         reinterpret_cast<float*>(r[2]),
                         reinterpret_cast<float*>(r[3]),
                         reinterpret_cast<uint16_t*>(r[4]), n};
    table.start[i] = static_cast<int>(blocks);
    blocks += (n + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  table.start[count] = static_cast<int>(blocks);
  table.count = count;
  if (blocks == 0) return 0;  // nothing to update: no launch
  adamw_kernel<G, kOut><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(table, h);
  ++*launches;
  return static_cast<int>(cudaGetLastError());
}

// Every row, kLeaves to a launch; *launches the launches made.
template <typename G, bool kOut>
int launch_all(const int64_t* rows, int count, float lr, float b1, float b2,
               float eps, float wd, float omb1, float omb2, float rbc1,
               float rbc2, int device, void* stream, int* launches) {
  *launches = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const Hyper h{-lr, b1, omb1, b2, omb2, eps, wd, rbc1, rbc2};
  for (int first = 0; first < count; first += kLeaves) {
    const int part = count - first < kLeaves ? count - first : kLeaves;
    const int rc = launch<G, kOut>(rows + 6 * first, part, h, stream,
                                   launches);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

// One AdamW step of `count` leaves on `device`, each row of `rows` (g, p,
// mu, nu, out, n) contiguous arrays of n elements: bf16 g and out, f32 p,
// mu, nu. omb1 = 1 - b1, omb2 = 1 - b2, rbc1 = 1 / (1 - b1^t), rbc2 = 1 /
// (1 - b2^t). One kernel on `stream` for each kLeaves rows (none for rows
// whose every n is 0), their number in *launches; returns
// cudaGetLastError().
extern "C" int adamw_bf16(const int64_t* rows, int count, float lr, float b1,
                          float b2, float eps, float wd, float omb1, float omb2,
                          float rbc1, float rbc2, int device, void* stream,
                          int* launches) {
  return launch_all<uint16_t, true>(rows, count, lr, b1, b2, eps, wd, omb1,
                                    omb2, rbc1, rbc2, device, stream,
                                    launches);
}

// The same with f32 g and no out: p is the param itself.
extern "C" int adamw_f32(const int64_t* rows, int count, float lr, float b1,
                         float b2, float eps, float wd, float omb1, float omb2,
                         float rbc1, float rbc2, int device, void* stream,
                         int* launches) {
  return launch_all<float, false>(rows, count, lr, b1, b2, eps, wd, omb1,
                                  omb2, rbc1, rbc2, device, stream, launches);
}
