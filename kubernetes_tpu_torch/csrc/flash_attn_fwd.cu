// Causal flash-attention forward: o = softmax(q k^T / sqrt(D)) v, and the
// natural-log row sums lse = log(sum(exp(q k^T / sqrt(D)))) that the
// backward pass recomputes P from.
//
// Replaces both TPU kernels of the reference's attention:
//   - `_splash_attention` (kubernetes_tpu/workloads/lm.py:202-239), the
//     Pallas splash kernel taken when T % 1024 == 0 or T == 512;
//   - `_flash_attention` (kubernetes_tpu/workloads/lm.py:163-199), the
//     Pallas flash kernel with divisor blocks, taken for every other T.
// They compute one function; which one ran was a TPU tuning choice. Here
// one kernel takes every T.
//
// Layout: q, k, v, o are contiguous [B, H, T, D] bf16 (the reference's
// layout); lse is [B, H, T] f32. Scores, the running max and sum, and
// the output accumulator are f32; P is rounded to bf16 for the P.V
// product, as the tensor cores take it.
//
// Design. One block of four warps per (q-tile of 64 rows, head, batch);
// each warp owns 16 query rows and keeps its Q fragments and its output
// accumulator in registers. An inner loop over 64-key tiles of K and V
// (staged in shared memory) takes the place of the TPU kernel's
// sequential grid axis, with an online softmax carrying max and sum
// from tile to tile. The loop stops at the diagonal tile, so blocks
// that the causal mask hides entirely are never loaded or computed, and
// q-tiles are issued longest first so the short ones fill the tail.
// Products are `mma.sync.m16n8k16` bf16 -> f32: the S accumulator's
// register layout is the A-operand layout of the P.V product, so P
// never leaves registers. Keys and queries past T are masked, so any T
// works. D is a template parameter: 32, 64 or 128.
//
// Bound: operations. The causal work is 4 * B * H * D * T(T+1)/2 FLOPs
// against (3 + 1) * B * H * T * D * 2 bytes of q, k, v and o: at
// B4 H16 T2048 D128 that is 68.7 GFLOP, >= 69 us at 989 TFLOP/s, while
// its 67 MB take 20 us at 3.35 TB/s. The kernel is simple rather than
// fast: no wgmma, no TMA, no copy/compute overlap, no warp
// specialisation. Those are the work of a later change.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per inner-loop tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kBlockN, "the causal tile count assumes square tiles");

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 values as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int T, float scale_log2) {
  // Shared rows padded by 8 elements: 16-byte aligned and spread over
  // the banks.
  constexpr int kStride = D + 8;
  __shared__ __align__(16) uint16_t ks[kBlockN * kStride];
  __shared__ __align__(16) uint16_t vs[kBlockN * kStride];

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int64_t head = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const uint16_t* qh = q + head * T * D;
  const uint16_t* kh = k + head * T * D;
  const uint16_t* vh = v + head * T * D;
  uint16_t* oh = o + head * T * D;
  float* lseh = lse + head * T;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row within the 8-row group
  const int c = lane % 4;  // fragment column pair
  const int r0 = tile * kBlockM + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;

  // Q as A fragments, straight from device memory; rows past T are 0.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * c;
    qf[kk][0] = r0 < T ? load_pair(qh + static_cast<int64_t>(r0) * D + col) : 0u;
    qf[kk][1] = r1 < T ? load_pair(qh + static_cast<int64_t>(r1) * D + col) : 0u;
    qf[kk][2] = r0 < T ? load_pair(qh + static_cast<int64_t>(r0) * D + col + 8) : 0u;
    qf[kk][3] = r1 < T ? load_pair(qh + static_cast<int64_t>(r1) * D + col + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  // Running max (in the log2-scaled score domain) and this thread's
  // share of the running sum, for rows r0 and r1.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // Causal: keys up to this q-tile's last row, i.e. tiles 0..tile.
  for (int j = 0; j <= tile; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
#pragma unroll
    for (int i = threadIdx.x; i < kBlockN * kChunksPerRow; i += kThreads) {
      const int row = i / kChunksPerRow;
      const int col = (i % kChunksPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (n0 + row < T) {
        const int64_t off = static_cast<int64_t>(n0 + row) * D + col;
        kv = *reinterpret_cast<const uint4*>(kh + off);
        vv = *reinterpret_cast<const uint4*>(vh + off);
      }
      *reinterpret_cast<uint4*>(ks + row * kStride + col) = kv;
      *reinterpret_cast<uint4*>(vs + row * kStride + col) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = ks + (nt * 8 + g) * kStride + kk * 16 + 2 * c;
        const uint32_t bf[2] = {load_pair(kr), load_pair(kr + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // Scale into the log2 domain and mask keys after the row or past T.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = n0 + nt * 8 + 2 * c + (e & 1);
        const float x = (key > row || key >= T) ? -INFINITY : s[nt][e] * scale_log2;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    // The four lanes sharing a row hold its 64 columns between them.
    float corr[2];
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with no visible key so far keeps max -inf; exp2 of
      // (-inf - 0) is 0, never NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e / 2]);
        rowsum[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V. The S fragments of key columns 16kk..16kk+15 are the A
    // fragment of k-step kk; V's B fragment pairs two key rows.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint16_t* vc = vs + (kk * 16 + 2 * c) * kStride + dt * 8 + g;
        const uint32_t bf[2] = {
            static_cast<uint32_t>(vc[0]) | (static_cast<uint32_t>(vc[kStride]) << 16),
            static_cast<uint32_t>(vc[8 * kStride]) |
                (static_cast<uint32_t>(vc[9 * kStride]) << 16),
        };
        mma_16816(acc[dt], pa, bf);
      }
    }
  }

  // Whole-row sums, then normalise and store.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(oh + static_cast<int64_t>(r0) * D + col) =
          pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(oh + static_cast<int64_t>(r1) * D + col) =
          pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    }
  }
  if (c == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    if (r0 < T) lseh[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r1 < T) lseh[r1] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int T, float scale_log2, cudaStream_t stream) {
  const dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), T, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [B, H, T, D] bf16; lse: [B, H, T] f32.
// scale_log2 = sm_scale * log2(e).
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int T,
                                   int D, float scale_log2, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, H, T, scale_log2, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, T, scale_log2, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, T, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
