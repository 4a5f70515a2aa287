// Causal flash-attention backward: dq, dk, dv given q, k, v, the
// forward's output o and its natural-log row sums lse, and the output
// gradient do. With S = q k^T, scale = 1/sqrt(D):
//
//   P     = exp(S * scale - lse)          (recomputed, never stored)
//   delta = rowsum(do * o)
//   dS    = P * (do v^T - delta)
//   dq    = scale * dS k,   dk = scale * dS^T q,   dv = P^T do
//
// Replaces the backward of both TPU attention kernels of the reference:
//   - splash's fused dq/dk/dv kernel (`use_fused_bwd_kernel=True`,
//     kubernetes_tpu/workloads/lm.py:232-236);
//   - flash's dq and dkv kernels (blocks at lm.py:193-197).
// One backward takes every T, as one forward does (flash_attn_fwd.cu).
//
// Layout: q, k, v, o, do, dq, dk, dv contiguous [B, H, T, D] bf16; lse and
// the delta scratch [B, H, T] f32. Products are `mma.sync.m16n8k16` bf16
// -> f32; scores, exponentials, dP, delta and the accumulators are f32.
// P and dS, the operands the kernel makes itself, enter the tensor cores
// as two bf16 parts, hi + lo (acc_to_a_split). Rounded once to bf16, as
// FlashAttention-2 takes them, their error over a long sum reached 2.1x
// the largest deviation of the f32 backward of the same bf16 inputs at
// T = 8192 (measured on an H100); the split keeps the kernel's deviation
// equal to that backward's for 18% more kernel time.
//
// Design (FlashAttention-2's dK/dV and dQ kernels, written from the math
// above):
//   1. delta kernel: rowsum(do * o) in f32, D/8 threads per row.
//   2. dK/dV kernel: one block of four warps per (64-key tile, head,
//      batch); each warp owns 16 keys and keeps their dK and dV
//      accumulators in registers. A loop over the q-tiles from the
//      diagonal tile to the end stages q, do, lse and delta in shared
//      memory. With keys as rows it computes S^T = K Q^T, so P^T sits in
//      the accumulator layout, which is the A-operand layout of
//      dV += P^T dO: P never goes through shared memory. Likewise
//      dP^T = V dO^T, dS^T = P^T * (dP^T - delta) and dK += dS^T Q. Each
//      q-tile is taken in two passes of 32 columns to keep S^T and dP^T
//      to 16 registers each beside the 128 of the accumulators at D128;
//      K and V stay in shared memory and are read per k-step.
//   3. dQ kernel: one block per (64-query tile, head, batch); a loop over
//      the key tiles up to the diagonal computes S, P, dP = dO V^T and dS,
//      and accumulates dQ += dS K in registers. No atomics: every output
//      element has one writer, so the result is deterministic.
// Keys and queries past T are zero-filled and masked: P is 0 there, so
// rows past T add nothing to dK/dV and keys past T nothing to dQ.
//
// Bound: operations. The useful work is five causal matmuls (S, dP, dV,
// dK, dQ), 2.5x the forward's: 10 * B * H * D * T(T+1)/2 FLOPs, 171.9
// GFLOP at B4 H16 T2048 D128, >= 0.174 ms at 989 TFLOP/s, while its
// ~270 MB of bf16 tensors take 0.08 ms at 3.35 TB/s. This design
// recomputes S and dP in both kernels and takes the three products with
// P or dS twice (hi and lo): ten matmuls of the size of the five counted.
// It is simple rather than fast: no wgmma, no TMA, no copy/compute
// overlap.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 64;  // rows of a tile: keys (dK/dV) or queries (dQ)
constexpr int kWarps = 4;   // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 32;    // q columns per register pass, dK/dV kernel
constexpr float kLog2e = 1.4426950408889634f;

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

// A fragment (16 rows x 16 k) of a row-major tile in shared memory;
// `m` points at row 0, column k0 of the 16-row slab.
__device__ __forceinline__ void load_a(uint32_t* a, const uint16_t* m,
                                       int stride, int g, int c) {
  a[0] = load_pair(m + g * stride + 2 * c);
  a[1] = load_pair(m + (g + 8) * stride + 2 * c);
  a[2] = load_pair(m + g * stride + 2 * c + 8);
  a[3] = load_pair(m + (g + 8) * stride + 2 * c + 8);
}

// B fragment (16 k x 8 n) of a product with M^T, M row-major in shared
// memory: B[k][n] = M[n][k], so each register is two neighbours of one
// row. `m` points at row n0, column k0.
__device__ __forceinline__ void load_b_rows(uint32_t* b, const uint16_t* m,
                                            int stride, int g, int c) {
  b[0] = load_pair(m + g * stride + 2 * c);
  b[1] = load_pair(m + g * stride + 2 * c + 8);
}

// B fragment (16 k x 8 n) of a product with M itself: B[k][n] = M[k][n],
// so each register pairs two rows of one column. `m` points at row k0,
// column n0.
__device__ __forceinline__ void load_b_cols(uint32_t* b, const uint16_t* m,
                                            int stride, int g, int c) {
  const uint16_t* p = m + (2 * c) * stride + g;
  b[0] = static_cast<uint32_t>(p[0]) |
         (static_cast<uint32_t>(p[stride]) << 16);
  b[1] = static_cast<uint32_t>(p[8 * stride]) |
         (static_cast<uint32_t>(p[9 * stride]) << 16);
}

// The accumulators of n-tiles 2kk (`c0`) and 2kk+1 (`c1`) as the A
// fragment of k-step kk of a product that contracts over those 16
// columns, in two parts: `hi`, the values rounded to bf16, and `lo`, the
// bf16 rounding of what `hi` left out. hi + lo carries ~16 significant
// bits, so a product taken as two mma (hi, then lo) loses almost nothing
// to the bf16 operand.
__device__ __forceinline__ void acc_to_a_split(uint32_t* hi, uint32_t* lo,
                                               const float* c0,
                                               const float* c1) {
  const float v[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(v[2 * i] - hf.x, v[2 * i + 1] - hf.y);
  }
}

// Rows [row0, row0 + kBlock) of a [T, D] matrix into shared memory with
// row stride D + 8 (16-byte aligned, spread over the banks); rows past T
// are zero.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int T) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int col = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < T) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + row) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + row * (D + 8) + col) = val;
  }
}

template <int D>
constexpr int smem_bytes() {
  return 4 * kBlock * (D + 8) * 2 + 2 * kBlock * 4;
}

// delta[r] = sum_d do[r, d] * o[r, d] in f32, for rows = B * H * T rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o,
                       const uint16_t* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  constexpr int kLanes = D / 8;  // threads per row, 16 bytes each
  constexpr int kRows = kThreads / kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows +
                      threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]);
      const float2 fb = __bfloat1622float2(pb[i]);
      sum += fa.x * fb.x + fa.y * fb.y;
    }
  }
  // The kLanes threads of a row are neighbours within one warp.
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (part == 0 && row < rows) delta[row] = sum;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int T, float scale, float scale_log2) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);  // this block's keys
  uint16_t* vs = ks + kBlock * S;
  uint16_t* qs = vs + kBlock * S;  // the current q-tile
  uint16_t* dos = qs + kBlock * S;
  float* lse_s = reinterpret_cast<float*>(dos + kBlock * S);  // log2 domain
  float* delta_s = lse_s + kBlock;

  // Key tile 0 loops over every q-tile: issue the longest first.
  const int tile = blockIdx.x;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const uint16_t* qh = q + head * T * D;
  const uint16_t* kh = k + head * T * D;
  const uint16_t* vh = v + head * T * D;
  const uint16_t* doh = dout + head * T * D;
  const float* lseh = lse + head * T;
  const float* deltah = delta + head * T;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int n0 = tile * kBlock;
  const int wkey = n0 + warp * 16;  // this warp's first key
  const int key0 = wkey + g;        // this thread's two keys
  const int key1 = key0 + 8;
  const uint16_t* kw = ks + warp * 16 * S;
  const uint16_t* vw = vs + warp * 16 * S;

  load_tile<D>(ks, kh, n0, T);
  load_tile<D>(vs, vh, n0, T);

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  const int n_tiles = (T + kBlock - 1) / kBlock;
  // Causal: queries at or after this tile's first key, i.e. q-tiles
  // tile..n_tiles-1.
  for (int i = tile; i < n_tiles; ++i) {
    const int m0 = i * kBlock;
    __syncthreads();  // every warp is done with the previous q-tile
    load_tile<D>(qs, qh, m0, T);
    load_tile<D>(dos, doh, m0, T);
    if (threadIdx.x < kBlock) {
      const int r = m0 + threadIdx.x;
      lse_s[threadIdx.x] = r < T ? lseh[r] * kLog2e : 0.f;
      delta_s[threadIdx.x] = r < T ? deltah[r] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kSub) {
      // Warp-uniform skips (no barrier inside this loop): every query of
      // the pass is before this warp's first key, or past T.
      if (m0 + c0 + kSub - 1 < wkey) continue;
      if (m0 + c0 >= T) break;

      // S^T = K Q^T: this warp's 16 keys x the pass's 32 queries.
      float st[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a(a, kw + kk * 16, S, g, c);
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
          uint32_t b[2];
          load_b_rows(b, qs + (c0 + nt * 8) * S + kk * 16, S, g, c);
          mma_16816(st[nt], a, b);
        }
      }
      // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)); 0 where the
      // key is after the query or the query is past T.
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + 2 * c + (e & 1);  // within the tile
          const int qrow = m0 + col;
          const int key = e < 2 ? key0 : key1;
          st[nt][e] = (key > qrow || qrow >= T)
                          ? 0.f
                          : exp2f(st[nt][e] * scale_log2 - lse_s[col]);
        }
      }
      // dV += P^T dO, contracting over the pass's 32 queries.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t hi[4], lo[4];
        acc_to_a_split(hi, lo, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t b[2];
          load_b_cols(b, dos + (c0 + kk * 16) * S + dt * 8, S, g, c);
          mma_16816(dv_acc[dt], hi, b);
          mma_16816(dv_acc[dt], lo, b);
        }
      }
      // dP^T = V dO^T.
      float dpt[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a(a, vw + kk * 16, S, g, c);
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
          uint32_t b[2];
          load_b_rows(b, dos + (c0 + nt * 8) * S + kk * 16, S, g, c);
          mma_16816(dpt[nt], a, b);
        }
      }
      // dS^T = P^T * (dP^T - delta), in place of dP^T.
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + 2 * c + (e & 1);
          dpt[nt][e] = st[nt][e] * (dpt[nt][e] - delta_s[col]);
        }
      }
      // dK += dS^T Q (scaled once, at the store).
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t hi[4], lo[4];
        acc_to_a_split(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t b[2];
          load_b_cols(b, qs + (c0 + kk * 16) * S + dt * 8, S, g, c);
          mma_16816(dk_acc[dt], hi, b);
          mma_16816(dk_acc[dt], lo, b);
        }
      }
    }
  }

  uint16_t* dkh = dk + head * T * D;
  uint16_t* dvh = dv + head * T * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (key0 < T) {
      const int64_t off = static_cast<int64_t>(key0) * D + col;
      *reinterpret_cast<uint32_t*>(dkh + off) =
          pack_bf16(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dvh + off) =
          pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key1 < T) {
      const int64_t off = static_cast<int64_t>(key1) * D + col;
      *reinterpret_cast<uint32_t*>(dkh + off) =
          pack_bf16(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dvh + off) =
          pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    uint16_t* __restrict__ dq,
                    int T, float scale, float scale_log2) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);  // this block's queries
  uint16_t* dos = qs + kBlock * S;
  uint16_t* ks = dos + kBlock * S;  // the current key tile
  uint16_t* vs = ks + kBlock * S;

  // Query tile i loops over key tiles 0..i: issue the longest first.
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const uint16_t* qh = q + head * T * D;
  const uint16_t* kh = k + head * T * D;
  const uint16_t* vh = v + head * T * D;
  const uint16_t* doh = dout + head * T * D;
  const float* lseh = lse + head * T;
  const float* deltah = delta + head * T;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int m0 = tile * kBlock;
  const int r0 = m0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const uint16_t* qw = qs + warp * 16 * S;
  const uint16_t* dow = dos + warp * 16 * S;

  load_tile<D>(qs, qh, m0, T);
  load_tile<D>(dos, doh, m0, T);
  const float lse2[2] = {r0 < T ? lseh[r0] * kLog2e : 0.f,
                         r1 < T ? lseh[r1] * kLog2e : 0.f};
  const float dl[2] = {r0 < T ? deltah[r0] : 0.f, r1 < T ? deltah[r1] : 0.f};

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;
  }

  for (int j = 0; j <= tile; ++j) {
    const int n0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<D>(ks, kh, n0, T);
    load_tile<D>(vs, vh, n0, T);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys.
    float s[kBlock / 8][4];
    float dp[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, qw + kk * 16, S, g, c);
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        uint32_t b[2];
        load_b_rows(b, ks + nt * 8 * S + kk * 16, S, g, c);
        mma_16816(s[nt], a, b);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, dow + kk * 16, S, g, c);
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        uint32_t b[2];
        load_b_rows(b, vs + nt * 8 * S + kk * 16, S, g, c);
        mma_16816(dp[nt], a, b);
      }
    }
    // P, masked where the key is after the row or the row is past T
    // (a key past T is after every row before T); then dS in place of dP.
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = n0 + nt * 8 + 2 * c + (e & 1);
        const float p = (key > row || row >= T)
                            ? 0.f
                            : exp2f(s[nt][e] * scale_log2 - lse2[e / 2]);
        dp[nt][e] = p * (dp[nt][e] - dl[e / 2]);
      }
    }
    // dQ += dS K (scaled once, at the store).
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b[2];
        load_b_cols(b, ks + kk * 16 * S + dt * 8, S, g, c);
        mma_16816(dq_acc[dt], hi, b);
        mma_16816(dq_acc[dt], lo, b);
      }
    }
  }

  uint16_t* dqh = dq + head * T * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dqh + static_cast<int64_t>(r0) * D + col) =
          pack_bf16(dq_acc[dt][0] * scale, dq_acc[dt][1] * scale);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(dqh + static_cast<int64_t>(r1) * D + col) =
          pack_bf16(dq_acc[dt][2] * scale, dq_acc[dt][3] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int T, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto* q16 = static_cast<const uint16_t*>(q);
  const auto* k16 = static_cast<const uint16_t*>(k);
  const auto* v16 = static_cast<const uint16_t*>(v);
  const auto* do16 = static_cast<const uint16_t*>(dout);
  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const int64_t rows = static_cast<int64_t>(B) * H * T;
  constexpr int kRowsPerBlock = kThreads / (D / 8);
  const int64_t delta_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (delta_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>(delta_blocks), kThreads,
                              0, stream>>>(
      static_cast<const uint16_t*>(o), do16, delta32, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((T + kBlock - 1) / kBlock, H, B);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      q16, k16, v16, do16, lse32, delta32, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      q16, k16, v16, do16, lse32, delta32, static_cast<uint16_t*>(dq), T,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [B, H, T, D] bf16; lse:
// [B, H, T] f32 (natural log, as flash_attn_fwd_bf16 writes it); delta:
// [B, H, T] f32 scratch. scale = 1/sqrt(D). Three launches on `stream`.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int T,
                                   int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, T,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, T,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, T,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
