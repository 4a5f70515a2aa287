// Flash-attention backward, causal or not: dq, dk, dv given q, k, v, the
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
// The ring (workloads/ring_attention.py) launches it per block of keys
// with the whole sequence's o and lse, so that P is the global softmax
// restricted to the block and delta the global one: the causal instance
// on the diagonal block, the non-causal one for a block before it.
//
// Layout: q, k, v, o, do, dq, dk, dv contiguous [B, H, T, D] bf16 (dq,
// dk, dv f32 for the ring, which sums its blocks' gradients in f32 and
// rounds once); lse and the delta scratch [B, H, T] f32. Scores, exponentials, dP, delta and the
// accumulators are f32. P and dS, the operands the kernel makes itself,
// enter the tensor cores as two bf16 parts, hi + lo (acc_to_a_split in
// hopper.cuh). Rounded once to bf16, as FlashAttention-2 takes them,
// their error over a long sum reached 2.1x the largest deviation of the
// f32 backward of the same bf16 inputs at T = 8192 (measured on an
// H100); the split keeps the kernel's deviation equal to that backward's.
//
// Bound: operations. The useful work is five causal matmuls (S, dP, dV,
// dK, dQ), 2.5x the forward's: 10 * B * H * D * T(T+1)/2 FLOPs (twice
// that less the diagonal non-causal, 10 * B * H * D * T^2), 171.9
// GFLOP at B4 H16 T2048 D128, >= 0.174 ms at 989 TFLOP/s, while its
// ~270 MB of bf16 tensors take 0.08 ms at 3.35 TB/s. This design
// executes ten products of that size: S and dP in both the dK/dV and the
// dQ kernel, and the three products with P or dS twice (hi and lo). So
// every product is a `wgmma` (the only path to the tensor cores' full
// rate), every tile arrives by TMA into a ring that overlaps the next
// tile's copy with this tile's products, and no operand is gathered by
// hand.
//
// Design (FlashAttention-2's split into three kernels, no atomics: every
// output element has one writer, so the result is deterministic;
// building blocks in hopper.cuh):
//   1. delta kernel: rowsum(do * o) in f32, W/8 threads per row.
//   2. dK/dV kernel: one block per (128-key tile, head, batch). K and V
//      stay in shared memory for the whole loop. A producer warp
//      TMA-loads the Q and dO tiles of 64 queries into a two-stage ring
//      and copies their lse (log2-scaled) and delta beside them with
//      ordinary loads (their row stride T * 4 is not a TMA stride). Two
//      consumer warpgroups own 64 keys each and, for every q-tile from
//      the diagonal (non-causal: the first) to the end, compute S^T = K Q^T and dP^T = V dO^T
//      (both operands in shared memory), P^T and dS^T in f32 registers,
//      then dV += P^T dO and dK += dS^T Q with A from registers (the
//      accumulator layout of S^T is the A layout) and Q, dO as
//      transposed B operands. dK and dV take 128 f32 registers per
//      thread at W 128; `setmaxnreg` gives the consumers 240, and at W 128
//      each q-tile is taken in two passes of 32 queries, so S^T, dP^T
//      and their bf16 parts fit beside the accumulators without spills.
//   3. dQ kernel: one block per (128-query tile, head, batch). Q and dO
//      stay in shared memory; K and V tiles of 64 keys go through the
//      ring up to the diagonal (non-causal: to the end). Per tile: S = Q K^T, dP = dO V^T, dS in
//      registers, dQ += dS K with K as a transposed B.
// Rows past T arrive as zeros from TMA. Their lse reads as +inf, so P is
// 0 there and they add nothing to dK and dV. Keys past T arrive as zeros
// too; their own dK and dV rows are never stored. Causal, they lie after
// every valid query, so the causal mask hides them from dQ; non-causal,
// a mask of their own does (with K = V = 0 they would add 0 anyway).
//
// Head dims, as in the forward: the tile width W (16, 32, 64, 128 or
// 256) is the template parameter, the head dim D (a multiple of 8 up to
// 256) an argument, run by the smallest W >= D. Columns D..W-1 of every
// tile arrive as zeros from TMA, so S, dP and the products are those of
// D columns and dq, dk, dv have zero columns there, which are not
// stored; the delta kernel reads the D columns of each row at stride D.
//
// W 256 (head dims 129-256). At 128 rows a block, K and V resident for
// 128 keys beside two Q/dO stages would take 128 KB + 2 x 65 KB, and Q
// and dO for 128 queries beside two K/V stages 128 KB + 128 KB, both
// over a block's 227 KB; and dK plus dV would take 256 f32 registers a
// thread. So each block of either kernel takes 64 rows (keys, or
// queries), and both consumer warpgroups work on all 64 of them, each
// owning one half of the head dim's columns (`Split<W>`): each computes
// S and dP (S^T and dP^T) over all 256 columns, then its half of dK and
// dV (64 + 64 registers a thread) or of dQ (64) with m64n128k16
// products on its half of Q, dO or K (`Tile<W>::box`). Shared memory:
// dK/dV K + V 64 KB + 2 x 65 KB stages, dQ Q + dO 64 KB + 2 x 64 KB
// stages, ~194 KB each. The price is S and dP computed twice: a third
// more products than the useful ones in the dK/dV kernel, half more in
// the dQ kernel.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kQTile = 64;      // dK/dV kernel: queries per ring tile
constexpr int kKeyTile = 64;    // dQ kernel: keys per ring tile

// How the two consumer warpgroups share a block of either kernel. Up to
// W 128: 128 rows a block (keys for dK/dV, queries for dQ), 64 a
// warpgroup, each over all W columns. At W 256: 64 rows a block, all of
// them in both warpgroups, each over its half of the columns.
template <int W>
struct Split {
  static constexpr bool kSplit = W == 256;  // the warpgroups split columns
  static constexpr int kRows = kSplit ? 64 : 128;  // rows per block
  static constexpr int kN = kSplit ? W / 2 : W;    // columns per warpgroup
  // A warpgroup's first row within the block, and its first column.
  static __device__ __forceinline__ int row0(int wg) {
    return kSplit ? 0 : wg * 64;
  }
  static __device__ __forceinline__ int col0(int wg) {
    return kSplit ? wg * kN : 0;
  }
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaThreads = 128;

// delta[r] = sum_d do[r, d] * o[r, d] in f32, for rows = B * H * T rows
// of D columns; W / 8 threads a row, of which the first D / 8 read.
template <int W>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o,
                       const uint16_t* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int D) {
  constexpr int kLanes = W / 8;  // threads per row, 16 bytes each
  constexpr int kRows = kDeltaThreads / kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows +
                      threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows && part * 8 < D) {
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

// dK/dV kernel shared memory, from a 1024-byte aligned base: K, V, then
// per stage Q, dO, lse, delta (padded to 1024 B), then the barriers.
template <int W>
struct DkvSmem {
  static constexpr int kKeyBlock = Split<W>::kRows;  // keys per block
  static constexpr int kK = 0;
  static constexpr int kV = Tile<W>::bytes(kKeyBlock);
  static constexpr int kStage0 = 2 * Tile<W>::bytes(kKeyBlock);
  static constexpr int kQ = 0;  // offsets within a stage
  static constexpr int kDo = Tile<W>::bytes(kQTile);
  static constexpr int kLse = 2 * Tile<W>::bytes(kQTile);
  static constexpr int kDelta = kLse + kQTile * 4;
  static constexpr int kStage = (kDelta + kQTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kStage0 + kStages * kStage;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int W, bool kCausal, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      Out* __restrict__ dk, Out* __restrict__ dv,
                      int T, int D, float scale, float scale_log2) {
  using L = DkvSmem<W>;
  using P = Split<W>;
  constexpr int kKeyBlock = L::kKeyBlock;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // One block per (key tile, head), the tile-major index walking every
  // head's key tile 0, which loops over every q-tile, first.
  const int key_blocks = (T + kKeyBlock - 1) / kKeyBlock;
  const int heads = gridDim.x / key_blocks;
  const int tile = static_cast<int>(blockIdx.x) / heads;
  const int head = blockIdx.x % heads;
  const int n0 = tile * kKeyBlock;
  // Causal: the q-tiles from the one holding key n0 to the end; else all.
  const int m_first = kCausal ? n0 / kQTile : 0;
  const int n_iters = (T + kQTile - 1) / kQTile - m_first;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < kConsumers + 32) {
      // Producer warp: lane 0 issues the copies; every lane copies two
      // rows of lse and delta.
      const int lane = threadIdx.x - kConsumers;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * Tile<W>::bytes(kKeyBlock));
        Tile<W>::load(base + L::kK, &tk, kv_full, n0, kKeyBlock, head);
        Tile<W>::load(base + L::kV, &tv, kv_full, n0, kKeyBlock, head);
      }
      const float* lseh = lse + static_cast<int64_t>(head) * T;
      const float* deltah = delta + static_cast<int64_t>(head) * T;
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStages;
        const int m0 = (m_first + it) * kQTile;
        const uint32_t stage = base + L::kStage0 + s * L::kStage;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        float* lse_s = reinterpret_cast<float*>(smem + (stage - base) + L::kLse);
        float* delta_s =
            reinterpret_cast<float*>(smem + (stage - base) + L::kDelta);
#pragma unroll
        for (int r = lane; r < kQTile; r += 32) {
          const bool in = m0 + r < T;
          lse_s[r] = in ? lseh[m0 + r] * kLog2e : INFINITY;
          delta_s[r] = in ? deltah[m0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * s, 2 * Tile<W>::bytes(kQTile));
          Tile<W>::load(stage + L::kQ, &tq, full + 8 * s, m0, kQTile, head);
          Tile<W>::load(stage + L::kDo, &tdo, full + 8 * s, m0, kQTile, head);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int kw0 = n0 + P::row0(wg);        // this warpgroup's first key
  const int key0 = kw0 + warp * 16 + g;    // this thread's keys key0, key0+8
  constexpr int kN = P::kN;                // its columns of dK and dV
  const int col0 = P::col0(wg);
  // Query columns per register pass: at 128 columns a warpgroup dK and
  // dV already hold 128 f32 per thread, so a q-tile is taken in two
  // passes of 32.
  constexpr int kCols = kN == 128 ? 32 : kQTile;

  float dk_acc[kN / 2];
  float dv_acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kStages;
    const int m = m_first + it;
    const uint32_t stage = base + L::kStage0 + s * L::kStage;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t qs = stage + L::kQ;
    const uint32_t dos = stage + L::kDo;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (stage - base) + L::kLse);
    const float* delta_s =
        reinterpret_cast<const float*>(smem + (stage - base) + L::kDelta);
#pragma unroll 1
    for (int c0 = 0; c0 < kQTile; c0 += kCols) {
      const int q0 = m * kQTile + c0;  // the pass's first query
      // Causal: passes wholly before this warpgroup's keys add nothing.
      if (kCausal && q0 + kCols - 1 < kw0) continue;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x kCols queries each.
      float st[kCols / 2];
      float dpt[kCols / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        wgmma_ss<kCols>(st, Tile<W>::kmajor(base + L::kK, kKeyBlock, P::row0(wg), kk),
                        Tile<W>::kmajor(qs, kQTile, c0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        wgmma_ss<kCols>(dpt, Tile<W>::kmajor(base + L::kV, kKeyBlock, P::row0(wg), kk),
                        Tile<W>::kmajor(dos, kQTile, c0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kCols / 2>(st);
      fence_regs<kCols / 2>(dpt);

      // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), 0 where the
      // key is after the query; dS^T = P^T * (dP^T - delta) in place of
      // dP^T. Queries are the columns here.
      const bool diagonal = kCausal && q0 <= kw0 + 63;
#pragma unroll
      for (int i = 0; i < kCols / 2; i += 2) {
        const int col = c0 + 8 * (i / 4) + 2 * c;  // within the q-tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
        const int key = key0 + 8 * ((i % 4) / 2);
        const int q = m * kQTile + col;
        float p0 = exp2f(st[i] * scale_log2 - l2.x);
        float p1 = exp2f(st[i + 1] * scale_log2 - l2.y);
        if (diagonal && key > q) p0 = 0.f;
        if (diagonal && key > q + 1) p1 = 0.f;
        dpt[i] = p0 * (dpt[i] - dl.x);
        dpt[i + 1] = p1 * (dpt[i + 1] - dl.y);
        st[i] = p0;
        st[i + 1] = p1;
      }

      // dV += P^T dO, then dK += dS^T Q, contracting over the pass's
      // queries (k-slices c0/16.. of the q-tile), on this warpgroup's
      // columns of dO and Q.
      const uint32_t dos_n =
          Tile<W>::box(dos, kQTile, col0 / Tile<W>::kBoxCols);
      const uint32_t qs_n = Tile<W>::box(qs, kQTile, col0 / Tile<W>::kBoxCols);
      uint32_t p_hi[kCols / 16][4], p_lo[kCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        acc_to_a_split(p_hi[kk], p_lo[kk], st + 8 * kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const uint64_t b = Tile<W>::mnmajor(dos_n, kQTile, c0 / 16 + kk);
        wgmma_rs<kN>(dv_acc, p_hi[kk], b, 1);
        wgmma_rs<kN>(dv_acc, p_lo[kk], b, 1);
      }
      wgmma_commit();
      uint32_t ds_hi[kCols / 16][4], ds_lo[kCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        acc_to_a_split(ds_hi[kk], ds_lo[kk], dpt + 8 * kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const uint64_t b = Tile<W>::mnmajor(qs_n, kQTile, c0 / 16 + kk);
        wgmma_rs<kN>(dk_acc, ds_hi[kk], b, 1);
        wgmma_rs<kN>(dk_acc, ds_lo[kk], b, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kN / 2>(dv_acc);
      fence_regs<kN / 2>(dk_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's Q, dO, lse, delta are read
  }

  // Columns col, col + 1 of keys < T, only those < D (D is even).
  Out* dkh = dk + static_cast<int64_t>(head) * T * D;
  Out* dvh = dv + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int key = key0 + 8 * ((i % 4) / 2);
    const int col = col0 + 8 * (i / 4) + 2 * c;
    if (key < T && col < D) {
      const int64_t off = static_cast<int64_t>(key) * D + col;
      store_pair(dkh + off, dk_acc[i] * scale, dk_acc[i + 1] * scale);
      store_pair(dvh + off, dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// dQ kernel shared memory: Q, dO, then per stage K and V, then barriers.
template <int W>
struct DqSmem {
  static constexpr int kQBlock = Split<W>::kRows;  // queries per block
  static constexpr int kQ = 0;
  static constexpr int kDo = Tile<W>::bytes(kQBlock);
  static constexpr int kStage0 = 2 * Tile<W>::bytes(kQBlock);
  static constexpr int kK = 0;  // offsets within a stage
  static constexpr int kV = Tile<W>::bytes(kKeyTile);
  static constexpr int kStage = 2 * Tile<W>::bytes(kKeyTile);
  static constexpr int kBar = kStage0 + kStages * kStage;
  // qdo_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int W, bool kCausal, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    Out* __restrict__ dq, int T, int D, float scale,
                    float scale_log2) {
  using L = DqSmem<W>;
  using P = Split<W>;
  constexpr int kQBlock = L::kQBlock;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qdo_full = base + L::kBar;
  const uint32_t full = qdo_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // Causal, query tile i loops over key tiles 0..2i+1 (0..i at 64
  // queries a block), else over all; the tile-major index walks every
  // head's longest q-tile first.
  const int q_blocks = (T + kQBlock - 1) / kQBlock;
  const int heads = gridDim.x / q_blocks;
  const int tile = q_blocks - 1 - static_cast<int>(blockIdx.x) / heads;
  const int head = blockIdx.x % heads;
  const int m0 = tile * kQBlock;
  const int key_tiles = (T + kKeyTile - 1) / kKeyTile;
  const int diag = m0 / kKeyTile;  // key tile of the block's first row
  const int n_iters =
      kCausal ? min(diag + kQBlock / kKeyTile, key_tiles) : key_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(qdo_full, 2 * Tile<W>::bytes(kQBlock));
      Tile<W>::load(base + L::kQ, &tq, qdo_full, m0, kQBlock, head);
      Tile<W>::load(base + L::kDo, &tdo, qdo_full, m0, kQBlock, head);
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStages;
        const uint32_t stage = base + L::kStage0 + s * L::kStage;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, L::kStage);
        Tile<W>::load(stage + L::kK, &tk, full + 8 * s, it * kKeyTile,
                      kKeyTile, head);
        Tile<W>::load(stage + L::kV, &tv, full + 8 * s, it * kKeyTile,
                      kKeyTile, head);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  // This thread's rows r0, r0+8.
  const int r0 = m0 + P::row0(wg) + warp * 16 + g;
  constexpr int kN = P::kN;  // this warpgroup's columns of dQ
  const int col0 = P::col0(wg);
  // This warpgroup's last key tile: causal, its diagonal one.
  const int last =
      kCausal ? diag + (P::kSplit ? 0 : wg) : key_tiles - 1;

  // lse in the log2 domain; +inf past T makes P 0 there.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int64_t at = static_cast<int64_t>(head) * T + row;
    lse2[r] = row < T ? lse[at] * kLog2e : INFINITY;
    dl[r] = row < T ? delta[at] : 0.f;
  }

  float dq_acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(qdo_full, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kStages;
    const uint32_t stage = base + L::kStage0 + s * L::kStage;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (it <= last) {  // the key tile after the diagonal is all masked
      const uint32_t ks = stage + L::kK;
      const uint32_t vs = stage + L::kV;
      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each.
      float sc[kKeyTile / 2];
      float dp[kKeyTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        wgmma_ss<kKeyTile>(sc, Tile<W>::kmajor(base + L::kQ, kQBlock, P::row0(wg), kk),
                           Tile<W>::kmajor(ks, kKeyTile, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        wgmma_ss<kKeyTile>(dp, Tile<W>::kmajor(base + L::kDo, kQBlock, P::row0(wg), kk),
                           Tile<W>::kmajor(vs, kKeyTile, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kKeyTile / 2>(sc);
      fence_regs<kKeyTile / 2>(dp);

      // P masked where the key is after the row (causal) or past T, then
      // dS in place of dP.
      const bool edge = it == last;
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; ++i) {
        const int r = (i % 4) / 2;
        const int row = r0 + 8 * r;
        const int key = it * kKeyTile + 8 * (i / 4) + 2 * c + (i % 2);
        float p = exp2f(sc[i] * scale_log2 - lse2[r]);
        if (edge && (kCausal ? key > row : key >= T)) p = 0.f;
        dp[i] = p * (dp[i] - dl[r]);
      }
      // dQ += dS K (scaled once, at the store), on this warpgroup's
      // columns of K.
      uint32_t ds_hi[kKeyTile / 16][4], ds_lo[kKeyTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        acc_to_a_split(ds_hi[kk], ds_lo[kk], dp + 8 * kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        const uint64_t b = Tile<W>::mnmajor(
            Tile<W>::box(ks, kKeyTile, col0 / Tile<W>::kBoxCols), kKeyTile, kk);
        wgmma_rs<kN>(dq_acc, ds_hi[kk], b, 1);
        wgmma_rs<kN>(dq_acc, ds_lo[kk], b, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kN / 2>(dq_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  // Columns col, col + 1 of rows < T, only those < D (D is even).
  Out* dqh = dq + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int row = r0 + 8 * ((i % 4) / 2);
    const int col = col0 + 8 * (i / 4) + 2 * c;
    if (row < T && col < D) {
      store_pair(dqh + static_cast<int64_t>(row) * D + col, dq_acc[i] * scale,
                 dq_acc[i + 1] * scale);
    }
  }
}

template <int W, bool kCausal, typename Out>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int T, int D, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tile_map<W>(&tq, q, B * H, T, D);
  if (err == 0) err = make_tile_map<W>(&tk, k, B * H, T, D);
  if (err == 0) err = make_tile_map<W>(&tv, v, B * H, T, D);
  if (err == 0) err = make_tile_map<W>(&tdo, dout, B * H, T, D);
  // The shared-memory limits are properties of the kernels on a device:
  // set once per device, not on every launch.
  static PerDevice smem_set;
  int done = 0;
  if (err == 0) {
    err = smem_set.get(&done, [](int, int* set) {
      *set = 1;
      cudaError_t e = cudaFuncSetAttribute(
          flash_bwd_dkdv_kernel<W, kCausal, Out>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          DkvSmem<W>::kAlloc);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(flash_bwd_dq_kernel<W, kCausal, Out>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DqSmem<W>::kAlloc);
      }
      return e;
    });
  }
  if (err != 0) return err;

  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const int64_t rows = static_cast<int64_t>(B) * H * T;
  constexpr int kRowsPerBlock = kDeltaThreads / (W / 8);
  const int64_t delta_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  // One block per (row tile, head) in both the dK/dV and dQ grids: 128
  // rows a tile, 64 at W 256.
  constexpr int kRows = Split<W>::kRows;
  const int64_t blocks = static_cast<int64_t>((T + kRows - 1) / kRows) * B * H;
  if (delta_blocks > 0x7fffffff || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_delta_kernel<W><<<static_cast<unsigned>(delta_blocks),
                              kDeltaThreads, 0, stream>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
      delta32, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dkdv_kernel<W, kCausal, Out><<<static_cast<unsigned>(blocks),
                                           kThreads, DkvSmem<W>::kAlloc,
                                           stream>>>(
      tq, tk, tv, tdo, lse32, delta32, static_cast<Out*>(dk),
      static_cast<Out*>(dv), T, D, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dq_kernel<W, kCausal, Out><<<static_cast<unsigned>(blocks),
                                         kThreads, DqSmem<W>::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse32, delta32, static_cast<Out*>(dq), T, D, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The smallest tile width that holds head dim D (a multiple of 8, at
// most 256; the entry point checks).
template <bool kCausal, typename Out>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int H, int T, int D, float scale,
             cudaStream_t s) {
  if (D <= 16) {
    return launch<16, kCausal, Out>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, T, D, scale, s);
  }
  if (D <= 32) {
    return launch<32, kCausal, Out>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, T, D, scale, s);
  }
  if (D <= 64) {
    return launch<64, kCausal, Out>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, T, D, scale, s);
  }
  if (D <= 128) {
    return launch<128, kCausal, Out>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, B, H, T, D, scale, s);
  }
  return launch<256, kCausal, Out>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, H, T, D, scale, s);
}

template <typename Out>
int launch_c(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int H, int T, int D, int causal,
             float scale, cudaStream_t s) {
  return causal ? launch_d<true, Out>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, H, T, D, scale, s)
                : launch_d<false, Out>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, T, D, scale, s);
}

}  // namespace

// q, k, v, o, dout: contiguous [B, H, T, D] bf16, D a multiple of 8 up to
// 256; dq, dk, dv: the same,
// bf16, or f32 when f32_out is 1; lse: [B, H, T] f32 (natural log, as
// flash_attn_fwd_bf16 writes it); delta: [B, H, T] f32 scratch; all on
// `device`. causal: 1 masks key j > query i, 0 masks nothing (but keys
// past T). scale = 1/sqrt(D) of the caller's head dim (which may be less
// than D, when the caller padded it). Three launches on `stream`, one of
// that device's streams.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int T,
                                   int D, int causal, int f32_out,
                                   float scale, int device, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535 || D <= 0 ||
      D > 256 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32_out ? launch_c<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, H, T, D, causal, scale, s)
                 : launch_c<uint16_t>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, H, T, D, causal, scale, s);
}
