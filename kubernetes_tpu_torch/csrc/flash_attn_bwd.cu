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
// the delta scratch [B, H, T] f32. Scores, exponentials, dP, delta and the
// accumulators are f32. P and dS, the operands the kernel makes itself,
// enter the tensor cores as two bf16 parts, hi + lo (acc_to_a_split in
// hopper.cuh). Rounded once to bf16, as FlashAttention-2 takes them,
// their error over a long sum reached 2.1x the largest deviation of the
// f32 backward of the same bf16 inputs at T = 8192 (measured on an
// H100); the split keeps the kernel's deviation equal to that backward's.
//
// Bound: operations. The useful work is five causal matmuls (S, dP, dV,
// dK, dQ), 2.5x the forward's: 10 * B * H * D * T(T+1)/2 FLOPs, 171.9
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
//   1. delta kernel: rowsum(do * o) in f32, D/8 threads per row.
//   2. dK/dV kernel: one block per (128-key tile, head, batch). K and V
//      stay in shared memory for the whole loop. A producer warp
//      TMA-loads the Q and dO tiles of 64 queries into a two-stage ring
//      and copies their lse (log2-scaled) and delta beside them with
//      ordinary loads (their row stride T * 4 is not a TMA stride). Two
//      consumer warpgroups own 64 keys each and, for every q-tile from
//      the diagonal to the end, compute S^T = K Q^T and dP^T = V dO^T
//      (both operands in shared memory), P^T and dS^T in f32 registers,
//      then dV += P^T dO and dK += dS^T Q with A from registers (the
//      accumulator layout of S^T is the A layout) and Q, dO as
//      transposed B operands. dK and dV take 128 f32 registers per
//      thread at D128; `setmaxnreg` gives the consumers 240, and at D128
//      each q-tile is taken in two passes of 32 queries, so S^T, dP^T
//      and their bf16 parts fit beside the accumulators without spills.
//   3. dQ kernel: one block per (128-query tile, head, batch). Q and dO
//      stay in shared memory; K and V tiles of 64 keys go through the
//      ring up to the diagonal. Per tile: S = Q K^T, dP = dO V^T, dS in
//      registers, dQ += dS K with K as a transposed B.
// Rows past T arrive as zeros from TMA. Their lse reads as +inf, so P is
// 0 there and they add nothing to dK and dV; keys past T lie after every
// valid query, so the causal mask hides them from dQ.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kKeyBlock = 128;  // dK/dV kernel: keys per block
constexpr int kQTile = 64;      // dK/dV kernel: queries per ring tile
constexpr int kQBlock = 128;    // dQ kernel: queries per block
constexpr int kKeyTile = 64;    // dQ kernel: keys per ring tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaThreads = 128;

// delta[r] = sum_d do[r, d] * o[r, d] in f32, for rows = B * H * T rows.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o,
                       const uint16_t* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  constexpr int kLanes = D / 8;  // threads per row, 16 bytes each
  constexpr int kRows = kDeltaThreads / kLanes;
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

// dK/dV kernel shared memory, from a 1024-byte aligned base: K, V, then
// per stage Q, dO, lse, delta (padded to 1024 B), then the barriers.
template <int D>
struct DkvSmem {
  static constexpr int kK = 0;
  static constexpr int kV = Tile<D>::bytes(kKeyBlock);
  static constexpr int kStage0 = 2 * Tile<D>::bytes(kKeyBlock);
  static constexpr int kQ = 0;  // offsets within a stage
  static constexpr int kDo = Tile<D>::bytes(kQTile);
  static constexpr int kLse = 2 * Tile<D>::bytes(kQTile);
  static constexpr int kDelta = kLse + kQTile * 4;
  static constexpr int kStage = (kDelta + kQTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kStage0 + kStages * kStage;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int T, float scale, float scale_log2) {
  using L = DkvSmem<D>;
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
  // Causal: the q-tiles from the one holding key n0 to the end.
  const int m_first = n0 / kQTile;
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
        mbar_arrive_expect_tx(kv_full, 2 * Tile<D>::bytes(kKeyBlock));
        Tile<D>::load(base + L::kK, &tk, kv_full, n0, kKeyBlock, head);
        Tile<D>::load(base + L::kV, &tv, kv_full, n0, kKeyBlock, head);
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
          mbar_arrive_expect_tx(full + 8 * s, 2 * Tile<D>::bytes(kQTile));
          Tile<D>::load(stage + L::kQ, &tq, full + 8 * s, m0, kQTile, head);
          Tile<D>::load(stage + L::kDo, &tdo, full + 8 * s, m0, kQTile, head);
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
  const int kw0 = n0 + wg * 64;            // this warpgroup's first key
  const int key0 = kw0 + warp * 16 + g;    // this thread's keys key0, key0+8
  // Query columns per register pass: at D128 dK and dV already hold 128
  // f32 per thread, so a q-tile is taken in two passes of 32.
  constexpr int kCols = D == 128 ? 32 : kQTile;

  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
      // Passes wholly before this warpgroup's keys add nothing.
      if (q0 + kCols - 1 < kw0) continue;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x kCols queries each.
      float st[kCols / 2];
      float dpt[kCols / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kCols>(st, Tile<D>::kmajor(base + L::kK, kKeyBlock, wg * 64, kk),
                        Tile<D>::kmajor(qs, kQTile, c0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kCols>(dpt, Tile<D>::kmajor(base + L::kV, kKeyBlock, wg * 64, kk),
                        Tile<D>::kmajor(dos, kQTile, c0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kCols / 2>(st);
      fence_regs<kCols / 2>(dpt);

      // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), 0 where the
      // key is after the query; dS^T = P^T * (dP^T - delta) in place of
      // dP^T. Queries are the columns here.
      const bool diagonal = q0 <= kw0 + 63;
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
      // queries (k-slices c0/16.. of the q-tile).
      uint32_t p_hi[kCols / 16][4], p_lo[kCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        acc_to_a_split(p_hi[kk], p_lo[kk], st + 8 * kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const uint64_t b = Tile<D>::mnmajor(dos, kQTile, c0 / 16 + kk);
        wgmma_rs<D>(dv_acc, p_hi[kk], b, 1);
        wgmma_rs<D>(dv_acc, p_lo[kk], b, 1);
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
        const uint64_t b = Tile<D>::mnmajor(qs, kQTile, c0 / 16 + kk);
        wgmma_rs<D>(dk_acc, ds_hi[kk], b, 1);
        wgmma_rs<D>(dk_acc, ds_lo[kk], b, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dv_acc);
      fence_regs<D / 2>(dk_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's Q, dO, lse, delta are read
  }

  uint16_t* dkh = dk + static_cast<int64_t>(head) * T * D;
  uint16_t* dvh = dv + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + 8 * ((i % 4) / 2);
    const int col = 8 * (i / 4) + 2 * c;
    if (key < T) {
      const int64_t off = static_cast<int64_t>(key) * D + col;
      *reinterpret_cast<uint32_t*>(dkh + off) =
          pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvh + off) =
          pack_bf16(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// dQ kernel shared memory: Q, dO, then per stage K and V, then barriers.
template <int D>
struct DqSmem {
  static constexpr int kQ = 0;
  static constexpr int kDo = Tile<D>::bytes(kQBlock);
  static constexpr int kStage0 = 2 * Tile<D>::bytes(kQBlock);
  static constexpr int kK = 0;  // offsets within a stage
  static constexpr int kV = Tile<D>::bytes(kKeyTile);
  static constexpr int kStage = 2 * Tile<D>::bytes(kKeyTile);
  static constexpr int kBar = kStage0 + kStages * kStage;
  // qdo_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int T, float scale,
                    float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qdo_full = base + L::kBar;
  const uint32_t full = qdo_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // Query tile i loops over key tiles 0..2i+1; the tile-major index
  // walks every head's longest q-tile first.
  const int q_blocks = (T + kQBlock - 1) / kQBlock;
  const int heads = gridDim.x / q_blocks;
  const int tile = q_blocks - 1 - static_cast<int>(blockIdx.x) / heads;
  const int head = blockIdx.x % heads;
  const int m0 = tile * kQBlock;
  const int key_tiles = (T + kKeyTile - 1) / kKeyTile;
  const int diag = m0 / kKeyTile;  // key tile of the block's first row
  const int n_iters = min(diag + kQBlock / kKeyTile, key_tiles);

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
      mbar_arrive_expect_tx(qdo_full, 2 * Tile<D>::bytes(kQBlock));
      Tile<D>::load(base + L::kQ, &tq, qdo_full, m0, kQBlock, head);
      Tile<D>::load(base + L::kDo, &tdo, qdo_full, m0, kQBlock, head);
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStages;
        const uint32_t stage = base + L::kStage0 + s * L::kStage;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, L::kStage);
        Tile<D>::load(stage + L::kK, &tk, full + 8 * s, it * kKeyTile,
                      kKeyTile, head);
        Tile<D>::load(stage + L::kV, &tv, full + 8 * s, it * kKeyTile,
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
  const int r0 = m0 + wg * 64 + warp * 16 + g;  // this thread's rows r0, r0+8
  const int last = diag + wg;  // this warpgroup's diagonal key tile

  // lse in the log2 domain; +inf past T makes P 0 there.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int64_t at = static_cast<int64_t>(head) * T + row;
    lse2[r] = row < T ? lse[at] * kLog2e : INFINITY;
    dl[r] = row < T ? delta[at] : 0.f;
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

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
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kKeyTile>(sc, Tile<D>::kmajor(base + L::kQ, kQBlock, wg * 64, kk),
                           Tile<D>::kmajor(ks, kKeyTile, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kKeyTile>(dp, Tile<D>::kmajor(base + L::kDo, kQBlock, wg * 64, kk),
                           Tile<D>::kmajor(vs, kKeyTile, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kKeyTile / 2>(sc);
      fence_regs<kKeyTile / 2>(dp);

      // P masked where the key is after the row, then dS in place of dP.
      const bool diagonal = it == last;
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; ++i) {
        const int r = (i % 4) / 2;
        const int row = r0 + 8 * r;
        const int key = it * kKeyTile + 8 * (i / 4) + 2 * c + (i % 2);
        float p = exp2f(sc[i] * scale_log2 - lse2[r]);
        if (diagonal && key > row) p = 0.f;
        dp[i] = p * (dp[i] - dl[r]);
      }
      // dQ += dS K (scaled once, at the store).
      uint32_t ds_hi[kKeyTile / 16][4], ds_lo[kKeyTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        acc_to_a_split(ds_hi[kk], ds_lo[kk], dp + 8 * kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        const uint64_t b = Tile<D>::mnmajor(ks, kKeyTile, kk);
        wgmma_rs<D>(dq_acc, ds_hi[kk], b, 1);
        wgmma_rs<D>(dq_acc, ds_lo[kk], b, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  uint16_t* dqh = dq + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = r0 + 8 * ((i % 4) / 2);
    const int col = 8 * (i / 4) + 2 * c;
    if (row < T) {
      *reinterpret_cast<uint32_t*>(dqh + static_cast<int64_t>(row) * D + col) =
          pack_bf16(dq_acc[i] * scale, dq_acc[i + 1] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int T, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tile_map<D>(&tq, q, B * H, T);
  if (err == 0) err = make_tile_map<D>(&tk, k, B * H, T);
  if (err == 0) err = make_tile_map<D>(&tv, v, B * H, T);
  if (err == 0) err = make_tile_map<D>(&tdo, dout, B * H, T);
  // The shared-memory limits are properties of the kernels on a device:
  // set once per device, not on every launch.
  static PerDevice smem_set;
  int done = 0;
  if (err == 0) {
    err = smem_set.get(&done, [](int, int* set) {
      *set = 1;
      cudaError_t e = cudaFuncSetAttribute(
          flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          DkvSmem<D>::kAlloc);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DqSmem<D>::kAlloc);
      }
      return e;
    });
  }
  if (err != 0) return err;

  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const int64_t rows = static_cast<int64_t>(B) * H * T;
  constexpr int kRowsPerBlock = kDeltaThreads / (D / 8);
  const int64_t delta_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  // One block per (128-row tile, head) in both the dK/dV and dQ grids.
  static_assert(kKeyBlock == kQBlock, "one grid size for both kernels");
  const int64_t blocks =
      static_cast<int64_t>((T + kQBlock - 1) / kQBlock) * B * H;
  if (delta_blocks > 0x7fffffff || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>(delta_blocks),
                              kDeltaThreads, 0, stream>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
      delta32, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dkdv_kernel<D><<<static_cast<unsigned>(blocks), kThreads,
                             DkvSmem<D>::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse32, delta32, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dq_kernel<D><<<static_cast<unsigned>(blocks), kThreads,
                           DqSmem<D>::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse32, delta32, static_cast<uint16_t*>(dq), T, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [B, H, T, D] bf16; lse:
// [B, H, T] f32 (natural log, as flash_attn_fwd_bf16 writes it); delta:
// [B, H, T] f32 scratch; all on `device`. scale = 1/sqrt(D). Three
// launches on `stream`, one of that device's streams.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int T,
                                   int D, float scale, int device,
                                   void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
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
