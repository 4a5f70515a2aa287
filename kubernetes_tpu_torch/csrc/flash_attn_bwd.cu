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
//
// f32 q, k, v, o, do (head dims up to 128): dq, dk, dv f32. The entry
// point splits q, k, v and do into their fp16 parts under a power-of-2
// scale per [batch, head] slice (hopper.cuh) in a pre-pass; delta reads
// o and do in f32. Every product that takes Q, K, V or dO is taken by
// parts: S and dP as hi.hi + hi.lo + lo.hi, dV, dK, dQ as P or dS (in
// two fp16 parts) times the two parts of dO, Q or K, less lo.lo (Terms).
// The slices' scales fold into the softmax scale for S, multiply dP back
// before delta is taken from it, and divide out of dq, dk, dv in the
// epilogue. P enters under the fixed scale kPScale; dS, whose range no
// bound fixes, under a running scale per row of the product it feeds
// (RowScale): per query in the dQ kernel (dQ = dS K), per key in the
// dK/dV kernel (dK = dS^T Q, whose A operand is dS^T), each rescaling
// its accumulator's row when the scale falls; each pass's products with
// P or dS go into a fresh accumulator, added in f32 (the tensor cores'
// adds truncate, which over T would pass the operands' rounding). A tile
// in two parts holds
// twice the bytes, so W 128 takes the W-256 plan (64 rows a block, the
// columns split between the warpgroups: dK/dV K + V 64 KB + 2 x 65 KB,
// dQ 64 KB + 2 x 64 KB) and W <= 64 the 128-row blocks. Bound: the same
// operations over the TF32 rate (495 TFLOP/s); the design executes 21
// fp16 products of the useful ones' size where the bf16 backward
// executes 10 (S and dP three times in each of the two kernels, dV, dK
// and dQ three times), and the pre-pass reads q, k, v and do twice and
// writes 4 bytes an element.
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
// W 128 in one part (64 in two): 128 rows a block (keys for dK/dV,
// queries for dQ), 64 a warpgroup, each over all W columns. At W 256, or
// W 128 in two parts: 64 rows a block, all of them in both warpgroups,
// each over its half of the columns.
template <int W, int kParts>
struct Split {
  // The warpgroups split columns.
  static constexpr bool kSplit = W * kParts >= 256;
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
// of D columns of In (bf16 bits, or f32); 16 bytes a thread (kVec
// values), W / kVec threads a row, of which the first D / kVec read.
template <int W, typename In>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const In* __restrict__ o, const In* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int D) {
  constexpr int kVec = 16 / sizeof(In);
  constexpr int kLanes = W / kVec;  // threads per row
  constexpr int kRows = kDeltaThreads / kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows +
                      threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows && part * kVec < D) {
    const uint4 a =
        *reinterpret_cast<const uint4*>(o + row * D + part * kVec);
    const uint4 b =
        *reinterpret_cast<const uint4*>(dout + row * D + part * kVec);
    if constexpr (sizeof(In) == 2) {
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(pa[i]);
        const float2 fb = __bfloat1622float2(pb[i]);
        sum += fa.x * fb.x + fa.y * fb.y;
      }
    } else {
      const float* fa = reinterpret_cast<const float*>(&a);
      const float* fb = reinterpret_cast<const float*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += fa[i] * fb[i];
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
// per stage Q, dO, lse, delta (padded to 1024 B), then the barriers; each
// tile's kParts parts one after the other.
template <int W, int kParts>
struct DkvSmem {
  static constexpr int kKeyBlock = Split<W, kParts>::kRows;  // keys per block
  static constexpr int kKPart = Tile<W>::bytes(kKeyBlock);  // of K or V
  static constexpr int kK = 0;
  static constexpr int kV = kParts * kKPart;
  static constexpr int kStage0 = 2 * kParts * kKPart;
  static constexpr int kQPart = Tile<W>::bytes(kQTile);  // of Q or dO
  static constexpr int kQ = 0;  // offsets within a stage
  static constexpr int kDo = kParts * kQPart;
  static constexpr int kLse = 2 * kParts * kQPart;
  static constexpr int kDelta = kLse + kQTile * 4;
  static constexpr int kStage = (kDelta + kQTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kStage0 + kStages * kStage;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int W, bool kCausal, typename Out, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const uint32_t* __restrict__ amax,
                      Out* __restrict__ dk, Out* __restrict__ dv,
                      int T, int D, float scale, float scale_log2) {
  using L = DkvSmem<W, kParts>;
  using P = Split<W, kParts>;
  using Score = Terms<kParts, kParts>;  // S^T = K Q^T, dP^T = V dO^T
  using Grad = Terms<2, kParts>;        // dV += P^T dO, dK += dS^T Q
  using E = typename Part<kParts>::T;
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
      // Part p of head `head` is head head + p * heads of the maps.
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, L::kStage0);
        for (int p = 0; p < kParts; ++p) {
          Tile<W>::load(base + L::kK + p * L::kKPart, &tk, kv_full, n0,
                        kKeyBlock, head + p * heads);
          Tile<W>::load(base + L::kV + p * L::kKPart, &tv, kv_full, n0,
                        kKeyBlock, head + p * heads);
        }
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
          mbar_arrive_expect_tx(full + 8 * s, L::kLse);
          for (int p = 0; p < kParts; ++p) {
            Tile<W>::load(stage + L::kQ + p * L::kQPart, &tq, full + 8 * s,
                          m0, kQTile, head + p * heads);
            Tile<W>::load(stage + L::kDo + p * L::kQPart, &tdo, full + 8 * s,
                          m0, kQTile, head + p * heads);
          }
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
  // In two parts: S^T comes out s_k s_q times (the softmax scale takes
  // it), dP^T s_v s_do times (dp_back takes it back), dV kPScale s_do
  // times and dK ds_scale s_q times (the epilogue divides them out).
  float dp_back = 1.f, dv_post = 1.f, dk_post = scale;
  RowScale ds_scale;
  if constexpr (kParts == 2) {
    const int bh = heads;
    const float inv_q = slice_inv_scale(amax[head]);
    const float inv_do = slice_inv_scale(amax[3 * bh + head]);
    scale_log2 = scale_log2 * slice_inv_scale(amax[bh + head]) * inv_q;
    dp_back = slice_inv_scale(amax[2 * bh + head]) * inv_do;
    dv_post = inv_do * (1.f / kPScale);
    dk_post = scale * inv_q;
  }

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
      for (int t = 0; t < Score::kN; ++t) {
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          wgmma_ss<kCols, E>(st,
                          Tile<W>::kmajor(base + L::kK + Score::a(t) * L::kKPart,
                                          kKeyBlock, P::row0(wg), kk),
                          Tile<W>::kmajor(qs + Score::b(t) * L::kQPart, kQTile,
                                          c0, kk),
                          t > 0 || kk > 0);
        }
      }
#pragma unroll
      for (int t = 0; t < Score::kN; ++t) {
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          wgmma_ss<kCols, E>(dpt,
                          Tile<W>::kmajor(base + L::kV + Score::a(t) * L::kKPart,
                                          kKeyBlock, P::row0(wg), kk),
                          Tile<W>::kmajor(dos + Score::b(t) * L::kQPart,
                                          kQTile, c0, kk),
                          t > 0 || kk > 0);
        }
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
        dpt[i] = p0 * (dpt[i] * dp_back - dl.x);
        dpt[i + 1] = p1 * (dpt[i + 1] * dp_back - dl.y);
        st[i] = p0;
        st[i + 1] = p1;
      }

      // dV += P^T dO, then dK += dS^T Q, contracting over the pass's
      // queries (k-slices c0/16.. of the q-tile), on this warpgroup's
      // columns of dO and Q; P^T and dS^T in two parts [hi, lo] (bf16,
      // or fp16 beside f32 operands: P^T times kPScale, dS^T times its
      // keys' running scale).
      const int box0 = col0 / Tile<W>::kBoxCols;
      uint32_t pt[2][kCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        if constexpr (kParts == 1) {
          acc_to_a_split(pt[0][kk], pt[1][kk], st + 8 * kk);
        } else {
          const float ps[2] = {kPScale, kPScale};
          acc_to_a_split_f16(pt[0][kk], pt[1][kk], st + 8 * kk, ps);
        }
      }
      // In two parts each pass's products go into a fresh accumulator,
      // `part`, added to dV and dK in f32 after: the tensor cores add
      // into an accumulator with truncation, whose bias over a long sum
      // would pass the ~22-bit operands' rounding.
      float part[kParts == 2 ? kN / 2 : 1];
      float* dv_to = dv_acc;
      float* dk_to = dk_acc;
      if constexpr (kParts == 2) dv_to = dk_to = part;
      wgmma_fence();
      constexpr int kSlices = kCols / 16;
#pragma unroll
      for (int i = 0; i < Grad::kN * kSlices; ++i) {
        const int t = Grad::term(i, kSlices), kk = Grad::slice(i, kSlices);
        const uint64_t b = Tile<W>::mnmajor(
            Tile<W>::box(dos + Grad::b(t) * L::kQPart, kQTile, box0), kQTile,
            c0 / 16 + kk);
        wgmma_rs<kN, E>(dv_to, pt[Grad::a(t)][kk], b, kParts == 1 || i > 0);
      }
      wgmma_commit();
      if constexpr (kParts == 2) {
        wgmma_wait<0>();
        fence_regs<kN / 2>(part);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dv_acc[i] += part[i];
      }
      uint32_t dst[2][kCols / 16][4];
      if constexpr (kParts == 2) {
        ds_scale.update<kCols / 2, kN / 2>(dpt, dk_acc);
      }
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        if constexpr (kParts == 1) {
          acc_to_a_split(dst[0][kk], dst[1][kk], dpt + 8 * kk);
        } else {
          acc_to_a_split_f16(dst[0][kk], dst[1][kk], dpt + 8 * kk,
                             ds_scale.s);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < Grad::kN * kSlices; ++i) {
        const int t = Grad::term(i, kSlices), kk = Grad::slice(i, kSlices);
        const uint64_t b = Tile<W>::mnmajor(
            Tile<W>::box(qs + Grad::b(t) * L::kQPart, kQTile, box0), kQTile,
            c0 / 16 + kk);
        wgmma_rs<kN, E>(dk_to, dst[Grad::a(t)][kk], b, kParts == 1 || i > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kParts == 2) {
        fence_regs<kN / 2>(part);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dk_acc[i] += part[i];
      }
      fence_regs<kN / 2>(dv_acc);
      fence_regs<kN / 2>(dk_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's Q, dO, lse, delta are read
  }

  // Columns col, col + 1 of keys < T, only those < D (D is even).
  Out* dkh = dk + static_cast<int64_t>(head) * T * D;
  Out* dvh = dv + static_cast<int64_t>(head) * T * D;
  float dk_row[2] = {dk_post, dk_post};
  if constexpr (kParts == 2) {
    dk_row[0] = ds_scale.inv(0) * dk_post;
    dk_row[1] = ds_scale.inv(1) * dk_post;
  }
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int key = key0 + 8 * r;
    const int col = col0 + 8 * (i / 4) + 2 * c;
    if (key < T && col < D) {
      const int64_t off = static_cast<int64_t>(key) * D + col;
      store_pair(dkh + off, dk_acc[i] * dk_row[r], dk_acc[i + 1] * dk_row[r]);
      store_pair(dvh + off, dv_acc[i] * dv_post, dv_acc[i + 1] * dv_post);
    }
  }
}

// dQ kernel shared memory: Q, dO, then per stage K and V, then barriers;
// each tile's kParts parts one after the other.
template <int W, int kParts>
struct DqSmem {
  static constexpr int kQBlock = Split<W, kParts>::kRows;  // queries per block
  static constexpr int kQPart = Tile<W>::bytes(kQBlock);  // of Q or dO
  static constexpr int kQ = 0;
  static constexpr int kDo = kParts * kQPart;
  static constexpr int kStage0 = 2 * kParts * kQPart;
  static constexpr int kKPart = Tile<W>::bytes(kKeyTile);  // of K or V
  static constexpr int kK = 0;  // offsets within a stage
  static constexpr int kV = kParts * kKPart;
  static constexpr int kStage = 2 * kParts * kKPart;
  static constexpr int kBar = kStage0 + kStages * kStage;
  // qdo_full, full[kStages], empty[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int W, bool kCausal, typename Out, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint32_t* __restrict__ amax,
                    Out* __restrict__ dq, int T, int D, float scale,
                    float scale_log2) {
  using L = DqSmem<W, kParts>;
  using P = Split<W, kParts>;
  using Score = Terms<kParts, kParts>;  // S = Q K^T, dP = dO V^T
  using Grad = Terms<2, kParts>;        // dQ += dS K
  using E = typename Part<kParts>::T;
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
      // Part p of head `head` is head head + p * heads of the maps.
      mbar_arrive_expect_tx(qdo_full, L::kStage0);
      for (int p = 0; p < kParts; ++p) {
        Tile<W>::load(base + L::kQ + p * L::kQPart, &tq, qdo_full, m0, kQBlock,
                      head + p * heads);
        Tile<W>::load(base + L::kDo + p * L::kQPart, &tdo, qdo_full, m0,
                      kQBlock, head + p * heads);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStages;
        const uint32_t stage = base + L::kStage0 + s * L::kStage;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, L::kStage);
        for (int p = 0; p < kParts; ++p) {
          Tile<W>::load(stage + L::kK + p * L::kKPart, &tk, full + 8 * s,
                        it * kKeyTile, kKeyTile, head + p * heads);
          Tile<W>::load(stage + L::kV + p * L::kKPart, &tv, full + 8 * s,
                        it * kKeyTile, kKeyTile, head + p * heads);
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
  // In two parts: S comes out s_q s_k times, dP s_do s_v times, dQ
  // ds_scale s_k times (as in the dK/dV kernel).
  float dp_back = 1.f, dq_post = scale;
  RowScale ds_scale;
  if constexpr (kParts == 2) {
    const int bh = heads;
    const float inv_k = slice_inv_scale(amax[bh + head]);
    scale_log2 = scale_log2 * slice_inv_scale(amax[head]) * inv_k;
    dp_back = slice_inv_scale(amax[3 * bh + head]) *
              slice_inv_scale(amax[2 * bh + head]);
    dq_post = scale * inv_k;
  }

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
      for (int t = 0; t < Score::kN; ++t) {
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          wgmma_ss<kKeyTile, E>(
              sc,
              Tile<W>::kmajor(base + L::kQ + Score::a(t) * L::kQPart, kQBlock,
                              P::row0(wg), kk),
              Tile<W>::kmajor(ks + Score::b(t) * L::kKPart, kKeyTile, 0, kk),
              t > 0 || kk > 0);
        }
      }
#pragma unroll
      for (int t = 0; t < Score::kN; ++t) {
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          wgmma_ss<kKeyTile, E>(
              dp,
              Tile<W>::kmajor(base + L::kDo + Score::a(t) * L::kQPart, kQBlock,
                              P::row0(wg), kk),
              Tile<W>::kmajor(vs + Score::b(t) * L::kKPart, kKeyTile, 0, kk),
              t > 0 || kk > 0);
        }
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
        dp[i] = p * (dp[i] * dp_back - dl[r]);
      }
      // dQ += dS K (scaled once, at the store), on this warpgroup's
      // columns of K; dS in two parts [hi, lo] (bf16, or fp16 times its
      // rows' running scale beside f32 operands).
      uint32_t ds[2][kKeyTile / 16][4];
      if constexpr (kParts == 2) {
        ds_scale.update<kKeyTile / 2, kN / 2>(dp, dq_acc);
      }
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        if constexpr (kParts == 1) {
          acc_to_a_split(ds[0][kk], ds[1][kk], dp + 8 * kk);
        } else {
          acc_to_a_split_f16(ds[0][kk], ds[1][kk], dp + 8 * kk, ds_scale.s);
        }
      }
      // In two parts the tile's products go into a fresh accumulator,
      // added to dQ in f32 after (as dV and dK in the dK/dV kernel).
      float part[kParts == 2 ? kN / 2 : 1];
      float* dq_to = dq_acc;
      if constexpr (kParts == 2) dq_to = part;
      wgmma_fence();
      constexpr int kSlices = kKeyTile / 16;
#pragma unroll
      for (int i = 0; i < Grad::kN * kSlices; ++i) {
        const int t = Grad::term(i, kSlices), kk = Grad::slice(i, kSlices);
        const uint64_t b = Tile<W>::mnmajor(
            Tile<W>::box(ks + Grad::b(t) * L::kKPart, kKeyTile,
                         col0 / Tile<W>::kBoxCols),
            kKeyTile, kk);
        wgmma_rs<kN, E>(dq_to, ds[Grad::a(t)][kk], b, kParts == 1 || i > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kParts == 2) {
        fence_regs<kN / 2>(part);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dq_acc[i] += part[i];
      }
      fence_regs<kN / 2>(dq_acc);
    }
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  // Columns col, col + 1 of rows < T, only those < D (D is even).
  Out* dqh = dq + static_cast<int64_t>(head) * T * D;
  float dq_row[2] = {dq_post, dq_post};
  if constexpr (kParts == 2) {
    dq_row[0] = ds_scale.inv(0) * dq_post;
    dq_row[1] = ds_scale.inv(1) * dq_post;
  }
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = col0 + 8 * (i / 4) + 2 * c;
    if (row < T && col < D) {
      store_pair(dqh + static_cast<int64_t>(row) * D + col,
                 dq_acc[i] * dq_row[r], dq_acc[i + 1] * dq_row[r]);
    }
  }
}

// q, k, v, do_tiles: kParts parts of B * H heads each (hopper.cuh), read
// by the tensor maps; o and dout: [B, H, T, D] of In, read by the delta
// kernel.
template <int W, bool kCausal, typename Out, int kParts, typename In>
int launch(const void* q, const void* k, const void* v, const void* do_tiles,
           const In* o, const In* dout, const void* lse, void* delta,
           const uint32_t* amax, void* dq, void* dk, void* dv, int B, int H,
           int T, int D, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int heads = kParts * B * H;
  constexpr CUtensorMapDataType type = Part<kParts>::kMap;
  int err = make_tile_map<W>(&tq, q, heads, T, D, type);
  if (err == 0) err = make_tile_map<W>(&tk, k, heads, T, D, type);
  if (err == 0) err = make_tile_map<W>(&tv, v, heads, T, D, type);
  if (err == 0) err = make_tile_map<W>(&tdo, do_tiles, heads, T, D, type);
  // The shared-memory limits are properties of the kernels on a device:
  // set once per device, not on every launch.
  static PerDevice smem_set;
  int done = 0;
  if (err == 0) {
    err = smem_set.get(&done, [](int, int* set) {
      *set = 1;
      cudaError_t e = cudaFuncSetAttribute(
          flash_bwd_dkdv_kernel<W, kCausal, Out, kParts>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          DkvSmem<W, kParts>::kAlloc);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(flash_bwd_dq_kernel<W, kCausal, Out, kParts>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DqSmem<W, kParts>::kAlloc);
      }
      return e;
    });
  }
  if (err != 0) return err;

  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const int64_t rows = static_cast<int64_t>(B) * H * T;
  constexpr int kRowsPerBlock = kDeltaThreads / (W * sizeof(In) / 16);
  const int64_t delta_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  // One block per (row tile, head) in both the dK/dV and dQ grids: 128
  // rows a tile, 64 where the warpgroups split the columns.
  constexpr int kRows = Split<W, kParts>::kRows;
  const int64_t blocks = static_cast<int64_t>((T + kRows - 1) / kRows) * B * H;
  if (delta_blocks > 0x7fffffff || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_delta_kernel<W, In><<<static_cast<unsigned>(delta_blocks),
                                  kDeltaThreads, 0, stream>>>(
      o, dout, delta32, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dkdv_kernel<W, kCausal, Out, kParts>
      <<<static_cast<unsigned>(blocks), kThreads, DkvSmem<W, kParts>::kAlloc,
         stream>>>(tq, tk, tv, tdo, lse32, delta32, amax,
                   static_cast<Out*>(dk), static_cast<Out*>(dv), T, D, scale,
                   scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  flash_bwd_dq_kernel<W, kCausal, Out, kParts>
      <<<static_cast<unsigned>(blocks), kThreads, DqSmem<W, kParts>::kAlloc,
         stream>>>(tq, tk, tv, tdo, lse32, delta32, amax,
                   static_cast<Out*>(dq), T, D, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The smallest tile width that holds head dim D (a multiple of 8, at
// most 256 in one part, 128 in two; the entry points check).
template <bool kCausal, typename Out, int kParts, typename In>
int launch_d(const void* q, const void* k, const void* v,
             const void* do_tiles, const In* o, const In* dout,
             const void* lse, void* delta, const uint32_t* amax, void* dq,
             void* dk, void* dv, int B, int H, int T, int D, float scale,
             cudaStream_t s) {
  if (D <= 16) {
    return launch<16, kCausal, Out, kParts>(q, k, v, do_tiles, o, dout, lse,
                                            delta, amax, dq, dk, dv, B, H, T, D,
                                            scale, s);
  }
  if (D <= 32) {
    return launch<32, kCausal, Out, kParts>(q, k, v, do_tiles, o, dout, lse,
                                            delta, amax, dq, dk, dv, B, H, T, D,
                                            scale, s);
  }
  if (D <= 64) {
    return launch<64, kCausal, Out, kParts>(q, k, v, do_tiles, o, dout, lse,
                                            delta, amax, dq, dk, dv, B, H, T, D,
                                            scale, s);
  }
  if (D <= 128) {
    return launch<128, kCausal, Out, kParts>(q, k, v, do_tiles, o, dout, lse,
                                             delta, amax, dq, dk, dv, B, H, T, D,
                                             scale, s);
  }
  if constexpr (kParts == 1) {
    return launch<256, kCausal, Out, 1>(q, k, v, do_tiles, o, dout, lse,
                                        delta, amax, dq, dk, dv, B, H, T, D,
                                        scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Out, int kParts, typename In>
int launch_c(const void* q, const void* k, const void* v,
             const void* do_tiles, const In* o, const In* dout,
             const void* lse, void* delta, const uint32_t* amax, void* dq,
             void* dk, void* dv, int B, int H, int T, int D, int causal,
             float scale, cudaStream_t s) {
  return causal ? launch_d<true, Out, kParts>(q, k, v, do_tiles, o, dout, lse,
                                              delta, amax, dq, dk, dv, B, H,
                                              T, D, scale, s)
                : launch_d<false, Out, kParts>(q, k, v, do_tiles, o, dout,
                                               lse, delta, amax, dq, dk, dv,
                                               B, H, T, D, scale, s);
}

bool bad_shape(int B, int H, int T, int D, int max_d) {
  return B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535 || D <= 0 ||
         D > max_d || D % 8 != 0;
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
  if (bad_shape(B, H, T, D, 256)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o16 = static_cast<const uint16_t*>(o);
  const auto* do16 = static_cast<const uint16_t*>(dout);
  return f32_out ? launch_c<float, 1>(q, k, v, dout, o16, do16, lse, delta,
                                      nullptr, dq, dk, dv, B, H, T, D, causal,
                                      scale, s)
                 : launch_c<uint16_t, 1>(q, k, v, dout, o16, do16, lse, delta,
                                         nullptr, dq, dk, dv, B, H, T, D,
                                         causal, scale, s);
}

// The same for f32 q, k, v, o, dout and dq, dk, dv, D a multiple of 8 up
// to 128; parts: scratch of [4, 2, B, H, T, D] fp16 (8 x 2 bytes an
// element of q), and amax of [4, B * H] uint32, which the pre-pass fills
// with the fp16 parts of q, k, v and dout and their slices' largest |x|
// before the kernels read them. Eleven launches and a memset on
// `stream`.
extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* parts,
                                  void* amax, void* dq, void* dk, void* dv,
                                  int B, int H, int T, int D, int causal,
                                  float scale, int device, void* stream) {
  if (bad_shape(B, H, T, D, 128)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t slices = static_cast<int64_t>(B) * H;
  const int64_t n = static_cast<int64_t>(T) * D;  // per slice
  const void* src[4] = {q, k, v, dout};
  const int err = split_operands(src, 4, parts, amax, slices, n, s);
  if (err != 0) return err;
  const __half* p = static_cast<const __half*>(parts);
  const int64_t part = 2 * slices * n;  // an operand's two parts
  return launch_c<float, 2>(p, p + part, p + 2 * part, p + 3 * part,
                            static_cast<const float*>(o),
                            static_cast<const float*>(dout), lse, delta,
                            static_cast<const uint32_t*>(amax), dq, dk, dv, B,
                            H, T, D, causal, scale, s);
}
