// Flash attention, forward and backward, at head dims wider than one tile
// of flash_attn_fwd.cu and flash_attn_bwd.cu holds: bf16 q, k, v over
// head dim 256, f32 q, k, v over 128. The same functions as those kernels
// (o and lse; dq, dk, dv from o, lse and do; causal or not; outputs in
// the input dtype or f32, the instances the ring runs), with the head dim
// split across tiles of 64 columns.
//
// Replaces, at those widths, the TPU kernels those files replace:
//   - `_splash_attention` and `_flash_attention` and their backward
//     kernels (kubernetes_tpu/workloads/lm.py:163-239), which the
//     reference runs at any head dim;
//   - the ring's blocks (kubernetes_tpu/workloads/ring_attention.py:43-56),
//     whose einsums take any head dim.
//
// Why a kernel of its own. A tile of the fused kernels holds a row's
// whole head dim: Q for 128 queries and two stages of K and V at D 256 in
// bf16 already take 192 KB of a block's 227 KB (Smem<256, 1>), and f32's
// two parts double every tile. So here no tile is wider than 64 columns:
//   - S = Q K^T is summed over the head dim's 64-column slices (Q_s K_s^T
//     for s = 0.. D/64), each slice a pair of 64 x 64 tiles;
//   - every output is made one 64-column block at a time: a block of the
//     grid owns one (64-row tile, column block, head) and computes its
//     columns of O, or of dK and dV, or of dQ, recomputing S (and dP)
//     over all slices for its column block.
// That is the simplest design that is right at any width: D / 64 column
// blocks each recompute S, so the forward executes (D / 64 + 1) / 2
// times the useful products and the backward more. Speed is later work.
//
// Structure (the building blocks of hopper.cuh): one consumer warpgroup
// of 64 rows per block and one producer warp that TMA-loads a ring of
// kStages stages, each holding two 64 x 64 tiles (an "item": Q_s and K_s
// for S, V_s and dO_s for dP, or one column block for a product) in
// kParts parts; "full" and "empty" barriers as in the fused kernels.
// Every tile comes through one tensor map of box 64 columns x 64 rows
// (Tile<64>, 128-byte swizzle); columns past D and rows past T arrive as
// zeros, which add nothing to S or dP and give output columns that are
// never stored.
//
// Dtypes, as in the fused kernels. bf16: P rounded once to bf16 for P V,
// P and dS split into bf16 hi + lo for the backward's products. f32: the
// entry points split q, k, v (and do) into fp16 parts under a power of 2
// per [batch, head] slice in a pre-pass (hopper.cuh's split_operands), S
// and dP take three fp16 products per slice pair, P enters under the
// fixed scale kPScale, dS under a running scale per row of the product
// (RowScale), and the scales are divided out at the store; each tile's
// products with P or dS go into a fresh accumulator, added to the output
// in f32 (the tensor cores' own adds truncate).
//
// Bound: operations, as the fused kernels (4 B H D T^2, half of it
// causal, forward; 2.5 times that backward), over the bf16 rate or, for
// f32 operands, the TF32 rate a user asking for f32 would get.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;     // rows (queries or keys) of a block's tile
constexpr int kSlice = 64;    // head-dim columns of a tile
constexpr int kStages = 4;
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;
using Tl = Tile<kSlice>;

// The ring, from a 1024-byte aligned base: kStages stages of two tiles
// (A, then B) of kParts parts each, then the full and empty barriers.
template <int kParts>
struct Ring {
  static constexpr int kPart = Tl::bytes(kRows);  // 8 KB
  static constexpr int kTile = kParts * kPart;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kAlloc = kBar + 8 * 2 * kStages + 1024;
};

__device__ __forceinline__ uint32_t ring_base(unsigned char* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The tile of rows row0.. and columns col0.. of each part of `head` (part
// p is head head + p * heads of the map) into dst, a part after a part.
template <int kParts>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col0, int row0,
                                          int head, int heads) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    tma_load_3d(dst + p * Ring<kParts>::kPart, map, bar, col0, row0,
                head + p * heads);
  }
}

// The producer's side of item `it`: waits for its stage to be free, then
// loads tile a (and tile b, when there is one) into it.
template <int kParts>
__device__ __forceinline__ void produce(uint32_t base, uint32_t full,
                                        uint32_t empty, int it,
                                        const CUtensorMap* ma, int ca, int ra,
                                        const CUtensorMap* mb, int cb, int rb,
                                        int head, int heads) {
  using L = Ring<kParts>;
  const int s = it % kStages;
  const uint32_t st = base + s * L::kStage;
  mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(full + 8 * s, (mb ? 2 : 1) * L::kTile);
  load_tile<kParts>(st, ma, full + 8 * s, ca, ra, head, heads);
  if (mb) load_tile<kParts>(st + L::kTile, mb, full + 8 * s, cb, rb, head, heads);
}

// The consumer's side: waits for item `it` and returns its stage.
template <int kParts>
__device__ __forceinline__ uint32_t consume(uint32_t base, uint32_t full,
                                            int it) {
  const int s = it % kStages;
  mbar_wait(full + 8 * s, (it / kStages) & 1);
  return base + s * Ring<kParts>::kStage;
}

__device__ __forceinline__ void release(uint32_t empty, int it) {
  mbar_arrive(empty + 8 * (it % kStages));
}

// acc (+)= A B^T over one slice: A and B the stage's two 64 x 64 tiles,
// K-major, in parts (Terms).
template <int kParts>
__device__ __forceinline__ void slice_product(float* acc, uint32_t st,
                                              bool first) {
  using L = Ring<kParts>;
  using Prod = Terms<kParts, kParts>;
  using E = typename Part<kParts>::T;
#pragma unroll
  for (int t = 0; t < Prod::kN; ++t) {
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk) {
      wgmma_ss<kRows, E>(acc, Tl::kmajor(st + Prod::a(t) * L::kPart, kRows, 0, kk),
                         Tl::kmajor(st + L::kTile + Prod::b(t) * L::kPart,
                                    kRows, 0, kk),
                         !first || t > 0 || kk > 0);
    }
  }
}

// acc += A B (acc = A B when `fresh`): A the 64 x 64 operand in kA parts
// of fragments (a[part][kk], kk the 16-column k-slice), B the tile at
// `tile` (64 rows of the contraction x 64 columns), MN-major, in kParts
// parts.
template <int kA, int kParts>
__device__ __forceinline__ void frag_product(float* acc,
                                             uint32_t (*a)[4][4],
                                             uint32_t tile, bool fresh) {
  using Prod = Terms<kA, kParts>;
  using E = typename Part<kParts>::T;
  constexpr int kSlices = kRows / 16;
#pragma unroll
  for (int i = 0; i < Prod::kN * kSlices; ++i) {
    const int t = Prod::term(i, kSlices), kk = Prod::slice(i, kSlices);
    wgmma_rs<kSlice, E>(acc, a[Prod::a(t)][kk],
                        Tl::mnmajor(tile + Prod::b(t) * Ring<kParts>::kPart,
                                    kRows, kk),
                        !fresh || i > 0);
  }
}

// acc += A B as frag_product, then waits for it. With f32 operands the
// product goes into a fresh accumulator, `part`, added to acc in f32
// after: the tensor cores add into an accumulator with truncation, whose
// bias over a long sum would pass the ~22-bit operands' rounding.
template <int kA, int kParts>
__device__ __forceinline__ void add_product(float* acc, float* part,
                                            uint32_t (*a)[4][4],
                                            uint32_t tile) {
  wgmma_fence();
  frag_product<kA, kParts>(kParts == 2 ? part : acc, a, tile, kParts == 2);
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (kParts == 2) {
    fence_regs<kSlice / 2>(part);
#pragma unroll
    for (int i = 0; i < kSlice / 2; ++i) acc[i] += part[i];
  }
  fence_regs<kSlice / 2>(acc);
}

// The inverse scale of operand i's slice of `head` (f32 operands; 1 for
// bf16).
template <int kParts>
__device__ __forceinline__ float inv_scale(const uint32_t* amax, int i,
                                           int head, int heads) {
  if constexpr (kParts == 2) {
    return slice_inv_scale(amax[i * heads + head]);
  } else {
    return 1.f;
  }
}

// Entries 8kk..8kk+7 of a 64 x 64 accumulator as A fragments: bf16 P
// rounded once (kParts 1, forward), or two parts: bf16 hi + lo (bf16
// operands), fp16 hi + lo times s[row] (f32 operands).
template <int kParts, int kOut>
__device__ __forceinline__ void to_frags(uint32_t (*a)[4][4], const float* x,
                                         const float* s) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    if constexpr (kOut == 1) {
      acc_to_a(a[0][kk], x + 8 * kk);
    } else if constexpr (kParts == 1) {
      acc_to_a_split(a[0][kk], a[1][kk], x + 8 * kk);
    } else {
      acc_to_a_split_f16(a[0][kk], a[1][kk], x + 8 * kk, s);
    }
  }
}

// Grid of (64-row tile, column block, head) blocks, tile-major from the
// last tile (the longest, causal, in the forward and dQ kernels).
struct Block {
  int tile, col0, head;
  __device__ Block(int tiles, int heads, bool from_last) {
    const int per_tile = gridDim.x / tiles;
    const int t = static_cast<int>(blockIdx.x) / per_tile;
    const int rem = static_cast<int>(blockIdx.x) % per_tile;
    tile = from_last ? tiles - 1 - t : t;
    col0 = rem / heads * kSlice;
    head = rem % heads;
  }
};

// ---- forward ----------------------------------------------------------

template <bool kCausal, typename Out, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, Out* __restrict__ o,
                float* __restrict__ lse, const uint32_t* __restrict__ amax,
                int heads, int T, int D, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  const uint32_t full = base + Ring<kParts>::kBar;
  const uint32_t empty = full + 8 * kStages;
  const int tiles = (T + kRows - 1) / kRows;
  const Block blk(tiles, heads, true);
  const int m0 = blk.tile * kRows;
  const int slices = (D + kSlice - 1) / kSlice;
  // Key tiles n_tiles-1, ..., 0: causal, from the diagonal.
  const int n_tiles = kCausal ? blk.tile + 1 : tiles;
  init_ring(full, empty);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int n0 = (n_tiles - 1 - t) * kRows;
        for (int j = 0; j < slices; ++j, ++it) {
          produce<kParts>(base, full, empty, it, &tq, j * kSlice, m0, &tk,
                          j * kSlice, n0, blk.head, heads);
        }
        produce<kParts>(base, full, empty, it++, &tv, blk.col0, n0, nullptr,
                        0, 0, blk.head, heads);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows r0, r0 + 8
  // f32 operands: S comes out s_q s_k times, O s_v kPScale times.
  float post = 1.f;
  if constexpr (kParts == 2) {
    scale_log2 *= inv_scale<2>(amax, 0, blk.head, heads) *
                  inv_scale<2>(amax, 1, blk.head, heads);
    post = inv_scale<2>(amax, 2, blk.head, heads) * (1.f / kPScale);
  }
  float acc[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = (n_tiles - 1 - t) * kRows;
    float sc[kRows / 2];
    for (int j = 0; j < slices; ++j, ++it) {
      const uint32_t st = consume<kParts>(base, full, it);
      wgmma_fence();
      slice_product<kParts>(sc, st, j == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kRows / 2>(sc);
      release(empty, it);
    }
    // The first tile taken is the only one masked: the diagonal
    // (causal) or the one holding T's last keys.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2);
      const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
      const bool masked = kCausal ? key > row : key >= T;
      const float x = (t == 0 && masked) ? -INFINITY : sc[i] * scale_log2;
      sc[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    float corr[2], base_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base_max[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m_run[r] - base_max[r]);
      m_run[r] = mx[r];
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      sc[i] = exp2f(sc[i] - base_max[(i % 4) / 2]);
      rowsum[(i % 4) / 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int i = 0; i < kSlice / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    // O's column block += P V_c.
    uint32_t pf[kParts][kRows / 16][4];
    const float ps[2] = {kPScale, kPScale};
    to_frags<kParts, kParts>(pf, sc, ps);
    const uint32_t st = consume<kParts>(base, full, it);
    float part[kSlice / 2];
    add_product<kParts, kParts>(acc, part, pf, st);
    release(empty, it++);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  Out* oh = o + static_cast<int64_t>(blk.head) * T * D;
#pragma unroll
  for (int i = 0; i < kSlice / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = blk.col0 + 8 * (i / 4) + 2 * c;
    if (row < T && col < D) {
      store_pair(oh + static_cast<int64_t>(row) * D + col,
                 acc[i] * inv[r] * post, acc[i + 1] * inv[r] * post);
    }
  }
  if (c == 0 && blk.col0 == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    float* lseh = lse + static_cast<int64_t>(blk.head) * T;
    if (r0 < T) lseh[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r0 + 8 < T) lseh[r0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

// ---- backward -----------------------------------------------------------

// delta[r] = sum_d do[r, d] o[r, d] in f32: one warp a row.
template <typename In>
__device__ __forceinline__ float to_f32(In x);
template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

constexpr int kDeltaThreads = 128;

template <typename In>
__global__ void __launch_bounds__(kDeltaThreads)
wide_delta_kernel(const In* __restrict__ o, const In* __restrict__ dout,
                  float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kDeltaThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp
  const int lane = threadIdx.x % 32;
  const In* a = o + row * D;
  const In* b = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(a[d]) * to_f32(b[d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) delta[row] = sum;
}

// dK and dV of one (64-key tile, column block, head): for each q-tile
// from the diagonal (causal) or the first, S^T = K Q^T and dP^T = V dO^T
// over every slice, P^T and dS^T in registers, then dV_c += P^T dO_c and
// dK_c += dS^T Q_c.
template <bool kCausal, typename Out, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
wide_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const uint32_t* __restrict__ amax, Out* __restrict__ dk,
                 Out* __restrict__ dv, int heads, int T, int D, float scale,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  const uint32_t full = base + Ring<kParts>::kBar;
  const uint32_t empty = full + 8 * kStages;
  const int tiles = (T + kRows - 1) / kRows;
  const Block blk(tiles, heads, false);
  const int n0 = blk.tile * kRows;
  const int slices = (D + kSlice - 1) / kSlice;
  const int m_first = kCausal ? blk.tile : 0;
  init_ring(full, empty);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int m = m_first; m < tiles; ++m) {
        const int m0 = m * kRows;
        for (int j = 0; j < slices; ++j) {
          produce<kParts>(base, full, empty, it++, &tk, j * kSlice, n0, &tq,
                          j * kSlice, m0, blk.head, heads);
          produce<kParts>(base, full, empty, it++, &tv, j * kSlice, n0, &tdo,
                          j * kSlice, m0, blk.head, heads);
        }
        produce<kParts>(base, full, empty, it++, &tdo, blk.col0, m0, &tq,
                        blk.col0, m0, blk.head, heads);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys key0, key0 + 8
  // f32 operands: S^T comes out s_k s_q times, dP^T s_v s_do times, dV
  // kPScale s_do times, dK ds_scale s_q times.
  float dp_back = 1.f, dv_post = 1.f, dk_post = scale;
  RowScale ds_scale;
  if constexpr (kParts == 2) {
    const float inv_q = inv_scale<2>(amax, 0, blk.head, heads);
    const float inv_do = inv_scale<2>(amax, 3, blk.head, heads);
    scale_log2 *= inv_scale<2>(amax, 1, blk.head, heads) * inv_q;
    dp_back = inv_scale<2>(amax, 2, blk.head, heads) * inv_do;
    dv_post = inv_do * (1.f / kPScale);
    dk_post = scale * inv_q;
  }
  const float* lseh = lse + static_cast<int64_t>(blk.head) * T;
  const float* deltah = delta + static_cast<int64_t>(blk.head) * T;
  float dk_acc[kSlice / 2], dv_acc[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int it = 0;
  for (int m = m_first; m < tiles; ++m) {
    const int m0 = m * kRows;
    float st[kRows / 2], dpt[kRows / 2];
    for (int j = 0; j < slices; ++j, it += 2) {
      const uint32_t kq = consume<kParts>(base, full, it);
      wgmma_fence();
      slice_product<kParts>(st, kq, j == 0);
      const uint32_t vdo = consume<kParts>(base, full, it + 1);
      slice_product<kParts>(dpt, vdo, j == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kRows / 2>(st);
      fence_regs<kRows / 2>(dpt);
      release(empty, it);
      release(empty, it + 1);
    }
    // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where the key is
    // after the query (the diagonal tile) or the query is past T (its
    // lse read as +inf); dS^T = P^T (dP^T - delta) in place of dP^T.
    // Queries are the columns here.
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int key = key0 + 8 * ((i % 4) / 2);
      const int q = m0 + 8 * (i / 4) + 2 * c + (i % 2);
      const bool in = q < T;
      const float l2 = in ? lseh[q] * kLog2e : INFINITY;
      const float dl = in ? deltah[q] : 0.f;
      float p = exp2f(st[i] * scale_log2 - l2);
      if (kCausal && m == blk.tile && key > q) p = 0.f;
      dpt[i] = p * (dpt[i] * dp_back - dl);
      st[i] = p;
    }
    uint32_t pt[2][kRows / 16][4], dst[2][kRows / 16][4];
    const float ps[2] = {kPScale, kPScale};
    to_frags<kParts, 2>(pt, st, ps);
    if constexpr (kParts == 2) {
      ds_scale.update<kRows / 2, kSlice / 2>(dpt, dk_acc);
    }
    to_frags<kParts, 2>(dst, dpt, ds_scale.s);
    const uint32_t doq = consume<kParts>(base, full, it);
    float part[kSlice / 2];
    add_product<2, kParts>(dv_acc, part, pt, doq);
    add_product<2, kParts>(dk_acc, part, dst, doq + Ring<kParts>::kTile);
    release(empty, it++);
  }

  Out* dkh = dk + static_cast<int64_t>(blk.head) * T * D;
  Out* dvh = dv + static_cast<int64_t>(blk.head) * T * D;
  float dk_row[2] = {dk_post, dk_post};
  if constexpr (kParts == 2) {
    dk_row[0] = ds_scale.inv(0) * dk_post;
    dk_row[1] = ds_scale.inv(1) * dk_post;
  }
#pragma unroll
  for (int i = 0; i < kSlice / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int key = key0 + 8 * r;
    const int col = blk.col0 + 8 * (i / 4) + 2 * c;
    if (key < T && col < D) {
      const int64_t off = static_cast<int64_t>(key) * D + col;
      store_pair(dkh + off, dk_acc[i] * dk_row[r], dk_acc[i + 1] * dk_row[r]);
      store_pair(dvh + off, dv_acc[i] * dv_post, dv_acc[i + 1] * dv_post);
    }
  }
}

// dQ of one (64-query tile, column block, head): for each key tile up to
// the diagonal (causal) or to the end, S = Q K^T and dP = dO V^T over
// every slice, dS in registers, then dQ_c += dS K_c.
template <bool kCausal, typename Out, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
wide_dq_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint32_t* __restrict__ amax, Out* __restrict__ dq,
               int heads, int T, int D, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  const uint32_t full = base + Ring<kParts>::kBar;
  const uint32_t empty = full + 8 * kStages;
  const int tiles = (T + kRows - 1) / kRows;
  const Block blk(tiles, heads, true);
  const int m0 = blk.tile * kRows;
  const int slices = (D + kSlice - 1) / kSlice;
  const int n_tiles = kCausal ? blk.tile + 1 : tiles;
  init_ring(full, empty);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int n = 0; n < n_tiles; ++n) {
        const int n0 = n * kRows;
        for (int j = 0; j < slices; ++j) {
          produce<kParts>(base, full, empty, it++, &tq, j * kSlice, m0, &tk,
                          j * kSlice, n0, blk.head, heads);
          produce<kParts>(base, full, empty, it++, &tdo, j * kSlice, m0, &tv,
                          j * kSlice, n0, blk.head, heads);
        }
        produce<kParts>(base, full, empty, it++, &tk, blk.col0, n0, nullptr,
                        0, 0, blk.head, heads);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows r0, r0 + 8
  // f32 operands: S comes out s_q s_k times, dP s_do s_v times, dQ
  // ds_scale s_k times.
  float dp_back = 1.f, dq_post = scale;
  RowScale ds_scale;
  if constexpr (kParts == 2) {
    const float inv_k = inv_scale<2>(amax, 1, blk.head, heads);
    scale_log2 *= inv_scale<2>(amax, 0, blk.head, heads) * inv_k;
    dp_back = inv_scale<2>(amax, 3, blk.head, heads) *
              inv_scale<2>(amax, 2, blk.head, heads);
    dq_post = scale * inv_k;
  }
  // lse in the log2 domain; +inf past T makes P 0 there.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int64_t at = static_cast<int64_t>(blk.head) * T + row;
    lse2[r] = row < T ? lse[at] * kLog2e : INFINITY;
    dl[r] = row < T ? delta[at] : 0.f;
  }
  float dq_acc[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) dq_acc[i] = 0.f;

  int it = 0;
  for (int n = 0; n < n_tiles; ++n) {
    const int n0 = n * kRows;
    float sc[kRows / 2], dp[kRows / 2];
    for (int j = 0; j < slices; ++j, it += 2) {
      const uint32_t qk = consume<kParts>(base, full, it);
      wgmma_fence();
      slice_product<kParts>(sc, qk, j == 0);
      const uint32_t dov = consume<kParts>(base, full, it + 1);
      slice_product<kParts>(dp, dov, j == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kRows / 2>(sc);
      fence_regs<kRows / 2>(dp);
      release(empty, it);
      release(empty, it + 1);
    }
    // P masked where the key is after the row (the diagonal tile,
    // causal) or past T (non-causal: the last tile), then dS in place of
    // dP.
    const bool edge = kCausal ? n == blk.tile : n == tiles - 1;
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int r = (i % 4) / 2;
      const int row = r0 + 8 * r;
      const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
      float p = exp2f(sc[i] * scale_log2 - lse2[r]);
      if (edge && (kCausal ? key > row : key >= T)) p = 0.f;
      dp[i] = p * (dp[i] * dp_back - dl[r]);
    }
    uint32_t ds[2][kRows / 16][4];
    if constexpr (kParts == 2) {
      ds_scale.update<kRows / 2, kSlice / 2>(dp, dq_acc);
    }
    to_frags<kParts, 2>(ds, dp, ds_scale.s);
    const uint32_t kc = consume<kParts>(base, full, it);
    float part[kSlice / 2];
    add_product<2, kParts>(dq_acc, part, ds, kc);
    release(empty, it++);
  }

  Out* dqh = dq + static_cast<int64_t>(blk.head) * T * D;
  float dq_row[2] = {dq_post, dq_post};
  if constexpr (kParts == 2) {
    dq_row[0] = ds_scale.inv(0) * dq_post;
    dq_row[1] = ds_scale.inv(1) * dq_post;
  }
#pragma unroll
  for (int i = 0; i < kSlice / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = blk.col0 + 8 * (i / 4) + 2 * c;
    if (row < T && col < D) {
      store_pair(dqh + static_cast<int64_t>(row) * D + col,
                 dq_acc[i] * dq_row[r], dq_acc[i + 1] * dq_row[r]);
    }
  }
}

// ---- host ---------------------------------------------------------------

template <int kParts>
int maps(CUtensorMap* out, const void* const* ptrs, int n, int heads, int T,
         int D) {
  for (int i = 0; i < n; ++i) {
    const int err = make_tile_map<kSlice>(out + i, ptrs[i], kParts * heads, T,
                                          D, Part<kParts>::kMap);
    if (err != 0) return err;
  }
  return 0;
}

// The grid of (64-row tile, column block, head) blocks, or 0 past the
// grid's limit.
inline int64_t grid_blocks(int heads, int T, int D) {
  const int64_t blocks = static_cast<int64_t>((T + kRows - 1) / kRows) *
                         ((D + kSlice - 1) / kSlice) * heads;
  return blocks > 0x7fffffff ? 0 : blocks;
}

template <typename Kernel>
int set_smem(Kernel kernel, PerDevice* flag, int bytes) {
  int done = 0;
  return flag->get(&done, [&](int, int* set) {
    *set = 1;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
  });
}

template <bool kCausal, typename Out, int kParts>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const uint32_t* amax, int heads, int T, int D, float scale_log2,
        cudaStream_t s) {
  CUtensorMap m[3];
  const void* ptrs[3] = {q, k, v};
  int err = maps<kParts>(m, ptrs, 3, heads, T, D);
  static PerDevice smem_set;
  constexpr int kBytes = Ring<kParts>::kAlloc;
  auto kernel = wide_fwd_kernel<kCausal, Out, kParts>;
  if (err == 0) err = set_smem(kernel, &smem_set, kBytes);
  if (err != 0) return err;
  const int64_t blocks = grid_blocks(heads, T, D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      m[0], m[1], m[2], static_cast<Out*>(o), static_cast<float*>(lse), amax,
      heads, T, D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal, typename Out, int kParts, typename In>
int bwd(const void* q, const void* k, const void* v, const void* do_tiles,
        const In* o, const In* dout, const void* lse, void* delta,
        const uint32_t* amax, void* dq, void* dk, void* dv, int heads, int T,
        int D, float scale, cudaStream_t s) {
  CUtensorMap m[4];
  const void* ptrs[4] = {q, k, v, do_tiles};
  int err = maps<kParts>(m, ptrs, 4, heads, T, D);
  static PerDevice dkdv_set, dq_set;
  constexpr int kBytes = Ring<kParts>::kAlloc;
  auto dkdv = wide_dkdv_kernel<kCausal, Out, kParts>;
  auto dqk = wide_dq_kernel<kCausal, Out, kParts>;
  if (err == 0) err = set_smem(dkdv, &dkdv_set, kBytes);
  if (err == 0) err = set_smem(dqk, &dq_set, kBytes);
  if (err != 0) return err;
  const int64_t blocks = grid_blocks(heads, T, D);
  const int64_t rows = static_cast<int64_t>(heads) * T;
  const int64_t delta_blocks =
      (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  if (blocks == 0 || delta_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;
  wide_delta_kernel<In><<<static_cast<unsigned>(delta_blocks), kDeltaThreads,
                          0, s>>>(o, dout, delta32, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      m[0], m[1], m[2], m[3], lse32, delta32, amax, static_cast<Out*>(dk),
      static_cast<Out*>(dv), heads, T, D, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      m[0], m[1], m[2], m[3], lse32, delta32, amax, static_cast<Out*>(dq),
      heads, T, D, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int T, int D) {
  return B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535 || D <= 0 ||
         D % 8 != 0;
}

}  // namespace

// q, k, v: contiguous [B, H, T, D] bf16, D any multiple of 8 (the
// wrappers take this entry point over 256); o: the same, bf16, or f32
// when f32_out is 1; lse: [B, H, T] f32. causal: 1 masks key j > query i,
// 0 masks nothing (but keys past T). scale_log2 = sm_scale * log2(e).
// One launch on `stream`.
extern "C" int flash_attn_fwd_wide_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int T, int D,
                                        int causal, int f32_out,
                                        float scale_log2, int device,
                                        void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heads = B * H;
  if (f32_out) {
    return causal ? fwd<true, float, 1>(q, k, v, o, lse, nullptr, heads, T, D,
                                        scale_log2, s)
                  : fwd<false, float, 1>(q, k, v, o, lse, nullptr, heads, T,
                                         D, scale_log2, s);
  }
  return causal ? fwd<true, uint16_t, 1>(q, k, v, o, lse, nullptr, heads, T,
                                         D, scale_log2, s)
                : fwd<false, uint16_t, 1>(q, k, v, o, lse, nullptr, heads, T,
                                          D, scale_log2, s);
}

// The same for f32 q, k, v and o (the wrappers take it over head dim
// 128); parts: scratch of [3, 2, B, H, T, D] fp16 and amax of [3, B * H]
// uint32, which the pre-pass fills (hopper.cuh's split_operands). Seven
// launches and a memset on `stream`.
extern "C" int flash_attn_fwd_wide_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       void* parts, void* amax, int B, int H,
                                       int T, int D, int causal,
                                       float scale_log2, int device,
                                       void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heads = B * H;
  const int64_t n = static_cast<int64_t>(T) * D;
  const void* src[3] = {q, k, v};
  const int err = split_operands(src, 3, parts, amax, heads, n, s);
  if (err != 0) return err;
  const __half* p = static_cast<const __half*>(parts);
  const int64_t part = 2 * heads * n;
  const auto* a = static_cast<const uint32_t*>(amax);
  return causal ? fwd<true, float, 2>(p, p + part, p + 2 * part, o, lse, a,
                                      heads, T, D, scale_log2, s)
                : fwd<false, float, 2>(p, p + part, p + 2 * part, o, lse, a,
                                       heads, T, D, scale_log2, s);
}

// q, k, v, o, dout: contiguous [B, H, T, D] bf16, D any multiple of 8;
// dq, dk, dv: the same, bf16, or f32 when f32_out is 1; lse: [B, H, T]
// f32 (natural log, as the forward writes it); delta: [B, H, T] f32
// scratch. scale = 1/sqrt(D) of the caller's head dim. Three launches on
// `stream`.
extern "C" int flash_attn_bwd_wide_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int B, int H, int T, int D,
                                        int causal, int f32_out, float scale,
                                        int device, void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heads = B * H;
  const auto* o16 = static_cast<const uint16_t*>(o);
  const auto* do16 = static_cast<const uint16_t*>(dout);
  if (f32_out) {
    return causal ? bwd<true, float, 1>(q, k, v, dout, o16, do16, lse, delta,
                                        nullptr, dq, dk, dv, heads, T, D,
                                        scale, s)
                  : bwd<false, float, 1>(q, k, v, dout, o16, do16, lse, delta,
                                         nullptr, dq, dk, dv, heads, T, D,
                                         scale, s);
  }
  return causal ? bwd<true, uint16_t, 1>(q, k, v, dout, o16, do16, lse, delta,
                                         nullptr, dq, dk, dv, heads, T, D,
                                         scale, s)
                : bwd<false, uint16_t, 1>(q, k, v, dout, o16, do16, lse,
                                          delta, nullptr, dq, dk, dv, heads,
                                          T, D, scale, s);
}

// The same for f32 q, k, v, o, dout and dq, dk, dv; parts: scratch of [4,
// 2, B, H, T, D] fp16 and amax of [4, B * H] uint32 for the pre-pass.
// Eleven launches and a memset on `stream`.
extern "C" int flash_attn_bwd_wide_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* parts, void* amax,
                                       void* dq, void* dk, void* dv, int B,
                                       int H, int T, int D, int causal,
                                       float scale, int device, void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heads = B * H;
  const int64_t n = static_cast<int64_t>(T) * D;
  const void* src[4] = {q, k, v, dout};
  const int err = split_operands(src, 4, parts, amax, heads, n, s);
  if (err != 0) return err;
  const __half* p = static_cast<const __half*>(parts);
  const int64_t part = 2 * heads * n;
  const auto* a = static_cast<const uint32_t*>(amax);
  const auto* o32 = static_cast<const float*>(o);
  const auto* do32 = static_cast<const float*>(dout);
  return causal ? bwd<true, float, 2>(p, p + part, p + 2 * part, p + 3 * part,
                                      o32, do32, lse, delta, a, dq, dk, dv,
                                      heads, T, D, scale, s)
                : bwd<false, float, 2>(p, p + part, p + 2 * part,
                                       p + 3 * part, o32, do32, lse, delta, a,
                                       dq, dk, dv, heads, T, D, scale, s);
}
