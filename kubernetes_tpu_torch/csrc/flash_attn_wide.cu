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
// Bound: operations, as the fused kernels (4 B H D T^2, half of it
// causal, forward; 2.5 times that backward), over the bf16 rate or, for
// f32 operands, the TF32 rate a user asking for f32 would get.
//
// Why a kernel of its own. A tile of the fused kernels holds a row's
// whole head dim: Q for 128 queries and two stages of K and V at D 256 in
// bf16 already take 192 KB of a block's 227 KB, and f32's two parts
// double every tile. So here every operand comes as 64 x 64 tiles
// ("slices" of the head dim; "boxes" when they are an output's columns),
// through one tensor map of box 64 columns x 64 rows each (Tile<64>,
// 128-byte swizzle); columns past D and rows past T arrive as zeros,
// which add nothing to S or dP and give output columns never stored.
//
// Plan. S = Q K^T (and dP) is a sum over the D / 64 slices; the outputs
// (o; dk, dv; dq) are D columns wide. Registers bound the output columns
// one block can hold, so each kernel has a column-group plan (make_plan,
// mirrored by workloads/flash_attention.py's `wide_plan`): a block owns
// one (64- or 128-row tile, column group, head) and computes S and dP
// ONCE per (query tile, key tile) for all its group's columns; a head dim
// wider than the widest group goes to further blocks, each recomputing S
// (and dP) for its own group. Widest groups, in 64-column boxes: forward
// 5 bf16 (o 160 registers a thread) and 2 f32 (o and its fresh
// per-tile accumulator, 64 + 64); dK/dV 5 and 2 (one output per
// warpgroup); dQ 6 and 4 (split between the warpgroups). Groups are the
// fewest of the widest that fit, evened out: D 272 bf16 is one group of
// 5 boxes in every kernel, D 512 bf16 two of 4 in every kernel, D 256
// f32 two of 2 (forward, dK/dV) and one of 4 (dQ). Executed over useful products: (groups + 1) x Dp / 2D forward
// and dK/dV, (2 groups + 1) x Dp / 3D dQ, Dp the head dim padded to 64:
// 1.18 at D 272 bf16 (the design this replaces: 3.53 forward), 1.5 / 1.5
// / 1.0 at D 256 f32 (it: 2.5 / 3.0 backward). Within the groups, the
// plan takes 3 slice stages first, then resident A operands, then two
// group stages: on an H100 (perf/wide_kernels.py), 2 slice stages left
// dQ 26% slower at D 272 and the backward 26-27% slower at D 512, and a
// fourth stage bought with resident K and V left dK/dV 12% slower at
// D 272.
//
// Structure (hopper.cuh's building blocks). Three warpgroups a block:
// a producer (one thread issues every TMA copy, 24 registers by
// `setmaxnreg`) and two consumer warpgroups (240). Shared memory, sized
// per launch by the plan (at most 227 KB): resident tiles, a ring of
// slice items (a 64-column slice of the score products' operands), a
// ring of group items (the output products' B operand at the group's
// width, its boxes side by side), exchange buffers, barriers ("full"
// and "empty" per stage as in the fused kernels).
//   - Forward: 128 query rows a block, 64 to each consumer warpgroup,
//     which computes S for its rows, the online softmax and O += P V for
//     all the group's columns, P from S's registers (RS wgmma). Causal,
//     warpgroup 0 skips the key tile past its diagonal.
//   - dK/dV: 64 keys a block. Warpgroup 0 computes S^T = K Q^T, P^T, and
//     dV += P^T dO_c; warpgroup 1 dP^T = V dO^T, dS^T (P^T passed to it
//     through shared memory in f32), and dK += dS^T Q_c.
//   - dQ: 64 queries a block. Warpgroup 0 computes S and P, warpgroup 1
//     dP and dS; P passes to 1 and dS back to 0 in f32, and each adds
//     dS K_c over half of the group's boxes.
//   Named barriers (bar.arrive / bar.sync over the 256 consumer threads)
//   order each exchange both ways. The grid runs the heads in chunks
//   whose streamed operands fit 8 MB of L2 where it is deep enough
//   (head_chunk), row tiles longest first within a chunk.
// What the plan does about the four limits of a one-warpgroup design that
// recomputes S per 64-column output block, waits after every slice and
// reloads Q with every K slice:
//   1. S and dP once per (query tile, key tile) and group, above;
//   2. each slice's products are one commit group; the kernel waits for
//      the one before (wgmma_wait<1>) to free its ring stage, and once
//      for all at the tile's end; the output products are as wide in N
//      as the warpgroup's boxes (m64n256 + m64n64 at 5 boxes);
//   3. two consumer warpgroups, one running its softmax or exchange
//      while the other's products run;
//   4. the score products' A operands (Q forward; K and V in dK/dV; Q
//      and dO in dQ) stay resident in shared memory for the whole loop
//      where the plan fits them (bf16 to D 320 in every kernel; the
//      forward to D 512 in bf16 and D 256 in f32), else come with each
//      slice.
// Not done: overlapping one warpgroup's softmax with its own next S
// products (a second S accumulator, 32 registers a thread, which a
// 5-box group's 160 output registers leave no room for); the two
// warpgroups overlap each other instead.
//
// Dtypes, as in the fused kernels. bf16: P rounded once to bf16 for P V,
// P and dS split into bf16 hi + lo for the backward's products. f32: the
// entry points split q, k, v (and do) into fp16 parts under a power of 2
// per [batch, head] slice in a pre-pass (hopper.cuh's split_operands), S
// and dP take three fp16 products per slice pair, the small ones first,
// P enters under the fixed scale kPScale, dS under a running scale per
// row of the product (RowScale; in dQ both warpgroups keep the same one,
// from the same dS), the scales divided out at the store; each tile's
// products with P or dS go into a fresh accumulator, added to the output
// in f32 (the tensor cores' own adds truncate). Each output element's
// sums run in the order of the one-warpgroup design's.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                  // rows of a tile and of a warpgroup
constexpr int kUnit = Tile<64>::bytes(kRows);  // 8 KB: one part of a tile
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kMaxStages = 8;              // of the slice ring
constexpr int kWantStages = 3;             // slice stages a plan wants first
constexpr int kBarBytes = 256;
constexpr int kSmemMax = 232448;           // a block's shared memory
constexpr int kXch = kRows * kRows * 4;    // a 64 x 64 f32 exchange buffer
constexpr float kLog2e = 1.4426950408889634f;
using Tl = Tile<64>;

// Named barriers of the consumer warpgroups (0 is __syncthreads).
constexpr int kReady = 1, kRead = 2, kDsReady = 3, kDsRead = 4;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

// After a fence, so the writes before it are seen by the threads that
// sync on the barrier.
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

enum WideKernel { kFwd = 0, kDkdv = 1, kDq = 2 };

// A kernel's plan at one head dim (make_plan). Groups are runs of
// `boxes` boxes from box 0 (the last one narrower where slices does not
// divide).
struct Plan {
  int slices;    // 64-column slices of the head dim
  int groups;    // column groups: blocks per row tile
  int boxes;     // boxes of the widest group
  int resident;  // 1: the score products' A operands stay resident
  int s_stages;  // stages of the slice ring
  int g_stages;  // stages of the group ring
  int res;       // bytes: resident tiles
  int s_item;    // bytes: a slice-ring stage
  int g_item;    // bytes: a group-ring stage
  int xch;       // bytes: exchange buffers
  int bytes;     // dynamic shared memory, the alignment's slack included
};

// Widest group in boxes: the forward's and dK/dV's outputs live in one
// warpgroup's registers (5 boxes: 160 a thread in bf16; f32 2, beside
// the fresh per-tile accumulator), dQ's in two.
inline int group_cap(int kernel, int parts) {
  if (kernel == kDq) return parts == 2 ? 4 : 6;
  return parts == 2 ? 2 : 5;
}

inline void item_sizes(int kernel, int parts, Plan* p) {
  const int u = kUnit * parts;
  // Resident: Q for 128 rows (forward), K and V (dK/dV), Q and dO (dQ).
  p->res = p->resident ? 2 * p->slices * u : 0;
  // A slice item: K_j (forward; + Q_j's 128 rows unless resident), Q_j
  // and dO_j (dK/dV; + K_j and V_j), K_j and V_j (dQ; + Q_j and dO_j).
  p->s_item = (kernel == kFwd ? 1 : 2) * u + (p->resident ? 0 : 2 * u);
  // A group item: V_c (forward), dO_c and Q_c (dK/dV), K_c (dQ).
  p->g_item = (kernel == kDkdv ? 2 : 1) * p->boxes * u;
  p->xch = kernel == kFwd ? 0 : kernel == kDkdv ? kXch : 2 * kXch;
}

inline int plan_bytes(const Plan& p) {
  return 1024 + p.res + p.s_stages * p.s_item + p.g_stages * p.g_item +
         p.xch + kBarBytes;
}

// The fewest groups of the widest boxes that fit; then kWantStages slice
// stages, resident A operands, two group stages, in that order; then as
// many slice stages (up to 8) as fit. 2 stages at least.
inline int make_plan(int kernel, int parts, int D, Plan* out) {
  if (D <= 0 || kernel < kFwd || kernel > kDq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (D + 63) / 64;
  const int cap = group_cap(kernel, parts);
  for (int want = imin(cap, slices); want >= 1; --want) {
    Plan p{};
    p.slices = slices;
    p.boxes = (slices + (slices + want - 1) / want - 1) /
              ((slices + want - 1) / want);
    p.groups = (slices + p.boxes - 1) / p.boxes;
    const int tries[2] = {kWantStages, 2};
    for (const int least : tries) {
      for (p.resident = 1; p.resident >= 0; --p.resident) {
        item_sizes(kernel, parts, &p);
        for (p.g_stages = 2; p.g_stages >= 1; --p.g_stages) {
          p.s_stages = least;
          if (plan_bytes(p) > kSmemMax) continue;
          while (p.s_stages < kMaxStages) {
            ++p.s_stages;
            if (plan_bytes(p) > kSmemMax) {
              --p.s_stages;
              break;
            }
          }
          p.bytes = plan_bytes(p);
          *out = p;
          return 0;
        }
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A ring of `stages` items `item` bytes apart, with a full and an empty
// barrier per stage.
struct Ring {
  uint32_t data, full, empty;
  int stages, item;
  __device__ __forceinline__ uint32_t at(int it) const {
    return data + (it % stages) * item;
  }
  __device__ __forceinline__ uint32_t full_bar(int it) const {
    return full + 8 * (it % stages);
  }
  // Consumer: waits for item `it` to land.
  __device__ __forceinline__ void wait(int it) const {
    mbar_wait(full_bar(it), (it / stages) & 1);
  }
  __device__ __forceinline__ void release(int it) const {
    mbar_arrive(empty + 8 * (it % stages));
  }
  // Consumer, on an item it does not read: still waits for it, so its
  // arrival counts toward this item's release and no earlier one's.
  __device__ __forceinline__ void skip(int it) const {
    wait(it);
    release(it);
  }
  // Producer: waits for the stage to be free and announces `bytes`.
  __device__ __forceinline__ uint32_t fill(int it, int bytes) const {
    mbar_wait(empty + 8 * (it % stages), ((it / stages) & 1) ^ 1);
    mbar_arrive_expect_tx(full_bar(it), bytes);
    return at(it);
  }
};

// The block's shared memory from a 1024-byte aligned base.
struct Smem {
  uint32_t res, res_full, xch;
  Ring s, g;
  const unsigned char* raw;  // generic address of `base`
  __device__ Smem(unsigned char* smem_raw, const Plan& p) {
    const uint32_t at = smem_u32(smem_raw);
    const uint32_t base = (at + 1023) & ~1023u;
    raw = smem_raw + (base - at);
    res = base;
    s = Ring{base + p.res, 0, 0, p.s_stages, p.s_item};
    g = Ring{s.data + p.s_stages * p.s_item, 0, 0, p.g_stages, p.g_item};
    xch = g.data + p.g_stages * p.g_item;
    res_full = xch + p.xch;
    s.full = res_full + 8;
    s.empty = s.full + 8 * kMaxStages;
    g.full = s.empty + 8 * kMaxStages;
    g.empty = g.full + 16;
  }
  // The exchange buffer at byte `off` of xch, as f32.
  __device__ __forceinline__ float* xch_f32(int off) const {
    return reinterpret_cast<float*>(
        const_cast<unsigned char*>(raw) + (xch - res) + off);
  }
  __device__ void init() const {
    if (threadIdx.x == 0) {
      mbar_init(res_full, 1);
      for (int i = 0; i < s.stages; ++i) {
        mbar_init(s.full + 8 * i, 1);
        mbar_init(s.empty + 8 * i, kConsumers);
      }
      for (int i = 0; i < g.stages; ++i) {
        mbar_init(g.full + 8 * i, 1);
        mbar_init(g.empty + 8 * i, kConsumers);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// The tile of 64 rows from row0 and 64 columns from col0 of each part of
// `head` (part p is head head + p * heads of the map) into dst, the parts
// `stride` bytes apart.
template <int kParts>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t stride,
                                          const CUtensorMap* map, uint32_t bar,
                                          int col0, int row0, int head,
                                          int heads) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    tma_load_3d(dst + p * stride, map, bar, col0, row0, head + p * heads);
  }
}

// `n` boxes from box c0 of rows row0.. into dst: box b at dst + b kUnit,
// the parts `stride` bytes apart.
template <int kParts>
__device__ __forceinline__ void load_boxes(uint32_t dst, uint32_t stride,
                                           const CUtensorMap* map,
                                           uint32_t bar, int c0, int n,
                                           int row0, int head, int heads) {
  for (int b = 0; b < n; ++b) {
    load_tile<kParts>(dst + b * kUnit, stride, map, bar, (c0 + b) * 64, row0,
                      head, heads);
  }
}

// acc (+)= A B^T over one slice: A and B 64 x 64 tiles, K-major, their
// parts `ap` and `bp` bytes apart (Terms: the small products first).
template <int kParts>
__device__ __forceinline__ void score_slice(float* acc, uint32_t a,
                                            uint32_t ap, uint32_t b,
                                            uint32_t bp, bool first) {
  using Prod = Terms<kParts, kParts>;
  using E = typename Part<kParts>::T;
#pragma unroll
  for (int t = 0; t < Prod::kN; ++t) {
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_ss<kRows, E>(acc, Tl::kmajor(a + Prod::a(t) * ap, kRows, 0, kk),
                         Tl::kmajor(b + Prod::b(t) * bp, kRows, 0, kk),
                         !first || t > 0 || kk > 0);
    }
  }
}

// Where slice j's operands lie: A (resident, or in the item) and B (in
// the item), each with its parts' stride.
struct Operands {
  uint32_t a, ap, b, bp;
};

// acc = A B^T summed over the slices, slice j's operands from ring item
// it + j (`at(j, stage)` gives them): each slice's products one commit
// group, the stage before freed once its group is done, one wait for
// the last at the end.
template <int kParts, typename At>
__device__ __forceinline__ void scores(float* acc, const Ring& r, int it,
                                       int slices, At at) {
  for (int j = 0; j < slices; ++j) {
    r.wait(it + j);
    const Operands op = at(j, r.at(it + j));
    wgmma_fence();
    score_slice<kParts>(acc, op.a, op.ap, op.b, op.bp, j == 0);
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      r.release(it + j - 1);
    }
  }
  wgmma_wait<0>();
  fence_regs<kRows / 2>(acc);
  r.release(it + slices - 1);
}

// acc (+)= A B over boxes kFirst..kBoxes-1 of B, in products of up to 4
// boxes (m64n256): A the 64 x 64 operand in kA parts of fragments
// (a[part][kk]), B the boxes at `tile` (box b at tile + b kUnit, 64 rows
// of the contraction), MN-major, kB parts `bp` bytes apart. Box b's
// columns are acc's entries 32b..32b+31, whatever the product's width.
template <int kA, int kB, int kFirst, int kBoxes>
__device__ __forceinline__ void box_products(float* acc, uint32_t (*a)[4][4],
                                             uint32_t tile, uint32_t bp,
                                             bool fresh) {
  if constexpr (kFirst < kBoxes) {
    constexpr int kN = (kBoxes - kFirst < 4 ? kBoxes - kFirst : 4) * 64;
    using Prod = Terms<kA, kB>;
    using E = typename Part<kB>::T;
    constexpr int kSlices = kRows / 16;
#pragma unroll
    for (int i = 0; i < Prod::kN * kSlices; ++i) {
      const int t = Prod::term(i, kSlices), kk = Prod::slice(i, kSlices);
      wgmma_rs<kN, E>(acc + kFirst * 32, a[Prod::a(t)][kk],
                      Tl::mnmajor(tile + Prod::b(t) * bp + kFirst * kUnit,
                                  kRows, kk),
                      !fresh || i > 0);
    }
    box_products<kA, kB, kFirst + 4, kBoxes>(acc, a, tile, bp, fresh);
  }
}

// The same over the first nb (1..kMax) boxes, nb known at run time.
template <int kA, int kB, int kMax>
__device__ __forceinline__ void group_products(float* acc, uint32_t (*a)[4][4],
                                               uint32_t tile, uint32_t bp,
                                               int nb, bool fresh) {
  if (nb == kMax) {
    box_products<kA, kB, 0, kMax>(acc, a, tile, bp, fresh);
  } else if constexpr (kMax > 1) {
    group_products<kA, kB, kMax - 1>(acc, a, tile, bp, nb, fresh);
  }
}

// acc += A B over nb boxes, then waits for it. With f32 operands the
// products go into a fresh accumulator, `part`, added to acc in f32
// after: the tensor cores add into an accumulator with truncation, whose
// bias over a long sum would pass the ~22-bit operands' rounding.
template <int kA, int kParts, int kMax>
__device__ __forceinline__ void add_products(float* acc, float* part,
                                             uint32_t (*a)[4][4],
                                             uint32_t tile, uint32_t bp,
                                             int nb) {
  wgmma_fence();
  group_products<kA, kParts, kMax>(kParts == 2 ? part : acc, a, tile, bp, nb,
                                   kParts == 2);
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (kParts == 2) {
    fence_regs<kMax * 32>(part);
#pragma unroll
    for (int i = 0; i < kMax * 32; ++i) acc[i] += part[i];
  }
  fence_regs<kMax * 32>(acc);
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

// Entries 8kk..8kk+7 of a 64 x 64 accumulator as the A fragments of
// k-slice kk: bf16 P rounded once (kOut 1, forward), or two parts: bf16
// hi + lo (bf16 operands), fp16 hi + lo times s[row] (f32 operands).
template <int kParts, int kOut>
__device__ __forceinline__ void to_frag(uint32_t (*a)[4][4], const float* x,
                                        int kk, const float* s) {
  if constexpr (kOut == 1) {
    acc_to_a(a[0][kk], x + 8 * kk);
  } else if constexpr (kParts == 1) {
    acc_to_a_split(a[0][kk], a[1][kk], x + 8 * kk);
  } else {
    acc_to_a_split_f16(a[0][kk], a[1][kk], x + 8 * kk, s);
  }
}

// Every k-slice's fragments.
template <int kParts, int kOut>
__device__ __forceinline__ void to_frags(uint32_t (*a)[4][4], const float* x,
                                         const float* s) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) to_frag<kParts, kOut>(a, x, kk, s);
}

// A 64 x 64 accumulator through an exchange buffer: entry i of consumer
// thread t at [i][t], so a warp's accesses fall on 32 banks.
__device__ __forceinline__ void put(float* buf, const float* x, int t) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) buf[i * 128 + t] = x[i];
}
__device__ __forceinline__ void get(float* x, const float* buf, int t) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) x[i] = buf[i * 128 + t];
}

// Two adjacent values of an output in bf16 or f32.
__device__ __forceinline__ void store_out(void* out, bool f32, int64_t off,
                                          float a, float b) {
  if (f32) {
    store_pair(static_cast<float*>(out) + off, a, b);
  } else {
    store_pair(static_cast<uint16_t*>(out) + off, a, b);
  }
}

// A warpgroup's accumulator over nb boxes (box b: columns col0 + 64 b..),
// rows r0 and r0 + 8 of a [T, D] output at `out` + head_off, times
// mul[row] and then `post`; only rows < T and columns < D.
template <int kMax>
__device__ __forceinline__ void store_acc(void* out, bool f32,
                                          int64_t head_off, const float* acc,
                                          int nb, int col0, int r0, int c,
                                          int T, int D, const float* mul,
                                          float post = 1.f) {
#pragma unroll
  for (int i = 0; i < kMax * 32; i += 2) {
    const int box = i / 32, y = i % 32;
    const int r = (y % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = col0 + 64 * box + 8 * (y / 4) + 2 * c;
    if (box < nb && row < T && col < D) {
      store_out(out, f32, head_off + static_cast<int64_t>(row) * D + col,
                acc[i] * mul[r] * post, acc[i + 1] * mul[r] * post);
    }
  }
}

// The block's (row tile, group, head) and its group's first box and
// width. The heads go in chunks of `chunk` (the launch sets it so that a
// chunk's streamed operands fit a share of L2, which they then stay in
// while the chunk's row tiles read them); within a chunk, row tile by row
// tile, from the first or from the last (the longest causal ones first),
// then group, then head.
struct Block {
  int tile, group, head, c0, nb;
  __device__ Block(int tiles, int heads, int chunk, const Plan& p,
                   bool from_last) {
    const int id = static_cast<int>(blockIdx.x);
    const int full = chunk * tiles * p.groups;  // blocks of a whole chunk
    const int first = id / full * chunk;        // the chunk's first head
    const int n = imin(chunk, heads - first);   // its heads
    const int rem = id % full;
    const int t = rem / (p.groups * n);
    tile = from_last ? tiles - 1 - t : t;
    group = rem / n % p.groups;
    head = first + rem % n;
    c0 = group * p.boxes;
    nb = imin(p.boxes, p.slices - c0);
  }
};

// ---- forward ----------------------------------------------------------

// Shared memory: resident Q, part p of slice j for warpgroup w's rows at
// res + ((p slices + j) 2 + w) kUnit; a slice item: K_j (part p at p
// kUnit), then, unless resident, Q_j (at (kParts + 2p + w) kUnit); a
// group item: V_c, box b of part p at (p boxes + b) kUnit.
template <int kParts, int kMax>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                float* __restrict__ lse, const uint32_t* __restrict__ amax,
                const Plan pl, int heads, int chunk, int T, int D,
                int causal, int f32_out, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, pl);
  const int tiles = (T + kRows - 1) / kRows;
  // Row tile: 128 queries, tiles 2 pair and 2 pair + 1; the longest
  // (causal) first.
  const Block blk((tiles + 1) / 2, heads, chunk, pl, true);
  const int m0 = blk.tile * 2 * kRows;
  const int n_tiles = causal ? imin(2 * blk.tile + 2, tiles) : tiles;
  const int slices = pl.slices;
  sm.init();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      if (pl.resident) {
        mbar_arrive_expect_tx(sm.res_full, pl.res);
        for (int j = 0; j < slices; ++j) {
          for (int w = 0; w < 2; ++w) {
            load_tile<kParts>(sm.res + (2 * j + w) * kUnit,
                              2 * slices * kUnit, &tq, sm.res_full, j * 64,
                              m0 + w * kRows, blk.head, heads);
          }
        }
      }
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int n0 = (n_tiles - 1 - t) * kRows;
        for (int j = 0; j < slices; ++j, ++it) {
          const uint32_t st = sm.s.fill(it, pl.s_item);
          load_tile<kParts>(st, kUnit, &tk, sm.s.full_bar(it), j * 64, n0,
                            blk.head, heads);
          if (!pl.resident) {
            for (int w = 0; w < 2; ++w) {
              load_tile<kParts>(st + (kParts + w) * kUnit, 2 * kUnit, &tq,
                                sm.s.full_bar(it), j * 64, m0 + w * kRows,
                                blk.head, heads);
            }
          }
        }
        const uint32_t gt = sm.g.fill(t, blk.nb * kParts * kUnit);
        load_boxes<kParts>(gt, pl.boxes * kUnit, &tv, sm.g.full_bar(t),
                           blk.c0, blk.nb, n0, blk.head, heads);
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
  const int qtile = 2 * blk.tile + wg;        // this warpgroup's query tile
  const int r0 = qtile * kRows + warp * 16 + g;  // its rows r0, r0 + 8
  // f32 operands: S comes out s_q s_k times, O s_v kPScale times.
  float post = 1.f;
  if constexpr (kParts == 2) {
    scale_log2 *= inv_scale<2>(amax, 0, blk.head, heads) *
                  inv_scale<2>(amax, 1, blk.head, heads);
    post = inv_scale<2>(amax, 2, blk.head, heads) * (1.f / kPScale);
  }
  float acc[kMax * 32];
  float part[kParts == 2 ? kMax * 32 : 1];
#pragma unroll
  for (int i = 0; i < kMax * 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kParts == 2 ? kMax * 32 : 1); ++i) part[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  if (pl.resident) mbar_wait(sm.res_full, 0);
  const uint32_t q_part = pl.resident ? 2 * slices * kUnit : 2 * kUnit;

  int it = 0;
  for (int t = 0; t < n_tiles; ++t, it += slices) {
    const int n = n_tiles - 1 - t;
    const int n0 = n * kRows;
    if (causal && n > qtile) {  // past this warpgroup's diagonal
      for (int j = 0; j < slices; ++j) sm.s.skip(it + j);
      sm.g.skip(t);
      continue;
    }
    float sc[kRows / 2];
    scores<kParts>(sc, sm.s, it, slices, [&](int j, uint32_t st) {
      return Operands{pl.resident ? sm.res + (2 * j + wg) * kUnit
                                  : st + (kParts + wg) * kUnit,
                      q_part, st, kUnit};
    });
    // The tile that holds the diagonal (causal) or T's last keys is the
    // only one masked; every row sees a key in the first tile it takes.
    const bool edge = causal ? n == qtile : n == tiles - 1;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2);
      const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
      const bool masked = causal ? key > row : key >= T;
      const float x = (edge && masked) ? -INFINITY : sc[i] * scale_log2;
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
    for (int i = 0; i < kMax * 32; ++i) acc[i] *= corr[(i % 4) / 2];

    // O's group += P V_c.
    uint32_t pf[kParts][kRows / 16][4];
    const float ps[2] = {kPScale, kPScale};
    to_frags<kParts, kParts>(pf, sc, ps);
    sm.g.wait(t);
    add_products<kParts, kParts, kMax>(acc, part, pf, sm.g.at(t),
                                       pl.boxes * kUnit, blk.nb);
    sm.g.release(t);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  store_acc<kMax>(o, f32_out, static_cast<int64_t>(blk.head) * T * D, acc,
                  blk.nb, blk.c0 * 64, r0, c, T, D, inv, post);
  if (c == 0 && blk.group == 0) {
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

// The producer of both backward kernels: per tile the slice items (the
// pair b1, b2 of the tile's slice j; with a1, a2 unless resident), then
// the group item (g1, g2: the group's boxes; g2 may be null). Resident:
// a1 then a2 of the block's own rows, part p of slice j at (p slices + j)
// kUnit from a1's start, a2 kParts slices kUnit after it.
template <int kParts>
__device__ __forceinline__ void backward_producer(
    const Smem& sm, const Plan& pl, const CUtensorMap* a1,
    const CUtensorMap* a2, const CUtensorMap* b1, const CUtensorMap* b2,
    const CUtensorMap* g1, const CUtensorMap* g2, int row0, int first,
    int count, int head, int heads, int c0, int nb) {
  const int slices = pl.slices;
  const uint32_t res_part = slices * kUnit;
  if (pl.resident) {
    mbar_arrive_expect_tx(sm.res_full, pl.res);
    for (int j = 0; j < slices; ++j) {
      load_tile<kParts>(sm.res + j * kUnit, res_part, a1, sm.res_full,
                        j * 64, row0, head, heads);
      load_tile<kParts>(sm.res + (kParts * slices + j) * kUnit, res_part, a2,
                        sm.res_full, j * 64, row0, head, heads);
    }
  }
  int it = 0;
  for (int t = 0; t < count; ++t) {
    const int r = (first + t) * kRows;
    for (int j = 0; j < slices; ++j, ++it) {
      const uint32_t st = sm.s.fill(it, pl.s_item);
      const uint32_t bar = sm.s.full_bar(it);
      load_tile<kParts>(st, kUnit, b1, bar, j * 64, r, head, heads);
      load_tile<kParts>(st + kParts * kUnit, kUnit, b2, bar, j * 64, r, head,
                        heads);
      if (!pl.resident) {
        load_tile<kParts>(st + 2 * kParts * kUnit, kUnit, a1, bar, j * 64,
                          row0, head, heads);
        load_tile<kParts>(st + 3 * kParts * kUnit, kUnit, a2, bar, j * 64,
                          row0, head, heads);
      }
    }
    const int n = g2 ? 2 : 1;
    const uint32_t gt = sm.g.fill(t, n * nb * kParts * kUnit);
    load_boxes<kParts>(gt, pl.boxes * kUnit, g1, sm.g.full_bar(t), c0, nb, r,
                       head, heads);
    if (g2) {
      load_boxes<kParts>(gt + kParts * pl.boxes * kUnit, pl.boxes * kUnit, g2,
                         sm.g.full_bar(t), c0, nb, r, head, heads);
    }
  }
}

// Warpgroup wg's score operands (A: a1 for warpgroup 0, a2 for 1, both
// resident or in the item; B: b1 or b2 of the item) for slice j.
template <int kParts>
__device__ __forceinline__ Operands backward_operands(const Smem& sm,
                                                      const Plan& pl, int wg,
                                                      int j, uint32_t st) {
  if (pl.resident) {
    return Operands{sm.res + (wg * kParts * pl.slices + j) * kUnit,
                    static_cast<uint32_t>(pl.slices * kUnit),
                    st + wg * kParts * kUnit, kUnit};
  }
  return Operands{st + (2 + wg) * kParts * kUnit, kUnit,
                  st + wg * kParts * kUnit, kUnit};
}

// dK and dV of one (64-key tile, group, head): for each query tile from
// the diagonal (causal) or the first, warpgroup 0 takes S^T = K Q^T, P^T
// and dV_c += P^T dO_c, warpgroup 1 dP^T = V dO^T, dS^T and dK_c +=
// dS^T Q_c. Resident: K, V; slice items Q_j, dO_j (+ K_j, V_j); group
// items dO_c, Q_c.
template <int kParts, int kMax>
__global__ void __launch_bounds__(kThreads, 1)
wide_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const uint32_t* __restrict__ amax, void* __restrict__ dk,
                 void* __restrict__ dv, const Plan pl, int heads, int chunk,
                 int T, int D, int causal, int f32_out, float scale,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, pl);
  const int tiles = (T + kRows - 1) / kRows;
  const Block blk(tiles, heads, chunk, pl, false);
  const int n0 = blk.tile * kRows;
  const int m_first = causal ? blk.tile : 0;
  sm.init();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      backward_producer<kParts>(sm, pl, &tk, &tv, &tq, &tdo, &tdo, &tq, n0,
                                m_first, tiles - m_first, blk.head, heads,
                                blk.c0, blk.nb);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys key0, key0 + 8
  // f32 operands: S^T comes out s_k s_q times, dP^T s_v s_do times, dV
  // kPScale s_do times, dK ds_scale s_q times.
  float dp_back = 1.f, dv_post = 1.f, dk_post = scale;
  if constexpr (kParts == 2) {
    const float inv_q = inv_scale<2>(amax, 0, blk.head, heads);
    const float inv_do = inv_scale<2>(amax, 3, blk.head, heads);
    scale_log2 *= inv_scale<2>(amax, 1, blk.head, heads) * inv_q;
    dp_back = inv_scale<2>(amax, 2, blk.head, heads) * inv_do;
    dv_post = inv_do * (1.f / kPScale);
    dk_post = scale * inv_q;
  }
  RowScale ds_scale;
  const float* lseh = lse + static_cast<int64_t>(blk.head) * T;
  const float* deltah = delta + static_cast<int64_t>(blk.head) * T;
  float* xch = sm.xch_f32(0);
  float acc[kMax * 32];  // dV (warpgroup 0) or dK (1)
  float part[kParts == 2 ? kMax * 32 : 1];
#pragma unroll
  for (int i = 0; i < kMax * 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kParts == 2 ? kMax * 32 : 1); ++i) part[i] = 0.f;
  if (pl.resident) mbar_wait(sm.res_full, 0);

  int it = 0;
  for (int m = m_first; m < tiles; ++m, it += pl.slices) {
    const int m0 = m * kRows;
    const int t = m - m_first;
    float x[kRows / 2];  // S^T then P^T (0); dP^T then dS^T (1)
    scores<kParts>(x, sm.s, it, pl.slices, [&](int j, uint32_t st) {
      return backward_operands<kParts>(sm, pl, wg, j, st);
    });
    uint32_t af[2][kRows / 16][4];
    // Queries are the columns here. A k-slice's entries at a time, each
    // made into its fragments before the next slice's are read (but dS
    // in f32, whose row scale needs them all), to keep few registers
    // beside the group's accumulators.
    if (wg == 0) {
      // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where the key is
      // after the query (the diagonal tile) or the query is past T (its
      // lse read as +inf).
      if (t > 0) bar_sync(kRead);
      const float ps[2] = {kPScale, kPScale};
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
        for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
          const int key = key0 + 8 * ((i % 4) / 2);
          const int q = m0 + 8 * (i / 4) + 2 * c + (i % 2);
          const float l2 = q < T ? lseh[q] * kLog2e : INFINITY;
          float p = exp2f(x[i] * scale_log2 - l2);
          if (causal && m == blk.tile && key > q) p = 0.f;
          x[i] = p;
          xch[i * 128 + tid] = p;
        }
        to_frag<kParts, 2>(af, x, kk, ps);
      }
      bar_arrive(kReady);
    } else {
      // dS^T = P^T (dP^T - delta), P^T read from the exchange.
      bar_sync(kReady);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
        for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
          const int q = m0 + 8 * (i / 4) + 2 * c + (i % 2);
          const float dl = q < T ? deltah[q] : 0.f;
          x[i] = xch[i * 128 + tid] * (x[i] * dp_back - dl);
        }
        if constexpr (kParts == 1) to_frag<1, 2>(af, x, kk, ds_scale.s);
      }
      bar_arrive(kRead);
      if constexpr (kParts == 2) {
        ds_scale.update<kRows / 2, kMax * 32>(x, acc);
        to_frags<2, 2>(af, x, ds_scale.s);
      }
    }
    sm.g.wait(t);
    add_products<2, kParts, kMax>(acc, part, af,
                                  sm.g.at(t) + wg * kParts * pl.boxes * kUnit,
                                  pl.boxes * kUnit, blk.nb);
    sm.g.release(t);
  }
  if (wg == 0) bar_sync(kRead);  // the last tile's P^T read

  float mul[2] = {dv_post, dv_post};
  if (wg == 1) {
    mul[0] = mul[1] = dk_post;
    if constexpr (kParts == 2) {
      mul[0] = ds_scale.inv(0) * dk_post;
      mul[1] = ds_scale.inv(1) * dk_post;
    }
  }
  store_acc<kMax>(wg == 0 ? dv : dk, f32_out,
                  static_cast<int64_t>(blk.head) * T * D, acc, blk.nb,
                  blk.c0 * 64, key0, c, T, D, mul);
}

// dQ of one (64-query tile, group, head): for each key tile up to the
// diagonal (causal) or to the end, warpgroup 0 takes S = Q K^T and P,
// warpgroup 1 dP = dO V^T and dS, and each dQ += dS K_c over its half of
// the group's boxes (0 the first (nb + 1) / 2). Resident: Q, dO; slice
// items K_j, V_j (+ Q_j, dO_j); group items K_c.
template <int kParts, int kMax>
__global__ void __launch_bounds__(kThreads, 1)
wide_dq_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint32_t* __restrict__ amax, void* __restrict__ dq,
               const Plan pl, int heads, int chunk, int T, int D,
               int causal, int f32_out, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, pl);
  const int tiles = (T + kRows - 1) / kRows;
  const Block blk(tiles, heads, chunk, pl, true);
  const int m0 = blk.tile * kRows;
  const int n_tiles = causal ? blk.tile + 1 : tiles;
  sm.init();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      backward_producer<kParts>(sm, pl, &tq, &tdo, &tk, &tv, &tk, nullptr,
                                m0, 0, n_tiles, blk.head, heads, blk.c0,
                                blk.nb);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows r0, r0 + 8
  // This warpgroup's boxes of the group.
  const int nb0 = (blk.nb + 1) / 2;
  const int box0 = wg == 0 ? 0 : nb0;
  const int nbw = wg == 0 ? nb0 : blk.nb - nb0;
  // f32 operands: S comes out s_q s_k times, dP s_do s_v times, dQ
  // ds_scale s_k times.
  float dp_back = 1.f, dq_post = scale;
  if constexpr (kParts == 2) {
    const float inv_k = inv_scale<2>(amax, 1, blk.head, heads);
    scale_log2 *= inv_scale<2>(amax, 0, blk.head, heads) * inv_k;
    dp_back = inv_scale<2>(amax, 3, blk.head, heads) *
              inv_scale<2>(amax, 2, blk.head, heads);
    dq_post = scale * inv_k;
  }
  RowScale ds_scale;
  // lse in the log2 domain; +inf past T makes P 0 there.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int64_t at = static_cast<int64_t>(blk.head) * T + row;
    lse2[r] = row < T ? lse[at] * kLog2e : INFINITY;
    dl[r] = row < T ? delta[at] : 0.f;
  }
  float* xp = sm.xch_f32(0);
  float* xds = sm.xch_f32(kXch);
  float acc[kMax * 32];
  float part[kParts == 2 ? kMax * 32 : 1];
#pragma unroll
  for (int i = 0; i < kMax * 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kParts == 2 ? kMax * 32 : 1); ++i) part[i] = 0.f;
  if (pl.resident) mbar_wait(sm.res_full, 0);

  int it = 0;
  for (int n = 0; n < n_tiles; ++n, it += pl.slices) {
    const int n0 = n * kRows;
    float x[kRows / 2];  // S then P then dS (0); dP then dS (1)
    scores<kParts>(x, sm.s, it, pl.slices, [&](int j, uint32_t st) {
      return backward_operands<kParts>(sm, pl, wg, j, st);
    });
    if (wg == 0) {
      // P masked where the key is after the row (the diagonal tile,
      // causal) or past T (non-causal: the last tile).
      const bool edge = causal ? n == blk.tile : n == tiles - 1;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = (i % 4) / 2;
        const int row = r0 + 8 * r;
        const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
        float p = exp2f(x[i] * scale_log2 - lse2[r]);
        if (edge && (causal ? key > row : key >= T)) p = 0.f;
        x[i] = p;
      }
      if (n > 0) bar_sync(kRead);
      put(xp, x, tid);
      bar_arrive(kReady);
      bar_sync(kDsReady);
      get(x, xds, tid);
      bar_arrive(kDsRead);
    } else {
      // dS = P (dP - delta), P read from the exchange.
      bar_sync(kReady);
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        x[i] = xp[i * 128 + tid] * (x[i] * dp_back - dl[(i % 4) / 2]);
      }
      bar_arrive(kRead);
      if (n > 0) bar_sync(kDsRead);
      put(xds, x, tid);
      bar_arrive(kDsReady);
    }
    // Both warpgroups hold the same dS now, and keep the same scale.
    if constexpr (kParts == 2) {
      ds_scale.update<kRows / 2, kMax * 32>(x, acc);
    }
    uint32_t dsf[2][kRows / 16][4];
    to_frags<kParts, 2>(dsf, x, ds_scale.s);
    sm.g.wait(n);
    if (nbw > 0) {
      add_products<2, kParts, kMax>(acc, part, dsf,
                                    sm.g.at(n) + box0 * kUnit,
                                    pl.boxes * kUnit, nbw);
    }
    sm.g.release(n);
  }
  // The last tile's exchanges read.
  bar_sync(wg == 0 ? kRead : kDsRead);

  float mul[2] = {dq_post, dq_post};
  if constexpr (kParts == 2) {
    mul[0] = ds_scale.inv(0) * dq_post;
    mul[1] = ds_scale.inv(1) * dq_post;
  }
  store_acc<kMax>(dq, f32_out, static_cast<int64_t>(blk.head) * T * D, acc,
                  nbw, (blk.c0 + box0) * 64, r0, c, T, D, mul);
}

// ---- host ---------------------------------------------------------------

template <int kParts>
int maps(CUtensorMap* out, const void* const* ptrs, int n, int heads, int T,
         int D) {
  for (int i = 0; i < n; ++i) {
    const int err = make_tile_map<64>(out + i, ptrs[i], kParts * heads, T, D,
                                      Part<kParts>::kMap);
    if (err != 0) return err;
  }
  return 0;
}

// Blocks of `row_tiles` row tiles x groups x heads, or 0 past the grid's
// limit.
inline int64_t grid_blocks(int64_t row_tiles, const Plan& p, int heads) {
  const int64_t blocks = row_tiles * p.groups * heads;
  return blocks > 0x7fffffff ? 0 : blocks;
}

// Heads a chunk of a grid of `blocks` blocks takes (Block): as many as
// keep the operands a block streams (two [T, D] tensors of `parts` 16-bit
// parts a head) within kL2Share bytes, at least one; all of them (row
// tiles in order across every head) in a grid of under kChunkBlocks
// blocks, about 12 waves of an H100's 132 SMs, where starting the longest
// causal tiles first saves more than the chunks' L2 reuse. On an H100 at
// B4 H16 T2048 (perf/wide_kernels.py): chunks of 8 MB took the D-512
// backward from 7.80 to 6.90 ms and the f32 D-256 forward from 1.93 to
// 1.67 ms, and cost the D-272 forward (1024 blocks) 0.53 -> 0.57 ms.
constexpr int64_t kL2Share = 8ll << 20;
constexpr int64_t kChunkBlocks = 12 * 132;
inline int head_chunk(int heads, int T, int D, int parts, int64_t blocks) {
  if (blocks < kChunkBlocks) return heads;
  const int64_t per_head = 2ll * T * ((D + 63) / 64 * 64) * 2 * parts;
  const int64_t n = kL2Share / per_head;
  return static_cast<int>(n < 1 ? 1 : n > heads ? heads : n);
}

// Every plan fits kSmemMax, so the limit is set to it once per device.
template <typename Kernel>
int set_smem(Kernel kernel, PerDevice* flag) {
  int done = 0;
  return flag->get(&done, [&](int, int* set) {
    *set = 1;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  });
}

template <int kParts>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const uint32_t* amax, int heads, int T, int D, int causal,
        int f32_out, float scale_log2, cudaStream_t s) {
  constexpr int kMax = kParts == 2 ? 2 : 5;
  Plan pl;
  int err = make_plan(kFwd, kParts, D, &pl);
  if (err != 0) return err;
  CUtensorMap m[3];
  const void* ptrs[3] = {q, k, v};
  err = maps<kParts>(m, ptrs, 3, heads, T, D);
  static PerDevice smem_set;
  auto kernel = wide_fwd_kernel<kParts, kMax>;
  if (err == 0) err = set_smem(kernel, &smem_set);
  if (err != 0) return err;
  const int tiles = (T + kRows - 1) / kRows;
  const int64_t blocks = grid_blocks((tiles + 1) / 2, pl, heads);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, pl.bytes, s>>>(
      m[0], m[1], m[2], o, static_cast<float*>(lse), amax, pl, heads,
      head_chunk(heads, T, D, kParts, blocks), T, D, causal, f32_out,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int kParts, typename In>
int bwd(const void* q, const void* k, const void* v, const void* do_tiles,
        const In* o, const In* dout, const void* lse, void* delta,
        const uint32_t* amax, void* dq, void* dk, void* dv, int heads, int T,
        int D, int causal, int f32_out, float scale, cudaStream_t s) {
  constexpr int kMaxKv = kParts == 2 ? 2 : 5;
  constexpr int kMaxQ = kParts == 2 ? 2 : 3;  // half of dQ's widest group
  Plan pkv, pq;
  int err = make_plan(kDkdv, kParts, D, &pkv);
  if (err == 0) err = make_plan(kDq, kParts, D, &pq);
  if (err != 0) return err;
  CUtensorMap m[4];
  const void* ptrs[4] = {q, k, v, do_tiles};
  err = maps<kParts>(m, ptrs, 4, heads, T, D);
  static PerDevice dkdv_set, dq_set;
  auto dkdv = wide_dkdv_kernel<kParts, kMaxKv>;
  auto dqk = wide_dq_kernel<kParts, kMaxQ>;
  if (err == 0) err = set_smem(dkdv, &dkdv_set);
  if (err == 0) err = set_smem(dqk, &dq_set);
  if (err != 0) return err;
  const int tiles = (T + kRows - 1) / kRows;
  const int64_t kv_blocks = grid_blocks(tiles, pkv, heads);
  const int64_t q_blocks = grid_blocks(tiles, pq, heads);
  const int64_t rows = static_cast<int64_t>(heads) * T;
  const int64_t delta_blocks =
      (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  if (kv_blocks == 0 || q_blocks == 0 || delta_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* lse32 = static_cast<const float*>(lse);
  auto* delta32 = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;
  wide_delta_kernel<In><<<static_cast<unsigned>(delta_blocks), kDeltaThreads,
                          0, s>>>(o, dout, delta32, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<static_cast<unsigned>(kv_blocks), kThreads, pkv.bytes, s>>>(
      m[0], m[1], m[2], m[3], lse32, delta32, amax, dk, dv, pkv, heads,
      head_chunk(heads, T, D, kParts, kv_blocks), T, D, causal, f32_out,
      scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<static_cast<unsigned>(q_blocks), kThreads, pq.bytes, s>>>(
      m[0], m[1], m[2], m[3], lse32, delta32, amax, dq, pq, heads,
      head_chunk(heads, T, D, kParts, q_blocks), T, D, causal, f32_out,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int T, int D) {
  return B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535 || D <= 0 ||
         D % 8 != 0;
}

}  // namespace

// The plan of `kernel` (0 forward, 1 dK/dV, 2 dQ) at head dim D, f32
// operands when f32 is 1: out = {groups, boxes, resident, slice stages,
// group stages, shared-memory bytes}. What workloads/flash_attention.py's
// `wide_plan` mirrors. Returns a CUDA error code.
extern "C" int flash_attn_wide_plan(int kernel, int f32, int D, int* out) {
  Plan p;
  const int err = make_plan(kernel, f32 ? 2 : 1, D, &p);
  if (err != 0) return err;
  const int vals[6] = {p.groups, p.boxes, p.resident, p.s_stages, p.g_stages,
                       p.bytes};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

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
  return fwd<1>(q, k, v, o, lse, nullptr, B * H, T, D, causal != 0,
                f32_out != 0, scale_log2, static_cast<cudaStream_t>(stream));
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
  return fwd<2>(p, p + part, p + 2 * part, o, lse,
                static_cast<const uint32_t*>(amax), heads, T, D, causal != 0,
                1, scale_log2, s);
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
  return bwd<1>(q, k, v, dout, static_cast<const uint16_t*>(o),
                static_cast<const uint16_t*>(dout), lse, delta, nullptr, dq,
                dk, dv, B * H, T, D, causal != 0, f32_out != 0, scale,
                static_cast<cudaStream_t>(stream));
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
  return bwd<2>(p, p + part, p + 2 * part, p + 3 * part,
                static_cast<const float*>(o), static_cast<const float*>(dout),
                lse, delta, static_cast<const uint32_t*>(amax), dq, dk, dv,
                heads, T, D, causal != 0, 1, scale, s);
}
