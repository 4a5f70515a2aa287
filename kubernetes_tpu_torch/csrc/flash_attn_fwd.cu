// Flash-attention forward: o = softmax(q k^T / sqrt(D)) v, and the
// natural-log row sums lse = log(sum(exp(q k^T / sqrt(D)))) that the
// backward pass recomputes P from. Causal (key j <= query i) or not: the
// ring (workloads/ring_attention.py) takes the causal instance for a
// block of keys at the queries' own positions and the non-causal one for
// a block wholly before them.
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
// the output accumulator are f32; P is rounded once to bf16 for the P V
// product, as the tensor cores take it. o is bf16, or f32 for the ring,
// which merges its blocks' o in f32 and rounds once (rounding each block
// too put the ring's largest deviation from f32 attention at 1.9x the
// plain path's, at T 8192 split 2 and 4 ways on an H100).
//
// Bound: operations. The causal work is 4 * B * H * D * T(T+1)/2 FLOPs
// (4 * B * H * D * T^2 non-causal) against (3 + 1) * B * H * T * D * 2
// bytes of q, k, v and o: at B4 H16 T2048 D128 that is 68.7 GFLOP,
// >= 69 us at 989 TFLOP/s, while its 67 MB take 20 us at 3.35 TB/s. So
// the kernel is built around the tensor cores' full rate, which on Hopper
// only `wgmma` reaches, fed by TMA so that no thread spends instructions
// on copies.
//
// Design (FlashAttention-3's structure, without its intra-warpgroup
// pingpong; building blocks in hopper.cuh). One block of three
// warpgroups per (128-query tile, head, batch):
//   - a producer warp TMA-loads the Q tile once, then the K and V tiles
//     of 128 keys (64 at W 256) into a two-stage ring, each stage
//     guarded by "full" barriers (K and V apart, so S can start before
//     V lands) and an "empty" barrier that the consumers release;
//   - two consumer warpgroups of 64 query rows each compute, per key
//     tile, S = Q K^T (wgmma, both operands in shared memory), the
//     online softmax in f32 registers (exp2, in the log2 domain), and
//     O += P V with P straight from the S accumulator's registers (RS
//     wgmma, V as a transposed B), so P never touches shared memory;
//   - `setmaxnreg` moves registers from the producer (24) to the
//     consumers (240), which hold O and S (64 + 64 f32 at D128).
// The loop starts at the last key tile it takes, the only one masked,
// and walks back to key 0: causal, that is the diagonal tile, and the
// longest q-tiles of every head are issued first so the short ones fill
// the tail; non-causal, every q-tile takes every key tile, from the last,
// partial one. Rows past T arrive as zeros from TMA and are never
// stored. Keys past T arrive as zeros too, and lie only in that last
// tile: causal, after every valid row, so the causal mask hides them;
// non-causal, a mask of its own hides them, since a zero score would add
// exp(0 - m) to every row's sum.
//
// Head dims. The tile width W (16, 32, 64, 128 or 256) and causality
// are template parameters; the head dim D is an argument, any multiple
// of 8 up to 256, run by the smallest W >= D. TMA fills columns D..W-1
// of every tile with zeros (hopper.cuh), which leaves S = Q K^T as it is
// and gives zero columns of O, and only columns < D are stored, at the
// tensor's own row stride D. So a head dim of 96 (Phi-3-mini's) runs the
// W-128 instance at the work of D 128; the wrapper pads any other D to a
// multiple of 8.
//
// W 256 (head dims 129-256; GPT-J's 256). Two 128-key stages of K and V
// beside the 128-row Q tile would take 64 KB + 4 x 64 KB = 320 KB, over
// the 227 KB a block may have, and S's 64 registers a thread would not
// fit beside O's 128 under the consumers' 240. So its K/V tiles hold 64
// keys: Q 64 KB + 4 x 32 KB = 192 KB, and per thread O 128, S 32 and
// P's fragments 16 registers. O += P V is one m64n256k16 per 16 keys.
// A 128-row q-tile's diagonal then spans two key tiles, the first two
// taken, both masked; in the first, warpgroup 0's rows see no key at
// all, and their running max and sum stay -inf and 0 until the second.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q, then the K stages, the V stages, then the barriers.
template <int W>
struct Smem {
  // Keys per K/V tile of the ring: 128 (square tiles), 64 at W 256.
  static constexpr int kKeys = W == 256 ? 64 : 128;
  static constexpr int kTile = Tile<W>::bytes(kKeys);
  static constexpr int kQ = 0;
  static constexpr int kK = Tile<W>::bytes(kRows);
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack for the alignment
};

template <int W, bool kCausal, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 Out* __restrict__ o, float* __restrict__ lse, int T, int D,
                 float scale_log2) {
  using L = Smem<W>;
  constexpr int kKeys = L::kKeys;
  // Square tiles: a q-tile takes the key tiles up to its own index, and
  // only the first taken (the diagonal, or T's last keys) is masked.
  constexpr bool kSquare = kKeys == kRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // One block per (q-tile, head), the tile-major index walking every
  // head's longest q-tile first: the short tiles fill the tail.
  const int q_tiles = (T + kRows - 1) / kRows;
  const int heads = gridDim.x / q_tiles;
  const int tile = q_tiles - 1 - static_cast<int>(blockIdx.x) / heads;
  const int head = blockIdx.x % heads;
  const int m0 = tile * kRows;
  // Key tiles n_tiles-1, ..., 0: causal, from the diagonal tile (at 64
  // keys, the one holding the block's last row, or T's last key).
  const int key_tiles = kSquare ? q_tiles : (T + kKeys - 1) / kKeys;
  const int n_tiles =
      kCausal ? (kSquare ? tile + 1 : min((m0 + kRows) / kKeys, key_tiles))
              : key_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread issues every copy.
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, Tile<W>::bytes(kRows));
      Tile<W>::load(base + L::kQ, &tq, q_full, m0, kRows, head);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int n0 = (n_tiles - 1 - it) * kKeys;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, L::kTile);
        Tile<W>::load(base + L::kK + s * L::kTile, &tk, k_full + 8 * s, n0,
                      kKeys, head);
        mbar_arrive_expect_tx(v_full + 8 * s, L::kTile);
        Tile<W>::load(base + L::kV + s * L::kTile, &tv, v_full + 8 * s, n0,
                      kKeys, head);
      }
    }
    return;
  }

  // Consumer warpgroups.
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row within the warp's 8-row group
  const int c = lane % 4;  // accumulator column pair
  const int r0 = m0 + wg * 64 + warp * 16 + g;  // this thread's rows r0, r0+8

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  // Running max (log2-scaled score domain) and this thread's share of
  // the running sum, for rows r0 and r0 + 8.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int n0 = (n_tiles - 1 - it) * kKeys;
    const uint32_t ks = base + L::kK + s * L::kTile;
    const uint32_t vs = base + L::kV + s * L::kTile;

    // S = Q K^T: this warpgroup's 64 rows x kKeys keys.
    float sc[kKeys / 2];
    mbar_wait(k_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      wgmma_ss<kKeys>(sc, Tile<W>::kmajor(base + L::kQ, kRows, wg * 64, kk),
                      Tile<W>::kmajor(ks, kKeys, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kKeys / 2>(sc);

    // Scale into the log2 domain; mask keys after the row (causal) on
    // the tiles that cross the block's diagonal (the first taken at
    // square tiles, the first two at 64 keys) or past T (non-causal: in
    // the first tile taken).
    float mx[2] = {m_run[0], m_run[1]};
    const bool edge =
        kSquare || !kCausal ? it == 0 : n0 + kKeys - 1 > m0;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2);
      const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
      const bool masked = kCausal ? key > row : key >= T;
      const float x = (edge && masked) ? -INFINITY : sc[i] * scale_log2;
      sc[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    // The four lanes sharing a row hold its kKeys columns between them.
    float corr[2];
    float base_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // At square tiles every row sees a valid key in the first tile
      // taken (key 0 on the diagonal; key n0 < T in the last, partial
      // tile), so its max is finite after it; at 64-key tiles, causal,
      // warpgroup 0's rows see none in the first. The guard keeps exp2
      // of (-inf - -inf) from making a NaN: while a row's max is -inf,
      // its corr and P are 0, so its sum and O stay 0.
      base_max[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m_run[r] - base_max[r]);
      m_run[r] = mx[r];
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      sc[i] = exp2f(sc[i] - base_max[(i % 4) / 2]);
      rowsum[(i % 4) / 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    // O += P V: P's k-slice kk is S's entries 8kk..8kk+7.
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(pf[kk], sc + 8 * kk);
    mbar_wait(v_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<W>(acc, pf[kk], Tile<W>::mnmajor(vs, kKeys, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<W / 2>(acc);
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  // Whole-row sums, then normalise and store.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  // Columns col, col + 1 of rows < T; D is even, so a pair is stored
  // whole or not at all.
  Out* oh = o + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = 8 * (i / 4) + 2 * c;
    if (row < T && col < D) {
      store_pair(oh + static_cast<int64_t>(row) * D + col, acc[i] * inv[r],
                 acc[i + 1] * inv[r]);
    }
  }
  if (c == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    float* lseh = lse + static_cast<int64_t>(head) * T;
    if (r0 < T) lseh[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r0 + 8 < T) lseh[r0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

template <int W, bool kCausal, typename Out>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int T, int D, float scale_log2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_tile_map<W>(&tq, q, B * H, T, D);
  if (err == 0) err = make_tile_map<W>(&tk, k, B * H, T, D);
  if (err == 0) err = make_tile_map<W>(&tv, v, B * H, T, D);
  // The shared-memory limit is a property of the kernel on a device: set
  // once per device, not on every launch.
  static PerDevice smem_set;
  int done = 0;
  if (err == 0) {
    err = smem_set.get(&done, [](int, int* set) {
      *set = 1;
      return cudaFuncSetAttribute(flash_fwd_kernel<W, kCausal, Out>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Smem<W>::kAlloc);
    });
  }
  if (err != 0) return err;
  const int64_t blocks = static_cast<int64_t>((T + kRows - 1) / kRows) * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<W, kCausal, Out><<<static_cast<unsigned>(blocks),
                                      kThreads, Smem<W>::kAlloc, stream>>>(
      tq, tk, tv, static_cast<Out*>(o), static_cast<float*>(lse), T, D,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The smallest tile width that holds head dim D (a multiple of 8, at
// most 256; the entry point checks).
template <bool kCausal, typename Out>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int T, int D, float scale_log2, cudaStream_t s) {
  if (D <= 16) {
    return launch<16, kCausal, Out>(q, k, v, o, lse, B, H, T, D, scale_log2,
                                    s);
  }
  if (D <= 32) {
    return launch<32, kCausal, Out>(q, k, v, o, lse, B, H, T, D, scale_log2,
                                    s);
  }
  if (D <= 64) {
    return launch<64, kCausal, Out>(q, k, v, o, lse, B, H, T, D, scale_log2,
                                    s);
  }
  if (D <= 128) {
    return launch<128, kCausal, Out>(q, k, v, o, lse, B, H, T, D, scale_log2,
                                     s);
  }
  return launch<256, kCausal, Out>(q, k, v, o, lse, B, H, T, D, scale_log2,
                                   s);
}

template <typename Out>
int launch_c(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int T, int D, int causal, float scale_log2,
             cudaStream_t s) {
  return causal
             ? launch_d<true, Out>(q, k, v, o, lse, B, H, T, D, scale_log2, s)
             : launch_d<false, Out>(q, k, v, o, lse, B, H, T, D, scale_log2, s);
}

}  // namespace

// q, k, v: contiguous [B, H, T, D] bf16, D a multiple of 8 up to 256; o:
// the same, bf16, or f32 when f32_out is 1; lse: [B, H, T] f32; all on
// `device`, and `stream` one of its streams. causal: 1 masks key j >
// query i, 0 masks nothing (but keys past T). scale_log2 = sm_scale *
// log2(e).
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int T,
                                   int D, int causal, int f32_out,
                                   float scale_log2, int device,
                                   void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535 || D <= 0 ||
      D > 256 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32_out ? launch_c<float>(q, k, v, o, lse, B, H, T, D, causal,
                                   scale_log2, s)
                 : launch_c<uint16_t>(q, k, v, o, lse, B, H, T, D, causal,
                                      scale_log2, s);
}
