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
// the output accumulator are f32; P is rounded once to bf16 for the P V
// product, as the tensor cores take it.
//
// Bound: operations. The causal work is 4 * B * H * D * T(T+1)/2 FLOPs
// against (3 + 1) * B * H * T * D * 2 bytes of q, k, v and o: at
// B4 H16 T2048 D128 that is 68.7 GFLOP, >= 69 us at 989 TFLOP/s, while
// its 67 MB take 20 us at 3.35 TB/s. So the kernel is built around the
// tensor cores' full rate, which on Hopper only `wgmma` reaches, fed by
// TMA so that no thread spends instructions on copies.
//
// Design (FlashAttention-3's structure, without its intra-warpgroup
// pingpong; building blocks in hopper.cuh). One block of three
// warpgroups per (128-query tile, head, batch):
//   - a producer warp TMA-loads the Q tile once, then the K and V tiles
//     of 128 keys into a two-stage ring, each stage guarded by "full"
//     barriers (K and V apart, so S can start before V lands) and an
//     "empty" barrier that the consumers release;
//   - two consumer warpgroups of 64 query rows each compute, per key
//     tile, S = Q K^T (wgmma, both operands in shared memory), the
//     online softmax in f32 registers (exp2, in the log2 domain), and
//     O += P V with P straight from the S accumulator's registers (RS
//     wgmma, V as a transposed B), so P never touches shared memory;
//   - `setmaxnreg` moves registers from the producer (24) to the
//     consumers (240), which hold O and S (64 + 64 f32 at D128).
// The loop starts at the diagonal key tile, the only one masked, and
// walks back to key 0; the longest q-tiles of every head are issued
// first so the short ones fill the tail. Rows past T arrive as zeros from TMA and are never
// stored; keys past T lie only in the diagonal tile, after every valid
// row, so the causal mask hides them. D is a template parameter: 32, 64
// or 128.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kKeys = 128;  // keys per K/V tile of the ring
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
static_assert(kRows == kKeys, "the causal tile count assumes square tiles");

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q, then the K stages, the V stages, then the barriers.
template <int D>
struct Smem {
  static constexpr int kTile = Tile<D>::bytes(kKeys);
  static constexpr int kQ = 0;
  static constexpr int kK = Tile<D>::bytes(kRows);
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack for the alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int T,
                 float scale_log2) {
  using L = Smem<D>;
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
  const int n_tiles = tile + 1;  // key tiles tile, tile-1, ..., 0

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
      mbar_arrive_expect_tx(q_full, Tile<D>::bytes(kRows));
      Tile<D>::load(base + L::kQ, &tq, q_full, m0, kRows, head);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int n0 = (tile - it) * kKeys;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, L::kTile);
        Tile<D>::load(base + L::kK + s * L::kTile, &tk, k_full + 8 * s, n0,
                      kKeys, head);
        mbar_arrive_expect_tx(v_full + 8 * s, L::kTile);
        Tile<D>::load(base + L::kV + s * L::kTile, &tv, v_full + 8 * s, n0,
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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // Running max (log2-scaled score domain) and this thread's share of
  // the running sum, for rows r0 and r0 + 8.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int n0 = (tile - it) * kKeys;
    const uint32_t ks = base + L::kK + s * L::kTile;
    const uint32_t vs = base + L::kV + s * L::kTile;

    // S = Q K^T: this warpgroup's 64 rows x 128 keys.
    float sc[kKeys / 2];
    mbar_wait(k_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kKeys>(sc, Tile<D>::kmajor(base + L::kQ, kRows, wg * 64, kk),
                      Tile<D>::kmajor(ks, kKeys, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kKeys / 2>(sc);

    // Scale into the log2 domain; on the diagonal tile mask keys after
    // the row.
    float mx[2] = {m_run[0], m_run[1]};
    const bool diagonal = it == 0;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2);
      const int key = n0 + 8 * (i / 4) + 2 * c + (i % 2);
      const float x = (diagonal && key > row) ? -INFINITY : sc[i] * scale_log2;
      sc[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    // The four lanes sharing a row hold its 128 columns between them.
    float corr[2];
    float base_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Every row sees key 0, so its max is finite after the first tile;
      // the guard keeps exp2 of (-inf - -inf) from making a NaN.
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
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    // O += P V: P's k-slice kk is S's entries 8kk..8kk+7.
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(pf[kk], sc + 8 * kk);
    mbar_wait(v_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<D>(acc, pf[kk], Tile<D>::mnmajor(vs, kKeys, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
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
  uint16_t* oh = o + static_cast<int64_t>(head) * T * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i % 4) / 2;
    const int row = r0 + 8 * r;
    const int col = 8 * (i / 4) + 2 * c;
    if (row < T) {
      *reinterpret_cast<uint32_t*>(oh + static_cast<int64_t>(row) * D + col) =
          pack_bf16(acc[i] * inv[r], acc[i + 1] * inv[r]);
    }
  }
  if (c == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    float* lseh = lse + static_cast<int64_t>(head) * T;
    if (r0 < T) lseh[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r0 + 8 < T) lseh[r0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int T, float scale_log2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_tile_map<D>(&tq, q, B * H, T);
  if (err == 0) err = make_tile_map<D>(&tk, k, B * H, T);
  if (err == 0) err = make_tile_map<D>(&tv, v, B * H, T);
  // The shared-memory limit is a property of the kernel on a device: set
  // once per device, not on every launch.
  static PerDevice smem_set;
  int done = 0;
  if (err == 0) {
    err = smem_set.get(&done, [](int, int* set) {
      *set = 1;
      return cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Smem<D>::kAlloc);
    });
  }
  if (err != 0) return err;
  const int64_t blocks = static_cast<int64_t>((T + kRows - 1) / kRows) * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<D><<<static_cast<unsigned>(blocks), kThreads,
                        Smem<D>::kAlloc, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), static_cast<float*>(lse), T,
      scale_log2);
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
