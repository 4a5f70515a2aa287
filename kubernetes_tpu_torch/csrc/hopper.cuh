// Hopper (sm_90a) building blocks shared by the attention kernels, as
// inline PTX: TMA tile loads into swizzled shared memory, mbarrier
// pipelines between a producer warp and consumer warpgroups,
// `wgmma.mma_async` bf16 -> f32 with shared-memory descriptors,
// `setmaxnreg`, and the split of f32 operands into bf16 parts. `wgmma`
// and `setmaxnreg` exist only for sm_90a (kernels/build.py compiles with
// `-gencode arch=compute_90a,code=sm_90a`).
//
// Tiles. Every operand tile is a [rows, W] slice of a contiguous
// [B*H, T, D] bf16 tensor, copied by TMA through a 3-D tensor map
// (D, T, B*H): a tile never reads into the next head, and rows past T
// arrive as zeros. W, the tile width, is the template parameter: 16,
// 32, 64, 128 or 256, the smallest that holds the head dim D (any
// multiple of 8 up to 256). The map has the tensor's true width D and
// row stride, so columns D..W-1 of a tile arrive as zeros too, which is
// exact: a zero column of Q and K adds nothing to Q K^T, and one of V or
// dO gives a zero column of the product, which the kernels never store.
// TMA writes each tile as W / kBoxCols column boxes, one after the
// other, each [rows][kRowBytes] with the hardware swizzle of its row
// length: 128 B (64 columns) at W 64, 128 and 256 (two boxes at 128,
// four at 256), 64 B (32 columns) at W 32, 32 B (16 columns) at W 16. A
// box that lies partly past D still lands whole (zero-filled) and counts
// its full bytes toward the barrier's transaction count, as a box past T
// does. The wgmma descriptors below name the same swizzle, so the tensor
// cores read the tiles as TMA left them.
//
// Products. A K-major operand (the contraction runs along a row: Q, K,
// dO or V as the left factor, or K, Q, dO, V as B in X Y^T) takes
// `Tile<W>::kmajor`; an MN-major B (the contraction runs down the rows:
// V in P V, dO in P^T dO, Q in dS^T Q, K in dS K) takes
// `Tile<W>::mnmajor` and the transposed-B bit. At W 16 the products
// that contract over the head dim are one k16 step, and those whose N
// is the head dim are m64n16k16; at W 256 a product whose N is the
// head dim is m64n256k16, or m64n128k16 over one half of the columns
// (boxes 2h, 2h + 1: `Tile<W>::box`). The accumulator of m64nN (N/2 f32
// per thread) holds, for warp w of the warpgroup, lane
// (g = lane/4, c = lane%4), entry 4i+e at row 16w + g + 8(e/2) and
// column 8i + 2c + (e%2). That is also the layout of the A fragments of
// a register-sourced (RS) product: k-slice kk of an accumulator is
// entries 8kk..8kk+7, packed as pairs (acc_to_a / acc_to_a_split).
//
// f32 operands. The tensor cores take `.tf32` operands only K-major,
// and the kernels read V, dO, Q and K as MN-major B operands, which only
// `.bf16`/`.f16` allow. So an f32 tensor enters as two fp16 tensors, its
// parts (split_parts): under a power of 2 `s` per [batch, head] slice,
// chosen from the slice's largest |x| so that |x s| < 2^15 (scale_of),
// hi is the rounding of x s to fp16 and lo the rounding of what hi left
// out; hi + lo carries ~22 significant bits (fp16 keeps 11, and lo is
// within 2^-11 of hi), the scale keeping both parts clear of fp16's
// overflow and, down to 2^-17 of the slice's largest value, of its
// subnormals. The parts lie one after the other, [2, heads, T, D], so
// one tensor map of 2 * heads heads reads both: part p of head h is head
// h + p * heads. A product of two such operands is three fp16 products
// summed in the f32 accumulator, hi.hi + hi.lo + lo.hi (Terms), dropping
// lo.lo, ~2^-22 of the product, the small ones first; its result is s_a
// s_b times the
// product, which the kernels divide out (folded into the softmax scale
// for S, into the epilogue for the outputs). P in [0, 1] enters under
// the fixed scale 2^15 (kPScale), dS under a scale per row of the
// product it feeds, kept as a running minimum across tiles like the
// softmax's running max (RowScale). Every layout and wgmma instance
// stays as it is for bf16; only the operand type is `.f16`.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA data still to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One arrival; releases this thread's earlier shared-memory writes to
// the threads that wait on the barrier.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
// A fresh barrier is in phase 0, so a wait on parity 1 passes at once:
// the producer's first pass over an empty ring.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Rows the tensor maps of make_tile_map copy per box.
constexpr int kTmaRows = 64;

// Geometry of a [rows, W] bf16 tile as TMA leaves it in shared memory,
// and the wgmma descriptors that read it.
template <int W>
struct Tile {
  static_assert(W == 16 || W == 32 || W == 64 || W == 128 || W == 256,
                "tile width 16, 32, 64, 128 or 256");
  static constexpr int kRowBytes = W * 2 < 128 ? W * 2 : 128;  // per box
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = W / kBoxCols;
  // Descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 =
  // 32-byte.
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // The TMA swizzle that writes what kLayout reads.
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  // Bytes of a `rows`-row tile, zero-filled columns included.
  static constexpr __host__ __device__ int bytes(int rows) {
    return rows * W * 2;
  }

  // rows (a multiple of kTmaRows) starting at row0 of head `head`.
  static __device__ __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0,
                                              int rows, int head) {
#pragma unroll 1
    for (int rb = 0; rb < rows; rb += kTmaRows) {
#pragma unroll
      for (int cb = 0; cb < kBoxes; ++cb) {
        tma_load_3d(dst + (cb * rows + rb) * kRowBytes, map, bar,
                    cb * kBoxCols, row0 + rb, head);
      }
    }
  }

  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (kLayout << 62);
  }

  // Column box cb (columns cb * kBoxCols..) of a `rows`-row tile: a
  // tile of its own, of kBoxCols columns and the same swizzle, whose
  // next boxes follow it at the same stride. An MN-major B operand that
  // starts there reads columns from cb * kBoxCols on.
  static __device__ __forceinline__ uint32_t box(uint32_t tile, int rows,
                                                 int cb) {
    return tile + cb * rows * kRowBytes;
  }

  // K-major operand: rows row0.. (a multiple of 8) of a `rows`-row tile,
  // columns 16kk..16kk+15. Within a box the slice starts 32 B further
  // along the row; the hardware applies the swizzle to the address.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int row0, int kk) {
    constexpr int kSlices = kRowBytes / 32;  // 16-column slices per box
    const uint32_t addr = tile + (kk / kSlices) * rows * kRowBytes +
                          row0 * kRowBytes + (kk % kSlices) * 32;
    return desc(addr, 16, 8 * kRowBytes);
  }

  // MN-major B operand: rows 16kk..16kk+15 of a `rows`-row tile, all W
  // columns. Under every swizzle the leading byte offset steps to the
  // next box of columns, `rows * kRowBytes` further on (unread at W 16,
  // whose N of 16 is one 32-byte swizzle row), and the stride byte
  // offset to the next 8 rows of the contraction.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk) {
    return desc(tile + 16 * kk * kRowBytes, rows * kRowBytes, 8 * kRowBytes);
  }
};

// ---- wgmma -----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After a wait: the compiler must not move reads of an accumulator above
// the wait, nor writes below it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x N, f32) = A B (+ d if accumulate): A and B K-major in shared
// memory, both of 16-bit type E (bf16, or fp16: the parts of f32).
template <int N, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate);

// d (m64 x N, f32) = A B (+ d if accumulate): A in registers (four pairs
// of E per thread), B MN-major in shared memory.
template <int N, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// fp16: the parts of f32 operands (above).

template <>
__device__ __forceinline__ void wgmma_ss<64, __half>(float* d, uint64_t a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, __half>(float* d, uint64_t a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, __half>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32, __half>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, __half>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, __half>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ---- register budget -------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- fragments -------------------------------------------------------

// Two f32 values as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values (x0 in the low half) in two parts: `hi`, the values
// rounded to bf16, and `lo`, the bf16 rounding of what `hi` left out.
__device__ __forceinline__ void split_pair(uint32_t* hi, uint32_t* lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Two adjacent output values stored at p: rounded once to bf16 (a
// uint16_t output holds bf16 bits) or kept in f32 (a float output, which
// the ring sums before it rounds).
__device__ __forceinline__ void store_pair(uint16_t* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// Entries 8kk..8kk+7 of an accumulator (`c` points at entry 8kk) as
// the A fragment of k-slice kk, rounded once to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// The same in two parts: `hi`, the values rounded to bf16, and `lo`, the
// bf16 rounding of what `hi` left out. hi + lo carries ~16 significant
// bits, so a product taken twice (hi, then lo) loses almost nothing to
// the bf16 operand.
__device__ __forceinline__ void acc_to_a_split(uint32_t* hi, uint32_t* lo,
                                               const float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_pair(hi + i, lo + i, c[2 * i], c[2 * i + 1]);
}

// Two f32 values (x0 in the low half) times `s`, in two fp16 parts:
// `hi`, the products rounded to fp16, and `lo`, the fp16 rounding of
// what `hi` left out. `s` is a power of 2, so x s is exact.
__device__ __forceinline__ void split_pair_f16(uint32_t* hi, uint32_t* lo,
                                               float x0, float x1, float s) {
  x0 *= s;
  x1 *= s;
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc_to_a_split in fp16 parts of the entries times `s[r]`, r the row
// of the entry (entries 4i + e lie on row e / 2: rows g and g + 8).
__device__ __forceinline__ void acc_to_a_split_f16(uint32_t* hi,
                                                   uint32_t* lo,
                                                   const float* c,
                                                   const float* s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_pair_f16(hi + i, lo + i, c[2 * i], c[2 * i + 1], s[i % 2]);
  }
}

// The fixed scale of P (in [0, 1]) in fp16 parts: the largest P lands
// on 2^15, below fp16's largest finite value, and a P down to 2^-29
// stays a normal fp16 number.
constexpr float kPScale = 32768.f;

// ---- f32 operands: scales ---------------------------------------------

// The biased f32 exponent of the scale that takes a largest |x| with
// bits `amax` into [2^14, 2^15): 2^(14 - floor(log2 amax)), at most
// 2^126 (so its inverse is a normal f32 too); 2^126 for 0 and for
// subnormal amax.
__host__ __device__ __forceinline__ int scale_exp(uint32_t amax) {
  const int e = 268 - static_cast<int>((amax >> 23) & 0xff);
  return e < 253 ? e : 253;
}

// 2^(e - 127) for a biased exponent e in [1, 254]; 0 below 1.
__device__ __forceinline__ float pow2_biased(int e) {
  return e >= 1 ? __uint_as_float(static_cast<uint32_t>(e) << 23) : 0.f;
}

// The scale of biased exponent e, and its inverse.
__device__ __forceinline__ float scale_of(int e) { return pow2_biased(e); }
__device__ __forceinline__ float inv_scale_of(int e) {
  return pow2_biased(254 - e);
}

// The scale of the operand slice whose largest |x| has bits `amax`.
__device__ __forceinline__ float slice_inv_scale(uint32_t amax) {
  return inv_scale_of(scale_exp(amax));
}

// A running scale for the two accumulator rows a thread holds (g and g
// + 8), for an A operand that a kernel makes itself (dS) and whose range
// no bound fixes: per tile, each row's largest |x| over the tile's
// columns (the four lanes of a quad hold a row between them), then the
// smaller of that row's scale so far and the tile's. When it falls, the
// accumulator's entries of that row are multiplied by the ratio (an
// exact power of 2) before the tile's products are added, so the
// accumulator always holds scale x the sum; the epilogue multiplies by
// inv().
struct RowScale {
  int e[2] = {253, 253};  // biased exponents; 2^126 before any tile
  float s[2] = {0x1p126f, 0x1p126f};

  // `x`: the tile's n entries of this thread (entry i on row (i % 4) /
  // 2); `acc`: the m accumulator entries to rescale.
  template <int n, int m>
  __device__ __forceinline__ void update(const float* x, float* acc) {
    float mx[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < n; ++i) {
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], fabsf(x[i]));
    }
    float ratio[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const int t = scale_exp(__float_as_uint(mx[r]));
      const int next = t < e[r] ? t : e[r];
      ratio[r] = pow2_biased(127 + next - e[r]);
      e[r] = next;
      s[r] = scale_of(next);
    }
#pragma unroll
    for (int i = 0; i < m; ++i) acc[i] *= ratio[(i % 4) / 2];
  }
  __device__ __forceinline__ float inv(int r) const {
    return inv_scale_of(e[r]);
  }
};

// The element type of an operand's parts: bf16 in one part (a bf16
// tensor), fp16 in two (the parts of an f32 tensor), with the tensor
// map type that copies it.
template <int kParts>
struct Part {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Part<2> {
  using T = __half;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// The 16-bit products that make up one product A B whose A comes in kA
// parts and B in kB (1: bf16; 2: hi, lo). In bf16 (a bf16 operand beside
// P or dS split in two): every pair, (0, 0) then (1, 0). Two operands in
// fp16 parts (f32): every pair but lo.lo, the small ones first, (0, 1),
// (1, 0), then (0, 0), since the tensor cores add each product into the
// accumulator with truncation relative to the accumulator's magnitude:
// added after the large one, the small products would lose their low
// bits. Product t takes part a(t) of A and part b(t) of B; a product
// over K k-slices takes its (term, k-slice) steps in the order term(i,
// K), slice(i, K): term by term for f32 parts, else term within k-slice.
template <int kA, int kB>
struct Terms {
  static constexpr bool kF32 = kA == 2 && kB == 2;
  static constexpr int kN = kF32 ? 3 : kA * kB;
  static constexpr __host__ __device__ int a(int t) {
    return kF32 ? t == 1 : t / kB;
  }
  static constexpr __host__ __device__ int b(int t) {
    return kF32 ? t == 0 : t % kB;
  }
  static constexpr __host__ __device__ int term(int i, int K) {
    return kF32 ? i / K : i % kN;
  }
  static constexpr __host__ __device__ int slice(int i, int K) {
    return kF32 ? i % K : i / kN;
  }
};

// ---- f32 operands: the split into parts ---------------------------------

constexpr int kSplitThreads = 256;
// Blocks per slice of the pre-pass grids: enough to fill an H100 at
// a few slices, one where a slice is small.
inline int split_chunks(int64_t n4_slice, int64_t slices) {
  int64_t c = (n4_slice + kSplitThreads * 8 - 1) / (kSplitThreads * 8);
  const int64_t fill = (132 * 8 + slices - 1) / slices;
  if (c > fill) c = fill;
  return static_cast<int>(c < 1 ? 1 : c > 65535 ? 65535 : c);
}

// amax[slice] = bits of the largest |x| over each slice of n4 float4s
// (blockIdx.x the slice, blockIdx.y a chunk of it): non-negative floats
// order as their bits, so atomicMax on the bits is max on the values.
__global__ void __launch_bounds__(kSplitThreads)
slice_amax_kernel(const float4* __restrict__ x, uint32_t* __restrict__ amax,
                  int64_t n4) {
  const float4* xs = x + static_cast<int64_t>(blockIdx.x) * n4;
  float m = 0.f;
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * kSplitThreads +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.y) * kSplitThreads) {
    const float4 v = xs[i];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kSplitThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSplitThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax + blockIdx.x, __float_as_uint(m));
  }
}

// Each slice of n4 float4s times its scale, in fp16 parts: hi and lo,
// at the same offset in two arrays.
__global__ void __launch_bounds__(kSplitThreads)
split_parts_kernel(const float4* __restrict__ x,
                   const uint32_t* __restrict__ amax, uint2* __restrict__ hi,
                   uint2* __restrict__ lo, int64_t n4) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n4;
  const float s = scale_of(scale_exp(amax[blockIdx.x]));
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * kSplitThreads +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.y) * kSplitThreads) {
    const float4 v = x[base + i];
    uint2 h, l;
    split_pair_f16(&h.x, &l.x, v.x, v.y, s);
    split_pair_f16(&h.y, &l.y, v.z, v.w, s);
    hi[base + i] = h;
    lo[base + i] = l;
  }
}

// The parts of `slices` slices of n f32 values each at x (n a multiple
// of 4) into `parts` ([2, slices, n] fp16), each slice's largest |x|
// into amax[slice] (bits; amax zeroed by the caller), on `stream`: two
// launches. Returns a CUDA error code.
inline int split_parts(const void* x, void* parts, uint32_t* amax,
                       int64_t slices, int64_t n, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  if (slices <= 0 || slices > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(slices),
                  static_cast<unsigned>(split_chunks(n4, slices)));
  const auto* in = static_cast<const float4*>(x);
  slice_amax_kernel<<<grid, kSplitThreads, 0, stream>>>(in, amax, n4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* out = static_cast<uint2*>(parts);
  split_parts_kernel<<<grid, kSplitThreads, 0, stream>>>(
      in, amax, out, out + slices * n4, n4);
  return static_cast<int>(cudaGetLastError());
}

// The parts of `count` f32 operands (src[i], each `slices` slices of n
// values) into parts + 2 i slices n and their slices' largest |x| into
// amax[i * slices ..]: the pre-pass of the f32 entry points.
inline int split_operands(const void* const* src, int count, void* parts,
                          void* amax, int64_t slices, int64_t n,
                          cudaStream_t stream) {
  auto* a = static_cast<uint32_t*>(amax);
  cudaError_t e = cudaMemsetAsync(a, 0, sizeof(uint32_t) * count * slices,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* p = static_cast<__half*>(parts);
  for (int i = 0; i < count; ++i) {
    const int err = split_parts(src[i], p + 2 * i * slices * n,
                                a + i * slices, slices, n, stream);
    if (err != 0) return err;
  }
  return 0;
}

// ---- host: tensor maps -----------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function; it is reached through
// the runtime's entry-point query, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The 3-D map (D, T, heads) of a contiguous [heads, T, D] 16-bit tensor
// (`type`: bf16, or fp16 for the parts of f32),
// D a multiple of 8 (TMA takes row strides of 16 bytes) and at most W,
// boxes of Tile<W>::kBoxCols columns x kTmaRows rows, swizzled as Tile<W>
// expects; rows past T and columns past D read as zeros. Returns a CUDA
// error code.
template <int W>
int make_tile_map(CUtensorMap* map, const void* ptr, int heads, int T,
                  int D,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<W>::kBoxCols),
                             static_cast<cuuint32_t>(kTmaRows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<W>::kSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
