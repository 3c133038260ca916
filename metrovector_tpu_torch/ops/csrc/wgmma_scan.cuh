// The Hopper scan pipeline shared by K1's tensor-core variants
// (topk_int_kernel.cu: int8 or bf16 in one pass; topk_high_kernel.cu) and
// K2's int8-LUT product (adc_int8_mma_kernel.cu): PTX wrappers written by hand
// for TMA, mbarriers, wgmma and setmaxnreg, the host's tensor maps, the
// shared-memory layout of a scan block, and the per-query selection state
// of a consumer warpgroup around select.cuh's buffers and merges.
//
// The shape every scan of this header takes, for one block of a split of
// rows and a tile of QB = 2 NW queries (the whole batch up to 256 for the
// integer and the one-pass bf16 scans, 128 for bf16x3):
//
// * 384 threads: consumer warpgroups 0 and 1, producer warpgroup 2. One
//   thread of the producer keeps a ring of `stages` stages full through
//   TMA (cp.async.bulk.tensor, or cp.async.bulk of an image the wrapper
//   laid out), each stage's completion counted in bytes on its `full`
//   mbarrier; the consumers hand a stage back on its `empty` mbarrier (one
//   arrival per consumer warp). The producer gives its registers up
//   (setmaxnreg.dec 40), the consumers take them (setmaxnreg.inc 232).
// * A stage holds 64 rows of the split (one wgmma M) and one k-chunk.
//   Consumer warpgroup w owns queries w NW .. w NW + NW - 1 of the tile,
//   the wgmma N: it multiplies the stage's rows by its queries, and after a
//   tile's last chunk runs the epilogue and the selection for them alone.
//   Both consumers read every stage, so the rows come from device memory
//   once for the whole tile of queries, and a query's list has one owner.
//   The two run apart by up to the ring's depth: one's epilogue and
//   selection overlap the other's wgmma, and the producer's loads overlap
//   both.
// * The epilogue first only compares each score with its query's bar (a
//   float, or for the integer scan's deferred form the least raw dot that
//   can pass), keeping the scores in the accumulator registers and a bit
//   per passing element, and votes (bar.red.or) across the warpgroup. Only
//   when some score passed does a second pass offer the passing scores to
//   their queries' buffers of kBuf (select.cuh), one shared atomic each: no
//   per-tile selection. A buffer that fills is merged into its list
//   (flush_buffer) by the query's warp, which raises the bar and publishes
//   the split's slot; the scores that found it full are offered again from
//   the accumulator registers.
// * The bar shared by the splits (select.cuh's group bar) is read from
//   device memory every kRefresh tiles by each warp for its own queries, a
//   lane a query, and raises the bar the epilogue compares with: rows the
//   other splits have beaten never reach a buffer.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"

namespace {

constexpr int kScanRows = 64;                    // rows a stage: the wgmma M
constexpr int kScanThreads = 384;                // two consumers, one producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRefresh = 16;                     // tiles between group bar reads

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes the barriers' initialization visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// One arrival that also expects `bytes` of transactions (TMA) this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed. A wait that
// lasts about ten seconds (2^34 cycles) traps: a deadlock fails the launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  for (unsigned spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023u) == 1023u) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 34)) {
        __trap();
      }
    }
  }
}

// TMA: the box at (c0, c1) (innermost first) of `map` into `dst`, counted
// on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// TMA's bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory matrix descriptor of a K-major operand whose rows are
// `row_bytes` (128 or 64) wide and swizzled by TMA's 128B or 64B mode: 8
// rows make one atom, SBO = 8 row_bytes; LBO is unused for K-major
// swizzled layouts (1). A k step inside the row adds its byte offset to
// the start address; the atoms sit at 1024-byte aligned addresses.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int row_bytes) {
  const uint64_t a = smem_addr(p);
  const uint64_t layout = row_bytes == 128 ? 1 : 2;
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// d (+)= A B over one k step: d is the warpgroup's m64nN accumulator
// fragment (N / 2 registers a thread: rows 16 warp + lane / 4 + 8 (i / 2 %
// 2), columns 8 (i / 4) + 2 (lane % 4) + i % 2); scale_d = 0 overwrites.
// WgmmaS8: s8 x s8 -> s32, k = 32, A (64 rows) and B (N queries) K-major in
// shared memory. WgmmaS8RA: the same with A from registers (the mma.sync
// m16n8k32 fragment of each warp's 16 rows: registers 0 and 2 hold row
// lane / 4, 1 and 3 row lane / 4 + 8; registers 0 and 1 bytes 4 (lane % 4)
// .. + 3 of the k step, 2 and 3 the same + 16). WgmmaBf16: bf16 x bf16 ->
// f32, k = 16, A from registers (the mma.sync m16n8k16 fragment of each
// warp's 16 rows), B K-major in shared memory. WgmmaBf16SS: bf16 x bf16
// -> f32, k = 16, A (64 rows) and B (N queries) K-major in shared memory.
template <int N>
struct WgmmaS8;
template <int N>
struct WgmmaS8RA;
template <int N>
struct WgmmaBf16;
template <int N>
struct WgmmaBf16SS;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8RA<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8RA<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8RA<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8RA<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16SS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16SS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16SS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` of one warpgroup (128 threads), and the same with an
// or-vote of `pred` across it.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ bool wg_any(int id, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(pred)), "r"(id)
      : "memory");
  return out != 0;
}

// --------------------------------------------------------------- host ---

// A 2-D tensor map of `rows` rows of `inner` elements, `row_bytes` apart,
// read in boxes of box_rows x box_inner with `swizzle`; elements outside it
// load as zeros. cuTensorMapEncodeTiled comes through the runtime's driver
// entry point, so the library needs no -lcuda.
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                                 const void* base, uint64_t inner, uint64_t rows,
                                 uint64_t row_bytes, uint32_t box_inner,
                                 uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------- shared memory ---

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// The selection state of one consumer warpgroup of nw queries, lists of
// k_smem entries in shared memory (0: in device memory): per query the bar
// key, the bar the epilogue compares with, the buffer's offers, the buffer
// and the list.
__host__ __device__ constexpr size_t sel_bytes(int nw, int k_smem) {
  return align_up(static_cast<size_t>(nw) *
                      (8 + 4 + 4 + 8 * kBuf + 8 * static_cast<size_t>(k_smem)),
                  16);
}

// Dynamic shared memory of a scan block: 1024 bytes of slack to align the
// ring, the ring of `stages` stages, `q_bytes` of resident queries, the two
// consumers' selection state, and the full and empty barriers of each stage
// and the queries' barrier.
__host__ __device__ constexpr size_t scan_smem(int stage_bytes, int stages,
                                               int q_bytes, int nw, int k_smem) {
  return 1024 + static_cast<size_t>(stages) * stage_bytes + q_bytes +
         2 * sel_bytes(nw, k_smem) + 8 * (2 * static_cast<size_t>(stages) + 1);
}

struct ScanSmem {
  unsigned char* ring;   // [stages][stage_bytes], 1024-byte aligned
  unsigned char* qres;   // [q_bytes]
  unsigned char* sel[2];
  uint64_t* full;        // [stages]
  uint64_t* empty;       // [stages]
  uint64_t* qbar;
};

__device__ __forceinline__ ScanSmem scan_layout(unsigned char* raw, int stage_bytes,
                                                int stages, int q_bytes, int nw,
                                                int k_smem) {
  ScanSmem m;
  m.ring = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.qres = m.ring + static_cast<size_t>(stages) * stage_bytes;
  m.sel[0] = m.qres + q_bytes;
  m.sel[1] = m.sel[0] + sel_bytes(nw, k_smem);
  m.full = reinterpret_cast<uint64_t*>(m.sel[1] + sel_bytes(nw, k_smem));
  m.empty = m.full + stages;
  m.qbar = m.empty + stages;
  return m;
}

// ----------------------------------------------------------- selection ---

// One consumer warpgroup's view of its queries' selection.
struct WgSel {
  unsigned long long* bar;  // [nw] bar keys
  float* thr;               // [nw] the bar the epilogue compares with
  int* bc;                  // [nw] offers to the buffer (past kBuf: full)
  float* bs;                // [nw][kBuf]
  int* bi;
  float* cs;                // [nw][k_smem]
  int* ci;
  // Where the lists and the bars go: the warpgroup's first query q0 (of
  // nq_w live ones), the split, list length k (topk asked), lists in
  // device memory (big: part_* [nq, lists, k], the splits' lists first)
  // or in cs/ci; the group bar's first slot and size (select.cuh).
  int64_t q0;
  int nq_w, nw, k, topk, split, splits, lists, place, big, int_bar, gbase, gsize;
  float* part_s;
  int* part_i;
  unsigned long long* slots;
  // The seed whose floor starts each bar (select.cuh's seed_floor; null:
  // none).
  const float* seed_s;
  const int* seed_i;
  int kseed, seed_mul;

  __device__ float* list_s(int qq) const {
    return big ? part_s + ((q0 + qq) * lists + split) * k : cs + qq * k;
  }
  __device__ int* list_i(int qq) const {
    return big ? part_i + ((q0 + qq) * lists + split) * k : ci + qq * k;
  }
};

__device__ __forceinline__ WgSel sel_at(unsigned char* p, int nw, int k_smem) {
  WgSel s;
  s.bar = reinterpret_cast<unsigned long long*>(p);
  s.thr = reinterpret_cast<float*>(s.bar + nw);
  s.bc = reinterpret_cast<int*>(s.thr + nw);
  s.bs = reinterpret_cast<float*>(s.bc + nw);
  s.bi = reinterpret_cast<int*>(s.bs + nw * kBuf);
  s.cs = reinterpret_cast<float*>(s.bi + nw * kBuf);
  s.ci = reinterpret_cast<int*>(s.cs + nw * k_smem);
  s.nw = nw;
  s.seed_s = nullptr;
  s.seed_i = nullptr;
  s.kseed = 0;
  s.seed_mul = 1;
  return s;
}

// The least int32 v with f32(v) >= s (rounding is monotone): the deferred
// integer scan compares raw dots with it. Rounding moves a value by at most
// 64 below 2^31, so the answer lies in (ceil(s) - 128, ceil(s)].
__device__ __forceinline__ int int_bar(float s) {
  if (!(s > -2147483648.0f)) return INT32_MIN;
  if (s > 2147483520.0f) return INT32_MAX;  // no int32 rounds to s or above
  int64_t hi = __float2int_ru(s);
  int64_t lo = hi - 128;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (__ll2float_rn(mid) >= s) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return static_cast<int>(hi);
}

// The epilogue's bar of a query from its bar key.
__device__ __forceinline__ float epilogue_bar(const WgSel& s,
                                              unsigned long long key) {
  float score;
  int row;
  unrank(key, score, row);
  return s.int_bar ? __int_as_float(int_bar(score)) : score;
}

// Raises query qq's bar key, and the epilogue's bar with it, to `key`
// (one lane of the owning warp).
__device__ __forceinline__ void sel_raise(const WgSel& s, int qq,
                                          unsigned long long key) {
  if (key > s.bar[qq]) {
    s.bar[qq] = key;
    s.thr[qq] = epilogue_bar(s, key);
  }
}

// Before the first tile, by the warpgroup's 128 threads (tw): empty lists,
// bars at the seed's floor (0 without a seed) and empty buffers; a query
// past nq_w never passes (NaN, or INT32_MAX: no int8 dot of D < 2^17
// reaches it).
__device__ void sel_init(WgSel& s, int tw) {
  s.gbase = bar_base(s.split, s.splits, s.topk);
  s.gsize = bar_group(s.splits, s.topk);
  const int k_list = s.big ? 0 : s.k;
  if (s.big) {
    for (int64_t e = tw; e < static_cast<int64_t>(s.nq_w) * s.k; e += 128) {
      const int qq = static_cast<int>(e / s.k);
      s.list_s(qq)[e % s.k] = -CUDART_INF_F;
      s.list_i(qq)[e % s.k] = kSentinel;
    }
  }
  for (int e = tw; e < s.nw * k_list; e += 128) {
    s.cs[e] = -CUDART_INF_F;
    s.ci[e] = kSentinel;
  }
  for (int e = tw; e < s.nw; e += 128) {
    const unsigned long long fk =
        e < s.nq_w ? seed_floor(s.seed_s, s.seed_i, s.kseed, s.seed_mul, s.q0 + e, s.topk)
                   : 0ull;
    s.bar[e] = fk;
    s.bc[e] = 0;
    s.thr[e] = e < s.nq_w ? epilogue_bar(s, fk)
                          : (s.int_bar ? __int_as_float(INT32_MAX) : CUDART_NAN_F);
  }
}

// A score that reached its query's bar: query c, corpus row `row`, into
// the query's buffer. False when the buffer is full (the caller offers it
// again after sel_flush_full).
__device__ __forceinline__ bool sel_offer(const WgSel& s, int c, int row, float score) {
  const int at = atomicAdd(s.bc + c, 1);
  if (at >= kBuf) return false;
  s.bs[c * kBuf + at] = score;
  s.bi[c * kBuf + at] = row;
  return true;
}

// After an epilogue some of whose offers found a full buffer (and a
// barrier of the warpgroup): warp `warp` merges the full buffers of its
// queries (qq % 4 == warp) into their lists, publishes each list's entry
// at `place` to the query's slot for the other splits' group bars, and
// raises the bars to the lists' k-th entries. The caller's next barrier
// ends the step.
__device__ void sel_flush_full(const WgSel& s, int warp, int lane) {
  for (int qq = warp; qq < s.nq_w; qq += 4) {
    if (s.bc[qq] < kBuf) continue;  // the same in every lane
    float* ls = s.list_s(qq);
    int* li = s.list_i(qq);
    flush_buffer(ls, li, s.k, s.bs + qq * kBuf, s.bi + qq * kBuf, kBuf, lane);
    if (lane == 0) {
      s.bc[qq] = 0;
      if (s.slots != nullptr && s.place < s.k) {
        const unsigned long long mine = kth_rank(ls[s.place], li[s.place]);
        if (mine != 0) __stcg(s.slots + (s.q0 + qq) * s.splits + s.split, mine);
      }
      sel_raise(s, qq, kth_rank(ls[s.k - 1], li[s.k - 1]));
    }
    __syncwarp();
  }
}

// Every kRefresh tiles, by each warp for its queries (qq % 4 == warp),
// with the accumulators dead: the group bar (the least slot of the group's
// splits) raises the query's bar. Lane l takes query warp + 4 l and the
// group's slots, all loads in flight at once. A bar read while it rises
// only lets more rows through.
__device__ void sel_refresh(const WgSel& s, int warp, int lane) {
  const int qq = warp + 4 * lane;
  if (s.slots == nullptr || qq >= s.nq_w) return;
  const unsigned long long* p = s.slots + (s.q0 + qq) * s.splits + s.gbase;
  unsigned long long v = ~0ull;
  for (int g = 0; g < s.gsize; ++g) {
    const unsigned long long h = __ldcg(p + g);
    v = h < v ? h : v;
  }
  if (v != ~0ull) sel_raise(s, qq, v);
}

// The offer pass of an epilogue: element i of a thread's accumulator
// fragment (query c = 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup,
// tile row r_lo + 8 (i / 2 % 2)) goes to its query's buffer where bit i of
// `todo` is set, its score score_of(i). Returns the bits offered; the rest
// found a full buffer.
template <int NW, typename ScoreOf>
__device__ __forceinline__ unsigned long long sel_offer_pass(
    const WgSel& s, unsigned long long todo, int lane, int row_lo, ScoreOf score_of) {
  unsigned long long done = 0;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    if ((todo >> i) & 1ull) {
      const int c = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      if (sel_offer(s, c, row_lo + 8 * ((i >> 1) & 1), score_of(i))) done |= 1ull << i;
    }
  }
  return done;
}

// The rest of an epilogue once its compare pass has set `pass` (bit i:
// element i reached its bar) in each thread: unless no thread of the
// warpgroup has a bit, offer the passing elements, and while some offer
// found a full buffer, merge the full buffers (sel_flush_full) and offer
// the rest again. `id` is the warpgroup's named barrier.
template <int NW, typename ScoreOf>
__device__ __forceinline__ void sel_epilogue(const WgSel& s, unsigned long long pass,
                                             int warp, int lane, int row_lo, int id,
                                             ScoreOf score_of) {
  if (!wg_any(id, pass != 0)) return;
  for (;;) {
    if (pass != 0) pass &= ~sel_offer_pass<NW>(s, pass, lane, row_lo, score_of);
    if (!wg_any(id, pass != 0)) return;  // every offer of the tile is in
    sel_flush_full(s, warp, lane);
    wg_sync(id);  // before the rest are offered again
  }
}

// After the last tile: each warp merges its queries' buffers into their
// lists; lists in shared memory then go to part_* [nq, lists, k]. `id` is
// the warpgroup's named barrier.
__device__ void sel_finish(const WgSel& s, int tw, int id) {
  const int warp = tw >> 5;
  const int lane = tw & 31;
  for (int qq = warp; qq < s.nq_w; qq += 4) {
    const int cnt = min(s.bc[qq], kBuf);
    if (cnt > 0) {
      flush_buffer(s.list_s(qq), s.list_i(qq), s.k, s.bs + qq * kBuf,
                   s.bi + qq * kBuf, cnt, lane);
    }
  }
  if (s.big) return;
  wg_sync(id);
  for (int e = tw; e < s.nq_w * s.k; e += 128) {
    const int64_t o = ((s.q0 + e / s.k) * s.lists + s.split) * s.k + e % s.k;
    s.part_s[o] = s.cs[e];
    s.part_i[o] = s.ci[e];
  }
}

}  // namespace
