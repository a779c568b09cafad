// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads, named barriers and the wgmma products with their shared-memory
// matrix descriptors. Used by flash_attention.cu.
//
// Shared-memory tiles are written by TMA with 128-byte swizzle: a tile is
// stored as rows of 64 bf16 (128 bytes), 16-byte chunk c of row r at
// chunk position c ^ (r % 8), each 8-row group 1024 bytes, every tile
// 1024-byte aligned. A 128-wide operand is two such 64-column halves.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hvd_hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Block until the phase of `bar` with parity `parity` has completed. A
// wait that never completes (a fault in a ring's bookkeeping) traps after
// 2^24 polls -- seconds, where a real wait takes microseconds -- instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory at `dst`, completing
// its bytes on the mbarrier `bar`. Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Adds `v` to the shared-memory word at `addr` with acquire-release order
// at CTA scope and returns the old value: what the adding thread and
// those it synchronised with (a __syncwarp) did before, including reads
// that completed through wgmma_wait, happens before what a thread that
// reads the sum does after -- a ring stage handed from its readers to the
// thread that refills it, as an mbarrier arrive/wait pair would.
__device__ __forceinline__ uint32_t atomic_add_acq_rel(uint32_t addr,
                                                       uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "r"(addr), "r"(v) : "memory");
  return old;
}

// Barrier over `count` threads on hardware barrier `id` (1..15; 0 is
// __syncthreads); named_arrive counts this warp in without waiting.
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (exp2f adds four instructions to each call to produce denormals).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (PTX ISA, "Matrix Descriptor
// Format"). K-major (rows contiguous along the reduction): SBO = 1024
// bytes between 8-row groups, LBO unused. MN-major (rows along the
// reduction, contiguous along M/N): LBO = bytes between 64-wide M/N
// chunks, SBO = 1024 bytes between 8-row groups of the reduction.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the wgmma fence/commit/wait points.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HVD_WGMMA_D64(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define HVD_WGMMA_R64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B for a 64x128x16 bf16 tile, f32 accumulate; A and B from
// shared memory, both K-major. scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      HVD_WGMMA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HVD_WGMMA_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B for a 64x128x16 bf16 tile, f32 accumulate; A from registers
// (the m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      HVD_WGMMA_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HVD_WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace hvd_hopper
