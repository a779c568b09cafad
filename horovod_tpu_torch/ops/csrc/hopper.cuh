// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads, named barriers and the wgmma products with their shared-memory
// matrix descriptors; and, on the host, a kernel's shared memory limit
// and the TMA tensor maps. Used by flash_attention.cu,
// flash_attention_bwd.cu and fused_conv_bn.cu.
//
// Shared-memory tiles are written by TMA with 128-byte swizzle: a tile is
// stored as rows of 64 bf16 (128 bytes), 16-byte chunk c of row r at
// chunk position c ^ (r % 8), each 8-row group 1024 bytes, every tile
// 1024-byte aligned. A 128-wide operand is two such 64-column halves.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// Arrive (release at CTA scope) without waiting.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
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

// One box of a 2-D tensor map into shared memory at `dst`, completing its
// bytes on the mbarrier `bar`. Coordinates innermost (column) first.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1)
      : "memory");
}

// One box from shared memory at `src` to a 2-D tensor map; the parts of
// the box outside the tensor are not written. Tracked by this thread's
// bulk async-groups (bulk_commit, bulk_wait_read, bulk_wait).
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most kPending of this thread's bulk groups still read shared
// memory (their source may then be overwritten).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kPending)
               : "memory");
}

// Until at most kPending of this thread's bulk groups are incomplete.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(kPending)
               : "memory");
}

// 4 bytes from global memory at `src` into shared memory at `dst`,
// asynchronously; zeros, with nothing read, where `valid` is false.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// The current phase of the mbarrier `bar` also waits for this thread's
// cp.async copies issued so far (one more expected arrival, made when
// they land).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
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

// The same for the A fragments of a register-A wgmma, placed after the
// wait that completes it: the compiler sees the asm that issues the
// wgmma as the fragments' last use and may otherwise hand their registers
// to other values while the tensor cores still read them.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3]) :: "memory");
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

#define HVD_WGMMA_D32(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])

#define HVD_WGMMA_R32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a 64x64x16 bf16 tile, f32 accumulate; A and B from
// shared memory, K-major, or MN-major where kTransA / kTransB is 1.
// scale_d == 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16_t(float (&d)[32],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      HVD_WGMMA_R32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HVD_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA),
        "n"(kTransB));
}

// The same with both operands K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  wgmma_ss_m64n64k16_t<0, 0>(d, desc_a, desc_b, scale_d);
}

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

// -- host ------------------------------------------------------------------

// Raises `kernel`'s dynamic shared memory limit to `bytes`, once per kernel
// and device on each thread (the attribute is per device context).
inline cudaError_t allow_smem(const void* kernel, uint32_t bytes) {
  struct Done {
    const void* kernel;
    int dev;
  };
  static thread_local Done done[64];
  static thread_local int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i)
    if (done[i].kernel == kernel && done[i].dev == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && n < 64) done[n++] = {kernel, dev};
  return err;
}

// Tensor maps.

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is not in the runtime library: it is found once
// through the runtime's entry-point query (CUDA 12.5+), so the library
// needs no -lcuda. Null where it is missing.
inline EncodeTiled encoder() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &res) != cudaSuccess)
      return nullptr;
    return res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map (d, h, t, b) over a [B, T, H, 128] bf16 view with element
// strides (sb, st, sh) and unit stride on d; boxes of 64 d x `rows` rows,
// 128-byte swizzle, zero fill past T.
inline bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                     int B, int T, int H, long long sb, long long st,
                     long long sh, int rows) {
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map through the last 128 maps encoded on this thread (a training
// step's layers use about a hundred): an encode costs microseconds of host
// time on every call, and the caching allocator hands the same buffers
// back layer after layer and step after step. A map depends on nothing but
// the pointer and `key` (its shape, strides and box); `make(map)` encodes
// one.
template <class Make>
inline bool cached_map(CUtensorMap* map, const void* ptr,
                       const long long (&key)[7], Make make) {
  struct Entry {
    CUtensorMap map;
    const void* ptr = nullptr;
    long long key[7] = {};
  };
  static thread_local Entry cache[128];
  static thread_local int next = 0;
  for (const Entry& e : cache) {
    if (e.ptr == ptr && std::equal(key, key + 7, e.key)) {
      *map = e.map;
      return true;
    }
  }
  if (!make(map)) return false;
  Entry& e = cache[next];
  next = (next + 1) % 128;
  e.map = *map;
  e.ptr = ptr;
  std::copy(key, key + 7, e.key);
  return true;
}

inline bool get_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                    int B, int T, int H, long long sb, long long st,
                    long long sh, int rows) {
  const long long key[7] = {B, T, H, sb, st, sh, rows};
  return cached_map(map, ptr, key, [&](CUtensorMap* m) {
    return make_map(enc, m, ptr, B, T, H, sb, st, sh, rows);
  });
}

// A 2-D map over a contiguous [rows, cols] bf16 matrix (cols a multiple
// of 64): boxes of 64 columns x `box_rows` rows, 128-byte swizzle, zero
// fill past the last row (a store clips there), cached as get_map.
inline bool get_map_2d(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                       long long rows, int cols, int box_rows) {
  const long long key[7] = {rows, cols, box_rows, -1, -1, -1, -1};
  return cached_map(map, ptr, key, [&](CUtensorMap* m) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t estr[2] = {1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(ptr), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

}  // namespace hvd_hopper
