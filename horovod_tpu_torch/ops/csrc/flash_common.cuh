// Helpers of the flash-attention kernels: bf16 packing and the head
// dimension (flash_attention.cu, flash_attention_bwd.cu), and the
// m16n8k16 tensor-core product and row staging of the backward.
// Fragment layouts (PTX ISA, mma.m16n8k16, .bf16), with
// g = lane / 4 and t4 = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t4..+1), a1 = (g+8, 2t4..+1),
//                         a2 = (g, 2t4+8..+9), a3 = (g+8, 2t4+8..+9)
//   B (16x8, col-major):  b0 = (k 2t4..+1, n g), b1 = (k 2t4+8..+9, n g)
//   C (16x8, f32):        c0,c1 = (g, 2t4..+1), c2,c3 = (g+8, 2t4..+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hvd_flash {

constexpr int kD = 128;      // head dimension
constexpr int kPad = 8;      // shared-memory row padding, in elements
constexpr int kLD = kD + kPad;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile (a row-major 16x16, b col-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [row0, row0+16) and columns [k0, k0+16) of a bf16
// tile in shared memory with leading dimension kLD.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int k0, int g, int t4) {
  const __nv_bfloat16* p = tile + (row0 + g) * kLD + k0 + 2 * t4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kLD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kLD + 8);
}

// Copy rows [r0, r0+rows) of a [T, kD] strided bf16 operand (unit stride
// on D, row stride `st` elements) into shared memory; rows at or past T
// are zero. `scale` != 0 multiplies every value in f32 and rounds back
// to bf16 (the kernels' q * sm_scale * log2(e) on load).
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int r0, int T,
                                           float scale, int tid) {
  constexpr int CHUNKS = kRows * kD / 8;   // 16-byte chunks
  for (int c = tid; c < CHUNKS; c += kThreads) {
    const int row = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < T)   // rows past T stay zero: 0 * garbage is NaN
      v = *reinterpret_cast<const uint4*>(src + (r0 + row) * st + col);
    if (scale != 0.f) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      uint4 s;
      s.x = pack_bf16(__bfloat162float(e[0]) * scale,
                      __bfloat162float(e[1]) * scale);
      s.y = pack_bf16(__bfloat162float(e[2]) * scale,
                      __bfloat162float(e[3]) * scale);
      s.z = pack_bf16(__bfloat162float(e[4]) * scale,
                      __bfloat162float(e[5]) * scale);
      s.w = pack_bf16(__bfloat162float(e[6]) * scale,
                      __bfloat162float(e[7]) * scale);
      v = s;
    }
    *reinterpret_cast<uint4*>(&dst[row * kLD + col]) = v;
  }
}

}  // namespace hvd_flash
