// Helpers of the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): the head dimension, bf16 packing, the block
// order and the epilogue that writes a warpgroup's 64x128 accumulator.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace hvd_flash {

constexpr int kD = 128;      // head dimension

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight bf16 values times c in f32, rounded back to bf16.
__device__ __forceinline__ uint4 scale_bf16x8(uint4 v, float c) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint4 r;
  r.x = pack_bf16(__bfloat162float(e[0]) * c, __bfloat162float(e[1]) * c);
  r.y = pack_bf16(__bfloat162float(e[2]) * c, __bfloat162float(e[3]) * c);
  r.z = pack_bf16(__bfloat162float(e[4]) * c, __bfloat162float(e[5]) * c);
  r.w = pack_bf16(__bfloat162float(e[6]) * c, __bfloat162float(e[7]) * c);
  return r;
}

// A [B, T, H, D] bf16 view with unit stride on D: its (batch, time, head)
// strides in elements.
struct View {
  __nv_bfloat16* p;
  long long sb, st, sh;
};

// Tile index, batch and head of this CTA, `n_t` tiles a (batch, head).
// Groups of `group` heads; inside a group every head's heaviest tile
// first, then the next, so that the lightest tiles fill the tail. group =
// 1 is head by head, each head's tiles together so that they share its
// operands in L2. `heavy_last`: the heaviest tile is the last (causal q
// tiles) rather than the first (causal key tiles).
struct Tile {
  int t, b, h;
};

__device__ __forceinline__ Tile tile_of(int n_t, int H, int group,
                                        bool heavy_last) {
  const int bhs = static_cast<int>(gridDim.x) / n_t;   // B * H
  const int first = static_cast<int>(blockIdx.x) / (group * n_t) * group;
  const int size = min(group, bhs - first);
  const int within = static_cast<int>(blockIdx.x) - first * n_t;
  const int i = within / size;
  const int bh = first + within % size;
  return {heavy_last ? n_t - 1 - i : i, bh / H, bh % H};
}

// A warpgroup's 64x128 f32 accumulator (the rows of this thread: warp * 16
// + g and + 8, g = lane / 4), each value mapped through f(value, hf) with
// hf 0 or 1 for the first or second of those rows and rounded to bf16,
// through shared memory at `stage` (64 rows of a 128-byte-swizzled tile
// whose 64-column halves lie `half` bytes apart, free for the warpgroup
// to overwrite) into rows row0.. of `out`, rows at or past T skipped:
// 16-byte stores of whole rows. `bar` is the warpgroup's named barrier.
template <class F>
__device__ __forceinline__ void store_tile(uint8_t* stage, uint32_t half,
                                           const float (&acc)[64], F f,
                                           const View& out, int b, int h,
                                           int row0, int T, int bar) {
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rl = warp * 16 + g + 8 * hf;
      const uint32_t off = (j >> 3) * half + rl * 128 +
                           (((j & 7) ^ (rl & 7)) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pack_bf16(f(acc[4 * j + 2 * hf], hf),
                    f(acc[4 * j + 2 * hf + 1], hf));
    }
  }
  hvd_hopper::named_barrier(bar, 128);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = i * 128 + wtid;
    const int rl = c >> 4, cc = c & 15;
    const int row = row0 + rl;
    if (row < T) {
      const uint32_t off = (cc >> 3) * half + rl * 128 +
                           (((cc & 7) ^ (rl & 7)) << 4);
      *reinterpret_cast<uint4*>(out.p + b * out.sb + row * out.st +
                                h * out.sh + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + off);
    }
  }
}

}  // namespace hvd_flash
