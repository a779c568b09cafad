// Fused 1x1 conv + BatchNorm statistics for Hopper (sm_90a): the forward
// (K1) and backward (K2) of the fused bottleneck 1x1 convs of ResNet-50.
//
// Replaces: horovod_tpu/ops/pallas_conv.py::_fwd_kernel (launched by
// _call_fwd) and ::_bwd_kernel (launched by _fused_core_bwd), the TPU
// kernels behind BottleneckBlock's reduce, expand and shortcut convs under
// conv_backend="fused".
//
// Forward (hvd_conv_bn_fwd), x [M, Cin] bf16, W [Cout, Cin] f32:
//   u  = prologue ? bf16(relu(a*x + b)) : x      (a, b f32 per input channel)
//   y  = bf16(u . bf16(W)^T)                      (f32 accumulation)
//   s1 = sum_rows f32(y),  s2 = sum_rows f32(y)^2  (of the ROUNDED y)
// Backward (hvd_conv_bn_bwd), cotangents dy [M, Cout] bf16, ds1/ds2 [Cout]:
//   e   = bf16(dy + ds1 + 2*y*ds2)                (f32, rounded once)
//   dW  = e^T . u                   [Cout, Cin] f32 over all M
//   du  = e . bf16(W)               f32, zero where the prologue's pre <= 0
//   dx  = bf16(du * a)  (or bf16(du) without a prologue)
//   da  = sum_rows du * x,  db = sum_rows du        (prologue only)
// The rounding points are the TPU kernels'; a*x+b and the cotangent sum
// are computed without fused multiply-adds, in the reference's order.
//
// Bound: bytes at every ResNet-50 site. K1 does 2*M*Cin*Cout flops on
// 2*M*(Cin+Cout) bytes (Cin, Cout <= 512: <= 256 flops per byte, below
// the card's ~295), K2 twice the flops on about twice the bytes.
//
// Design (simple and right first; no TMA, no wgmma, no pipelining):
// * The TPU grid walks M in order and carries the column sums in VMEM.
//   Here every CTA owns a 128-row tile of M and writes its own column
//   partial sums to a [tiles, C] scratch; col_sum_kernel then adds the
//   partials over tiles in a FIXED order. No float atomics, so two
//   launches on the same input give bitwise-equal sums.
// * K1 is one kernel: a 128 x BN (BN = 128, or 64 when Cout is not a
//   multiple of 128) output tile per CTA of 8 warps, depth staged through
//   shared memory 32 at a time, mma.sync m16n8k16 (bf16 in, f32 out). The
//   prologue is applied while the x tile is copied into shared memory, so
//   u is never written to device memory; W is read in f32 and rounded to
//   bf16 on the way in, so no converted copy of W is made.
// * K2 is two kernels, both recomputing u (and e) from x, y, dy instead of
//   storing them: a row-parallel kernel for dx with the per-tile partials
//   of da/db, and a split-M kernel for dW writing [splits, Cout, Cin] f32
//   partials, each reduced in fixed order by col_sum_kernel.
// * Any M is accepted: rows past M are masked (loaded as zeros, never
//   stored). Cin and Cout must be multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // rows of M per CTA in the row kernels
constexpr int kBK = 32;         // depth of one shared-memory stage
constexpr int kPad = 8;         // shared-memory row padding, in elements
constexpr int kBNW = 64;        // Cin columns per CTA in the dW kernel

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile (a row-major 16x16, b col-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pre = a*x + b with two roundings (no FMA), as the reference computes it.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(a, x), b);
}

// e = dy + ds1 + 2*y*ds2, evaluated left to right without FMA.
__device__ __forceinline__ float cotangent(float dy, float y, float s1,
                                           float s2) {
  return __fadd_rn(__fadd_rn(dy, s1), __fmul_rn(__fmul_rn(2.f, y), s2));
}

// 8 bf16 of x -> 8 bf16 of u (prologue applied in f32, rounded once).
__device__ __forceinline__ uint4 apply_prologue(uint4 v, const float* a,
                                                const float* b, int k,
                                                int relu) {
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float p = affine(__bfloat162float(e[i]), a[k + i], b[k + i]);
    if (relu) p = fmaxf(p, 0.f);
    e[i] = __float2bfloat16_rn(p);
  }
  return v;
}

// 8 bf16 of the cotangent e from 8 of dy and y (columns k .. k+7).
__device__ __forceinline__ uint4 cotangent8(uint4 dyv, uint4 yv,
                                            const float* ds1,
                                            const float* ds2, int k) {
  const bf16* d = reinterpret_cast<const bf16*>(&dyv);
  const bf16* yy = reinterpret_cast<const bf16*>(&yv);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s1 = ds1 ? ds1[k + i] : 0.f;
    const float s2 = ds2 ? ds2[k + i] : 0.f;
    o[i] = __float2bfloat16_rn(cotangent(__bfloat162float(d[i]),
                                         __bfloat162float(yy[i]), s1, s2));
  }
  return out;
}

// Sum over the 8 row groups of a warp (lanes with equal lane & 3).
__device__ __forceinline__ float sum_rows_of_warp(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ---------------------------------------------------------------------------
// K1: y = u . W^T with the statistics epilogue.
// ---------------------------------------------------------------------------
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bn_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   bf16* __restrict__ y, float* __restrict__ part, int M,
                   int Cin, int Cout, int prologue, int relu) {
  constexpr int LD = kBK + kPad;
  constexpr int WN = BN / 2;      // columns per warp (warps are 4 x 2)
  constexpr int NT = WN / 8;
  constexpr int MT = 2;           // 32 rows per warp
  __shared__ __align__(16) bf16 As[kBM * LD];
  __shared__ __align__(16) bf16 Bs[BN * LD];
  __shared__ float red[2][4][BN];

  const int n_nt = Cout / BN;
  const int mt_idx = blockIdx.x / n_nt;
  const int n0 = (blockIdx.x % n_nt) * BN;
  const int m0 = mt_idx * kBM;
  const int n_mt = (M + kBM - 1) / kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += kBK) {
    __syncthreads();
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int row = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        v = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(row) * Cin + k0 + col);
        if (prologue) v = apply_prologue(v, a, b, k0 + col, relu);
      }
      *reinterpret_cast<uint4*>(&As[r * LD + col]) = v;
    }
    for (int c = tid; c < BN * kBK / 4; c += kThreads) {
      const int r = c / (kBK / 4), col = (c % (kBK / 4)) * 4;
      const float4 f = *reinterpret_cast<const float4*>(
          w + static_cast<long long>(n0 + r) * Cin + k0 + col);
      uint2 pk;
      pk.x = pack_bf16(f.x, f.y);
      pk.y = pack_bf16(f.z, f.w);
      *reinterpret_cast<uint2*>(&Bs[r * LD + col]) = pk;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* p0 = &As[(wm * 32 + mt * 16 + g) * LD + ks * 16 + 2 * t4];
        const bf16* p1 = p0 + 8 * LD;
        af[mt][0] = ld32(p0);
        af[mt][1] = ld32(p1);
        af[mt][2] = ld32(p0 + 8);
        af[mt][3] = ld32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* bp = &Bs[(wn * WN + nt * 8 + g) * LD + ks * 16 + 2 * t4];
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  // Epilogue: round y to bf16, store it, and sum the ROUNDED values.
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] =
      s2[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * t4;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<long long>(row) * Cout + col) = v;
        const float2 f = __bfloat1622float2(v);
        s1[nt][0] += f.x;
        s1[nt][1] += f.y;
        s2[nt][0] += __fmul_rn(f.x, f.x);
        s2[nt][1] += __fmul_rn(f.y, f.y);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v1 = sum_rows_of_warp(s1[nt][j]);
      const float v2 = sum_rows_of_warp(s2[nt][j]);
      if (g == 0) {
        red[0][wm][wn * WN + nt * 8 + 2 * t4 + j] = v1;
        red[1][wm][wn * WN + nt * 8 + 2 * t4 + j] = v2;
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * BN; c += kThreads) {
    const int s = c / BN, col = c % BN;
    const float t = ((red[s][0][col] + red[s][1][col]) + red[s][2][col]) +
                    red[s][3][col];
    part[(static_cast<long long>(s) * n_mt + mt_idx) * Cout + n0 + col] = t;
  }
}

// ---------------------------------------------------------------------------
// K2, row-parallel half: dx = mask(e . W) * a, partial da/db per row tile.
// ---------------------------------------------------------------------------
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                      const bf16* __restrict__ dy,
                      const float* __restrict__ w,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ ds1,
                      const float* __restrict__ ds2, bf16* __restrict__ dx,
                      float* __restrict__ part, int M, int Cin, int Cout,
                      int prologue, int relu) {
  constexpr int LDA = kBK + kPad;
  constexpr int LDB = BN + kPad;
  constexpr int WN = BN / 2;
  constexpr int NT = WN / 8;
  constexpr int MT = 2;
  __shared__ __align__(16) bf16 As[kBM * LDA];   // e   [m][k=cout]
  __shared__ __align__(16) bf16 Bs[kBK * LDB];   // W   [k=cout][n=cin]
  __shared__ float red[2][4][BN];

  const int n_nt = Cin / BN;
  const int mt_idx = blockIdx.x / n_nt;
  const int n0 = (blockIdx.x % n_nt) * BN;
  const int m0 = mt_idx * kBM;
  const int n_mt = (M + kBM - 1) / kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < Cout; k0 += kBK) {
    __syncthreads();
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int row = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        const long long off = static_cast<long long>(row) * Cout + k0 + col;
        v = cotangent8(*reinterpret_cast<const uint4*>(dy + off),
                       *reinterpret_cast<const uint4*>(y + off), ds1, ds2,
                       k0 + col);
      }
      *reinterpret_cast<uint4*>(&As[r * LDA + col]) = v;
    }
    for (int c = tid; c < kBK * BN / 4; c += kThreads) {
      const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
      const float4 f = *reinterpret_cast<const float4*>(
          w + static_cast<long long>(k0 + r) * Cin + n0 + col);
      uint2 pk;
      pk.x = pack_bf16(f.x, f.y);
      pk.y = pack_bf16(f.z, f.w);
      *reinterpret_cast<uint2*>(&Bs[r * LDB + col]) = pk;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* p0 =
            &As[(wm * 32 + mt * 16 + g) * LDA + ks * 16 + 2 * t4];
        const bf16* p1 = p0 + 8 * LDA;
        af[mt][0] = ld32(p0);
        af[mt][1] = ld32(p1);
        af[mt][2] = ld32(p0 + 8);
        af[mt][3] = ld32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* bp = &Bs[(ks * 16 + 2 * t4) * LDB + wn * WN + nt * 8 + g];
        const uint32_t b0 = pack_raw(bp[0], bp[LDB]);
        const uint32_t b1 = pack_raw(bp[8 * LDB], bp[9 * LDB]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  float sa[NT][2], sb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) sa[nt][0] = sa[nt][1] = sb[nt][0] =
      sb[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * t4;
        const long long off = static_cast<long long>(row) * Cin + col;
        float du0 = acc[mt][nt][2 * half], du1 = acc[mt][nt][2 * half + 1];
        float o0 = du0, o1 = du1;
        if (prologue) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off));
          const float a0 = a[col], a1 = a[col + 1];
          if (relu) {
            if (!(affine(xv.x, a0, b[col]) > 0.f)) du0 = 0.f;
            if (!(affine(xv.y, a1, b[col + 1]) > 0.f)) du1 = 0.f;
          }
          o0 = __fmul_rn(du0, a0);
          o1 = __fmul_rn(du1, a1);
          sa[nt][0] += __fmul_rn(du0, xv.x);
          sa[nt][1] += __fmul_rn(du1, xv.y);
          sb[nt][0] += du0;
          sb[nt][1] += du1;
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + off) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
  if (!prologue) return;   // uniform over the CTA
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v1 = sum_rows_of_warp(sa[nt][j]);
      const float v2 = sum_rows_of_warp(sb[nt][j]);
      if (g == 0) {
        red[0][wm][wn * WN + nt * 8 + 2 * t4 + j] = v1;
        red[1][wm][wn * WN + nt * 8 + 2 * t4 + j] = v2;
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * BN; c += kThreads) {
    const int s = c / BN, col = c % BN;
    const float t = ((red[s][0][col] + red[s][1][col]) + red[s][2][col]) +
                    red[s][3][col];
    part[(static_cast<long long>(s) * n_mt + mt_idx) * Cin + n0 + col] = t;
  }
}

// ---------------------------------------------------------------------------
// K2, split-M half: partial dW[split] = e^T . u over the split's rows.
// ---------------------------------------------------------------------------
template <int BMO>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                      const bf16* __restrict__ dy,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ ds1,
                      const float* __restrict__ ds2,
                      float* __restrict__ part, int M, int Cin, int Cout,
                      int prologue, int relu, int rows_per_split) {
  constexpr int LDA = BMO + kPad;
  constexpr int LDB = kBNW + kPad;
  constexpr int WM = BMO / 4;     // Cout rows per warp (warps are 4 x 2)
  constexpr int MT = WM / 16;
  constexpr int NT = (kBNW / 2) / 8;
  __shared__ __align__(16) bf16 As[kBK * LDA];   // e  [k=m][cout]
  __shared__ __align__(16) bf16 Bs[kBK * LDB];   // u  [k=m][cin]

  const int ci0 = blockIdx.x * kBNW;
  const int co0 = blockIdx.y * BMO;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    __syncthreads();
    for (int c = tid; c < kBK * BMO / 8; c += kThreads) {
      const int r = c / (BMO / 8), col = (c % (BMO / 8)) * 8;
      const int row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end) {
        const long long off = static_cast<long long>(row) * Cout + co0 + col;
        v = cotangent8(*reinterpret_cast<const uint4*>(dy + off),
                       *reinterpret_cast<const uint4*>(y + off), ds1, ds2,
                       co0 + col);
      }
      *reinterpret_cast<uint4*>(&As[r * LDA + col]) = v;
    }
    for (int c = tid; c < kBK * kBNW / 8; c += kThreads) {
      const int r = c / (kBNW / 8), col = (c % (kBNW / 8)) * 8;
      const int row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end) {
        v = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(row) * Cin + ci0 + col);
        if (prologue) v = apply_prologue(v, a, b, ci0 + col, relu);
      }
      *reinterpret_cast<uint4*>(&Bs[r * LDB + col]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int k = ks * 16 + 2 * t4;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = wm * WM + mt * 16 + g;
        af[mt][0] = pack_raw(As[k * LDA + m], As[(k + 1) * LDA + m]);
        af[mt][1] = pack_raw(As[k * LDA + m + 8], As[(k + 1) * LDA + m + 8]);
        af[mt][2] = pack_raw(As[(k + 8) * LDA + m], As[(k + 9) * LDA + m]);
        af[mt][3] = pack_raw(As[(k + 8) * LDA + m + 8],
                             As[(k + 9) * LDA + m + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * (kBNW / 2) + nt * 8 + g;
        const uint32_t b0 = pack_raw(Bs[k * LDB + n], Bs[(k + 1) * LDB + n]);
        const uint32_t b1 =
            pack_raw(Bs[(k + 8) * LDB + n], Bs[(k + 9) * LDB + n]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  float* out = part + static_cast<long long>(split) * Cout * Cin;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm * WM + mt * 16 + g + half * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ci = ci0 + wn * (kBNW / 2) + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(out + static_cast<long long>(co) * Cin +
                                   ci) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// out[s][c] = sum over t of in[s][t][c], t in a fixed order: 32 row
// groups each add every 32nd partial in order, then one thread adds the
// 32 group sums in order. Deterministic whatever the scheduling.
__global__ void __launch_bounds__(1024)
col_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int T,
               long long C) {
  __shared__ float sm[32][33];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + cx;
  const float* src = in + static_cast<long long>(blockIdx.y) * T * C;
  float s = 0.f;
  if (col < C)
    for (int t = ry; t < T; t += 32) s += src[static_cast<long long>(t) * C + col];
  sm[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && col < C) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) tot += sm[r][cx];
    out[static_cast<long long>(blockIdx.y) * C + col] = tot;
  }
}

int launch_col_sum(const float* in, float* out, int n_arrays, int T,
                   long long C, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((C + 31) / 32), n_arrays);
  col_sum_kernel<<<grid, 1024, 0, st>>>(in, out, T, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, Cin] bf16; w: [Cout, Cin] f32; a, b: [Cin] f32 (read only with
// prologue); y: [M, Cout] bf16; part: [2, ceil(M/128), Cout] f32 scratch;
// stats: [2, Cout] f32 (s1, s2). All contiguous. Cin, Cout multiples of 64.
// Launches K1 and the fixed-order reduction; returns cudaGetLastError().
extern "C" int hvd_conv_bn_fwd(const void* x, const void* w, const void* a,
                               const void* b, void* y, void* part,
                               void* stats, int M, int Cin, int Cout,
                               int prologue, int relu, void* stream) {
  if (M <= 0 || Cin % 64 || Cout % 64 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_mt = (M + kBM - 1) / kBM;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<bf16*>(y);
  auto* pp = static_cast<float*>(part);
  if (Cout % 128 == 0) {
    conv_bn_fwd_kernel<128><<<n_mt * (Cout / 128), kThreads, 0, st>>>(
        xp, wp, ap, bp, yp, pp, M, Cin, Cout, prologue, relu);
  } else {
    conv_bn_fwd_kernel<64><<<n_mt * (Cout / 64), kThreads, 0, st>>>(
        xp, wp, ap, bp, yp, pp, M, Cin, Cout, prologue, relu);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_col_sum(pp, static_cast<float*>(stats), 2, n_mt, Cout, st);
}

// x, y, dy as in the forward; w, a, b likewise; ds1, ds2: [Cout] f32 or
// null (zero). Outputs: dx [M, Cin] bf16, dw [Cout, Cin] f32, dab [2, Cin]
// f32 (da, db; written only with prologue). Scratch: part_ab [2,
// ceil(M/128), Cin] f32, part_w [n_splits, Cout, Cin] f32 with
// n_splits = ceil(M / rows_per_split), rows_per_split a multiple of 32.
// Launches the dx kernel, the dW kernel and their fixed-order reductions.
extern "C" int hvd_conv_bn_bwd(const void* x, const void* y, const void* dy,
                               const void* w, const void* a, const void* b,
                               const void* ds1, const void* ds2, void* dx,
                               void* dw, void* dab, void* part_ab,
                               void* part_w, int M, int Cin, int Cout,
                               int prologue, int relu, int n_splits,
                               int rows_per_split, void* stream) {
  if (M <= 0 || Cin % 64 || Cout % 64 || Cin <= 0 || Cout <= 0 ||
      rows_per_split % kBK || rows_per_split <= 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits) * rows_per_split < M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_mt = (M + kBM - 1) / kBM;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* yp = static_cast<const bf16*>(y);
  const auto* dyp = static_cast<const bf16*>(dy);
  const auto* wp = static_cast<const float*>(w);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* s1p = static_cast<const float*>(ds1);
  const auto* s2p = static_cast<const float*>(ds2);
  auto* dxp = static_cast<bf16*>(dx);
  auto* pab = static_cast<float*>(part_ab);
  auto* pw = static_cast<float*>(part_w);
  if (Cin % 128 == 0) {
    conv_bn_bwd_dx_kernel<128><<<n_mt * (Cin / 128), kThreads, 0, st>>>(
        xp, yp, dyp, wp, ap, bp, s1p, s2p, dxp, pab, M, Cin, Cout, prologue,
        relu);
  } else {
    conv_bn_bwd_dx_kernel<64><<<n_mt * (Cin / 64), kThreads, 0, st>>>(
        xp, yp, dyp, wp, ap, bp, s1p, s2p, dxp, pab, M, Cin, Cout, prologue,
        relu);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (prologue) {
    err = launch_col_sum(pab, static_cast<float*>(dab), 2, n_mt, Cin, st);
    if (err) return err;
  }
  if (Cout % 128 == 0) {
    const dim3 grid(Cin / kBNW, Cout / 128, n_splits);
    conv_bn_bwd_dw_kernel<128><<<grid, kThreads, 0, st>>>(
        xp, yp, dyp, ap, bp, s1p, s2p, pw, M, Cin, Cout, prologue, relu,
        rows_per_split);
  } else {
    const dim3 grid(Cin / kBNW, Cout / 64, n_splits);
    conv_bn_bwd_dw_kernel<64><<<grid, kThreads, 0, st>>>(
        xp, yp, dyp, ap, bp, s1p, s2p, pw, M, Cin, Cout, prologue, relu,
        rows_per_split);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_col_sum(pw, static_cast<float*>(dw), 1, n_splits,
                        static_cast<long long>(Cout) * Cin, st);
}
