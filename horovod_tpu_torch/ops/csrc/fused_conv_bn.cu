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
// Bound: bytes at every ResNet-50 site (Cin, Cout <= 512: K1 does at most
// 2*Cin*Cout / (2*(Cin+Cout)) <= 128 flops per byte, K2 twice that on
// twice the bytes; the card's ridge is ~295). What each launch reads and
// writes of x, y, dy and dx against the bound's bytes (each once), in MB,
// at the 16 sites of a batch-128 step (M rows, Cin->Cout), with the
// partials written and read back and the plan (fused_conv_bn.py):
//   site                 K1 moves/bound  K2 moves/bound  partials  K2 plan
//   401408  64->64           103 / 103      206 / 206       4.3   one pass
//   401408  64->256 pro      257 / 257      514 / 514      17.4   one pass
//   401408  64->256          257 / 257      514 / 514      17.3   one pass
//   401408 256->64           257 / 257      514 / 514      17.3   one pass
//   401408 256->128          308 / 308      617 / 617      34.6   one pass
//   100352 128->512 pro      154 / 128      514 / 257      35.3   split, 2 win
//   100352 256->512          206 / 154      668 / 308      35.4   split, 4 win
//   100352 512->128          128 / 128      411 / 257      35.0   split, 2 win
// (K1 reads x once per Cout slice; K2's dx kernel reads y and dy once per
// Cin slice and its dW windows y and dy once per window of Cin, x once
// per window of Cout. CTAs reading the same rows run side by side, so L2
// serves part of the re-reads.)
//
// Design: wgmma fed by TMA rings, one persistent CTA of two warpgroups per
// SM, no producer warp (nvcc 12.9's ptxas gives every thread the launch
// bound's registers whatever setmaxnreg asks): the last of the 8 warps done
// with a ring stage, counted by an acquire-release atomic, refills it. Every
// CTA owns a fixed contiguous run of row tiles (tile_run); its column sums
// stay in registers or shared memory across its tiles and are written once
// as the CTA's partial, which conv_bn_col_sum_kernel adds over CTAs in a
// FIXED order. No float atomics anywhere, so two launches on the same input
// give bitwise-equal results. Rows past M: TMA zero-fills the loads and
// clips the stores, and u and e are set to zero there after they are
// formed (a zero row is not zero after the prologue, relu(b), nor after
// the cotangent, bf16(ds1)). Any M >= 1; Cin and Cout multiples of 64.
// Outputs (y, dx) are rounded into a swizzled shared-memory box per
// warpgroup and written by TMA stores.
// * K1 (conv_bn_fwd_kernel): each CTA owns a 64*kNp-column slice of Cout;
//   its bf16 slice of W stays in shared memory (rounded from f32 once per
//   CTA; above ~1 K input channels, where it does not fit, W's boxes come
//   through the ring from a bf16 copy). 64-column boxes of 128 x-rows come
//   through a 4-stage ring; each warpgroup applies the prologue to its 64
//   rows in place and issues y += u W^T (shared-shared wgmma, K-major).
//   s1 and s2 of the rounded y are summed over each warp's rows in a
//   butterfly and kept in registers across the CTA's tiles.
// * K2, one pass (conv_bn_bwd_kernel<kNBW, true, .>) where the CTA's whole
//   [Cout, Cin] dW fits in registers (<= 8 blocks of 64x64, kNBW a
//   warpgroup) and a 2-stage ring of whole 64-row tiles fits beside bf16 W
//   (every site at M = 401408): x, y and dy of a tile arrive by TMA; e is
//   formed in place of dy and u in place of y (Cin <= Cout) or beside it,
//   128B-swizzled and made visible to wgmma; then dW += e^T u (e and u as
//   MN-major operands) and, box by box of 64 input channels, du = e W (W
//   MN-major) with the epilogue: the ReLU mask, *a, da/db summed per warp
//   in shared memory, dx stored. The stage is released before the next
//   tile is formed; with one box of dx (Cin = 64) the second warpgroup
//   forms it while the first runs the epilogue. x, y and dy are read once.
// * K2 elsewhere: a row-parallel dx kernel (conv_bn_bwd_dx_kernel: 128-row
//   tiles, e formed in place box by box of 64 output channels while W's
//   boxes stream from L2 through the same ring, du accumulated over all of
//   Cout, the same epilogue) and the one-pass kernel without dx over
//   [bco, bci] windows of dW (conv_bn_bwd_kernel<kNBW, false, .>), each
//   window's rows split over CTAs; windows vary fastest so that CTAs
//   reading the same rows run side by side.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = hvd_hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                // two warpgroups
constexpr uint32_t kSmemLimit = 232448;      // a CTA's dynamic shared memory
constexpr uint32_t kBox = 64 * 128;          // a [64 rows, 64] bf16 box
constexpr int kMaxStages = 4;

// This thread's warpgroup, broadcast so that ptxas knows it is uniform in
// the warp (a wgmma under a branch on threadIdx would be serialized).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
}

// Byte offset of element (r, c) of a [rows, C] bf16 tile stored as C/64
// boxes of [rows, 64]: rows of 128 bytes whose 16-byte chunks are swizzled
// by r % 8, what a 128B-swizzle TMA box holds.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return static_cast<uint32_t>((c >> 6) * rows * 128 + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                               (c & 7) * 2);
}

// Descriptors of a 128B-swizzled operand: K-major (a k-step of 16 is +32
// bytes inside a box), or MN-major from the first of its 16 reduction rows
// (a k-step is +2048 bytes), `box` bytes between 64-wide M/N boxes.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return hp::desc_sw128(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t box) {
  return hp::desc_sw128(addr, box, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// 8 bf16 of x -> 8 bf16 of u; a, b point at the 8 columns' values.
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* a,
                                           const float* b, bool relu) {
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float p = affine(__bfloat162float(e[i]), a[i], b[i]);
    if (relu) p = fmaxf(p, 0.f);
    e[i] = __float2bfloat16_rn(p);
  }
  return v;
}

// 8 bf16 of e from 8 of dy and y; s1, s2 point at the 8 columns' ds1, ds2.
__device__ __forceinline__ uint4 cotangent8(uint4 dyv, uint4 yv,
                                            const float* s1,
                                            const float* s2) {
  const bf16* d = reinterpret_cast<const bf16*>(&dyv);
  const bf16* yy = reinterpret_cast<const bf16*>(&yv);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = __float2bfloat16_rn(cotangent(__bfloat162float(d[i]),
                                         __bfloat162float(yy[i]), s1[i],
                                         s2[i]));
  return out;
}

__device__ __forceinline__ uint4& at16(uint8_t* p, uint32_t off) {
  return *reinterpret_cast<uint4*>(p + off);
}

// v[2j + p]: this lane's sum over its two rows of column 8j + 2*t4 + p of
// a 64-column box. Summed over the warp's 8 row groups (lanes of equal t4)
// in a fixed butterfly that halves the values a lane holds at each step;
// afterwards v[p] holds column 8g + 2*t4 + p of the box (g = lane / 4).
__device__ __forceinline__ void sum_rows(float (&v)[16], int g) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool hi = g & 4;
    const float send = hi ? v[i] : v[i + 8];
    v[i] = (hi ? v[i + 8] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = g & 2;
    const float send = hi ? v[i] : v[i + 4];
    v[i] = (hi ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = g & 1;
    const float send = hi ? v[i] : v[i + 2];
    v[i] = (hi ? v[i + 2] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

// First tile and tile count of part `part` of `n_parts` contiguous runs of
// `n_tiles` tiles (every run non-empty when n_parts <= n_tiles).
struct Run {
  int first, count;
};

__device__ __forceinline__ Run tile_run(int n_tiles, int part, int n_parts) {
  const int b = static_cast<int>(static_cast<long long>(part) * n_tiles /
                                 n_parts);
  const int e = static_cast<int>(static_cast<long long>(part + 1) *
                                 n_tiles / n_parts);
  return {b, e - b};
}

// Staged output: a warpgroup's 64 rows of a 64-column box of y or dx go
// through its swizzled shared-memory box (at `off` + wg boxes) and a TMA
// store issued by its first thread. open() waits until the box's last
// store has read it; close() issues the store.
struct OutBox {
  uint32_t buf;
  uint8_t* ptr;
};

__device__ __forceinline__ OutBox out_open(uint8_t* smem, uint32_t base,
                                           uint32_t off, int wg, int wtid) {
  const uint32_t o = off + static_cast<uint32_t>(wg) * kBox;
  if (wtid == 0) hp::bulk_wait_read<0>();
  hp::named_barrier(1 + wg, 128);
  return {base + o, smem + o};
}

__device__ __forceinline__ void out_close(const OutBox& ob,
                                          const CUtensorMap* map, int col,
                                          int row, int wg, int wtid) {
  hp::fence_proxy_async();
  hp::named_barrier(1 + wg, 128);
  if (wtid == 0) {
    hp::tma_store_2d(map, ob.buf, col, row);
    hp::bulk_commit();
  }
}

// This warp's reads of ring stage `i % stages` are done; the last of the
// CTA's 8 warps to get there issues `refill(i + stages)` if there is one.
template <class Refill>
__device__ __forceinline__ void release(uint32_t done, int i, int stages,
                                        int n, int lane, Refill refill) {
  __syncwarp();
  if (lane == 0 &&
      hp::atomic_add_acq_rel(done + 4 * (i % stages), 1u) % 8 == 7 &&
      i + stages < n)
    refill(i + stages);
  __syncwarp();   // reconverged before the next .aligned instruction
}

// bf16(W[r0 + r, c]) for r < rows, all Cin columns, into shared memory at
// `dst` as Cin/64 boxes of [rows, 64] (K-major for the forward's W^T
// slice, MN-major for the backward's W: the same bytes).
__device__ __forceinline__ void stage_weight(uint8_t* dst, const float* w,
                                             int r0, int rows, int cin) {
  for (int q = threadIdx.x; q < rows * cin / 8; q += kThreads) {
    const int r = q / (cin / 8), c = q % (cin / 8) * 8;
    const float4* src = reinterpret_cast<const float4*>(
        w + static_cast<long long>(r0 + r) * cin + c);
    const float4 f0 = src[0], f1 = src[1];
    at16(dst, swz(rows, r, c)) =
        make_uint4(pack_bf16(f0.x, f0.y), pack_bf16(f0.z, f0.w),
                   pack_bf16(f1.x, f1.y), pack_bf16(f1.z, f1.w));
  }
}

// One 64x64 box of dx from a warpgroup's accumulator of du, into the
// staged output box `out`: element i is row w4 * 16 + g + 8 * ((i >> 1) &
// 1), box column 8 * (i >> 2) + 2 * t4 + (i & 1). With the prologue,
// x2(r, cl) gives the bf16 pair of x at (row, box column) and a, b point at
// the box's 64 values: du is zeroed where pre <= 0 under ReLU, dx = du * a,
// and da[2j + p], db[2j + p] get this lane's sums over its two rows (for
// sum_rows).
template <bool kPro, class X2>
__device__ __forceinline__ void dx_box(const float (&acc)[32], uint8_t* out,
                                       X2 x2, const float* a, const float* b,
                                       bool relu, int w4, int g, int t4,
                                       float (&da)[16], float (&db)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = 8 * j + 2 * t4;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = w4 * 16 + g + 8 * hf;
      float du0 = acc[4 * j + 2 * hf], du1 = acc[4 * j + 2 * hf + 1];
      float o0 = du0, o1 = du1;
      if (kPro) {
        const float2 xv = x2(r, cl);
        if (relu) {
          if (!(affine(xv.x, a[cl], b[cl]) > 0.f)) du0 = 0.f;
          if (!(affine(xv.y, a[cl + 1], b[cl + 1]) > 0.f)) du1 = 0.f;
        }
        o0 = __fmul_rn(du0, a[cl]);
        o1 = __fmul_rn(du1, a[cl + 1]);
        const float x0 = __fmul_rn(du0, xv.x);
        const float x1 = __fmul_rn(du1, xv.y);
        da[2 * j] = hf ? __fadd_rn(da[2 * j], x0) : x0;
        da[2 * j + 1] = hf ? __fadd_rn(da[2 * j + 1], x1) : x1;
        db[2 * j] = hf ? __fadd_rn(db[2 * j], du0) : du0;
        db[2 * j + 1] = hf ? __fadd_rn(db[2 * j + 1], du1) : du1;
      }
      *reinterpret_cast<uint32_t*>(out + swz(64, r, cl)) = pack_bf16(o0, o1);
    }
  }
}

// ---------------------------------------------------------------------------
// K1: y = u . W^T with the statistics epilogue.
// ---------------------------------------------------------------------------

// Shared memory of conv_bn_fwd_kernel (host and device): the ring (a stage
// is x's [128, 64] box, then W's [64 kNp, 64] box when W streams), W's
// resident slice, the output boxes, a and b, the mbarriers and counts.
struct FwdSmem {
  uint32_t stage, wst, wres, out, ab, bars, total;
  __host__ __device__ FwdSmem(int np, int cin, bool stream, bool pro,
                              int stages) {
    wst = 2 * kBox;
    stage = wst + (stream ? np * kBox : 0);
    uint32_t o = stage * stages;
    wres = o;
    if (!stream) o += np * kBox * (cin / 64);
    out = o;
    o += 2 * kBox;
    ab = o;
    if (pro) o += 8 * cin;
    bars = o;
    o += 16 * stages;
    total = o + 1024;
  }
};

struct FwdArgs {
  const float* w;
  const float* a;
  const float* b;
  float* part;          // [2, n_runs, Cout]
  int M, cin, cout, n_slices, n_runs, stages, relu;
};

template <int kNp, bool kStream, bool kPro>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const FwdArgs p) {
  constexpr int kBN = 64 * kNp;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const FwdSmem L(kNp, p.cin, kStream, kPro, p.stages);
  const int S = p.stages;
  const int slice = blockIdx.x % p.n_slices;
  const int co0 = slice * kBN;
  const Run run = tile_run((p.M + 127) / 128, blockIdx.x / p.n_slices,
                           p.n_runs);
  const int n_kc = p.cin / 64;
  const int n_it = run.count * n_kc;
  const uint32_t full = base + L.bars;
  const uint32_t done = full + 8 * S;

  auto load = [&](int i) {
    const uint32_t bar = full + 8 * (i % S);
    const uint32_t st = base + (i % S) * L.stage;
    const int kc = i % n_kc, row = (run.first + i / n_kc) * 128;
    hp::mbar_expect_tx(bar, L.stage);
    hp::tma_load_2d(st, &xmap, bar, kc * 64, row);
    if (kStream) hp::tma_load_2d(st + L.wst, &wmap, bar, kc * 64, co0);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      reinterpret_cast<uint32_t*>(smem + L.bars + 8 * S)[s] = 0;
    }
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&xmap);
    hp::tma_prefetch_map(&ymap);
    if (kStream) hp::tma_prefetch_map(&wmap);
    for (int i = 0; i < min(S, n_it); ++i) load(i);
  }
  float* ab_s = reinterpret_cast<float*>(smem + L.ab);   // a [Cin], b [Cin]
  if (kPro)
    for (int c = tid; c < p.cin; c += kThreads) {
      ab_s[c] = p.a[c];
      ab_s[p.cin + c] = p.b[c];
    }
  if (!kStream) {
    stage_weight(smem + L.wres, p.w, co0, kBN, p.cin);
    hp::fence_proxy_async();
  }
  __syncthreads();

  const int wg = warpgroup();
  const int wtid = tid & 127, w4 = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[kNp][32];
  float sums[kNp][4];   // s1 of columns 8g + 2 t4 + {0, 1}, then s2
#pragma unroll
  for (int n = 0; n < kNp; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sums[n][i] = 0.f;
  auto fence_acc = [&]() {
#pragma unroll
    for (int n = 0; n < kNp; ++n) hp::fence_operands(acc[n]);
  };
  auto rel = [&](int i) { release(done, i, S, n_it, lane, load); };

  // The tile's y: rounded, stored box by box, its column sums taken from
  // the rounded values. Element i of a box's accumulator: row w4 * 16 + g
  // + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * t4 + (i & 1).
  auto epilogue = [&](int row0) {
#pragma unroll
    for (int n = 0; n < kNp; ++n) {
      const OutBox ob = out_open(smem, base, L.out, wg, wtid);
      float v1[16], v2[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = w4 * 16 + g + 8 * hf;
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              acc[n][4 * j + 2 * hf], acc[n][4 * j + 2 * hf + 1]);
          *reinterpret_cast<__nv_bfloat162*>(ob.ptr +
                                             swz(64, r, 8 * j + 2 * t4)) = h;
          const float2 f = __bfloat1622float2(h);
          if (hf == 0) {
            v1[2 * j] = f.x;
            v1[2 * j + 1] = f.y;
            v2[2 * j] = __fmul_rn(f.x, f.x);
            v2[2 * j + 1] = __fmul_rn(f.y, f.y);
          } else {
            v1[2 * j] = __fadd_rn(v1[2 * j], f.x);
            v1[2 * j + 1] = __fadd_rn(v1[2 * j + 1], f.y);
            v2[2 * j] = __fadd_rn(v2[2 * j], __fmul_rn(f.x, f.x));
            v2[2 * j + 1] = __fadd_rn(v2[2 * j + 1], __fmul_rn(f.y, f.y));
          }
        }
      }
      out_close(ob, &ymap, co0 + 64 * n, row0 + 64 * wg, wg, wtid);
      sum_rows(v1, g);
      sum_rows(v2, g);
      sums[n][0] += v1[0];
      sums[n][1] += v1[1];
      sums[n][2] += v2[0];
      sums[n][3] += v2[1];
    }
  };

  int pending = -1;
  for (int i = 0; i < n_it; ++i) {
    const int s = i % S, kc = i % n_kc;
    const uint32_t st = base + s * L.stage;
    uint8_t* stp = smem + s * L.stage;
    const int row0 = (run.first + i / n_kc) * 128;
    hp::mbar_wait(full + 8 * s, static_cast<uint32_t>(i / S) & 1);
    if (kPro) {
      // u = bf16(relu(a x + b)) in place over this warpgroup's 64 rows;
      // zero past M.
      for (int q = wtid; q < 512; q += 128) {
        const int r = wg * 64 + (q >> 3), pos = q & 7;
        const uint32_t off = r * 128 + pos * 16;
        const int col = kc * 64 + ((pos ^ (r & 7)) << 3);
        at16(stp, off) = row0 + r < p.M
            ? prologue8(at16(stp, off), ab_s + col, ab_s + p.cin + col,
                        p.relu != 0)
            : make_uint4(0u, 0u, 0u, 0u);
      }
      hp::fence_proxy_async();
      hp::named_barrier(1 + wg, 128);
    }
    const uint32_t wb =
        kStream ? st + L.wst : base + L.wres + kc * kNp * kBox;
    fence_acc();
    hp::wgmma_fence();
#pragma unroll
    for (int n = 0; n < kNp; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n64k16_t<0, 0>(
            acc[n], kmajor(st + wg * 64 * 128 + kk * 32),
            kmajor(wb + n * kBox + kk * 32), kc > 0 || kk > 0);
    hp::wgmma_commit();
    if (kc + 1 < n_kc) {
      hp::wgmma_wait<1>();
      fence_acc();
      if (pending >= 0) rel(pending);
      pending = i;
    } else {
      hp::wgmma_wait<0>();
      fence_acc();
      if (pending >= 0) rel(pending);
      rel(i);
      pending = -1;
      epilogue(row0);
    }
  }

  // The CTA's partial: the 8 warps' sums added in order (the ring is free:
  // every load was consumed).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [8 warps][2][kBN]
  const int gw = tid >> 5;
#pragma unroll
  for (int n = 0; n < kNp; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = 64 * n + 8 * g + 2 * t4 + q;
      red[(gw * 2 + 0) * kBN + col] = sums[n][q];
      red[(gw * 2 + 1) * kBN + col] = sums[n][2 + q];
    }
  __syncthreads();
  const int part = blockIdx.x / p.n_slices;
  for (int c = tid; c < 2 * kBN; c += kThreads) {
    const int sidx = c / kBN, col = c % kBN;
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[(w * 2 + sidx) * kBN + col];
    p.part[(static_cast<long long>(sidx) * p.n_runs + part) * p.cout + co0 +
           col] = t;
  }
  if (wtid == 0) hp::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K2, one pass (kDx) or a dW window: dW += e^T u over the CTA's 64-row
// tiles, and with kDx du = e W, dx and the da/db partials.
// ---------------------------------------------------------------------------

// Shared memory of conv_bn_bwd_kernel (host and device): the ring (a stage
// is x's [64, bci], y's and dy's [64, bco] boxes; u goes in place of x in
// a dW window, into y's boxes in the one pass (e is formed from them first,
// by the same thread, chunk by chunk), or after them when Cin > Cout), then
// with kDx bf16 W ([Cout, 64] boxes), the output boxes and the per-warp
// da/db sums; a and b, ds1 and ds2, the mbarriers and counts.
struct BwdSmem {
  uint32_t x, y, dy, u, loaded, stage, w, out, dab, ab, ds, bars, total;
  __host__ __device__ BwdSmem(int cin, int cout, int bci, int bco, bool dx,
                              bool pro, int stages) {
    x = 0;
    y = 128 * bci;
    dy = y + 128 * bco;
    loaded = stage = dy + 128 * bco;   // bytes TMA writes into a stage
    u = x;
    if (dx && pro) {
      u = bci <= bco ? y : stage;
      if (bci > bco) stage += 128 * bci;
    }
    uint32_t o = stage * stages;
    w = o;
    if (dx) o += 2 * cin * cout;
    out = o;
    if (dx) o += 2 * kBox;
    dab = o;
    if (dx && pro) o += 32 * cin;
    ab = o;
    if (pro) o += 8 * bci;
    ds = o;
    o += 8 * bco;
    bars = o;
    o += 16 * stages;
    total = o + 1024;
  }
};

struct BwdArgs {
  const float* w;
  const float* a;
  const float* b;
  const float* ds1;
  const float* ds2;
  float* part_w;        // [n_parts, Cout, Cin]
  float* part_ab;       // [2, n_parts, Cin] (kDx with the prologue)
  int M, cin, cout, bci, bco, n_windows, n_parts, stages, relu;
};

template <int kNBW, bool kDx, bool kPro>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const __grid_constant__ CUtensorMap dymap,
                   const __grid_constant__ CUtensorMap dxmap,
                   const BwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const BwdSmem L(p.cin, p.cout, p.bci, p.bco, kDx, kPro, p.stages);
  const int S = p.stages;
  const int nx = p.bci / 64, ny = p.bco / 64, n_blk = nx * ny;
  const int win = blockIdx.x % p.n_windows, part = blockIdx.x / p.n_windows;
  const int co0 = win / (p.cin / p.bci) * p.bco;
  const int ci0 = win % (p.cin / p.bci) * p.bci;
  const Run run = tile_run((p.M + 63) / 64, part, p.n_parts);
  const uint32_t full = base + L.bars;
  const uint32_t done = full + 8 * S;

  auto load = [&](int i) {
    const uint32_t bar = full + 8 * (i % S);
    const uint32_t st = base + (i % S) * L.stage;
    const int row = (run.first + i) * 64;
    hp::mbar_expect_tx(bar, L.loaded);
    for (int c = 0; c < nx; ++c)
      hp::tma_load_2d(st + L.x + c * kBox, &xmap, bar, ci0 + 64 * c, row);
    for (int c = 0; c < ny; ++c) {
      hp::tma_load_2d(st + L.y + c * kBox, &ymap, bar, co0 + 64 * c, row);
      hp::tma_load_2d(st + L.dy + c * kBox, &dymap, bar, co0 + 64 * c, row);
    }
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      reinterpret_cast<uint32_t*>(smem + L.bars + 8 * S)[s] = 0;
    }
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&xmap);
    hp::tma_prefetch_map(&ymap);
    hp::tma_prefetch_map(&dymap);
    if (kDx) hp::tma_prefetch_map(&dxmap);
    for (int i = 0; i < min(S, run.count); ++i) load(i);
  }
  float* ab_s = reinterpret_cast<float*>(smem + L.ab);   // a, b [bci]
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);   // ds1, ds2 [bco]
  float* dab_s = reinterpret_cast<float*>(smem + L.dab);
  if (kPro)
    for (int c = tid; c < p.bci; c += kThreads) {
      ab_s[c] = p.a[ci0 + c];
      ab_s[p.bci + c] = p.b[ci0 + c];
    }
  for (int c = tid; c < p.bco; c += kThreads) {
    ds_s[c] = p.ds1 ? p.ds1[co0 + c] : 0.f;
    ds_s[p.bco + c] = p.ds2 ? p.ds2[co0 + c] : 0.f;
  }
  if (kDx) {
    stage_weight(smem + L.w, p.w, 0, p.cout, p.cin);
    // [4 warps of a warpgroup][da, db][Cin]: a box of dx belongs to one
    // warpgroup, so each column's sums to one thread of each of its warps.
    if (kPro)
      for (int c = tid; c < 8 * p.cin; c += kThreads) dab_s[c] = 0.f;
    hp::fence_proxy_async();
  }
  __syncthreads();

  const int wg = warpgroup();
  const int wtid = tid & 127, w4 = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float dw[kNBW][32];
#pragma unroll
  for (int k = 0; k < kNBW; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) dw[k][i] = 0.f;
  auto fence_dw = [&]() {
#pragma unroll
    for (int k = 0; k < kNBW; ++k) hp::fence_operands(dw[k]);
  };

  // e = bf16(dy + ds1 + 2 y ds2) in place of dy and u of tile i (see
  // BwdSmem); zero past M; by `nt` threads from `t0`. Made visible to
  // wgmma's async proxy.
  auto form = [&](int i, int t0, int nt) {
    uint8_t* stp = smem + (i % S) * L.stage;
    const int row0 = (run.first + i) * 64;
    hp::mbar_wait(full + 8 * (i % S), static_cast<uint32_t>(i / S) & 1);
    for (int q = t0; q < 8 * p.bco; q += nt) {
      const int r = (q >> 3) & 63, pos = q & 7;
      const uint32_t off = (q >> 9) * kBox + r * 128 + pos * 16;
      const int col = (q >> 9) * 64 + ((pos ^ (r & 7)) << 3);
      at16(stp, L.dy + off) = row0 + r < p.M
          ? cotangent8(at16(stp, L.dy + off), at16(stp, L.y + off),
                       ds_s + col, ds_s + p.bco + col)
          : make_uint4(0u, 0u, 0u, 0u);
    }
    if (kPro)
      for (int q = t0; q < 8 * p.bci; q += nt) {
        const int r = (q >> 3) & 63, pos = q & 7;
        const uint32_t off = (q >> 9) * kBox + r * 128 + pos * 16;
        const int col = (q >> 9) * 64 + ((pos ^ (r & 7)) << 3);
        at16(stp, L.u + off) = row0 + r < p.M
            ? prologue8(at16(stp, L.x + off), ab_s + col, ab_s + p.bci + col,
                        p.relu != 0)
            : make_uint4(0u, 0u, 0u, 0u);
      }
    hp::fence_proxy_async();
  };
  float acc[32];        // du of one box of dx (kDx)
  const uint32_t wbox = static_cast<uint32_t>(p.cout) * 128;
  // du = e W for the box c of 64 input channels: e K-major, W's box c
  // MN-major (its rows the reduction), a commit group per box of 64 output
  // channels.
  auto issue_dx = [&](uint32_t eb, int c) {
    const uint32_t wc = base + L.w + c * wbox;
    for (int kc = 0; kc < ny; ++kc) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n64k16_t<0, 1>(
            acc, kmajor(eb + kc * kBox + kk * 32),
            mnmajor(wc + (4 * kc + kk) * 2048, wbox), kc > 0 || kk > 0);
      hp::wgmma_commit();
    }
  };
  // dx of box c from acc (x from the stage), its da/db into the warp's
  // sums.
  auto epilogue = [&](const uint8_t* stp, int row0, int c) {
    const OutBox ob = out_open(smem, base, L.out, wg, wtid);
    float da[16], db[16];
    dx_box<kPro>(
        acc, ob.ptr,
        [&](int r, int cl) {
          return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              stp + L.x + swz(64, r, c * 64 + cl)));
        },
        ab_s + c * 64, ab_s + p.bci + c * 64, p.relu != 0, w4, g, t4, da,
        db);
    out_close(ob, &dxmap, c * 64, row0, wg, wtid);
    if (kPro) {
      sum_rows(da, g);
      sum_rows(db, g);
      float* sa = dab_s + w4 * 2 * p.cin + c * 64 + 8 * g + 2 * t4;
      sa[0] += da[0];
      sa[1] += da[1];
      sa[p.cin] += db[0];
      sa[p.cin + 1] += db[1];
    }
  };

  // Tile i: its products, then its dx boxes; the stage is released before
  // tile i + 1 is formed. Both warpgroups run the same number of dx boxes,
  // (nx + 1) / 2: with an odd count the second repeats the last and does
  // not store it (a wgmma under a branch or a loop that differs between
  // the warpgroups would be serialized).
  if (run.count > 0) form(0, tid, kThreads);
  __syncthreads();
  for (int i = 0; i < run.count; ++i) {
    const uint32_t st = base + (i % S) * L.stage;
    const uint8_t* stp = smem + (i % S) * L.stage;
    const int row0 = (run.first + i) * 64;
    const uint32_t eb = st + L.dy, ub = st + L.u;
    fence_dw();
    hp::fence_operands(acc);
    hp::wgmma_fence();
    // dW += e^T u: e's box mb as the MN-major A, u's box nb as the MN-major
    // B, 4 k-steps of 16 rows. (With an odd block count the second
    // warpgroup repeats the last block and does not write it.)
#pragma unroll
    for (int k = 0; k < kNBW; ++k) {
      const int blk = min(wg + 2 * k, n_blk - 1);
      const uint32_t ea = eb + (blk / nx) * kBox;
      const uint32_t ua = ub + (blk % nx) * kBox;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hp::wgmma_ss_m64n64k16_t<1, 1>(dw[k], mnmajor(ea + ks * 2048, kBox),
                                       mnmajor(ua + ks * 2048, kBox), 1);
    }
    if (kDx)
      issue_dx(eb, min(wg, nx - 1));
    else
      hp::wgmma_commit();
    hp::wgmma_wait<0>();
    fence_dw();
    hp::fence_operands(acc);
    if (kDx) {
      for (int k = 0; k < (nx + 1) / 2; ++k) {
        const int c = min(wg + 2 * k, nx - 1);
        if (k > 0) {
          hp::wgmma_fence();
          issue_dx(eb, c);
          hp::wgmma_wait<0>();
          hp::fence_operands(acc);
        }
        if (wg + 2 * k < nx) epilogue(stp, row0, c);
        hp::fence_operands(acc);
      }
    }
    release(done, i, S, run.count, lane, load);
    // With one box of dx (Cin = 64) the first warpgroup alone runs its
    // epilogue, so the second forms the next tile meanwhile.
    if (i + 1 < run.count) {
      if (!kDx || nx > 1)
        form(i + 1, tid, kThreads);
      else if (wg == 1)
        form(i + 1, wtid, 128);
    }
    __syncthreads();   // tile i + 1 formed
  }

  // dW: this warpgroup's blocks of the CTA's partial. Element i of block
  // (mb, nb): row co0 + 64 mb + w4 * 16 + g + 8 * ((i >> 1) & 1), column
  // ci0 + 64 nb + 8 * (i >> 2) + 2 * t4 + (i & 1).
#pragma unroll
  for (int k = 0; k < kNBW; ++k) {
    const int blk = wg + 2 * k;
    if (blk >= n_blk) continue;
    float* out = p.part_w +
                 (static_cast<long long>(part) * p.cout + co0 +
                  blk / nx * 64 + w4 * 16 + g) * p.cin +
                 ci0 + blk % nx * 64 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(out + 8 * hf * p.cin + 8 * j) =
            make_float2(dw[k][4 * j + 2 * hf], dw[k][4 * j + 2 * hf + 1]);
  }
  if constexpr (kDx) {
    if (kPro) {
      __syncthreads();
      for (int c = tid; c < 2 * p.cin; c += kThreads) {
        const int sidx = c / p.cin, col = c % p.cin;
        float t = 0.f;
        for (int w = 0; w < 4; ++w) t += dab_s[(w * 2 + sidx) * p.cin + col];
        p.part_ab[(static_cast<long long>(sidx) * p.n_parts + part) * p.cin +
                  col] = t;
      }
    }
    if (wtid == 0) hp::bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// K2, row-parallel dx where the one pass does not fit: du = e W over all
// of Cout for a 64*kNch-column slice of Cin, 128-row tiles.
// ---------------------------------------------------------------------------

// Shared memory of conv_bn_bwd_dx_kernel (host and device): the ring (a
// stage is y's and dy's [128, 64] boxes and W's [64, 64 kNch] boxes),
// the output boxes, a and b of the slice, ds1 and ds2, the mbarriers.
struct DxSmem {
  uint32_t y, dy, w, stage, out, ab, ds, bars, total;
  __host__ __device__ DxSmem(int nch, int cout, bool pro, int stages) {
    y = 0;
    dy = 2 * kBox;
    w = 4 * kBox;
    stage = w + nch * kBox;
    uint32_t o = stage * stages;
    out = o;
    o += 2 * kBox;
    ab = o;
    if (pro) o += 8 * 64 * nch;
    ds = o;
    o += 8 * cout;
    bars = o;
    o += 16 * stages;
    total = o + 1024;
  }
};

struct DxArgs {
  const bf16* x;
  const float* a;
  const float* b;
  const float* ds1;
  const float* ds2;
  float* part_ab;       // [2, n_runs, Cin] (prologue)
  int M, cin, cout, n_slices, n_runs, stages, relu;
};

template <int kNch, bool kPro>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_bwd_dx_kernel(const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap dxmap,
                      const DxArgs p) {
  constexpr int kBN = 64 * kNch;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const DxSmem L(kNch, p.cout, kPro, p.stages);
  const int S = p.stages;
  const int ci0 = blockIdx.x % p.n_slices * kBN;
  const int part = blockIdx.x / p.n_slices;
  const Run run = tile_run((p.M + 127) / 128, part, p.n_runs);
  const int n_kc = p.cout / 64;
  const int n_it = run.count * n_kc;
  const uint32_t full = base + L.bars;
  const uint32_t done = full + 8 * S;

  auto load = [&](int i) {
    const uint32_t bar = full + 8 * (i % S);
    const uint32_t st = base + (i % S) * L.stage;
    const int kc = i % n_kc, row = (run.first + i / n_kc) * 128;
    hp::mbar_expect_tx(bar, L.stage);
    hp::tma_load_2d(st + L.y, &ymap, bar, kc * 64, row);
    hp::tma_load_2d(st + L.dy, &dymap, bar, kc * 64, row);
    for (int n = 0; n < kNch; ++n)
      hp::tma_load_2d(st + L.w + n * kBox, &wmap, bar, ci0 + 64 * n,
                      kc * 64);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      reinterpret_cast<uint32_t*>(smem + L.bars + 8 * S)[s] = 0;
    }
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&ymap);
    hp::tma_prefetch_map(&dymap);
    hp::tma_prefetch_map(&wmap);
    hp::tma_prefetch_map(&dxmap);
    for (int i = 0; i < min(S, n_it); ++i) load(i);
  }
  float* ab_s = reinterpret_cast<float*>(smem + L.ab);   // a, b [kBN]
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);   // ds1, ds2 [Cout]
  if (kPro)
    for (int c = tid; c < kBN; c += kThreads) {
      ab_s[c] = p.a[ci0 + c];
      ab_s[kBN + c] = p.b[ci0 + c];
    }
  for (int c = tid; c < p.cout; c += kThreads) {
    ds_s[c] = p.ds1 ? p.ds1[c] : 0.f;
    ds_s[p.cout + c] = p.ds2 ? p.ds2[c] : 0.f;
  }
  __syncthreads();

  const int wg = warpgroup();
  const int wtid = tid & 127, w4 = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[kNch][32];
  float sums[kNch][4];   // da of columns 8g + 2 t4 + {0, 1}, then db
#pragma unroll
  for (int n = 0; n < kNch; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sums[n][i] = 0.f;
  auto fence_acc = [&]() {
#pragma unroll
    for (int n = 0; n < kNch; ++n) hp::fence_operands(acc[n]);
  };
  auto rel = [&](int i) { release(done, i, S, n_it, lane, load); };

  // dx of this warpgroup's 64 rows, box by box (x from global memory),
  // its da/db into the lane's sums.
  auto epilogue = [&](int row0) {
    const int rw = row0 + 64 * wg;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
      const OutBox ob = out_open(smem, base, L.out, wg, wtid);
      float da[16], db[16];
      dx_box<kPro>(
          acc[n], ob.ptr,
          [&](int r, int cl) {
            return rw + r < p.M
                ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                      p.x + static_cast<long long>(rw + r) * p.cin + ci0 +
                      64 * n + cl))
                : make_float2(0.f, 0.f);
          },
          ab_s + 64 * n, ab_s + kBN + 64 * n, p.relu != 0, w4, g, t4, da, db);
      out_close(ob, &dxmap, ci0 + 64 * n, rw, wg, wtid);
      if (kPro) {
        sum_rows(da, g);
        sum_rows(db, g);
        sums[n][0] += da[0];
        sums[n][1] += da[1];
        sums[n][2] += db[0];
        sums[n][3] += db[1];
      }
    }
  };

  int pending = -1;
  for (int i = 0; i < n_it; ++i) {
    const int s = i % S, kc = i % n_kc;
    const uint32_t st = base + s * L.stage;
    uint8_t* stp = smem + s * L.stage;
    const int row0 = (run.first + i / n_kc) * 128;
    hp::mbar_wait(full + 8 * s, static_cast<uint32_t>(i / S) & 1);
    // e in place of dy over this warpgroup's 64 rows; zero past M.
    for (int q = wtid; q < 512; q += 128) {
      const int r = wg * 64 + (q >> 3), pos = q & 7;
      const uint32_t off = r * 128 + pos * 16;
      const int col = kc * 64 + ((pos ^ (r & 7)) << 3);
      at16(stp, L.dy + off) = row0 + r < p.M
          ? cotangent8(at16(stp, L.dy + off), at16(stp, L.y + off),
                       ds_s + col, ds_s + p.cout + col)
          : make_uint4(0u, 0u, 0u, 0u);
    }
    hp::fence_proxy_async();
    hp::named_barrier(1 + wg, 128);
    fence_acc();
    hp::wgmma_fence();
#pragma unroll
    for (int n = 0; n < kNch; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss_m64n64k16_t<0, 1>(
            acc[n], kmajor(st + L.dy + wg * 64 * 128 + kk * 32),
            mnmajor(st + L.w + n * kBox + kk * 2048, kBox),
            kc > 0 || kk > 0);
    hp::wgmma_commit();
    if (kc + 1 < n_kc) {
      hp::wgmma_wait<1>();
      fence_acc();
      if (pending >= 0) rel(pending);
      pending = i;
    } else {
      hp::wgmma_wait<0>();
      fence_acc();
      if (pending >= 0) rel(pending);
      rel(i);
      pending = -1;
      epilogue(row0);
    }
  }

  if (kPro) {
    // The CTA's da/db partial: the 8 warps' sums added in order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);   // [8 warps][2][kBN]
    const int gw = tid >> 5;
#pragma unroll
    for (int n = 0; n < kNch; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 64 * n + 8 * g + 2 * t4 + q;
        red[(gw * 2 + 0) * kBN + col] = sums[n][q];
        red[(gw * 2 + 1) * kBN + col] = sums[n][2 + q];
      }
    __syncthreads();
    for (int c = tid; c < 2 * kBN; c += kThreads) {
      const int sidx = c / kBN, col = c % kBN;
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += red[(w * 2 + sidx) * kBN + col];
      p.part_ab[(static_cast<long long>(sidx) * p.n_runs + part) * p.cin +
                ci0 + col] = t;
    }
  }
  if (wtid == 0) hp::bulk_wait<0>();
}

// bf16(W), row-major [Cout, Cin], for the boxes that stream through a ring.
__global__ void __launch_bounds__(256)
conv_bn_w_round_kernel(const float* __restrict__ w, bf16* __restrict__ out,
                       int n4) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    const float4 f = reinterpret_cast<const float4*>(w)[i];
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
  }
}

// out[s][c] = sum over t of in[s][t][c], t in a fixed order: 8 row groups
// each add every 8th partial in order, 4 columns a thread, then one thread
// adds the 8 group sums in order. Deterministic whatever the scheduling.
__global__ void __launch_bounds__(256)
conv_bn_col_sum_kernel(const float4* __restrict__ in,
                       float4* __restrict__ out, int T, long long C4) {
  __shared__ float4 sm[8][33];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + cx;
  const float4* src = in + static_cast<long long>(blockIdx.y) * T * C4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < C4)
    for (int t = ry; t < T; t += 8) {
      const float4 v = src[static_cast<long long>(t) * C4 + col];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  sm[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && col < C4) {
    float4 tot = sm[0][cx];
#pragma unroll
    for (int r = 1; r < 8; ++r) {
      tot.x += sm[r][cx].x;
      tot.y += sm[r][cx].y;
      tot.z += sm[r][cx].z;
      tot.w += sm[r][cx].w;
    }
    out[static_cast<long long>(blockIdx.y) * C4 + col] = tot;
  }
}

// -- host ---------------------------------------------------------------------

// C a multiple of 4 (of 64 here).
int launch_col_sum(const float* in, float* out, int n_arrays, int T,
                   long long C, cudaStream_t st) {
  const long long c4 = C / 4;
  const dim3 grid(static_cast<unsigned>((c4 + 31) / 32), n_arrays);
  conv_bn_col_sum_kernel<<<grid, 256, 0, st>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), T,
      c4);
  return static_cast<int>(cudaGetLastError());
}

int launch_w_round(const void* w, void* out, int cout, int cin,
                   cudaStream_t st) {
  const int n4 = cout * cin / 4;
  conv_bn_w_round_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<bf16*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// The deepest ring (<= kMaxStages) whose layout fits; 0 if not even two.
template <class Layout>
int fit_stages(Layout layout) {
  for (int s = kMaxStages; s >= 2; --s)
    if (layout(s).total <= kSmemLimit) return s;
  return 0;
}

// A kernel of a family by its first template argument (1, 2, 3, 4).
template <class K>
K pick(int n, K k1, K k2, K k3, K k4) {
  return n == 1 ? k1 : n == 2 ? k2 : n == 3 ? k3 : n == 4 ? k4 : nullptr;
}

using FwdKernel = decltype(&conv_bn_fwd_kernel<1, false, false>);
using BwdKernel = decltype(&conv_bn_bwd_kernel<1, false, false>);
using DxKernel = decltype(&conv_bn_bwd_dx_kernel<1, false>);

template <bool kS, bool kP>
FwdKernel fwd_of(int np) {
  return pick<FwdKernel>(np, conv_bn_fwd_kernel<1, kS, kP>,
                         conv_bn_fwd_kernel<2, kS, kP>, nullptr,
                         conv_bn_fwd_kernel<4, kS, kP>);
}

FwdKernel fwd_kernel(int np, bool stream, bool pro) {
  return stream ? (pro ? fwd_of<true, true>(np) : fwd_of<true, false>(np))
                : (pro ? fwd_of<false, true>(np) : fwd_of<false, false>(np));
}

template <bool kDx, bool kP>
BwdKernel bwd_of(int nbw) {
  return pick<BwdKernel>(nbw, conv_bn_bwd_kernel<1, kDx, kP>,
                         conv_bn_bwd_kernel<2, kDx, kP>,
                         conv_bn_bwd_kernel<3, kDx, kP>,
                         conv_bn_bwd_kernel<4, kDx, kP>);
}

BwdKernel bwd_kernel(int nbw, bool dx, bool pro) {
  return dx ? (pro ? bwd_of<true, true>(nbw) : bwd_of<true, false>(nbw))
            : (pro ? bwd_of<false, true>(nbw) : bwd_of<false, false>(nbw));
}

DxKernel dx_kernel(int nch, bool pro) {
  return pro ? pick<DxKernel>(nch, conv_bn_bwd_dx_kernel<1, true>,
                              conv_bn_bwd_dx_kernel<2, true>, nullptr,
                              conv_bn_bwd_dx_kernel<4, true>)
             : pick<DxKernel>(nch, conv_bn_bwd_dx_kernel<1, false>,
                              conv_bn_bwd_dx_kernel<2, false>, nullptr,
                              conv_bn_bwd_dx_kernel<4, false>);
}

// Launches `kernel` on `grid` CTAs with `smem` bytes after raising its
// limit; returns the launch's cudaError_t.
template <class K, class... Args>
int launch(K kernel, int grid, uint32_t smem, cudaStream_t st,
           Args... args) {
  if (kernel == nullptr || smem == 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      hp::allow_smem(reinterpret_cast<const void*>(kernel), kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, Cin] bf16; w: [Cout, Cin] f32; a, b: [Cin] f32 (read only with
// prologue); y: [M, Cout] bf16; stats: [2, Cout] f32 (s1, s2). Plan (the
// wrapper's fwd_plan): Cout slices of `bn` columns (64, 128 or 256) times
// `n_runs` row runs, one CTA each; scratch part: [2, n_runs, Cout] f32;
// w_bf16: null (W's slice resident in each CTA) or a [Cout, Cin] bf16
// scratch (W streamed through the ring). All contiguous and 16-byte
// aligned; Cin, Cout multiples of 64. Returns the first cudaError_t.
extern "C" int hvd_conv_bn_fwd(const void* x, const void* w, const void* a,
                               const void* b, void* y, void* part,
                               void* stats, void* w_bf16, int M, int Cin,
                               int Cout, int prologue, int relu, int bn,
                               int n_runs, void* stream) {
  if (M <= 0 || Cin <= 0 || Cout <= 0 || Cin % 64 || Cout % 64 ||
      (bn != 64 && bn != 128 && bn != 256) || Cout % bn || n_runs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool stream_w = w_bf16 != nullptr;
  const bool pro = prologue != 0;
  const int np = bn / 64;
  CUtensorMap xm, wm, ym;
  if (!hp::get_map_2d(enc, &xm, x, M, Cin, 128) ||
      !hp::get_map_2d(enc, &ym, y, M, Cout, 64) ||
      (stream_w && !hp::get_map_2d(enc, &wm, w_bf16, Cout, Cin, bn)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stream_w) wm = xm;   // unused
  int err = 0;
  if (stream_w && (err = launch_w_round(w, w_bf16, Cout, Cin, st)))
    return err;
  const int stages = fit_stages(
      [&](int s) { return FwdSmem(np, Cin, stream_w, pro, s); });
  const uint32_t smem =
      stages ? FwdSmem(np, Cin, stream_w, pro, stages).total : 0;
  const FwdArgs args{static_cast<const float*>(w),
                     static_cast<const float*>(a),
                     static_cast<const float*>(b), static_cast<float*>(part),
                     M, Cin, Cout, Cout / bn, n_runs, stages, relu};
  err = launch(fwd_kernel(np, stream_w, pro), Cout / bn * n_runs, smem, st,
               xm, wm, ym, args);
  if (err) return err;
  return launch_col_sum(static_cast<float*>(part), static_cast<float*>(stats),
                        2, n_runs, Cout, st);
}

// x, y, dy as in the forward; w, a, b likewise; ds1, ds2: [Cout] f32 or
// null (zero). Outputs: dx [M, Cin] bf16, dw [Cout, Cin] f32, dab [2, Cin]
// f32 (da, db; written only with prologue). plan (the wrapper's
// bwd_plan), 6 ints:
//   [0] 1: one pass (conv_bn_bwd_kernel with dx), 0: dx kernel + windows;
//   [1] n_parts: the one pass's CTAs, or each window's row splits;
//   [2] bco, [3] bci: the dW window (Cout, Cin in the one pass);
//   [4] n_runs: the dx kernel's row runs, [5] nch: its slices' 64-column
//       boxes (Cin / (64 nch) slices).
// Scratch: part_w [n_parts, Cout, Cin] f32; part_ab [2, P, Cin] f32 with P
// = n_parts (one pass) or n_runs (prologue only); w_bf16 [Cout, Cin] bf16
// (dx kernel only). Returns the first cudaError_t.
extern "C" int hvd_conv_bn_bwd(const void* x, const void* y, const void* dy,
                               const void* w, const void* a, const void* b,
                               const void* ds1, const void* ds2, void* dx,
                               void* dw, void* dab, void* part_ab,
                               void* part_w, void* w_bf16, int M, int Cin,
                               int Cout, int prologue, int relu,
                               const int* plan, void* stream) {
  const int one_pass = plan[0], n_parts = plan[1], bco = plan[2],
            bci = plan[3], n_runs = plan[4], nch = plan[5];
  if (M <= 0 || Cin <= 0 || Cout <= 0 || Cin % 64 || Cout % 64 ||
      n_parts <= 0 || bco <= 0 || bci <= 0 || bco % 64 || bci % 64 ||
      Cout % bco || Cin % bci || (bco / 64) * (bci / 64) > 8 ||
      (one_pass && (bco != Cout || bci != Cin)) ||
      (!one_pass && (n_runs <= 0 || nch <= 0 || Cin % (64 * nch) ||
                     w_bf16 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pro = prologue != 0;
  const auto* s1 = static_cast<const float*>(ds1);
  const auto* s2 = static_cast<const float*>(ds2);
  const int nbw = ((bco / 64) * (bci / 64) + 1) / 2;
  CUtensorMap xm, ym, dym, dxm;
  if (!hp::get_map_2d(enc, &xm, x, M, Cin, 64) ||
      !hp::get_map_2d(enc, &ym, y, M, Cout, 64) ||
      !hp::get_map_2d(enc, &dym, dy, M, Cout, 64) ||
      !hp::get_map_2d(enc, &dxm, dx, M, Cin, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (!one_pass) {
    // dx: row-parallel over all of Cout, W's boxes streamed.
    CUtensorMap ym2, dym2, wm;
    if (!hp::get_map_2d(enc, &ym2, y, M, Cout, 128) ||
        !hp::get_map_2d(enc, &dym2, dy, M, Cout, 128) ||
        !hp::get_map_2d(enc, &wm, w_bf16, Cout, Cin, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    if ((err = launch_w_round(w, w_bf16, Cout, Cin, st))) return err;
    const int stages =
        fit_stages([&](int s) { return DxSmem(nch, Cout, pro, s); });
    const uint32_t smem = stages ? DxSmem(nch, Cout, pro, stages).total : 0;
    const int n_slices = Cin / (64 * nch);
    const DxArgs args{static_cast<const bf16*>(x),
                      static_cast<const float*>(a),
                      static_cast<const float*>(b), s1, s2,
                      static_cast<float*>(part_ab), M, Cin, Cout, n_slices,
                      n_runs, stages, relu};
    err = launch(dx_kernel(nch, pro), n_slices * n_runs, smem, st, ym2, dym2,
                 wm, dxm, args);
    if (err) return err;
  }
  const bool with_dx = one_pass != 0;
  const int stages = fit_stages([&](int s) {
    return BwdSmem(Cin, Cout, bci, bco, with_dx, pro, s);
  });
  const uint32_t smem =
      stages ? BwdSmem(Cin, Cout, bci, bco, with_dx, pro, stages).total : 0;
  const int n_windows = (Cout / bco) * (Cin / bci);
  const BwdArgs args{static_cast<const float*>(w),
                     static_cast<const float*>(a),
                     static_cast<const float*>(b), s1, s2,
                     static_cast<float*>(part_w), static_cast<float*>(part_ab),
                     M, Cin, Cout, bci, bco, n_windows, n_parts, stages, relu};
  err = launch(bwd_kernel(nbw, with_dx, pro), n_windows * n_parts, smem, st,
               xm, ym, dym, dxm, args);
  if (err) return err;
  if (pro) {
    err = launch_col_sum(static_cast<float*>(part_ab),
                         static_cast<float*>(dab), 2,
                         one_pass ? n_parts : n_runs, Cin, st);
    if (err) return err;
  }
  return launch_col_sum(static_cast<float*>(part_w), static_cast<float*>(dw),
                        1, n_parts, static_cast<long long>(Cout) * Cin, st);
}
