// Causal flash-attention forward for Hopper (sm_90a): bf16 q/k/v with
// d_head 128 in, bf16 out, and optionally the row log2-sum-exp2.
//
// Replaces: horovod_tpu/ops/pallas_attention.py::_attn_kernel as launched
// by _fwd_pallas (:462; without lse -- the TPU kernel every prefill layer
// of the paged generation engine runs, K3-fwd -- and with lse on a
// prescaled q, the pipelined LM's forward) and by _fwd_pallas_qkv (:619,
// the packed-qkv forward of LM training, K3-qkv), whose lse2 the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.
//
// Computes, per (batch, head), o = softmax(q k^T * sm_scale) v with the
// JAX kernel's rounding points: q is multiplied by `qscale` (sm_scale *
// log2(e), or 1 for a prescaled q) in f32 and rounded back to bf16;
// scores are bf16 products accumulated in f32 and exponentiated with
// exp2; P is rounded to bf16 before P.V, the row sum is taken over the f32
// P; the accumulator and the softmax statistics are f32; masked scores
// are -1e30; a row whose sum is 0 divides by 1 (comes out 0). With a
// non-null `lse` it also writes lse2 = m + log2(l) per row (-1e30 where
// l = 0) as one f32 per row of an [B*H, T] array (the TPU kernel's
// [BH, T, 8] lane-replicated wire format is a Mosaic layout, not carried
// over).
//
// Bound: causal work is 4*d*H*B*T(T+1)/2 flops against 4*B*T*H*d*2
// bytes, about T/2 flops per byte: tensor-core bound above T ~ 600. At
// the main paths' shapes (H=16, d=128, T=2048, 989 TFLOP/s):
// 0.139 ms at B=8 (K3-qkv), 0.0695 ms at B=4 (the pipelined step's lse
// forward), 0.0174 ms at B=1 (a prefill).
//
// Design (one CTA of two warpgroups per 128-row q tile and batch*head,
// one CTA per SM):
// - Tensor cores through wgmma, the only path to the card's full rate:
//   S = Q K^T is m64n128k16 with both operands in shared memory; O += P V
//   takes P from registers (the f32 S accumulator, rounded to bf16 pairs,
//   is the A fragment of the next product, so P never touches shared
//   memory) and V from shared memory in MN-major order (transpose bit).
//   Each warpgroup owns 64 q rows and keeps its 64x128 f32 output
//   accumulator and online-softmax state in registers.
// - A TMA ring: Q (32 KB) is loaded once; K and V tiles of 128 keys (32 KB
//   each) come through 3 stages, each with a full mbarrier for K and one
//   for V. The last warp done with a stage refills it with the tile three
//   ahead, so loads run two tiles ahead of the products. In place of an
//   empty mbarrier, each warp counts itself done on a per-stage word with
//   an acquire-release atomic (after its wgmma_wait and a __syncwarp), so
//   every warp's completed reads of the stage are ordered before the
//   refill TMA that the eighth issues. 128-byte swizzle
//   makes the wgmma reads conflict-free; a 256-byte row of d=128 arrives
//   as two 64-column boxes.
// - Softmax off the critical path: a warpgroup issues S of tile n and P.V
//   of tile n - 1 together and runs tile n's mask and exp2 (about half the
//   cycles of the two products) while P.V is still on the tensor cores;
//   and the two warpgroups take turns to issue (FlashAttention-3's
//   ping-pong), so one's softmax runs under the other's products.
// - No producer warp: ptxas gives every thread of a CTA the same
//   registers (setmaxnreg does not change its allocation; measured), so a
//   third warpgroup would cap the consumers at 168 registers, and S, P and
//   O of a 128-key tile in flight together need about 190.
// - Strided operands through the tensor maps: one 4-D map (d, h, t, b)
//   per operand with the caller's strides, so slices of the packed
//   [B,T,H,3,d] projection are read without copies. TMA zero-fills rows
//   past T (0 * garbage would be NaN); only tiles that cross the diagonal
//   or T are masked. Tiles above the diagonal are never loaded.
// - Heaviest q tiles first (the block order in the kernel). The output
//   goes through shared memory (Q's own rows, free after the last S) so
//   that each row is written to o [B,T,H,d] as 16-byte coalesced stores.
// - Deterministic: every sum in a fixed order (atomics only count the
//   warps done with a stage). The output is acc / l rounded as the plain
//   version's division rounds: acc * (1/l) and one fma correction
//   (Markstein), since 64 divisions a thread in an epilogue that runs
//   with the tensor cores idle slowed the kernel measurably.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using hvd_flash::kD;
using hvd_flash::pack_bf16;
using hvd_flash::scale_bf16x8;
using hvd_flash::store_tile;
using hvd_flash::Tile;
using hvd_flash::tile_of;
using hvd_flash::View;
namespace hp = hvd_hopper;

constexpr int kBQ = 128;       // q rows per CTA (64 per warpgroup)
constexpr int kBK = 128;       // keys per K/V tile
constexpr int kStages = 3;     // K/V ring depth (230 KB of shared memory)
constexpr int kThreads = 256;  // two warpgroups
static_assert(kBK == 128, "S is one m64n128 accumulator per warpgroup");
constexpr int kSN = kBK / 2;   // S accumulator registers a thread
constexpr int kPV = kBK / 16;  // k-steps of P.V
// Each tile is two 64-column boxes (halves) of its rows.
constexpr uint32_t kQHalf = kBQ * 64 * 2;
constexpr uint32_t kQBytes = 2 * kQHalf;
constexpr uint32_t kKVHalf = kBK * 64 * 2;
constexpr uint32_t kKVBytes = 2 * kKVHalf;          // one K or V tile
constexpr uint32_t kQOff = 0;
constexpr uint32_t kKOff = kQBytes;                 // stage s: + s * K+V
constexpr uint32_t kBarOff = kQBytes + 2 * kKVBytes * kStages;
// mbarriers q_full, k_full[kStages], v_full[kStages], then one u32 count
// of warps done with each stage.
constexpr uint32_t kBars = 1 + 2 * kStages;
constexpr uint32_t kCountOff = kBarOff + 8 * kBars;
// + 1024: the dynamic shared memory base is aligned up to 1024 bytes.
constexpr uint32_t kSmemBytes = kCountOff + 4 * kStages + 1024;

// K and V of tile kt into ring stage kt % kStages (one thread).
__device__ __forceinline__ void load_kv(const CUtensorMap& kmap,
                                        const CUtensorMap& vmap,
                                        uint32_t base, int kt, int h, int b) {
  const int s = kt % kStages;
  const uint32_t k_full = base + kBarOff + 8 * (1 + s);
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t kdst = base + kKOff + s * 2 * kKVBytes;
  const uint32_t vdst = kdst + kKVBytes;
  const int k0 = kt * kBK;
  hp::mbar_expect_tx(k_full, kKVBytes);
  hp::tma_load_4d(kdst, &kmap, k_full, 0, h, k0, b);
  hp::tma_load_4d(kdst + kKVHalf, &kmap, k_full, 64, h, k0, b);
  hp::mbar_expect_tx(v_full, kKVBytes);
  hp::tma_load_4d(vdst, &vmap, v_full, 0, h, k0, b);
  hp::tma_load_4d(vdst + kKVHalf, &vmap, v_full, 64, h, k0, b);
}

// Warpgroup `wg` (0 or 1) of the CTA: q rows q0 + 64 * wg .. + 63.
template <bool kLse>
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t base,
                                        const CUtensorMap& kmap,
                                        const CUtensorMap& vmap,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int T, int H,
                                        int b, int h, int q0, int n_kt,
                                        float qscale, int causal) {
  const int tid = threadIdx.x;
  const uint32_t q_full = base + kBarOff;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t done = base + kCountOff;   // u32 count per stage
  const int wg = tid >> 7;                  // 0 or 1: q rows 64*wg..
  const int wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // row group / thread in group
  const int r0 = q0 + wg * 64 + warp * 16 + g;   // rows r0, r0 + 8
  const uint32_t qrows = base + kQOff + wg * 64 * 128;   // this wg's rows

  hp::mbar_wait(q_full, 0);
  if (qscale != 1.f) {
    // q * qscale in f32, rounded to bf16, in place (elementwise, so the
    // swizzle does not matter); then visible to wgmma's async proxy.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * 128 + wtid;          // 16-byte chunk of 1024
      uint4* p = reinterpret_cast<uint4*>(
          smem + kQOff + wg * 64 * 128 + (c >> 9) * kQHalf + (c & 511) * 16);
      *p = scale_bf16x8(*p, qscale);
    }
    hp::fence_proxy_async();
    hp::named_barrier(1 + wg, 128);
  }

  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  float acc[64];
  uint32_t pa[kPV][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int row_lo = q0 + wg * 64;           // this warpgroup's first row
  auto k_tile = [&](int kt) {
    return base + kKOff + (kt % kStages) * 2 * kKVBytes;
  };

  // S = Q K^T for tile kt (log2 domain; q already scaled): 8 k-steps of
  // 16 over d, both operands K-major; the first overwrites sc, so every
  // tile's S starts in fresh registers. Issued, not waited for.
  auto issue_s = [&](float (&sc)[kSN], int kt) {
    const uint32_t kbase = k_tile(kt);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      hp::wgmma_ss_m64n128k16(
          sc, hp::desc_sw128(qrows + (ks >> 2) * kQHalf + col, 16, 1024),
          hp::desc_sw128(kbase + (ks >> 2) * kKVHalf + col, 16, 1024),
          ks > 0);
    }
    hp::wgmma_commit();
  };
  // O += P V for tile kt: V is MN-major (keys down, d contiguous), LBO
  // steps the 64-column halves, each k-step advances 16 key rows (2048
  // bytes). Issued, not waited for.
  auto issue_pv = [&](int kt) {
    const uint32_t vbase = k_tile(kt) + kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk)
      hp::wgmma_rs_m64n128k16_tb(
          acc, pa[kk], hp::desc_sw128(vbase + kk * 2048, kKVHalf, 1024));
    hp::wgmma_commit();
  };
  // Mask, online softmax on the finished S of tile kt: sc becomes the f32
  // P, m the new row max; returns the rescale factors and P's row sums.
  auto softmax = [&](float (&sc)[kSN], int kt, float (&alpha)[2],
                     float (&rs)[2]) {
    const int k0 = kt * kBK;
    // Causal / ragged mask, only on tiles that cross it. Element i of
    // the accumulator: row r0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2)
    // + 2 * t4 + (i & 1).
    if (k0 + kBK > T || (causal && k0 + kBK - 1 > row_lo)) {
#pragma unroll
      for (int i = 0; i < kSN; ++i) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (col >= T || (causal && col > row)) sc[i] = -1e30f;
      }
    }
    // Row max over the quad, exp2, rescale factors.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < kSN / 4; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hf] = hp::exp2_ftz(m[hf] - mx);
      m[hf] = mx;
    }
    rs[0] = rs[1] = 0.f;
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      const int hf = (i >> 1) & 1;
      const float p = hp::exp2_ftz(sc[i] - m[hf]);
      sc[i] = p;
      rs[hf] += p;
    }
  };
  // P (bf16) as the A fragments of the 8 k-steps of 16 keys.
  auto pack_p = [&](const float (&sc)[kSN]) {
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // This warp's reads of tile kt's stage are done. The last of the 8
  // warps to get there refills the stage with tile kt + kStages.
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0 &&
        hp::atomic_add_acq_rel(done + 4 * (kt % kStages), 1u) % 8 == 7 &&
        kt + kStages < n_kt)
      load_kv(kmap, vmap, base, kt + kStages, h, b);
  };
  auto phase = [](int kt) { return static_cast<uint32_t>(kt / kStages) & 1; };

  // Turns: named barrier 3 + wg opens this warpgroup's; warpgroup 0 goes
  // first, and each hands the turn over once its products are issued (the
  // last hand-over of warpgroup 1 would have no taker).
  auto my_turn = [&]() { hp::named_barrier(3 + wg, 256); };
  auto your_turn = [&](bool last) {
    if (!(last && wg == 1)) hp::named_arrive(4 - wg, 256);
  };
  if (wg == 1) hp::named_arrive(3, 256);

  // Tile 0: S, softmax, P.
  float alpha[2], rs[2];
  {
    float sc[kSN];
    hp::mbar_wait(k_full, 0);
    my_turn();
    hp::wgmma_fence();
    issue_s(sc, 0);
    your_turn(false);
    hp::wgmma_wait<0>();
    hp::fence_operands(sc);
    softmax(sc, 0, alpha, rs);
    l[0] = rs[0];
    l[1] = rs[1];
    pack_p(sc);
  }

  // Tile kt: S of kt and P.V of kt - 1 in flight together; the softmax of
  // kt runs while P.V is still on the tensor cores. O is rescaled by
  // tile kt's factors after P.V of kt - 1 has landed, so the sums are
  // those of the plain loop, in the same order.
  for (int kt = 1; kt < n_kt; ++kt) {
    float sc[kSN];
    hp::mbar_wait(k_full + 8 * (kt % kStages), phase(kt));
    hp::mbar_wait(v_full + 8 * ((kt - 1) % kStages), phase(kt - 1));
    hp::fence_operands(acc);
    my_turn();
    hp::wgmma_fence();
    issue_s(sc, kt);
    issue_pv(kt - 1);
    your_turn(false);
    hp::wgmma_wait<1>();
    hp::fence_operands(sc);
    softmax(sc, kt, alpha, rs);
    hp::wgmma_wait<0>();
    hp::fence_operands(acc);
    release(kt - 1);
    l[0] = l[0] * alpha[0] + rs[0];   // per-lane partial row sums; the
    l[1] = l[1] * alpha[1] + rs[1];   // quad is summed once at the end
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_p(sc);
  }
  hp::mbar_wait(v_full + 8 * ((n_kt - 1) % kStages), phase(n_kt - 1));
  hp::fence_operands(acc);
  my_turn();
  hp::wgmma_fence();
  issue_pv(n_kt - 1);
  your_turn(true);
  hp::wgmma_wait<0>();
  hp::fence_operands(acc);
  release(n_kt - 1);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  float safe[2], inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + hf * 8;
    safe[hf] = (l[hf] == 0.f) ? 1.f : l[hf];
    inv[hf] = 1.f / safe[hf];
    if (kLse && t4 == 0 && row < T)   // log2 domain, for the backward
      lse[(static_cast<long long>(b) * H + h) * T + row] =
          (l[hf] == 0.f) ? -1e30f : m[hf] + log2f(safe[hf]);
  }

  // acc / l: with inv the correctly rounded 1/l, the quotient a * inv
  // corrected by one fma with its exact residual is the correctly rounded
  // a / l (Markstein's theorem; away from the subnormal range).
  auto div_l = [&](float a, int hf) {
    const float q = a * inv[hf];
    return fmaf(fmaf(-q, safe[hf], a), inv[hf], q);
  };
  // o through this warpgroup's Q rows (its last S has completed).
  store_tile(smem + kQOff + wg * 64 * 128, kQHalf, acc, div_l,
             View{o, static_cast<long long>(T) * H * kD, H * kD, kD}, b, h,
             row_lo, T, 1 + wg);
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int T, int H, int group,
                       float qscale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int n_qt = (T + kBQ - 1) / kBQ;
  // Heaviest (last) q tiles first, in groups of `group` heads (tile_of).
  const Tile tl = tile_of(n_qt, H, group, true);
  const int b = tl.b, h = tl.h, q0 = tl.t * kBQ;
  const int n_kt_all = (T + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, T) - 1;
  const int n_kt = causal ? min(n_kt_all, last_row / kBK + 1) : n_kt_all;

  uint8_t* smem = smem_raw + (base - raw);
  if (threadIdx.x == 0) {
    // Barriers, then Q and the first kStages K/V tiles.
    const uint32_t q_full = base + kBarOff;
#pragma unroll
    for (int i = 0; i < static_cast<int>(kBars); ++i)
      hp::mbar_init(q_full + 8 * i, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      reinterpret_cast<uint32_t*>(smem + kCountOff)[s] = 0;
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&qmap);
    hp::tma_prefetch_map(&kmap);
    hp::tma_prefetch_map(&vmap);
    hp::mbar_expect_tx(q_full, kQBytes);
    hp::tma_load_4d(base + kQOff, &qmap, q_full, 0, h, q0, b);
    hp::tma_load_4d(base + kQOff + kQHalf, &qmap, q_full, 64, h, q0, b);
    for (int kt = 0; kt < min(kStages, n_kt); ++kt)
      load_kv(kmap, vmap, base, kt, h, b);
  }
  __syncthreads();
  consume<kLse>(smem, base, kmap, vmap, o, lse, T, H, b, h, q0, n_kt,
                qscale, causal);
}

}  // namespace

// q/k/v: [B, T, H, D] bf16 views with unit stride on D, 16-byte aligned,
// other strides (in elements) multiples of 8; o: contiguous [B, T, H, D]
// bf16; lse: null, or contiguous [B*H, T] f32. Returns a cudaError_t.
extern "C" int hvd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int T, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, float qscale, int causal, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  static_assert(kBQ == kBK, "one box shape serves Q, K and V");
  CUtensorMap qm, km, vm;
  if (!hp::get_map(enc, &qm, q, B, T, H, qsb, qst, qsh, kBK) ||
      !hp::get_map(enc, &km, k, B, T, H, ksb, kst, ksh, kBK) ||
      !hp::get_map(enc, &vm, v, B, T, H, vsb, vst, vsh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // One group of all heads when their K/V (512 * T bytes a head) fit in
  // the 50 MB L2 with room to spare, so the lightest tiles of a short
  // grid come last (a B=1, T=2048 prefill: 256 CTAs on 132 SMs); else
  // head by head, because heads whose tiles run apart read their K/V
  // from DRAM again (B=8: 128 MB).
  const long long kv_bytes = 512LL * T * B * H;
  const int group = kv_bytes <= (32LL << 20) ? B * H : 1;
  const dim3 grid((T + kBQ - 1) / kBQ * B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  cudaError_t err;
  if (lp != nullptr) {
    err = hp::allow_smem(
        reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<true>),
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_wgmma_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        qm, km, vm, op, lp, T, H, group, qscale, causal);
  } else {
    err = hp::allow_smem(
        reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<false>),
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_wgmma_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
        qm, km, vm, op, lp, T, H, group, qscale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one forward CTA, in bytes.
extern "C" int hvd_flash_attention_fwd_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
