// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/dO with
// d_head 128, the forward's f32 lse2 and the f32 row statistic
// Delta = rowsum(dO * O) in; bf16 dq, dk, dv out.
//
// Replaces, on the packed-qkv path of LM training
// (horovod_tpu/ops/pallas_attention.py::_flash_qkv_core_bwd):
//   _dqkv_packed_kernel (K7, the fused single pass the TPU runs up to
//     T ~ 8192) and the split pair it falls back to above that,
//   _dq_kernel (K4)  -> flash_bwd_dq_kernel,
//   _dkv_kernel (K5) -> flash_bwd_dkv_kernel;
// and, with K6's constants (q prescaled, qscale 1, gradient scale ln 2),
// _dqkv_kernel (K6) and its split pair on the pipelined LM's [B,T,H,D]
// path (_flash_core_bwd). K7 and K4+K5 compute the same gradient; on
// Hopper the pair's shared memory does not grow with T (the fused
// kernel's full-T dk/dv accumulators are what the TPU's VMEM budget gate,
// _fused_bwd_fits, protects), so the port always runs the pair.
//
// Every operand and gradient is a [B, T, H, D] view with unit stride on
// D and its own (batch, time, head) strides, so the kernels read slices
// of the packed projection and write straight into the packed head-major
// gradient d_qkv [B, T, H*3*D] (K7's output layout, no interleave copy).
//
// Rounding points (those of _dqkv_packed_kernel): qs = bf16(q * qscale)
// feeds only the score recompute; s = qs k^T in f32 from bf16 products;
// masked scores are -1e30; p = exp2(s - lse2) in f32; dp = dO v^T in
// f32; ds = p (dp - Delta) in f32, rounded to bf16 once for both dq and
// dk; p is rounded to bf16 before P^T dO; dq = grad_scale * sum ds k and
// dk = grad_scale * sum ds^T q (raw q) are scaled in f32 and rounded to
// bf16; dv = sum bf16(p)^T dO rounded to bf16.
//
// Bound: 3 (dq) + 4 (dkv) matmul passes of 2*d flops per causal (q, key)
// pair against reading q, k, v, dO once: tensor-core bound at training
// lengths (T = 2048: ~1500 flops per byte). At the main paths' shapes
// (H=16, T=2048, 989 TFLOP/s): dq 0.209 ms and dkv 0.278 ms at B=8,
// half that at B=4.
//
// Design: the forward's machinery (hopper.cuh; flash_attention.cu) on
// FlashAttention-2's split, one CTA of two warpgroups per tile and
// batch*head, one CTA per SM:
// * Products are wgmma. S = Qs K^T and dP = dO V^T (dq kernel), S^T =
//   K Qs^T and dP^T = V dO^T (dkv kernel) are m64n64k16 with both
//   operands in shared memory, K-major; dq += dS K, dV += P^T dO and
//   dK += dS^T q take the f32 accumulator, rounded to bf16 pairs, as the
//   register A operand, and read K, dO and q MN-major (transpose bit).
// * dq: 128 q rows a CTA (64 a warpgroup, its 64x128 f32 dq in
//   registers); Q and dO arrive once by TMA, Q is scaled in place; K/V
//   tiles of 64 keys come through a 4-stage TMA ring. Each warpgroup
//   issues S and dP of tile n with dq += dS K of tile n - 1 and forms
//   dS of tile n while that product runs. lse2 and Delta of its two rows
//   a thread are plain loads into registers.
// * dkv: 128 keys a CTA (64 a warpgroup, its 64x128 f32 dK and dV in
//   registers); K and V arrive once; q and dO of each 64-row q tile come
//   through a 3-stage TMA ring. The CTA's 8 warps make each stage ready
//   one tile ahead, under the products, and count themselves done on a
//   per-stage mbarrier: they copy the tile's 64 rows of lse2 and Delta
//   into it (4-byte cp.async copies, which that mbarrier also waits for;
//   a TMA box must start on a 16-byte boundary, which a row of a
//   [B*H, T] statistic does not for most T) and, on the packed path,
//   which needs both the raw q (for dK) and qs (for S^T), a second q
//   buffer, elementwise from the TMA-landed one (the same swizzled
//   layout, so offset i maps to offset i), each warp an eighth. With
//   qscale = 1 both products read the one buffer. A warpgroup issues S^T
//   and dP^T of tile n before it waits for dV and dK of tile n - 1.
// * No producer warp (ptxas gives every thread the launch bound's
//   registers; setmaxnreg does not change that): the last of the 8 warps
//   done with a ring stage, counted by an acquire-release atomic, issues
//   its refill.
// * Tiles above the diagonal are never loaded, and a warpgroup skips the
//   one tile of its CTA that it sees wholly masked. Only tiles that cross
//   the diagonal or T are masked; TMA zero-fills rows past T. Head by
//   head, each head's heaviest tile first: dq's last q tile, dkv's first
//   key tile.
// * Gradients are scaled in f32, rounded, staged in shared memory (the
//   warpgroup's own Q, or K and V, rows, free after its last product)
//   and written as 16-byte coalesced row stores.
// * Deterministic: every sum in a fixed order, no atomics in any sum
//   (atomics only count the warps done with a stage), so two launches
//   give bitwise-equal results.

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

constexpr int kThreads = 256;   // two warpgroups
constexpr float kMasked = -1e30f;

// This thread's warpgroup (0 or 1), broadcast from lane 0 so that ptxas
// knows it is warp-uniform: a branch or loop bound that depends on it
// around wgmma would otherwise count as divergent, and ptxas serializes
// the wgmma of a divergent path.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
}

// The f32 accumulator of an m64nN product, rounded to bf16 pairs: the A
// fragments of the next product's k-steps of 16 (along the accumulator's
// columns).
template <int kSteps>
__device__ __forceinline__ void pack_a(uint32_t (&a)[kSteps][4],
                                       const float (&c)[8 * kSteps]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// -- dq -----------------------------------------------------------------------

namespace dq_tile {

constexpr int kBQ = 128;       // q rows per CTA (64 per warpgroup)
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kStages = 4;     // K/V ring depth
static_assert(kBQ == 2 * kBK, "a warpgroup skips at most its last tile");
constexpr uint32_t kQHalf = kBQ * 128;            // a 64-column half
constexpr uint32_t kKHalf = kBK * 128;
constexpr uint32_t kQOff = 0;
constexpr uint32_t kDOOff = 2 * kQHalf;
constexpr uint32_t kKOff = 4 * kQHalf;            // stage s: + s * kStage
constexpr uint32_t kStage = 4 * kKHalf;           // K then V
constexpr uint32_t kBarOff = kKOff + kStages * kStage;
// mbarriers: Q+dO full, K/V full per stage; then a u32 count of the
// warps done with each stage.
constexpr uint32_t kBars = 1 + kStages;
constexpr uint32_t kCountOff = kBarOff + 8 * kBars;
constexpr uint32_t kSmemBytes = kCountOff + 4 * kStages + 1024;

__device__ __forceinline__ void load_kv(const CUtensorMap& kmap,
                                        const CUtensorMap& vmap,
                                        uint32_t base, int kt, int h, int b) {
  const int s = kt % kStages;
  const uint32_t full = base + kBarOff + 8 * (1 + s);
  const uint32_t dst = base + kKOff + s * kStage;
  const int k0 = kt * kBK;
  hp::mbar_expect_tx(full, kStage);
  hp::tma_load_4d(dst, &kmap, full, 0, h, k0, b);
  hp::tma_load_4d(dst + kKHalf, &kmap, full, 64, h, k0, b);
  hp::tma_load_4d(dst + 2 * kKHalf, &vmap, full, 0, h, k0, b);
  hp::tma_load_4d(dst + 3 * kKHalf, &vmap, full, 64, h, k0, b);
}

}  // namespace dq_tile

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, const View dqo, int T,
                    int H, float qscale, float grad_scale, int causal) {
  using namespace dq_tile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const Tile tl = tile_of((T + kBQ - 1) / kBQ, H, 1, true);
  const int b = tl.b, h = tl.h, q0 = tl.t * kBQ;
  const int n_kt_all = (T + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, T) - 1;
  const int n_kt = causal ? min(n_kt_all, last_row / kBK + 1) : n_kt_all;
  const uint32_t qd_full = base + kBarOff;
  const uint32_t kv_full = qd_full + 8;
  const uint32_t done = base + kCountOff;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(kBars); ++i)
      hp::mbar_init(qd_full + 8 * i, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      reinterpret_cast<uint32_t*>(smem + kCountOff)[s] = 0;
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&qmap);
    hp::tma_prefetch_map(&kmap);
    hp::tma_prefetch_map(&vmap);
    hp::tma_prefetch_map(&dmap);
    hp::mbar_expect_tx(qd_full, 4 * kQHalf);
    hp::tma_load_4d(base + kQOff, &qmap, qd_full, 0, h, q0, b);
    hp::tma_load_4d(base + kQOff + kQHalf, &qmap, qd_full, 64, h, q0, b);
    hp::tma_load_4d(base + kDOOff, &dmap, qd_full, 0, h, q0, b);
    hp::tma_load_4d(base + kDOOff + kQHalf, &dmap, qd_full, 64, h, q0, b);
    for (int kt = 0; kt < min(kStages, n_kt); ++kt)
      load_kv(kmap, vmap, base, kt, h, b);
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int wg = warpgroup(), wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + wg * 64;               // this warpgroup's rows
  const int r0 = row_lo + warp * 16 + g;         // this thread's: r0, +8
  const uint32_t qrows = base + kQOff + wg * 64 * 128;
  const uint32_t dorows = base + kDOOff + wg * 64 * 128;

  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    const long long i = (static_cast<long long>(b) * H + h) * T + row;
    lse_r[hf] = row < T ? lse[i] : 0.f;
    dlt_r[hf] = row < T ? delta[i] : 0.f;
  }

  hp::mbar_wait(qd_full, 0);
  if (qscale != 1.f) {
    // q * qscale in f32, rounded to bf16, in place (elementwise: the
    // swizzle does not matter), then visible to wgmma's async proxy.
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

  // The causal walk of this warpgroup: its CTA's last tile lies wholly
  // above the diagonal for the first warpgroup's rows when
  // row_lo + 63 < k0; it is the last tile, never refilled, so skipping
  // it needs no release.
  const int n_kt_wg =
      causal ? min(n_kt, (row_lo + 63) / kBK + 1) : n_kt;
  auto stage = [&](int kt) { return base + kKOff + (kt % kStages) * kStage; };
  auto phase = [](int kt) { return static_cast<uint32_t>(kt / kStages) & 1; };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t da[kBK / 16][4];

  // S = Qs K^T and dP = dO V^T of tile kt (8 k-steps of 16 over d each,
  // K-major; the first overwrites). Issued, not waited for.
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int kt) {
    const uint32_t kb = stage(kt), vb = kb + 2 * kKHalf;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      hp::wgmma_ss_m64n64k16(
          s, hp::desc_sw128(qrows + (ks >> 2) * kQHalf + col, 16, 1024),
          hp::desc_sw128(kb + (ks >> 2) * kKHalf + col, 16, 1024), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      hp::wgmma_ss_m64n64k16(
          dp, hp::desc_sw128(dorows + (ks >> 2) * kQHalf + col, 16, 1024),
          hp::desc_sw128(vb + (ks >> 2) * kKHalf + col, 16, 1024), ks > 0);
    }
    hp::wgmma_commit();
  };
  // dq += bf16(dS) K of tile kt: K MN-major (keys down, d contiguous),
  // LBO steps the 64-column halves, a k-step 16 key rows (2048 bytes).
  auto issue_dq = [&](int kt) {
    const uint32_t kb = stage(kt);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hp::wgmma_rs_m64n128k16_tb(
          acc, da[kk], hp::desc_sw128(kb + kk * 2048, kKHalf, 1024));
    hp::wgmma_commit();
  };
  // dS = exp2(S - lse2) (dP - Delta), in s. Element i of an accumulator:
  // row r0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2 * t4 + (i & 1).
  auto form_ds = [&](float (&s)[32], const float (&dp)[32], int kt) {
    const int k0 = kt * kBK;
    if (k0 + kBK > T || (causal && k0 + kBK - 1 > row_lo)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (col >= T || (causal && col > row)) s[i] = kMasked;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      s[i] = hp::exp2_ftz(s[i] - lse_r[hf]) * (dp[i] - dlt_r[hf]);
    }
  };
  // This warp's reads of tile kt's stage are done; the last of the 8
  // warps to get there refills it with tile kt + kStages.
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0 &&
        hp::atomic_add_acq_rel(done + 4 * (kt % kStages), 1u) % 8 == 7 &&
        kt + kStages < n_kt)
      load_kv(kmap, vmap, base, kt + kStages, h, b);
    __syncwarp();   // reconverged before the next .aligned instruction
  };

  // Tile kt: S and dP of kt, then dq of kt - 1, in flight together; dS of
  // kt is formed while dq of kt - 1 is still on the tensor cores.
  for (int kt = 0; kt < n_kt_wg; ++kt) {
    float s[32], dp[32];
    hp::mbar_wait(kv_full + 8 * (kt % kStages), phase(kt));
    hp::fence_operands(acc);
    hp::wgmma_fence();
    issue_sdp(s, dp, kt);
    if (kt > 0) {
      issue_dq(kt - 1);
      hp::wgmma_wait<1>();
    } else {
      hp::wgmma_wait<0>();
    }
    hp::fence_operands(s);
    hp::fence_operands(dp);
    form_ds(s, dp, kt);
    if (kt > 0) {
      hp::wgmma_wait<0>();
      hp::fence_operands(acc);
      hp::fence_operands(da);
      release(kt - 1);
    }
    pack_a(da, s);
  }
  hp::fence_operands(acc);
  hp::wgmma_fence();
  issue_dq(n_kt_wg - 1);
  hp::wgmma_wait<0>();
  hp::fence_operands(acc);
  hp::fence_operands(da);
  release(n_kt_wg - 1);

  // dq through this warpgroup's Q rows (its last S has completed).
  store_tile(smem + kQOff + wg * 64 * 128, kQHalf, acc,
             [=](float x, int) { return x * grad_scale; }, dqo, b, h, row_lo,
             T, 1 + wg);
}

// -- dk, dv -------------------------------------------------------------------

namespace dkv_tile {

constexpr int kBK = 128;       // keys per CTA (64 per warpgroup)
constexpr int kBQ = 64;        // q rows per ring tile
constexpr int kStages = 3;     // q/dO ring depth
static_assert(kBK == 2 * kBQ, "a warpgroup skips at most its first tile");
constexpr uint32_t kKHalf = kBK * 128;            // a 64-column half
constexpr uint32_t kQHalf = kBQ * 128;
constexpr uint32_t kKOff = 0;
constexpr uint32_t kVOff = 2 * kKHalf;
constexpr uint32_t kRingOff = 4 * kKHalf;         // stage s: + s * kStage
// A stage: raw q and dO by TMA, qs from the CTA's warps (two halves
// each), then the tile's 64 lse2 and 64 Delta values (f32, cp.async).
constexpr uint32_t kQsOff = 2 * kQHalf;
constexpr uint32_t kDOOff = 4 * kQHalf;
constexpr uint32_t kStatOff = 6 * kQHalf;
constexpr uint32_t kStage = kStatOff + 1024;      // 1024-byte aligned
constexpr uint32_t kLoadBytes = 4 * kQHalf;       // TMA bytes a stage
constexpr uint32_t kBarOff = kRingOff + kStages * kStage;
// mbarriers: K+V full; full per stage; ready per stage (8 warps: qs
// written, the statistics' copies landed); then a u32 count of the warps
// done with each stage.
constexpr uint32_t kBars = 1 + 2 * kStages;
constexpr uint32_t kCountOff = kBarOff + 8 * kBars;
constexpr uint32_t kSmemBytes = kCountOff + 4 * kStages + 1024;

__device__ __forceinline__ void load_q(const CUtensorMap& qmap,
                                       const CUtensorMap& dmap,
                                       uint32_t base, int j, int qt0, int h,
                                       int b) {
  const int s = j % kStages;
  const uint32_t full = base + kBarOff + 8 * (1 + s);
  const uint32_t dst = base + kRingOff + s * kStage;
  const int q0 = (qt0 + j) * kBQ;
  hp::mbar_expect_tx(full, kLoadBytes);
  hp::tma_load_4d(dst, &qmap, full, 0, h, q0, b);
  hp::tma_load_4d(dst + kQHalf, &qmap, full, 64, h, q0, b);
  hp::tma_load_4d(dst + kDOOff, &dmap, full, 0, h, q0, b);
  hp::tma_load_4d(dst + kDOOff + kQHalf, &dmap, full, 64, h, q0, b);
}

}  // namespace dkv_tile

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const View dko,
                     const View dvo, int T, int H, float qscale,
                     float grad_scale, int causal) {
  using namespace dkv_tile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const Tile tl = tile_of((T + kBK - 1) / kBK, H, 1, false);
  const int b = tl.b, h = tl.h, k0 = tl.t * kBK;
  const int qt0 = causal ? k0 / kBQ : 0;   // rows before k0 see no key here
  const int n_j = (T + kBQ - 1) / kBQ - qt0;
  const uint32_t kv_full = base + kBarOff;
  const uint32_t full = kv_full + 8;
  const uint32_t ready = full + 8 * kStages;
  const uint32_t done = base + kCountOff;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(ready + 8 * s, 8);
      reinterpret_cast<uint32_t*>(smem + kCountOff)[s] = 0;
    }
    hp::mbar_init_fence();
    hp::tma_prefetch_map(&qmap);
    hp::tma_prefetch_map(&kmap);
    hp::tma_prefetch_map(&vmap);
    hp::tma_prefetch_map(&dmap);
    hp::mbar_expect_tx(kv_full, 4 * kKHalf);
    hp::tma_load_4d(base + kKOff, &kmap, kv_full, 0, h, k0, b);
    hp::tma_load_4d(base + kKOff + kKHalf, &kmap, kv_full, 64, h, k0, b);
    hp::tma_load_4d(base + kVOff, &vmap, kv_full, 0, h, k0, b);
    hp::tma_load_4d(base + kVOff + kKHalf, &vmap, kv_full, 64, h, k0, b);
    for (int j = 0; j < min(kStages, n_j); ++j)
      load_q(qmap, dmap, base, j, qt0, h, b);
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + wg * 64;                  // this warpgroup's keys
  const int key0 = kw0 + warp * 16 + g;          // this thread's: key0, +8
  const uint32_t krows = base + kKOff + wg * 64 * 128;
  const uint32_t vrows = base + kVOff + wg * 64 * 128;
  const bool scaled = qscale != 1.f;
  auto stage = [&](int j) { return base + kRingOff + (j % kStages) * kStage; };
  auto phase = [](int j) { return static_cast<uint32_t>(j / kStages) & 1; };

  const long long stat0 = (static_cast<long long>(b) * H + h) * T;
  // Tile j's stage made ready by the CTA's 8 warps, one tile ahead of its
  // products. Each warp copies 16 of the tile's 64 lse2 and 64 Delta
  // values into it (asynchronous 4-byte copies, zeros past T, which the
  // stage's mbarrier waits for) and, on the packed path, writes its
  // eighth of qs = bf16(q * qscale) from the landed raw q, made visible
  // to wgmma's async proxy; then counts itself on the mbarrier. The
  // statistics' slot is free: every warp read those of tile j - kStages
  // before it counted itself ready for tile j - 1, which this warp has
  // waited for (all but the first kStages tiles).
  auto prepare = [&](int j) {
    const uint32_t bar = ready + 8 * (j % kStages);
    if (lane < 16) {
      const int c = (tid >> 5) * 16 + lane;   // lse2 rows 0-63, Delta's
      const int row = (qt0 + j) * kBQ + (c & (kBQ - 1));
      const float* src = c < kBQ ? lse : delta;
      hp::cp_async_4(stage(j) + kStatOff + 4 * c,
                     row < T ? src + stat0 + row : src, row < T);
      hp::cp_async_mbar_arrive(bar);
    }
    if (scaled) {
      hp::mbar_wait(full + 8 * (j % kStages), phase(j));
      uint8_t* q = smem + (stage(j) - base);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (tid >> 5) * 128 + i * 32 + lane;   // chunk of 1024
        *reinterpret_cast<uint4*>(q + kQsOff + c * 16) = scale_bf16x8(
            *reinterpret_cast<const uint4*>(q + c * 16), qscale);
      }
      hp::fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar);
    __syncwarp();
  };
  // This warp's reads of tile j's stage are done; the last of the 8 warps
  // to get there refills it with tile j + kStages.
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0 &&
        hp::atomic_add_acq_rel(done + 4 * (j % kStages), 1u) % 8 == 7 &&
        j + kStages < n_j)
      load_q(qmap, dmap, base, j + kStages, qt0, h, b);
    __syncwarp();   // reconverged before the next .aligned instruction
  };

  hp::mbar_wait(kv_full, 0);
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];

  // S^T = K Qs^T and dP^T = V dO^T of tile j (8 k-steps of 16 over d,
  // K-major; the first overwrites). Issued, not waited for.
  auto issue_sdp = [&](float (&st)[32], float (&dpt)[32], int j) {
    const uint32_t qb = stage(j) + (scaled ? kQsOff : 0);
    const uint32_t db = stage(j) + kDOOff;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      hp::wgmma_ss_m64n64k16(
          st, hp::desc_sw128(krows + (ks >> 2) * kKHalf + col, 16, 1024),
          hp::desc_sw128(qb + (ks >> 2) * kQHalf + col, 16, 1024), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      hp::wgmma_ss_m64n64k16(
          dpt, hp::desc_sw128(vrows + (ks >> 2) * kKHalf + col, 16, 1024),
          hp::desc_sw128(db + (ks >> 2) * kQHalf + col, 16, 1024), ks > 0);
    }
    hp::wgmma_commit();
  };
  // dV += bf16(P^T) dO and dK += bf16(dS^T) q (raw q) of tile j: dO and
  // q MN-major, a k-step 16 q rows (2048 bytes). Issued, not waited for.
  auto issue_dkv = [&](int j) {
    const uint32_t qb = stage(j), db = stage(j) + kDOOff;
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      hp::wgmma_rs_m64n128k16_tb(
          dv, pa[kk], hp::desc_sw128(db + kk * 2048, kQHalf, 1024));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      hp::wgmma_rs_m64n128k16_tb(
          dk, da[kk], hp::desc_sw128(qb + kk * 2048, kQHalf, 1024));
    hp::wgmma_commit();
  };
  // P^T = exp2(S^T - lse2) into st, dS^T = P^T (dP^T - Delta) into dpt.
  // Element i of an accumulator: key key0 + 8 * ((i >> 1) & 1), q row
  // q0 + 8 * (i >> 2) + 2 * t4 + (i & 1). Keys past T are not masked:
  // their rows of dK and dV are never written.
  auto form_p_ds = [&](float (&st)[32], float (&dpt)[32], int j) {
    const int q0 = (qt0 + j) * kBQ;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (stage(j) - base) + kStatOff);
    const float* dlt_s = lse_s + kBQ;
    const bool edge = q0 + kBQ > T || (causal && kw0 + 63 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int key = key0 + 8 * ((i >> 1) & 1), qrow = q0 + c;
      float sv = st[i];
      if (edge && (qrow >= T || (causal && key > qrow))) sv = kMasked;
      const float p = hp::exp2_ftz(sv - lse_s[c]);
      st[i] = p;
      dpt[i] = p * (dpt[i] - dlt_s[c]);
    }
  };

  prepare(0);
  // Tile j: S^T and dP^T of j are issued before the wait for dV and dK of
  // the last tile computed (`pending`), which then releases its stage.
  int pending = -1;
  for (int j = 0; j < n_j; ++j) {
    const int q0 = (qt0 + j) * kBQ;
    // The second warpgroup's keys all lie past the rows of the CTA's
    // first causal tile.
    const bool skip = causal && kw0 > q0 + kBQ - 1;
    float st[32], dpt[32];
    if (!skip) {
      hp::mbar_wait(full + 8 * (j % kStages), phase(j));
      hp::mbar_wait(ready + 8 * (j % kStages), phase(j));
      hp::wgmma_fence();
      issue_sdp(st, dpt, j);
    }
    // (Waits and fences on every path, so that ptxas sees dK and dV read,
    // and P^T and dS^T reused, only after their products are done.)
    if (skip)
      hp::wgmma_wait<0>();
    else
      hp::wgmma_wait<1>();
    hp::fence_operands(dk);
    hp::fence_operands(dv);
    hp::fence_operands(pa);
    hp::fence_operands(da);
    if (pending >= 0) release(pending);
    pending = -1;
    if (j + 1 < n_j) prepare(j + 1);
    if (skip) {
      release(j);
      continue;
    }
    hp::wgmma_wait<0>();
    hp::fence_operands(st);
    hp::fence_operands(dpt);
    form_p_ds(st, dpt, j);
    pack_a(pa, st);
    pack_a(da, dpt);
    hp::fence_operands(dk);
    hp::fence_operands(dv);
    hp::wgmma_fence();
    issue_dkv(j);
    pending = j;
  }
  hp::wgmma_wait<0>();
  hp::fence_operands(dk);
  hp::fence_operands(dv);
  hp::fence_operands(pa);
  hp::fence_operands(da);
  if (pending >= 0) release(pending);

  // dK and dV through this warpgroup's K and V rows (its last products
  // have completed).
  store_tile(smem + kKOff + wg * 64 * 128, kKHalf, dk,
             [=](float x, int) { return x * grad_scale; }, dko, b, h, kw0, T,
             1 + wg);
  store_tile(smem + kVOff + wg * 64 * 128, kKHalf, dv,
             [](float x, int) { return x; }, dvo, b, h, kw0, T, 1 + wg);
}

// -- host ---------------------------------------------------------------------

View grad(void* ptr, const long long* strides, int i) {
  return View{static_cast<__nv_bfloat16*>(ptr), strides[3 * i],
              strides[3 * i + 1], strides[3 * i + 2]};
}

// Tensor maps of operand i (q 0, k 1, v 2, dout 3) with boxes of `rows`.
bool operand_map(hp::EncodeTiled enc, CUtensorMap* map, const void* ptr,
                 int B, int T, int H, const long long* strides, int i,
                 int rows) {
  return hp::get_map(enc, map, ptr, B, T, H, strides[3 * i],
                     strides[3 * i + 1], strides[3 * i + 2], rows);
}

}  // namespace

// Operands q, k, v, dout and gradients dq, dk, dv are [B, T, H, D] bf16
// views with unit stride on D, 16-byte aligned; `strides` holds their
// (batch, time, head) strides in elements, multiples of 8, in that order
// (21 values). lse and delta are contiguous [B*H, T] f32. qscale
// multiplies q for the score recompute; grad_scale scales dq and dk.
// hvd_flash_bwd_dq writes dq (dk, dv untouched); hvd_flash_bwd_dkv writes
// dk and dv (dq untouched). Each returns the cudaError_t of its launch.
extern "C" int hvd_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int B, int T, int H, int D, const long long* strides, float qscale,
    float grad_scale, int causal, void* stream) {
  (void)dk;
  (void)dv;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, dm;
  if (!operand_map(enc, &qm, q, B, T, H, strides, 0, dq_tile::kBQ) ||
      !operand_map(enc, &km, k, B, T, H, strides, 1, dq_tile::kBK) ||
      !operand_map(enc, &vm, v, B, T, H, strides, 2, dq_tile::kBK) ||
      !operand_map(enc, &dm, dout, B, T, H, strides, 3, dq_tile::kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hp::allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel), dq_tile::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + dq_tile::kBQ - 1) / dq_tile::kBQ * B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, dq_tile::kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), grad(dq, strides, 4), T, H, qscale,
      grad_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int B, int T, int H, int D, const long long* strides, float qscale,
    float grad_scale, int causal, void* stream) {
  (void)dq;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, dm;
  if (!operand_map(enc, &qm, q, B, T, H, strides, 0, dkv_tile::kBQ) ||
      !operand_map(enc, &km, k, B, T, H, strides, 1, dkv_tile::kBK) ||
      !operand_map(enc, &vm, v, B, T, H, strides, 2, dkv_tile::kBK) ||
      !operand_map(enc, &dm, dout, B, T, H, strides, 3, dkv_tile::kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hp::allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dkv_kernel),
      dkv_tile::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + dkv_tile::kBK - 1) / dkv_tile::kBK * B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, dkv_tile::kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), grad(dk, strides, 5),
      grad(dv, strides, 6), T, H, qscale, grad_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one dq / dk-dv CTA, in bytes.
extern "C" int hvd_flash_bwd_dq_smem_bytes() {
  return static_cast<int>(dq_tile::kSmemBytes);
}

extern "C" int hvd_flash_bwd_dkv_smem_bytes() {
  return static_cast<int>(dkv_tile::kSmemBytes);
}
