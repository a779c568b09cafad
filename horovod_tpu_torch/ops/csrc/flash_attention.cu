// Causal flash-attention forward for Hopper (sm_90a): bf16 q/k/v with
// d_head 128 in, bf16 out, and optionally the row log2-sum-exp2.
//
// Replaces: horovod_tpu/ops/pallas_attention.py::_attn_kernel as launched
// by _fwd_pallas (with_lse=False) -- the TPU kernel every prefill layer of
// the paged generation engine runs (K3-fwd) -- and as launched by
// _fwd_pallas_qkv with its lse2 output -- the packed-qkv forward of LM
// training (K3-qkv), whose lse2 the backward (flash_attention_bwd.cu)
// recomputes the probabilities from.
//
// Computes, per (batch, head), o = softmax(q k^T * sm_scale) v with the
// JAX kernel's rounding points: q is multiplied by sm_scale*log2(e) in f32
// and rounded back to bf16 on load; scores are bf16 products accumulated in
// f32 and exponentiated with exp2; P is rounded to bf16 before P.V; the
// accumulator and the softmax statistics are f32; masked scores are -1e30;
// a row whose sum is 0 divides by 1 (comes out 0). With a non-null `lse`
// it also writes lse2 = m + log2(l) per row (-1e30 where l = 0) as one f32
// per row of an [B*H, T] array (the TPU kernel's [BH, T, 8]
// lane-replicated wire format is a Mosaic layout, not carried over).
//
// Bound: at the engine's prefill shapes (T up to 2048, d = 128) the work
// is 4*T^2*d*H/2 flops against 4*T*H*d*2 bytes, about T/2 flops per byte:
// compute-bound on the tensor cores above T ~ 600.
//
// Design: one CTA of 4 warps per (64-row q tile, batch*head); each warp
// owns 16 q rows and keeps its q fragments, the online-softmax state and
// the 16x128 f32 output accumulator in registers. K/V tiles of 64 rows are
// staged in shared memory (17 KB each, rows padded by 8 elements so the
// mma fragment reads hit 32 distinct banks); S = Q K^T and O += P V run on
// the tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate),
// and P goes from the S accumulators straight into the A fragments of the
// P.V product without touching shared memory. Tiles above the diagonal are
// never loaded; the ragged edge (T not a multiple of 64) is masked, so
// every prompt length runs this kernel. q/k/v are read through strides,
// so the [B,T,H,3,d] projection output is consumed without transposes,
// and o is written as [B,T,H,d], which is the packed [B,T,H*d] input of
// the output projection. The heaviest (last) q tiles are scheduled first.
// Loads are synchronous (no cp.async/TMA pipelining yet): a simple kernel
// that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using hvd_flash::kD;
using hvd_flash::kPad;
using hvd_flash::mma_bf16;
using hvd_flash::pack_bf16;
using hvd_flash::pack_raw;

constexpr int kBQ = 64;      // q rows per CTA (16 per warp)
constexpr int kBK = 64;      // keys per K/V tile
constexpr int kWarps = 4;

// Three CTAs per SM (at most 168 registers a thread): at 169 the register
// file holds only two, and a B=1, T=2048 prefill (512 CTAs) then needs two
// waves instead of one and a third. kLse compiles the lse2 epilogue only
// into the training instance, so the prefill instance is the lse-free
// kernel.
template <bool kLse>
__global__ void __launch_bounds__(kWarps * 32, 3)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T, int H,
                 long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh,
                 long long vsb, long long vst, long long vsh,
                 float qscale, int causal) {
  constexpr int D = kD;
  constexpr int LD = D + kPad;
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NT_D = D / 8;      // 8-wide n-tiles of the output
  constexpr int NT_K = kBK / 8;    // 8-wide n-tiles of the score tile
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int n_qt = (T + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma row group / thread in group
  const int q0 = qt * kBQ;
  const int r0 = q0 + warp * 16 + g;        // this lane's rows: r0, r0 + 8

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  // Q A-fragments: q * (sm_scale*log2e) in f32, rounded back to bf16.
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + half * 8;
#pragma unroll
      for (int cpart = 0; cpart < 2; ++cpart) {
        const int col = ks * 16 + cpart * 8 + 2 * t4;
        float x0 = 0.f, x1 = 0.f;
        if (row < T) {
          const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(
              qb + row * qst + col);
          x0 = __bfloat162float(pr.x) * qscale;
          x1 = __bfloat162float(pr.y) * qscale;
        }
        qa[ks][half + 2 * cpart] = pack_bf16(x0, x1);
      }
    }
  }

  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kt_all = (T + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, T) - 1;
  const int n_kt = causal ? min(n_kt_all, last_row / kBK + 1) : n_kt_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // every warp is done with the previous tile
    constexpr int CHUNKS = kBK * D / 8;   // 16-byte chunks per tile
    for (int c = tid; c < CHUNKS; c += kWarps * 32) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < T) {   // rows past T stay zero: 0 * garbage is NaN
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + row) * kst + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + row) * vst + col);
      }
      *reinterpret_cast<uint4*>(&Ks[row * LD + col]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row * LD + col]) = vv;
    }
    __syncthreads();

    // S = Q K^T (log2 domain; q already scaled).
    float s[NT_K][4];
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const __nv_bfloat16* kp = &Ks[(j * 8 + g) * LD + ks * 16 + 2 * t4];
        mma_bf16(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Causal / ragged mask, only on tiles that cross it.
    if (k0 + kBK > T || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NT_K; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          if (col >= T || (causal && col > row)) s[j][e] = -1e30f;
        }
      }
    }

    // Online softmax: row max over the quad, exp2, rescale.
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < NT_K; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hf] = exp2f(m[hf] - mx);
      m[hf] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    // Per-lane partial row sums; the quad is summed once at the end.
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) comes straight from the S fragments.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        const __nv_bfloat16* vp = &Vs[(kk * 16 + 2 * t4) * LD + n * 8 + g];
        mma_bf16(acc[n], pa, pack_raw(vp[0], vp[LD]),
                 pack_raw(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + hf * 8;
    if (row >= T) continue;
    const float safe = (l[hf] == 0.f) ? 1.f : l[hf];
    if (kLse && t4 == 0)   // log2 domain, for the backward
      lse[static_cast<long long>(blockIdx.y) * T + row] =
          (l[hf] == 0.f) ? -1e30f : m[hf] + log2f(safe);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * T + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * hf] / safe, acc[n][2 * hf + 1] / safe);
    }
  }
}

}  // namespace

// q/k/v: [B, T, H, D] bf16 views with unit stride on D (strides in
// elements); o: contiguous [B, T, H, D] bf16; lse: null, or contiguous
// [B*H, T] f32. Returns cudaGetLastError().
extern "C" int hvd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int T, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, float qscale, int causal, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  auto* lp = static_cast<float*>(lse);
  if (lp != nullptr)
    flash_fwd_kernel<true><<<grid, block, 0, st>>>(
        qp, kp, vp, op, lp, T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
        vsh, qscale, causal);
  else
    flash_fwd_kernel<false><<<grid, block, 0, st>>>(
        qp, kp, vp, op, lp, T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
        vsh, qscale, causal);
  return static_cast<int>(cudaGetLastError());
}
