// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/dO with
// d_head 128, the forward's f32 lse2 and the f32 row statistic
// Delta = rowsum(dO * O) in; bf16 dq, dk, dv out.
//
// Replaces, on the packed-qkv path of LM training
// (horovod_tpu/ops/pallas_attention.py::_flash_qkv_core_bwd):
//   _dqkv_packed_kernel (K7, the fused single pass the TPU runs up to
//     T ~ 8192) and the split pair it falls back to above that,
//   _dq_kernel (K4)  -> flash_bwd_dq_kernel,
//   _dkv_kernel (K5) -> flash_bwd_dkv_kernel.
// K7 and K4+K5 compute the same gradient; on Hopper the pair's shared
// memory does not grow with T (the fused kernel's full-T dk/dv
// accumulators are what the TPU's VMEM budget gate, _fused_bwd_fits,
// protects), so the port always runs the pair and has no such gate.
//
// Both kernels write straight into the packed head-major gradient
// d_qkv [B, T, H*3*D] (dq to columns [h*3D, h*3D+D), dk to +D, dv to
// +2D): K7's output layout, with no interleave copy. Every operand is
// passed as a pointer plus (batch, time, head) strides with unit stride
// on D, so the same kernels serve [B,T,H,D] / [BH,T,D] layouts too.
//
// Rounding points (those of _dqkv_packed_kernel): qs = bf16(q * c) with
// c = sm_scale*log2(e) feeds only the score recompute; s = qs k^T in f32
// from bf16 products; masked scores are -1e30; p = exp2(s - lse2) in f32;
// dp = dO v^T in f32; ds = p (dp - Delta) in f32, rounded to bf16 once for
// both dq and dk; p is rounded to bf16 before P^T dO; dq = sm_scale *
// sum ds k and dk = sm_scale * sum ds^T q (raw q) are scaled in f32 and
// rounded to bf16; dv = sum bf16(p)^T dO rounded to bf16.
//
// Bound: 3 (dq) + 4 (dkv) matmuls of 2*d flops per causal (q, key) pair
// against reading q, k, v, dO once: compute-bound on the tensor cores at
// training lengths (T = 2048: ~1500 flops per byte).
//
// Design (FlashAttention-2's split): no atomics and a fixed loop order, so
// two launches give bitwise-equal results, as the TPU kernels do.
// * dq: one CTA of 4 warps per (64-row q tile, batch*head) walks the K/V
//   tiles up to the diagonal. The scaled q tile and the dO tile are
//   staged once in shared memory; per K/V tile each warp forms its 16
//   rows of S and dP (16x64 each, registers), then dS, which goes from
//   the accumulators straight into the A fragments of dS K; the 16x128
//   dq accumulator stays in registers.
// * dkv: one CTA of 4 warps per (64-key K/V tile, batch*head) walks the
//   q tiles from the diagonal down. Each warp owns 16 keys and keeps its
//   16x128 dK and dV accumulators in registers (128 registers a thread);
//   to stay clear of spills it forms S^T and dP^T 32 q rows at a time
//   (16x32 each). K and V are staged once; per q tile the raw q, the
//   scaled q, dO, lse2 and Delta are staged.
// mma.sync m16n8k16 (bf16 in, f32 accumulate) from shared-memory tiles
// with rows padded by 8 elements; synchronous loads (no cp.async/TMA,
// no wgmma yet): a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using hvd_flash::kD;
using hvd_flash::kLD;
using hvd_flash::ld32;
using hvd_flash::load_a;
using hvd_flash::mma_bf16;
using hvd_flash::pack_bf16;
using hvd_flash::pack_raw;
using hvd_flash::stage_rows;

constexpr int kBQ = 64;      // q rows per tile
constexpr int kBK = 64;      // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kBQ * kLD;   // elements of one staged tile
constexpr int kSub = 32;           // q rows per S^T / dP^T slab (dkv)
constexpr float kMasked = -1e30f;

static_assert(kBQ == kBK, "the causal walks assume square tiles");

struct Operand {
  const __nv_bfloat16* p;
  long long sb, st, sh;   // batch, time, head strides (elements)
};

struct Grad {
  __nv_bfloat16* p;
  long long sb, st, sh;
};

struct BwdParams {
  Operand q, k, v, dout;
  const float* lse;      // [B*H, T]
  const float* delta;    // [B*H, T]
  Grad dq, dk, dv;
  int T, H;
  float qscale;          // sm_scale * log2(e)
  float grad_scale;      // sm_scale
  int causal;
};

__device__ __forceinline__ const __nv_bfloat16* head_base(const Operand& o,
                                                          int b, int h) {
  return o.p + b * o.sb + h * o.sh;
}

// Write a warp's 16x128 f32 accumulator (rows row0 + g, row0 + g + 8) as
// bf16 * scale.
__device__ __forceinline__ void store_rows(const Grad& out, int b, int h,
                                           int row0, int T, int g, int t4,
                                           const float (&acc)[kD / 8][4],
                                           float scale) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + g + hf * 8;
    if (row >= T) continue;
    __nv_bfloat16* dst = out.p + b * out.sb + row * out.st + h * out.sh;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t4) = pack_bf16(
          acc[n][2 * hf] * scale, acc[n][2 * hf + 1] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kTile;
  __nv_bfloat16* Ks = dOs + kTile;
  __nv_bfloat16* Vs = Ks + kTile;

  const int T = p.T, H = p.H;
  const int n_qt = (T + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);   // heavy first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kBQ;
  const int wr = warp * 16;               // warp's first row in the tile
  const int r0 = q0 + wr + g;             // this lane's rows: r0, r0 + 8

  stage_rows<kBQ, kThreads>(Qs, head_base(p.q, b, h), p.q.st, q0, T,
                            p.qscale, tid);
  stage_rows<kBQ, kThreads>(dOs, head_base(p.dout, b, h), p.dout.st, q0, T,
                            0.f, tid);
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + hf * 8;
    const long long i = static_cast<long long>(bh) * T + row;
    lse_r[hf] = row < T ? p.lse[i] : 0.f;
    dlt_r[hf] = row < T ? p.delta[i] : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kt_all = (T + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, T) - 1;
  const int n_kt = p.causal ? min(n_kt_all, last_row / kBK + 1) : n_kt_all;
  const __nv_bfloat16* kb = head_base(p.k, b, h);
  const __nv_bfloat16* vb = head_base(p.v, b, h);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // every warp is done with the previous K/V tile
    stage_rows<kBK, kThreads>(Ks, kb, p.k.st, k0, T, 0.f, tid);
    stage_rows<kBK, kThreads>(Vs, vb, p.v.st, k0, T, 0.f, tid);
    __syncthreads();

    // S = qs K^T and dP = dO V^T, this warp's 16 rows x 64 keys.
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t a[4], ad[4];
      load_a(a, Qs, wr, ks * 16, g, t4);
      load_a(ad, dOs, wr, ks * 16, g, t4);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const __nv_bfloat16* kp = &Ks[(j * 8 + g) * kLD + ks * 16 + 2 * t4];
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
        const __nv_bfloat16* vp = &Vs[(j * 8 + g) * kLD + ks * 16 + 2 * t4];
        mma_bf16(dp[j], ad, ld32(vp), ld32(vp + 8));
      }
    }

    // Mask (only tiles that cross the diagonal or the ragged edge), then
    // P = exp2(s - lse2) and dS = P (dP - Delta), all f32.
    const bool edge = k0 + kBK > T || (p.causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        float sv = s[j][e];
        if (edge && (col >= T || (p.causal && col > row))) sv = kMasked;
        const float pv = exp2f(sv - lse_r[e >> 1]);
        s[j][e] = pv * (dp[j][e] - dlt_r[e >> 1]);
      }
    }

    // dq += bf16(dS) K: dS goes from the accumulators into A fragments.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* kp = &Ks[(kk * 16 + 2 * t4) * kLD + n * 8 + g];
        mma_bf16(acc[n], da, pack_raw(kp[0], kp[kLD]),
                 pack_raw(kp[8 * kLD], kp[9 * kLD]));
      }
    }
  }
  store_rows(p.dq, b, h, q0 + wr, T, g, t4, acc, p.grad_scale);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qr = Vs + kTile;     // raw q
  __nv_bfloat16* Qs = Qr + kTile;     // bf16(q * c)
  __nv_bfloat16* dOs = Qs + kTile;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile);
  float* dlt_s = lse_s + kBQ;

  const int T = p.T, H = p.H;
  const int kt = blockIdx.x;          // the first K/V tiles are the heaviest
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * kBK;
  const int wk = warp * 16;           // warp's first key in the tile
  const int key0 = k0 + wk + g;       // this lane's keys: key0, key0 + 8

  stage_rows<kBK, kThreads>(Ks, head_base(p.k, b, h), p.k.st, k0, T, 0.f,
                            tid);
  stage_rows<kBK, kThreads>(Vs, head_base(p.v, b, h), p.v.st, k0, T, 0.f,
                            tid);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (T + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? kt : 0;   // q rows below k0 see no key here
  const __nv_bfloat16* qb = head_base(p.q, b, h);
  const __nv_bfloat16* db = head_base(p.dout, b, h);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();   // every warp is done with the previous q tile
    stage_rows<kBQ, kThreads>(Qr, qb, p.q.st, q0, T, 0.f, tid);
    stage_rows<kBQ, kThreads>(Qs, qb, p.q.st, q0, T, p.qscale, tid);
    stage_rows<kBQ, kThreads>(dOs, db, p.dout.st, q0, T, 0.f, tid);
    if (tid < kBQ) {
      const int row = q0 + tid;
      const long long i = static_cast<long long>(bh) * T + row;
      lse_s[tid] = row < T ? p.lse[i] : 0.f;
      dlt_s[tid] = row < T ? p.delta[i] : 0.f;
    }
    __syncthreads();
    const bool edge = q0 + kBQ > T || (p.causal && k0 + kBK - 1 > q0);

#pragma unroll
    for (int sub = 0; sub < kBQ / kSub; ++sub) {
      const int c0 = sub * kSub;      // slab's first q row in the tile
      // S^T = K qs^T and dP^T = V dO^T: this warp's 16 keys x 32 q rows.
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, wk, ks * 16, g, t4);
        load_a(av, Vs, wk, ks * 16, g, t4);
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          const int off = (c0 + j * 8 + g) * kLD + ks * 16 + 2 * t4;
          mma_bf16(st[j], ak, ld32(&Qs[off]), ld32(&Qs[off + 8]));
          mma_bf16(dpt[j], av, ld32(&dOs[off]), ld32(&dOs[off + 8]));
        }
      }
      // P^T = exp2(S^T - lse2[q]) and dS^T = P^T (dP^T - Delta[q]);
      // P^T stays in st, dS^T goes to dpt.
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8;
          const int c = c0 + j * 8 + 2 * t4 + (e & 1);
          const int qrow = q0 + c;
          float sv = st[j][e];
          if (edge && (qrow >= T || (p.causal && key > qrow))) sv = kMasked;
          const float pv = exp2f(sv - lse_s[c]);
          st[j][e] = pv;
          dpt[j][e] = pv * (dpt[j][e] - dlt_s[c]);
        }
      }
      // dV += bf16(P^T) dO and dK += bf16(dS^T) q: 16 q rows per k-step.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        const int rbase = (c0 + kk * 16 + 2 * t4) * kLD + g;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          const __nv_bfloat16* op = &dOs[rbase + n * 8];
          mma_bf16(dv[n], pa, pack_raw(op[0], op[kLD]),
                   pack_raw(op[8 * kLD], op[9 * kLD]));
          const __nv_bfloat16* qp = &Qr[rbase + n * 8];
          mma_bf16(dk[n], da, pack_raw(qp[0], qp[kLD]),
                   pack_raw(qp[8 * kLD], qp[9 * kLD]));
        }
      }
    }
  }
  store_rows(p.dk, b, h, k0 + wk, T, g, t4, dk, p.grad_scale);
  store_rows(p.dv, b, h, k0 + wk, T, g, t4, dv, 1.f);
}

constexpr int kSmemDq = 4 * kTile * 2;
constexpr int kSmemDkv = 5 * kTile * 2 + 2 * kBQ * 4;

int setup(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dq, void* dk, void* dv,
          int T, int H, int D, const long long* strides,
          float qscale, float grad_scale, int causal, BwdParams* p) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  auto operand = [&](const void* ptr, int i) {
    return Operand{static_cast<const __nv_bfloat16*>(ptr), strides[3 * i],
                   strides[3 * i + 1], strides[3 * i + 2]};
  };
  auto grad = [&](void* ptr, int i) {
    return Grad{static_cast<__nv_bfloat16*>(ptr), strides[3 * i],
                strides[3 * i + 1], strides[3 * i + 2]};
  };
  p->q = operand(q, 0);
  p->k = operand(k, 1);
  p->v = operand(v, 2);
  p->dout = operand(dout, 3);
  p->dq = grad(dq, 4);
  p->dk = grad(dk, 5);
  p->dv = grad(dv, 6);
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->T = T;
  p->H = H;
  p->qscale = qscale;
  p->grad_scale = grad_scale;
  p->causal = causal;
  return 0;
}

}  // namespace

// Operands q, k, v, dout and gradients dq, dk, dv are [B, T, H, D] bf16
// views with unit stride on D; `strides` holds their (batch, time, head)
// strides in elements, in that order (21 values). lse and delta are
// contiguous [B*H, T] f32. qscale = sm_scale*log2(e), grad_scale =
// sm_scale. hvd_flash_bwd_dq writes dq (dk, dv untouched);
// hvd_flash_bwd_dkv writes dk and dv (dq untouched). Each returns
// cudaGetLastError() of its launch.
extern "C" int hvd_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int B, int T, int H, int D, const long long* strides, float qscale,
    float grad_scale, int causal, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  BwdParams p;
  int err = setup(q, k, v, dout, lse, delta, dq, dk, dv, T, H, D, strides,
                  qscale, grad_scale, causal, &p);
  if (err) return err;
  static bool attr_set = false;
  if (!attr_set) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDq));
    if (err) return err;
    attr_set = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int B, int T, int H, int D, const long long* strides, float qscale,
    float grad_scale, int causal, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  BwdParams p;
  int err = setup(q, k, v, dout, lse, delta, dq, dk, dv, T, H, D, strides,
                  qscale, grad_scale, causal, &p);
  if (err) return err;
  static bool attr_set = false;
  if (!attr_set) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDkv));
    if (err) return err;
    attr_set = true;
  }
  const dim3 grid((T + kBK - 1) / kBK, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
