// Paged decode attention for Hopper (sm_90a): one query token per slot
// against that slot's KV blocks, read through its block-table row.
//
// Replaces: horovod_tpu/ops/pallas_paged_attention.py::_paged_kernel as
// launched by _paged_call -- the TPU kernel every decode layer of the
// paged generation engine runs.
//
// Computes, for each (slot s, head h) with pos = positions[s] >= 0,
// softmax(q . k_j * scale) . v over keys j = 0..pos, where key j lives at
// pool row (tables[s, j / bs], j % bs); q is scaled in f32, scores,
// softmax and accumulation are f32 (exp, -1e30 start), the output is
// rounded to bf16. pos < 0 gives zeros. Blocks past pos are never read.
// Takes bf16 q and pools with d_head 128 (the engine's shapes).
//
// Bound: bytes. Each key costs 2*d*2 bytes of K/V for 4*d flops, about one
// flop per byte -- far below the card's ~295 flops per byte, so the kernel
// can at best stream the slots' K/V at the memory rate.
//
// Design: one CTA of 8 warps per (head, slot). A 128-element key row is
// split across 16 lanes that each load 16 bytes (8 bf16), so a warp covers
// 2 keys per step with fully coalesced 256-byte row reads. The dot product
// is reduced with warp shuffles inside each lane group; every lane group
// keeps its own online-softmax state (m, l, acc) in registers and issues
// the loads of 4 keys before using them, so several loads are in flight
// per lane. The 16 partial states are merged through shared memory at the
// end. The loop runs to pos and no further, so work tracks the real
// sequence length, not the table's capacity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;      // head dimension
constexpr int kVec = 8;      // bf16 elements per 16-byte load
constexpr int kLanesPerKey = kD / kVec;           // 16 lanes read one key row
constexpr int kKeysPerWarp = 32 / kLanesPerKey;   // 2 keys per warp per step
constexpr int kWarps = 8;
constexpr int kGroups = kWarps * kKeysPerWarp;    // independent softmax states
constexpr int kUnroll = 4;   // keys per lane group whose loads are in flight

__device__ __forceinline__ void to_float(const uint4& raw, float (&out)[kVec]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int H, int bs,
                    int max_blocks, int n_blocks, float scale) {
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][kD];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sub = lane / kLanesPerKey, part = lane % kLanesPerKey;
  const int group = warp * kKeysPerWarp + sub;
  __nv_bfloat16* op = out + (static_cast<long long>(s) * H + h) * kD;

  const int pos = positions[s];
  if (pos < 0) {
    for (int i = tid; i < kD; i += kWarps * 32) op[i] = __float2bfloat16(0.f);
    return;
  }
  // Keys past the table's capacity do not exist (the TPU kernel's grid
  // stops at max_blocks too).
  const int n_keys = min(pos + 1, max_blocks * bs);

  float qv[kVec];
  to_float(*reinterpret_cast<const uint4*>(
               q + (static_cast<long long>(s) * H + h) * kD + part * kVec),
           qv);
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] *= scale;

  float m = -1e30f, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  const int* trow = tables + static_cast<long long>(s) * max_blocks;
  const long long row_stride = static_cast<long long>(H) * kD;

  // The trip count depends only on the warp, so every lane reaches the
  // shuffles together.
  for (int j0 = warp * kKeysPerWarp; j0 < n_keys;
       j0 += kGroups * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kGroups + sub;
      valid[u] = j < n_keys;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (valid[u]) {
        const int blk = min(max(trow[j / bs], 0), n_blocks - 1);
        const long long off =
            (static_cast<long long>(blk) * bs + (j % bs)) * row_stride +
            static_cast<long long>(h) * kD + part * kVec;
        kr[u] = *reinterpret_cast<const uint4*>(k_pool + off);
        vr[u] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      to_float(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot += qv[i] * kf[i];
#pragma unroll
      for (int w = kLanesPerKey / 2; w > 0; w >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, w);
      if (valid[u]) {
        float vf[kVec];
        to_float(vr[u], vf);
        const float mn = fmaxf(m, dot);
        const float alpha = expf(m - mn);
        const float p = expf(dot - mn);
        l = l * alpha + p;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = acc[i] * alpha + p * vf[i];
        m = mn;
      }
    }
  }

  if (part == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) sm_acc[group][part * kVec + i] = acc[i];
  __syncthreads();

  for (int d = tid; d < kD; d += kWarps * 32) {
    float M = -1e30f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) M = fmaxf(M, sm_m[gi]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(sm_m[gi] - M);
      L += sm_l[gi] * w;
      o += sm_acc[gi][d] * w;
    }
    const float safe = (L == 0.f) ? 1.f : L;
    op[d] = __float2bfloat16(o / safe);
  }
}

}  // namespace

// q, out: contiguous [S, H, 128] bf16; k_pool, v_pool: contiguous
// [n_blocks, bs, H, 128] bf16; tables: contiguous [S, max_blocks] int32;
// positions: [S] int32. Returns cudaGetLastError().
extern "C" int hvd_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, int S, int H,
    int D, int bs, int max_blocks, int n_blocks, float scale, void* stream) {
  if (S <= 0 || H <= 0) return 0;
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  paged_decode_kernel<<<dim3(H, S), dim3(kWarps * 32), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), H, bs, max_blocks, n_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}
