// Paged decode attention for Hopper (sm_90a): one query token per slot
// against that slot's KV blocks, read through its block-table row.
//
// Replaces: horovod_tpu/ops/pallas_paged_attention.py::_paged_kernel as
// launched by _paged_call -- the TPU kernel every decode layer of the
// paged generation engine runs.
//
// Computes, for each (slot s, head h) with pos = positions[s] >= 0,
// softmax(q . k_j * scale) . v over keys j = 0..pos, where key j lives at
// pool row (tables[s, j / bs], j % bs); q is scaled in f32 (by scale *
// log2 e: the softmax runs in the log2 domain with ex2), scores, softmax
// and accumulation are f32 with a -1e30 start, the output is acc / l
// rounded once to bf16. pos < 0 gives zeros. Blocks past pos's block are
// never read, and keys past max_blocks * bs do not exist; table entries
// are clamped into [0, n_blocks). Takes bf16 q and pools with d_head 128
// (the engine's shapes) and any block size.
//
// Bound: bytes. Each key costs 2*d*2 bytes of K/V for 4*d flops, about one
// flop per byte -- far below the card's ~295 flops per byte, so the kernel
// can at best stream the slots' K/V at the memory rate. Tensor cores do not
// help: there is one query row per head.
//
// Design (split-KV, "flash-decoding"):
// * Work: one CTA of 4 warps per (slot, head, chunk of keys: 128 at the
//   engine's table). The chunk is fixed on the host from the shapes alone
//   (ops/paged_attention.py split_plan), never from positions, which live
//   on the device. A CTA whose chunk starts past pos exits at once, so the
//   work tracks the real lengths and the longest slot is spread over as
//   many CTAs as it has chunks. The last chunks are launched first.
// * Loads: K and V arrive in tiles of 16 keys through a 4-stage ring in
//   shared memory (35 KB a CTA, 6 CTAs an SM), each tile whole TMA boxes
//   (a 4-D tensor map over the pool, box = box_rows rows of one head, no
//   swizzle: the math runs on CUDA cores and a warp reads whole 256-byte
//   rows, which no bank conflict slows) completing on the stage's
//   mbarrier. The chunk's table entries are read into shared memory up
//   front, beside the position, so no address waits on a table load.
//   Warp w owns tiles w, w + 4, ...: it issues their loads and refills
//   its stage itself when done with it, so the loop has no CTA barrier.
// * Math: per tile, not per key. A warp computes the tile's 16 scores at
//   once (each lane 4 of the 128 products of each row, then a butterfly
//   that leaves row r's sum in lanes 2r and 2r + 1 after 16 shuffles in 5
//   steps), takes one max and rescales its l and its accumulator (4
//   columns a lane) once, then adds the rows. The 4 warps' states merge
//   in warp order at the end.
// * Combine: a chunk that is its slot's only one writes the bf16 row. Else
//   each chunk writes f32 partials (m, l, acc[128]) to the workspace, and
//   the last CTA of the (slot, head) -- the one whose acquire-release
//   ticket completes the count -- merges them in split order, one pass
//   with 8 partials' loads in flight at a time, and resets the ticket for
//   the next launch. No float atomics: two launches on the same input give
//   bitwise-equal results.
// Where the time goes on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6): a launch whose CTAs all exit at once takes 2.7-4.0 us, the
// merge's two round trips about 2 us more; the rest is streaming, in one
// wave at the engine's shapes.

#include "hopper.cuh"

namespace hp = hvd_hopper;

namespace {

constexpr int kD = 128;                      // head dimension
constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;                // keys of one ring stage
constexpr int kStages = 4;                   // a multiple of kWarps
constexpr int kMaxTilesPerChunk = 8;
// Logical blocks one chunk can touch: its keys (<= 128) plus one block
// it starts inside of.
constexpr int kTableMax = kMaxTilesPerChunk * kTileRows + 1;
constexpr int kTableLoads = (kTableMax + kThreads - 1) / kThreads;
constexpr int kMergeBatch = 8;               // partials loaded at once
constexpr uint32_t kRowBytes = kD * 2;
static_assert(kStages % kWarps == 0, "a warp refills the stages it reads");
static_assert(kThreads == kD, "thread d owns output column d");
static_assert(kTileRows == 16, "the score butterfly folds 16 rows");

// The host's split plan (ops/paged_attention.py SplitPlan) and shapes. A
// tile is boxes_per_tile boxes of box_rows rows (box_rows divides bs), so
// it covers tile_keys consecutive keys; a chunk is tiles_per_chunk tiles.
struct Plan {
  int H, bs, max_blocks, n_blocks;
  int box_rows, boxes_per_tile, tiles_per_chunk, n_splits;
};

struct Smem {
  __nv_bfloat16 k[kStages][kTileRows][kD];
  __nv_bfloat16 v[kStages][kTileRows][kD];
  float red[kWarps][kD];          // the warps' accumulators at the end
  float red_m[kWarps], red_l[kWarps];
  int table[kTableMax];           // the chunk's physical blocks
  uint64_t full[kStages];
  int last;
};
constexpr uint32_t kSmemBytes = sizeof(Smem) + 128;   // + alignment

__device__ __forceinline__ void bf16x4(const uint2& raw, float (&f)[4]) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ uint32_t ticket_add(uint32_t* p) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// One step of the score butterfly: lanes whose `bit` is clear keep the
// first half of x and add their partner's first half; the others keep
// and add the second half.
template <int kHalf>
__device__ __forceinline__ void fold(float (&x)[2 * kHalf], bool upper,
                                     int bit) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float keep = upper ? x[j + kHalf] : x[j];
    const float give = upper ? x[j] : x[j + kHalf];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, give, bit);
  }
}

// Tile t's boxes into ring stage `st`: the boxes whose first key is
// below n_keys, box j at rows [j * box_rows, ...) of the stage.
__device__ __forceinline__ void load_tile(const CUtensorMap& kmap,
                                          const CUtensorMap& vmap,
                                          Smem& sm, const Plan& g, int st,
                                          int t, int n_keys, int blk0,
                                          int h) {
  const int tile_keys = g.box_rows * g.boxes_per_tile;
  const int nbox = min(g.boxes_per_tile,
                       (n_keys - t * tile_keys + g.box_rows - 1) /
                           g.box_rows);
  const uint32_t bar = hp::smem_addr(&sm.full[st]);
  hp::mbar_expect_tx(bar, nbox * g.box_rows * kRowBytes * 2);
  const int per_block = g.bs / g.box_rows;
  for (int j = 0; j < nbox; ++j) {
    const int box = t * g.boxes_per_tile + j;
    const int b = box / per_block;
    const int row0 = (box - b * per_block) * g.box_rows;
    const int phys = sm.table[b - blk0];
    const uint32_t off = j * g.box_rows * kRowBytes;
    hp::tma_load_4d(hp::smem_addr(&sm.k[st][0][0]) + off, &kmap, bar, 0, h,
                    row0, phys);
    hp::tma_load_4d(hp::smem_addr(&sm.v[st][0][0]) + off, &vmap, bar, 0, h,
                    row0, phys);
  }
}

__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __nv_bfloat16* __restrict__ q,
                          const int* __restrict__ tables,
                          const int* __restrict__ positions,
                          __nv_bfloat16* __restrict__ out,
                          uint32_t* __restrict__ tickets,
                          float2* __restrict__ part_ml,
                          float* __restrict__ part_acc, const Plan g,
                          float qscale) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((128u - hp::smem_addr(smem_raw) % 128u) % 128u));
  const int pair = blockIdx.x;                 // s * H + h
  const int s = pair / g.H, h = pair - s * g.H;
  const int c = g.n_splits - 1 - static_cast<int>(blockIdx.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_keys = g.box_rows * g.boxes_per_tile;
  const int key0 = c * tile_keys * g.tiles_per_chunk;
  const int blk0 = key0 / g.bs;

  // The chunk's table entries and the position, in flight together.
  const int* trow = tables + static_cast<long long>(s) * g.max_blocks;
  const int n_tbl = min(kTableMax, g.max_blocks - blk0);
  int tv[kTableLoads];
#pragma unroll
  for (int u = 0; u < kTableLoads; ++u) {
    const int i = tid + u * kThreads;
    tv[u] = i < n_tbl ? trow[blk0 + i] : 0;
  }
  const int pos = positions[s];

  __nv_bfloat16* op = out + static_cast<long long>(pair) * kD;
  if (pos < 0) {
    if (c == 0) op[tid] = __float2bfloat16(0.f);
    return;
  }
  const int n_keys = min(pos, g.max_blocks * g.bs - 1) + 1;
  const int n_tiles = (n_keys + tile_keys - 1) / tile_keys;
  const int n_active = (n_tiles + g.tiles_per_chunk - 1) / g.tiles_per_chunk;
  if (c >= n_active) return;
  const int t0 = c * g.tiles_per_chunk;
  const int nt = min(g.tiles_per_chunk, n_tiles - t0);

#pragma unroll
  for (int u = 0; u < kTableLoads; ++u) {
    const int i = tid + u * kThreads;
    if (i < kTableMax) sm.table[i] = min(max(tv[u], 0), g.n_blocks - 1);
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st)
      hp::mbar_init(hp::smem_addr(&sm.full[st]), 1);
    hp::mbar_init_fence();
  }
  float qv[4];
  bf16x4(*reinterpret_cast<const uint2*>(
             q + static_cast<long long>(pair) * kD + 4 * lane),
         qv);
#pragma unroll
  for (int e = 0; e < 4; ++e) qv[e] *= qscale;
  __syncthreads();
  // Warp w reads (and loads) tiles w, w + kWarps, ...: stage i % kStages
  // holds tile i, and the warp that reads a stage refills it.
  if (lane == 0)
    for (int i = warp; i < min(kStages, nt); i += kWarps)
      load_tile(kmap, vmap, sm, g, i, t0 + i, n_keys, blk0, h);

  float m = -1e30f, lp = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = warp; i < nt; i += kWarps) {
    const int st = i % kStages;
    const int nk = min(tile_keys, n_keys - (t0 + i) * tile_keys);
    hp::mbar_wait(hp::smem_addr(&sm.full[st]), (i / kStages) & 1);

    // The tile's 16 dot products, 4 columns a lane, then a butterfly
    // that leaves row lane >> 1's full score in lanes 2r and 2r + 1.
    float x[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      float kf[4];
      bf16x4(*reinterpret_cast<const uint2*>(&sm.k[st][r][4 * lane]), kf);
      x[r] = qv[0] * kf[0];
#pragma unroll
      for (int e = 1; e < 4; ++e) x[r] = fmaf(qv[e], kf[e], x[r]);
    }
    fold<8>(*reinterpret_cast<float(*)[16]>(x), lane & 16, 16);
    fold<4>(*reinterpret_cast<float(*)[8]>(x), lane & 8, 8);
    fold<2>(*reinterpret_cast<float(*)[4]>(x), lane & 4, 4);
    fold<1>(*reinterpret_cast<float(*)[2]>(x), lane & 2, 2);
    float sc = x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
    if ((lane >> 1) >= nk) sc = -INFINITY;    // keys past pos

    // One max and one rescale for the tile.
    float tmax = sc;
#pragma unroll
    for (int b = 2; b < 32; b <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, b));
    const float m_new = fmaxf(m, tmax);
    const float alpha = hp::exp2_ftz(m - m_new);
    const float p = hp::exp2_ftz(sc - m_new);
    lp = lp * alpha + ((lane & 1) ? 0.f : p);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float pr = __shfl_sync(0xffffffffu, p, 2 * r);
      if (r < nk) {          // warp-uniform: rows past pos are not read
        float vf[4];
        bf16x4(*reinterpret_cast<const uint2*>(&sm.v[st][r][4 * lane]),
               vf);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
      }
    }
    m = m_new;
    if (i + kStages < nt) {          // this warp is done with stage st
      __syncwarp();
      if (lane == 0)
        load_tile(kmap, vmap, sm, g, st, t0 + i + kStages, n_keys, blk0, h);
    }
  }

  // The warps' states, merged in warp order.
#pragma unroll
  for (int b = 1; b < 32; b <<= 1)
    lp += __shfl_xor_sync(0xffffffffu, lp, b);
  *reinterpret_cast<float4*>(&sm.red[warp][4 * lane]) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (lane == 0) {
    sm.red_m[warp] = m;
    sm.red_l[warp] = lp;
  }
  __syncthreads();
  float mc = sm.red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mc = fmaxf(mc, sm.red_m[w]);
  float a = 0.f, L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float wt = hp::exp2_ftz(sm.red_m[w] - mc);
    a = fmaf(sm.red[w][tid], wt, a);
    L = fmaf(sm.red_l[w], wt, L);
  }
  if (n_active == 1) {
    op[tid] = __float2bfloat16(a / (L == 0.f ? 1.f : L));
    return;
  }

  // Partials, then the ticket (its release covers the CTA's writes, which
  // the barrier orders before it); the last CTA of (s, h) merges.
  const long long base = static_cast<long long>(pair) * g.n_splits;
  part_acc[(base + c) * kD + tid] = a;
  if (tid == 0) part_ml[base + c] = make_float2(mc, L);
  __syncthreads();
  if (tid == 0) {
    const bool last = ticket_add(&tickets[pair]) ==
                      static_cast<uint32_t>(n_active - 1);
    if (last) tickets[pair] = 0;             // at rest for the next launch
    sm.last = last;
  }
  __syncthreads();
  if (!sm.last) return;
  // One pass over the splits in split order, kMergeBatch loads in flight.
  float M = -1e30f, Ls = 0.f, o = 0.f;
  for (int j0 = 0; j0 < n_active; j0 += kMergeBatch) {
    float2 ml[kMergeBatch];
    float pa[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const int j = min(j0 + u, n_active - 1);
      ml[u] = __ldcg(&part_ml[base + j]);
      pa[u] = __ldcg(&part_acc[(base + j) * kD + tid]);
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (j0 + u < n_active) {
        const float m2 = fmaxf(M, ml[u].x);
        const float rescale = hp::exp2_ftz(M - m2);
        const float w = hp::exp2_ftz(ml[u].x - m2);
        Ls = fmaf(ml[u].y, w, Ls * rescale);
        o = fmaf(pa[u], w, o * rescale);
        M = m2;
      }
    }
  }
  op[tid] = __float2bfloat16(o / (Ls == 0.f ? 1.f : Ls));
}

// A 4-D map (d, h, row, block) over a [n_blocks, bs, H, 128] bf16 pool:
// boxes of one head's `box_rows` rows, no swizzle; cached per pointer.
bool pool_map(hp::EncodeTiled enc, CUtensorMap* map, const void* pool,
              int n_blocks, int bs, int H, int box_rows) {
  const long long key[7] = {n_blocks, bs, H, box_rows, -2, -2, -2};
  return hp::cached_map(map, pool, key, [&](CUtensorMap* m) {
    const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(bs),
                                static_cast<cuuint64_t>(n_blocks)};
    const cuuint64_t strides[3] = {
        kRowBytes, static_cast<cuuint64_t>(H) * kRowBytes,
        static_cast<cuuint64_t>(bs) * H * kRowBytes};
    const cuuint32_t box[4] = {kD, 1, static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(pool), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

}  // namespace

// q, out: contiguous [S, H, 128] bf16; k_pool, v_pool: contiguous
// [n_blocks, bs, H, 128] bf16, 16-byte aligned; tables: contiguous
// [S, max_blocks] int32; positions: [S] int32. The plan (box_rows,
// boxes_per_tile, tiles_per_chunk, n_splits) is split_plan's. Workspace:
// tickets [S*H] u32, zero (and left zero), part_ml [S*H, n_splits] float2,
// part_acc [S*H, n_splits, 128] f32. Returns a cudaError_t.
extern "C" int hvd_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, void* tickets,
    void* part_ml, void* part_acc, int S, int H, int D, int bs,
    int max_blocks, int n_blocks, int box_rows, int boxes_per_tile,
    int tiles_per_chunk, int n_splits, float scale, void* stream) {
  if (S <= 0 || H <= 0) return 0;
  const long long cap = static_cast<long long>(max_blocks) * bs;
  const int tile_keys = box_rows * boxes_per_tile;
  if (D != kD || bs < 1 || max_blocks < 1 || n_blocks < 1 ||
      cap > (1LL << 30) || box_rows < 1 || bs % box_rows != 0 ||
      boxes_per_tile < 1 || tile_keys > kTileRows || tiles_per_chunk < 1 ||
      tiles_per_chunk > kMaxTilesPerChunk || n_splits > 65535 ||
      n_splits != ((cap + tile_keys - 1) / tile_keys + tiles_per_chunk - 1) /
                       tiles_per_chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const hp::EncodeTiled enc = hp::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap km, vm;
  if (!pool_map(enc, &km, k_pool, n_blocks, bs, H, box_rows) ||
      !pool_map(enc, &vm, v_pool, n_blocks, bs, H, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan g{H, bs, max_blocks, n_blocks, box_rows, boxes_per_tile,
               tiles_per_chunk, n_splits};
  const float qscale = static_cast<float>(scale * 1.4426950408889634);
  const cudaError_t err = hp::allow_smem(
      reinterpret_cast<const void*>(paged_decode_split_kernel), kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_split_kernel<<<dim3(S * H, n_splits), kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), static_cast<uint32_t*>(tickets),
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc), g,
      qscale);
  return static_cast<int>(cudaGetLastError());
}
