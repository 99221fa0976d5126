// Paged decode attention for Hopper (sm_90a): bf16 queries, bf16 or int8
// KV pages, f32 accumulate.
//
// One kernel, paged_decode_verify<D, KV>, replaces the four TPU kernels of
// skypilot_tpu/ops/paged_attention.py, whatever the number T of query
// tokens a slot:
//   T = 1 (a decode step):
//     bf16 pages      :50  _kernel      (paged_decode_attention)
//     int8 pages      :150 _kernel_q    (paged_decode_attention_q)
//   T > 1 (the speculative verify step):
//     bf16 pages      :98  _kernel_mq   (paged_decode_attention_mq)
//     int8 pages      :210 _kernel_mq_q (paged_decode_attention_mq_q)
// Each slot has T consecutive query tokens, token t at position
// lengths[s] + t, and attends that slot's KV pages, found through the
// block table, with an online softmax over the pages. Token t sees the
// keys at positions <= lengths[s] + t. Row r = t*G + g of a kv head's
// R = T*G query rows is token t, query head hk*G + g.
//
// What bounds it on this card: memory bandwidth. Each layer call must
// read every visible K and V row once, 2*Hkv*d*2 B*sum_s(lengths[s]+T)
// bytes from bf16 pages or (2*Hkv*d*1 B + 2*Hkv*4 B)*sum_s(lengths[s]+T)
// from int8 pages with their f32 scales, against 3.35 TB/s; a (kv head,
// page) pair does 2*R*P*d flops a product for its 2*P*d*2 bytes, R
// flops a byte (4 at llama3-8b's decode step, 16 at its verify step),
// far below the tensor-core ridge.
//
// Rules, exactly the TPU kernels':
//   * skip rule: page j is walked iff j*P <= lengths[s] + T-1 and
//     (tables[s, j] != 0 or j == 0). A released slot (all-zero row,
//     stale length) reads only dummy page 0, and page indices never
//     leave the slot's row. Positions a row cannot see are masked with
//     -1e30; p is rounded to bf16 before PV, as the TPU kernel's
//     p.astype(v.dtype). A partial a row sees nothing of keeps finite
//     junk (m = -1e30), which the next visible key (alpha = 0) or the
//     merge (weight e^(-1e30 - m) = 0) drops: position 0 is visible to
//     every row;
//   * int8 pages: the codes convert to bf16 exactly, as the TPU kernel's
//     cast to the query dtype; the key scale multiplies the score, and
//     the value scale multiplies p before PV, where p * v_scale is
//     rounded to bf16 (the TPU kernel's pd). The running sum l takes the
//     unscaled p.
//
// The design puts a kv head's query rows on the tensor cores, so that no
// row walks the pages on the CUDA cores and no page is read again per
// group of rows:
//   * one block per (slot, kv head, split) holds all R rows of the kv
//     group, padded to 16-row m-tiles (R = 1-8 at T = 1 -> one tile,
//     R = 32 -> two) with zero rows that are never written, so each
//     visible K/V byte comes from HBM once a call. At T = 1 most of the
//     m-tile is padding; the call is bound by bytes, not products, so
//     the padding's products cost little. R above 128 rows (8 m-tiles)
//     takes several row groups (grid y), each reading the pages again;
//   * the block's pages are j = split, split + n_split, ... (strided,
//     so a short slot's pages spread over its splits); the host picks
//     n_split from mp, slots * Hkv and the SM count (ops/
//     paged_attention.py verify_plan: about 4 pages a block, at least a
//     block an SM), and the tile rows (the page's rows rounded up to 16,
//     at most 64; 32 for a block of one m-tile over bf16 pages at
//     d = 256, so two such blocks fit an SM);
//   * async loads (issue_tile): pages arrive by TMA into a ring of
//     `stages` (2) tiles of K and V (and the int8 scales) on mbarriers.
//     Thread 0 issues the first `stages` tiles before any product and
//     refills a stage as soon as the block is done with it, so the next
//     tile's bytes are in flight during the current tile's products. A
//     (page, kv head) block of the pool is one contiguous run of P*d
//     elements: a tile is a box of tile_rows rows of the pool viewed as
//     [n_pages*Hkv*P, d], at row (tables[s, j]*Hkv + hk)*P (+ tile_rows
//     per tile of a longer page);
//   * every page size: a page of up to 64 rows is one box of its rows
//     rounded up to 16; a longer page takes boxes of tile_rows and, where
//     tile_rows does not divide it, a last box of tail_rows (its last
//     rows rounded up to 16) through a second pair of maps. A box's rows
//     past the page's end hold the pool's next rows (TMA zero-fills past
//     the pool's last row) and are masked like invisible positions. The
//     int8 scales come by 1-d bulk copies of the page's rows where a
//     page's run of scales is 16-byte aligned (P % 4 == 0; the ring's
//     slots past a short last tile hold 0 or an earlier tile's scales);
//     other pages' scales are loaded into the ring by the block's threads
//     with plain loads;
//   * the tile lands as 128-byte rows under the 128-byte swizzle (bf16:
//     64-column panels; int8: 128-column panels, or at d = 64 64-byte
//     rows under the 64-byte swizzle), so the fragment loads below are
//     free of bank conflicts (int8 V at d = 64: 2-way);
//   * warps = m-tiles x key splits: warp (mt, ks) takes m-tile mt and
//     the 16-key chunks ks, ks + key_splits, ... of each tile, and keeps
//     its own online-softmax state (FlashAttention-2's fragments: m and
//     l of its thread's two rows, O [16, d] in f32 registers);
//   * scores on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     accumulate), Q's A fragments loaded once into registers, K as the
//     B operand by ldmatrix from the swizzled tile, each n-tile summed in
//     two chains; softmax on the score fragments by quad shuffles (exp2,
//     the scale times log2 e folded in);
//   * PV on the tensor cores: P from the accumulators to bf16 A
//     fragments in registers; V as the B operand by ldmatrix.trans;
//   * int8: K's codes are read 16 bytes a lane and converted into bf16 B
//     fragments in registers, with the head dim permuted in each k-step
//     (Q's A fragments read in the same order); V's by 4-byte words of
//     four key rows, permuted into the B fragments of four n-tiles,
//     whose output columns the epilogue un-permutes. The conversion is a
//     byte permute into the f32 2^23 and a subtraction (i8_f32): exact,
//     on the full-rate ALUs;
//   * epilogue: each warp writes its O, rescaled to the block's m, into
//     its own slice of shared memory (the ring's bytes, rows padded so
//     the stores are free of bank conflicts); the key splits' slices are
//     summed, 16 bytes a thread. With one split that sum, divided by l,
//     is the output. Otherwise it is the block's partial (m, l, acc)
//     in global memory;
//   * the merge, folded in (merge_last), with a counter set a (slot, kv
//     head, row group): each block draws a ticket (atomicAdd) as it
//     starts, and once its partial is written counts it done (a barrier,
//     then a release add by thread 0). The blocks that drew the last
//     `mergers` tickets (1, or more on a grid of at most two blocks an
//     SM: 16 at gemma-2b's verify step) wait until all n_split partials
//     are done (an acquire load) and each folds them, for its share of
//     the rows, in split order (0, 1, ..., n_split-1) as an online
//     softmax does: m' = max(m, m_i), l = l 2^(m - m') + l_i 2^(m_i - m'),
//     acc likewise, out = acc / l (l == 0 gives 0). The fixed order makes
//     two calls on the same inputs bit-equal whichever block ends last.
//     The waits end: the last ticket goes to a running block that waits
//     only for blocks that drew theirs (and so run), and the plan keeps
//     the other mergers, which may wait for a block not yet started,
//     fewer than the SMs. The last merger resets the counters to 0, which
//     keeps them valid under CUDA-graph replay. The counters belong to
//     the caller's stream: the engine issues these calls on one stream,
//     one after another, so no two calls share a counter at once. A block
//     with no visible tile writes m = -1e30, l = 0 and a zero acc, which
//     weighs nothing.
//
// Host work per call: the two (four with a tail box) tensor maps are
// encoded once per (pool, rows, box rows) and the kernel's shared-memory
// attribute set once per size and device, then both are looked up; one
// launch a call.
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// Shared memory a block can use on Hopper.
constexpr size_t kSmemLimit = 227 * 1024;

namespace verify {

// Page rows a ring stage holds at most: a page of up to 64 rows is one
// tile, a longer one several.
constexpr int kTileRows = 64;
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;

// A [rows, D] tile of KV in shared memory: D / kCols panels of
// rows x kRowBytes, as TMA writes them: 128-byte rows under the 128-byte
// swizzle (bf16: 64 columns; int8: 128 columns), or int8 at D = 64:
// 64-byte rows under the 64-byte swizzle.
template <typename KV, int D>
struct Tile {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kCols = kQuant ? (D < 128 ? D : 128) : 64;
  static constexpr int kRowBytes = kCols * static_cast<int>(sizeof(KV));
  static constexpr int kPanels = D / kCols;
  // f32 row pitch of the epilogue's per-warp O slices: the pad keeps the
  // fragments' stores free of bank conflicts (bf16: float2 stores of
  // columns 2qd; int8: float4 stores of columns 8qd).
  static constexpr int kOPitch = D + (kQuant ? 4 : 8);
};

// bf16 row pitch of the staged queries: rows 16 bytes apart in banks.
__host__ __device__ constexpr int q_pitch(int d) { return d + 8; }

// Bytes of one ring stage: K and V tiles, then (int8) their scales.
__host__ __device__ inline int stage_bytes(int d, bool quant, int rows) {
  const int b = 2 * rows * d * (quant ? 1 : 2) + (quant ? 2 * rows * 4 : 0);
  return (b + 1023) / 1024 * 1024;
}

// Bytes of the ring and the staged queries [m_tiles * 16, q_pitch] bf16,
// and of the epilogue's per-warp O slices [warps, 16, kOPitch] f32, which
// reuse them after the walk.
__host__ __device__ inline size_t walk_bytes(int d, bool quant, int rows,
                                             int stages, int m_tiles) {
  return size_t(stages) * stage_bytes(d, quant, rows) +
         size_t(m_tiles) * 16 * q_pitch(d) * 2;
}

__host__ __device__ inline size_t slice_bytes(int d, bool quant,
                                              int warps) {
  return size_t(warps) * 16 * (d + (quant ? 4 : 8)) * 4;
}

// A block's dynamic shared memory (ops/paged_attention.py verify_plan
// computes the same): 1024 bytes to align the ring, the larger of
// walk_bytes and slice_bytes, the warps' (m, l) for 16 rows each, one
// mbarrier a stage, and 16 bytes for the block's ticket.
__host__ __device__ inline size_t smem_bytes(int d, bool quant, int rows,
                                             int stages, int m_tiles,
                                             int warps) {
  const size_t walk = walk_bytes(d, quant, rows, stages, m_tiles);
  const size_t slices = slice_bytes(d, quant, warps);
  return 1024 + (walk > slices ? walk : slices) +
         2 * size_t(warps) * 16 * 4 + size_t(stages) * 8 + 16;
}

// Byte offset of (row, byte) in one panel of kRowBytes-byte rows under
// TMA's swizzle: bits 4-6 (4-5) of the address XOR bits 7-9 (7-8).
template <int kRowBytes>
__device__ __forceinline__ int tile_off(int row, int byte) {
  const int a = row * kRowBytes + byte;
  return a ^ (((a >> 7) & (kRowBytes == 128 ? 7 : 3)) << 4);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(skyt::smem_u32(p)));
}

// TMA: the box of the 2-d `map` at (c0, c1) into shared memory, counted
// on `bar`.
__device__ __forceinline__ void tma_load_2d(void *dst, const CUtensorMap *map,
                                            uint64_t *bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(skyt::smem_u32(dst)),
      "l"(map), "r"(skyt::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 1-d bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), counted on `bar`.
__device__ __forceinline__ void bulk_load(void *dst, const void *src,
                                          int bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(skyt::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(skyt::smem_u32(bar))
      : "memory");
}

// int8 codes to bf16 on the full-rate ALUs (the I2F and F2F
// conversions run at a quarter of their rate): byte b of `biased`
// (w ^ 0x80808080, so x + 128) under the f32 2^23 is 2^23 + x + 128,
// less 2^23 + 128 gives x exactly.
__device__ __forceinline__ float i8_f32(uint32_t biased, int b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + b)) -
         8388736.f;
}

// Two f32 that hold small integers as a bf16 pair (lo in the low half):
// their high halves, exact since their low halves are 0.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

struct Params {
  const bf16 *q;
  const float *k_scale, *v_scale;
  const int *tables, *lengths;
  bf16 *out;                   // [S, T, Hq, D]
  float *part_acc, *part_ml;   // [S, Hkv, n_split, R, D], [..., R, 2]
  int *tickets;                // [3, S, Hkv, n_mgroups], 0 between calls
  int t_count, hq, hkv, page_size, mp, n_split, m_tiles, n_mgroups,
      key_splits, tile_rows, tail_rows, stages, mergers;
  float scale_log2;   // d^-0.5 * log2(e)
};

// The pools' maps: boxes of tile_rows rows, and of tail_rows rows for the
// last tile of a page that tile_rows does not divide (the same maps
// otherwise).
struct Maps {
  CUtensorMap k, v, k_tail, v_tail;
};

// The tiles one block walks, in order: pages j = split, split + n_split,
// ... that the skip rule keeps, and of each page its tiles that start at
// a position some token of the slot sees.
struct Walk {
  int j, st;
  __device__ __forceinline__ bool next(const int *trow, int n_visit,
                                       int n_split, int page_size,
                                       int tile_rows, int last) {
    ++st;
    while (j < n_visit) {
      if ((j == 0 || trow[j] != 0) && st * tile_rows < page_size &&
          j * page_size + st * tile_rows <= last)
        return true;
      j += n_split;
      st = 0;
    }
    return false;
  }
};

template <int D, typename KV>
__device__ __forceinline__ void issue_tile(const Params &p, const Maps &maps,
                                           const int *trow, const Walk &w,
                                           int hk, uint8_t *dst,
                                           uint64_t *bar) {
  using L = Tile<KV, D>;
  const int tr = p.tile_rows;
  const int kv_tile = tr * D * static_cast<int>(sizeof(KV));
  const int row0 = (trow[w.j] * p.hkv + hk) * p.page_size + w.st * tr;
  const int valid = min(tr, p.page_size - w.st * tr);   // the page's rows
  const bool tail = valid < tr && p.tail_rows != tr;
  const int box = tail ? p.tail_rows : tr;
  const bool bulk = L::kQuant && p.page_size % 4 == 0;
  skyt::mbar_expect_tx(bar, 2 * box * D * static_cast<int>(sizeof(KV)) +
                                (bulk ? 2 * valid * 4 : 0));
  const CUtensorMap *km = tail ? &maps.k_tail : &maps.k;
  const CUtensorMap *vm = tail ? &maps.v_tail : &maps.v;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
    tma_load_2d(dst + pn * tr * L::kRowBytes, km, bar, pn * L::kCols, row0);
    tma_load_2d(dst + kv_tile + pn * tr * L::kRowBytes, vm, bar,
                pn * L::kCols, row0);
  }
  if (bulk) {
    bulk_load(dst + 2 * kv_tile, p.k_scale + row0, valid * 4, bar);
    bulk_load(dst + 2 * kv_tile + tr * 4, p.v_scale + row0, valid * 4, bar);
  }
}

// Four output columns c .. c+3 of the block's row rr (token rr / G) as
// bf16.
template <int D>
__device__ __forceinline__ void store_out(const Params &p, int s, int hk,
                                          int rr, int c, float4 v) {
  const int g_count = p.hq / p.hkv;
  const int t = rr / g_count;
  uint2 w;
  w.x = skyt::pack_bf16(v.x, v.y);
  w.y = skyt::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2 *>(
      p.out + ((static_cast<long long>(s) * p.t_count + t) * p.hq +
               hk * g_count + rr - t * g_count) * D + c) = w;
}

// Output items (four columns of a row) a merging thread takes at once.
constexpr int kMergeItems = 4;

// Counter `which` of this block's (slot, kv head, row group), the groups'
// counters one after another: 0, the tickets, drawn as blocks start; 1,
// the partials written; 2, the mergers done waiting.
__device__ __forceinline__ int *counter(const Params &p, int which) {
  return p.tickets + (which * gridDim.x + blockIdx.x) * gridDim.y +
         blockIdx.y;
}

// After this block's partial of rows r0 .. r0 + rows is in global memory:
// the block counts its partial done (a release add). The blocks that drew
// the group's last `mergers` tickets (ticket >= n_split - mergers) then
// wait until all n_split partials are done (an acquire load) and each
// merges its share of the rows into the output; the others exit. The
// waits end: a block holds a ticket once it runs, so the last ticket's
// holder waits only for running blocks, and the plan keeps the mergers
// that could wait for a block not yet started below the SMs (mergers *
// groups < SMs), so that block always finds a place to run.
template <int D>
__device__ __forceinline__ void merge_last(const Params &p, int s, int hk,
                                           int r0, int rows, int ticket) {
  const int tid = threadIdx.x;
  __syncthreads();   // the block's partial is written
  // Release, cumulative over the barrier: the partial before the count.
  if (tid == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(
                     counter(p, 1))
                 : "memory");
  const int merger = ticket - (p.n_split - p.mergers);
  if (merger < 0) return;
  if (tid == 0) {
    int n = 0;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(n)
                   : "l"(counter(p, 1))
                   : "memory");
    } while (n < p.n_split);
  }
  __syncthreads();   // every partial is visible
  const int ra = merger * rows / p.mergers;
  r0 += ra;
  rows = (merger + 1) * rows / p.mergers - ra;
  // Each item folds the n_split partials in split order, as an online
  // softmax does: m' = max(m, m_i), l = l 2^(m - m') + l_i 2^(m_i - m'),
  // acc the same; out = acc / l (l == 0 gives 0). A block with no
  // visible tile left l_i = 0 and a zero acc. The loads (L2: other SMs
  // wrote them) wait on nothing, so a thread's kMergeItems items x 4
  // splits issue together; an item past the end repeats the last.
  constexpr int kCols4 = D / 4;
  const int rows_all = p.t_count * (p.hq / p.hkv);
  const long long base =
      (static_cast<long long>(s) * p.hkv + hk) * p.n_split * rows_all + r0;
  const float2 *ml = reinterpret_cast<const float2 *>(p.part_ml) + base;
  const float4 *acc =
      reinterpret_cast<const float4 *>(p.part_acc + base * D);
  const int n_items = rows * kCols4;
  const int step = static_cast<int>(blockDim.x);
  for (int i0 = tid; i0 < n_items; i0 += kMergeItems * step) {
    int row[kMergeItems], item[kMergeItems];
    float m[kMergeItems], l[kMergeItems];
    float4 a[kMergeItems];
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      item[u] = min(i0 + u * step, n_items - 1);
      row[u] = item[u] / kCols4;
      m[u] = skyt::kNegInf;
      l[u] = 0.f;
      a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int k = 0; k < p.n_split; ++k) {
#pragma unroll
      for (int u = 0; u < kMergeItems; ++u) {
        const float2 v = __ldcg(ml + k * rows_all + row[u]);
        const float4 x = __ldcg(
            acc + static_cast<long long>(k) * rows_all * kCols4 + item[u]);
        const float m_new = fmaxf(m[u], v.x);
        const float c_old = skyt::ex2(m[u] - m_new);
        const float c_new = skyt::ex2(v.x - m_new);
        m[u] = m_new;
        l[u] = l[u] * c_old + v.y * c_new;
        a[u].x = a[u].x * c_old + x.x * c_new;
        a[u].y = a[u].y * c_old + x.y * c_new;
        a[u].z = a[u].z * c_old + x.z * c_new;
        a[u].w = a[u].w * c_old + x.w * c_new;
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int i = i0 + u * step;
      const float il = l[u] > 0.f ? 1.f / l[u] : 0.f;
      if (i < n_items)
        store_out<D>(p, s, hk, r0 + i / kCols4, i % kCols4 * 4,
                     make_float4(a[u].x * il, a[u].y * il, a[u].z * il,
                                 a[u].w * il));
    }
  }
  // The last merger to get here leaves the counters at 0 for the next
  // call: every block has drawn its ticket and counted its partial, and
  // every merger is past its wait.
  if (tid == 0 && atomicAdd(counter(p, 2), 1) == p.mergers - 1) {
    *counter(p, 0) = 0;
    *counter(p, 1) = 0;
    *counter(p, 2) = 0;
  }
}

template <int D, typename KV>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_verify(const Params p, const __grid_constant__ Maps maps) {
  using L = Tile<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kNT = D / 8;     // n-tiles of O
  constexpr int kKS = D / 16;    // k-steps of the scores
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = reinterpret_cast<uint8_t *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tr = p.tile_rows;
  const int sbytes = stage_bytes(D, kQuant, tr);
  const int kv_tile = tr * D * static_cast<int>(sizeof(KV));
  const int warps = p.m_tiles * p.key_splits;
  const size_t walk_b =
      walk_bytes(D, kQuant, tr, p.stages, p.m_tiles);
  const size_t slice_b = slice_bytes(D, kQuant, warps);
  bf16 *qs = reinterpret_cast<bf16 *>(smem + size_t(p.stages) * sbytes);
  float *wm = reinterpret_cast<float *>(
      smem + (walk_b > slice_b ? walk_b : slice_b));         // [warps, 16]
  float *wl = wm + warps * 16;                              // [warps, 16]
  uint64_t *full = reinterpret_cast<uint64_t *>(wl + warps * 16);
  int *ticket_at = reinterpret_cast<int *>(full + p.stages);

  const int s = blockIdx.x;
  const int hk = blockIdx.y / p.n_mgroups;
  const int mgroup = blockIdx.y % p.n_mgroups;
  const int r0 = mgroup * p.m_tiles * 16;
  const int split = blockIdx.z;
  const int g_count = p.hq / p.hkv;
  const int rows_all = p.t_count * g_count;
  const int rows = min(p.m_tiles * 16, rows_all - r0);   // written rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp / p.key_splits, kslice = warp % p.key_splits;
  const int g = lane / 4, qd = lane % 4;
  const bool single = p.n_split == 1;   // the block's sum is the output

  const int pos = p.lengths[s];   // the first token's position
  const int last = pos + p.t_count - 1;
  const int n_visit = pos < 0 ? 0 : min(p.mp, last / p.page_size + 1);
  const int *trow = p.tables + static_cast<long long>(s) * p.mp;
  const long long part =
      ((static_cast<long long>(s) * p.hkv + hk) * p.n_split + split) *
          rows_all + r0;

  // The block's ticket, drawn as it starts by its last thread (thread 0
  // issues the tiles), read after the walk's barriers.
  if (!single && tid == blockDim.x - 1)
    *ticket_at = atomicAdd(counter(p, 0), 1);

  Walk walk{split, -1};
  if (!walk.next(trow, n_visit, p.n_split, p.page_size, tr, last)) {
    // No visible tile: zeros, or a partial the merge weighs 0.
    if (single) {
      for (int i = tid; i < rows * (D / 4); i += blockDim.x)
        store_out<D>(p, s, hk, r0 + i / (D / 4), i % (D / 4) * 4,
                     make_float4(0.f, 0.f, 0.f, 0.f));
      return;
    }
    for (int r = tid; r < rows; r += blockDim.x)
      reinterpret_cast<float2 *>(p.part_ml)[part + r] =
          make_float2(skyt::kNegInf, 0.f);
    for (int i = tid; i < rows * (D / 4); i += blockDim.x)
      reinterpret_cast<float4 *>(p.part_acc + part * D)[i] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    merge_last<D>(p, s, hk, r0, rows, *ticket_at);
    return;
  }

  // The block's query rows, 16 bytes a thread and load (zero past R),
  // issued before the pages' loads so as not to queue behind them.
  constexpr int kQChunks = D / 8;    // 16-byte chunks a row
  constexpr int kQLoads = D / 16;    // a thread's at most (warps >= m_tiles)
  const int q_total = p.m_tiles * 16 * kQChunks;
  uint4 qv[kQLoads];
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = tid + u * blockDim.x;
    const int rr = r0 + i / kQChunks;
    qv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < q_total && rr < rows_all) {
      const int t = rr / g_count;
      qv[u] = __ldg(reinterpret_cast<const uint4 *>(
                  p.q + ((static_cast<long long>(s) * p.t_count + t) * p.hq +
                         hk * g_count + rr - t * g_count) * D) +
              i % kQChunks);
    }
  }

  // The ring: thread 0 issues the first `stages` tiles at once. Over int8
  // pages whose scales come by bulk copies and whose last tile is short,
  // it first zeroes, in every stage, the scale slots that tile's copies
  // leave as they were (so no stage's first use reads unset bytes).
  const bool scale_bulk = kQuant && p.page_size % 4 == 0;
  Walk ahead = walk;   // the last tile issued
  if (tid == 0) {
    const int last_rows = p.page_size - (p.page_size - 1) / tr * tr;
    if (scale_bulk && last_rows < tr) {
      for (int st = 0; st < p.stages; ++st) {
        float *sc =
            reinterpret_cast<float *>(smem + st * sbytes + 2 * kv_tile);
        for (int i = last_rows; i < tr; ++i) sc[i] = sc[tr + i] = 0.f;
      }
      skyt::fence_async_smem();   // before the copies into the same bytes
    }
    for (int i = 0; i < p.stages; ++i) skyt::mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_tile<D, KV>(p, maps, trow, ahead, hk, smem, &full[0]);
    for (int i = 1; i < p.stages; ++i) {
      if (!ahead.next(trow, n_visit, p.n_split, p.page_size, tr, last))
        break;
      issue_tile<D, KV>(p, maps, trow, ahead, hk, smem + i * sbytes,
                        &full[i]);
    }
  }

  // The queries into shared memory (rows q_pitch apart).
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = tid + u * blockDim.x;
    if (i < q_total)
      *reinterpret_cast<uint4 *>(qs + i / kQChunks * q_pitch(D) +
                                 i % kQChunks * 8) = qv[u];
  }
  int lim[2];   // row h of this thread sees positions <= lim[h]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + mt * 16 + g + 8 * h;
    lim[h] = rr < rows_all ? pos + rr / g_count : pos;
  }
  __syncthreads();   // the mbarriers are initialised, the queries staged

  // Q's A fragments for this warp's m-tile, kept in registers: rows g and
  // g + 8. int8 pages permute the head dim of each k-step as the K
  // fragments below do.
  uint32_t qa[kKS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bf16 *qrow = qs + (mt * 16 + g + 8 * h) * q_pitch(D);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      int d0, d1;   // columns of k 2qd..2qd+1 and 2qd+8..2qd+9
      if constexpr (kQuant) {
        constexpr int kPer = L::kCols / 16;
        d0 = ks / kPer * L::kCols + qd * (L::kCols / 4) + 4 * (ks % kPer);
        d1 = d0 + 2;
      } else {
        d0 = 16 * ks + 2 * qd;
        d1 = d0 + 8;
      }
      qa[ks][h] = *reinterpret_cast<const uint32_t *>(qrow + d0);
      qa[ks][2 + h] = *reinterpret_cast<const uint32_t *>(qrow + d1);
    }
  }

  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {skyt::kNegInf, skyt::kNegInf}, l_run[2] = {0.f, 0.f};

  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, its row
  int n = 0;
  do {
    const int stage = n % p.stages;
    skyt::mbar_wait(&full[stage], (n / p.stages) & 1);
    const uint8_t *kt = smem + stage * sbytes;
    const uint8_t *vt = kt + kv_tile;
    const int k0 = walk.j * p.page_size + walk.st * tr;
    // Keys >= valid lie past the page's end: masked like the positions a
    // row cannot see (their int8 scales are finite: 0, or an earlier
    // tile's).
    const int valid = min(tr, p.page_size - walk.st * tr);
    const bool ragged = valid < tr;
    const int chunks = (ragged ? p.tail_rows : tr) / 16;
    const bool masked = ragged || k0 + tr - 1 > pos;   // some key masked
    const int lim_t[2] = {min(lim[0], k0 + valid - 1),
                          min(lim[1], k0 + valid - 1)};
    [[maybe_unused]] float *ksc =
        reinterpret_cast<float *>(smem + stage * sbytes + 2 * kv_tile);
    [[maybe_unused]] float *vsc = ksc + tr;
    if constexpr (kQuant) {
      if (!scale_bulk) {   // this tile's scales, by plain loads
        const long long row0 =
            static_cast<long long>(trow[walk.j] * p.hkv + hk) *
                p.page_size + walk.st * tr;
        for (int i = tid; i < 2 * tr; i += blockDim.x) {
          const int k = i % tr;
          (i < tr ? ksc : vsc)[k] =
              k < valid ? (i < tr ? p.k_scale : p.v_scale)[row0 + k] : 0.f;
        }
        __syncthreads();
      }
    }

    for (int c = kslice; c < chunks; c += p.key_splits) {
      // S [16 rows, 16 keys] = Q K^T: two n-tiles of 8 keys, each summed
      // in two chains (even and odd k-steps) to halve the mma latency
      // chain.
      float acc2[2][2][4] = {};
      if constexpr (!kQuant) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t b[4];
          const int row = c * 16 + (mi >> 1) * 8 + r8;
          const int chunk = 2 * ks + (mi & 1);
          skyt::ldmatrix_x4(b, kt + (chunk >> 3) * tr * 128 +
                                   tile_off<128>(row, (chunk & 7) * 16));
          mma(acc2[0][ks & 1], qa[ks], b[0], b[1]);
          mma(acc2[1][ks & 1], qa[ks], b[2], b[3]);
        }
      } else {
        constexpr int kPer = L::kCols / 16;   // k-steps a panel
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int row = c * 16 + nt * 8 + g;
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
            for (int h = 0; h < L::kCols / 64; ++h) {
              const uint4 w = *reinterpret_cast<const uint4 *>(
                  kt + pn * tr * L::kRowBytes +
                  tile_off<L::kRowBytes>(row,
                                         qd * (L::kCols / 4) + 16 * h));
              const uint32_t ws[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                      w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int ks = pn * kPer + 4 * h + e;
                mma(acc2[nt][e & 1], qa[ks],
                    bf16_pair(i8_f32(ws[e], 0), i8_f32(ws[e], 1)),
                    bf16_pair(i8_f32(ws[e], 2), i8_f32(ws[e], 3)));
              }
            }
          }
        }
      }
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = acc2[nt][0][e] + acc2[nt][1][e];

      // Online softmax on the fragments: lane holds keys 2qd, 2qd+1 of
      // each n-tile for rows g (elements 0, 1) and g + 8 (2, 3).
      float mx[2] = {skyt::kNegInf, skyt::kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c * 16 + nt * 8 + 2 * qd + (e & 1);
          float v = sc[nt][e] * p.scale_log2;
          if constexpr (kQuant) v *= ksc[key];
          if (masked && k0 + key > lim_t[e >> 1]) v = skyt::kNegInf;
          sc[nt][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = skyt::ex2(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      float pv[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = skyt::ex2(sc[nt][e] - m_run[e >> 1]);
          sum[e >> 1] += pe;
          pv[nt][e] = pe;
          if constexpr (kQuant)
            pv[nt][e] *= vsc[c * 16 + nt * 8 + 2 * qd + (e & 1)];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = alpha[h] * l_run[h] + sum[h];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
      // P as the A fragment of PV (keys of the chunk are its k).
      const uint32_t pa[4] = {skyt::pack_bf16(pv[0][0], pv[0][1]),
                              skyt::pack_bf16(pv[0][2], pv[0][3]),
                              skyt::pack_bf16(pv[1][0], pv[1][1]),
                              skyt::pack_bf16(pv[1][2], pv[1][3])};

      // O [16, D] += P V.
      if constexpr (!kQuant) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b[4];
          const int row = c * 16 + (mi & 1) * 8 + r8;
          const int chunk = 2 * np + (mi >> 1);
          ldmatrix_x4_trans(b, vt + (chunk >> 3) * tr * 128 +
                                   tile_off<128>(row, (chunk & 7) * 16));
          mma(o[2 * np], pa, b[0], b[1]);
          mma(o[2 * np + 1], pa, b[2], b[3]);
        }
      } else {
        const int row = c * 16 + 2 * qd;
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn) {
          const uint8_t *vp = vt + pn * tr * L::kRowBytes;
#pragma unroll
          for (int a = 0; a < L::kCols / 32; ++a) {
            const int col = 32 * a + 4 * g;
            uint32_t w[4];   // key rows 2qd, 2qd + 1, 2qd + 8, 2qd + 9
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w[i] = *reinterpret_cast<const uint32_t *>(
                         vp + tile_off<L::kRowBytes>(row + (i & 1) +
                                                     8 * (i >> 1), col)) ^
                     0x80808080u;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mma(o[pn * (L::kCols / 8) + 4 * a + e], pa,
                  bf16_pair(i8_f32(w[0], e), i8_f32(w[1], e)),
                  bf16_pair(i8_f32(w[2], e), i8_f32(w[3], e)));
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (tid == 0 &&
        ahead.next(trow, n_visit, p.n_split, p.page_size, tr, last))
      issue_tile<D, KV>(p, maps, trow, ahead, hk, smem + stage * sbytes,
                        &full[stage]);
    ++n;
  } while (walk.next(trow, n_visit, p.n_split, p.page_size, tr, last));

  // Merge the key splits' states of each m-tile; the ring is free (every
  // issued tile was consumed).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (qd == 0) {
      wm[warp * 16 + g + 8 * h] = m_run[h];
      wl[warp * 16 + g + 8 * h] = l_run[h];
    }
  }
  __syncthreads();
  float f[2], m_blk[2], l_blk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    float mm = skyt::kNegInf;
    for (int k = 0; k < p.key_splits; ++k)
      mm = fmaxf(mm, wm[(mt * p.key_splits + k) * 16 + r]);
    float ll = 0.f;
    for (int k = 0; k < p.key_splits; ++k)
      ll += wl[(mt * p.key_splits + k) * 16 + r] *
            skyt::ex2(wm[(mt * p.key_splits + k) * 16 + r] - mm);
    m_blk[h] = mm;
    l_blk[h] = ll;
    f[h] = skyt::ex2(m_run[h] - mm);
    if (single) f[h] = ll > 0.f ? f[h] / ll : 0.f;
  }
  // Each warp's O, rescaled to the block's m (and divided by l with one
  // split), into its own slice; then the key splits' slices are summed
  // into the partial or the output, 16 bytes a thread.
  float *slices = reinterpret_cast<float *>(smem);   // [warps, 16, pitch]
  constexpr int kPitch = L::kOPitch;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float *srow = slices + (warp * 16 + g + 8 * h) * kPitch;
    if constexpr (!kQuant) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2 *>(srow + 8 * nt + 2 * qd) =
            make_float2(o[nt][2 * h] * f[h], o[nt][2 * h + 1] * f[h]);
    } else {
      // n-tile 4a + e of panel pn holds columns 32a + 4n + e: this
      // lane's 8 columns 32a + 8qd .. + 7 of each group a.
      constexpr int kPer = L::kCols / 8;
#pragma unroll
      for (int nt0 = 0; nt0 < kNT; nt0 += 4) {
        const int col = nt0 / kPer * L::kCols + 32 * (nt0 % kPer / 4) +
                        8 * qd;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float4 *>(srow + col + 4 * c) = make_float4(
              o[nt0][2 * h + c] * f[h], o[nt0 + 1][2 * h + c] * f[h],
              o[nt0 + 2][2 * h + c] * f[h], o[nt0 + 3][2 * h + c] * f[h]);
      }
    }
  }
  if (!single && kslice == 0 && qd == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r < rows)   // m in log2 units, as merge_last reads it
        reinterpret_cast<float2 *>(p.part_ml)[part + r] =
            make_float2(m_blk[h], l_blk[h]);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const float *src = slices + ((r / 16) * p.key_splits * 16 + r % 16) *
                                    kPitch + c;
    float4 sum = *reinterpret_cast<const float4 *>(src);
    for (int k = 1; k < p.key_splits; ++k) {
      const float4 v = *reinterpret_cast<const float4 *>(src +
                                                         k * 16 * kPitch);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (single)
      store_out<D>(p, s, hk, r0 + r, c, sum);
    else
      *reinterpret_cast<float4 *>(p.part_acc + (part + r) * D + c) = sum;
  }
  if (!single) merge_last<D>(p, s, hk, r0, rows, *ticket_at);
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *lengths;
  void *out, *part_acc, *part_ml, *tickets;
  int slots, t_count, hq, hkv, page_size, n_pages, mp, n_split, m_tiles,
      n_mgroups, key_splits, tile_rows, tail_rows, stages, mergers;
  float scale;
};

// The 2-d map of a pool viewed as [rows, D] with boxes of kCols x
// box_rows, swizzled as Tile says.
template <typename KV, int D>
bool encode_pool(CUtensorMap *map, const void *base, long long rows,
                 int box_rows) {
  using L = Tile<KV, D>;
  const PFN_cuTensorMapEncodeTiled_v12000 fn = skyt::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * sizeof(KV)};
  const cuuint32_t box[2] = {cuuint32_t(L::kCols), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void *>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct MapKey {
  const void *base;
  long long rows;
  int box_rows;
  bool operator==(const MapKey &o) const {
    return base == o.base && rows == o.rows && box_rows == o.box_rows;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey &k) const {
    return std::hash<const void *>()(k.base) ^
           (std::hash<long long>()(k.rows) * 31) ^
           (static_cast<size_t>(k.box_rows) << 20);
  }
};

// encode_pool, once per (pool, rows, box rows) of each (KV, D): a layer
// call looks its maps up instead of encoding them.
template <typename KV, int D>
bool pool_map(CUtensorMap *map, const void *base, long long rows,
              int box_rows) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{base, rows, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_pool<KV, D>(map, base, rows, box_rows)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// The kernel's dynamic shared-memory limit, raised once per device to the
// largest size asked for.
template <int D, typename KV>
cudaError_t allow_smem(int bytes) {
  constexpr int kDevices = 64;
  static std::atomic<int> allowed[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_decode_verify<D, KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kDevices) {
    int cur = allowed[dev].load();
    while (cur < bytes && !allowed[dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

template <int D, typename KV>
int launch(const Args &a, cudaStream_t stream) {
  using L = Tile<KV, D>;
  const long long pool_rows =
      static_cast<long long>(a.n_pages) * a.hkv * a.page_size;
  Maps maps;
  if (pool_rows >= (1LL << 31) ||
      !pool_map<KV, D>(&maps.k, a.k_pool, pool_rows, a.tile_rows) ||
      !pool_map<KV, D>(&maps.v, a.v_pool, pool_rows, a.tile_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.tail_rows == a.tile_rows) {
    maps.k_tail = maps.k;
    maps.v_tail = maps.v;
  } else if (!pool_map<KV, D>(&maps.k_tail, a.k_pool, pool_rows,
                              a.tail_rows) ||
             !pool_map<KV, D>(&maps.v_tail, a.v_pool, pool_rows,
                              a.tail_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = a.m_tiles * a.key_splits;
  const size_t bytes = smem_bytes(D, L::kQuant, a.tile_rows, a.stages,
                                  a.m_tiles, warps);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<D, KV>(static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const bf16 *>(a.q),
                 static_cast<const float *>(a.k_scale),
                 static_cast<const float *>(a.v_scale),
                 static_cast<const int *>(a.tables),
                 static_cast<const int *>(a.lengths),
                 static_cast<bf16 *>(a.out),
                 static_cast<float *>(a.part_acc),
                 static_cast<float *>(a.part_ml),
                 static_cast<int *>(a.tickets),
                 a.t_count, a.hq, a.hkv, a.page_size, a.mp, a.n_split,
                 a.m_tiles, a.n_mgroups, a.key_splits, a.tile_rows,
                 a.tail_rows, a.stages, a.mergers,
                 a.scale * 1.4426950408889634f};
  paged_decode_verify<D, KV>
      <<<dim3(a.slots, a.hkv * a.n_mgroups, a.n_split), warps * 32, bytes,
         stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch_d(const Args &a, int d, cudaStream_t stream) {
  if (d == 64) return launch<64, KV>(a, stream);
  if (d == 128) return launch<128, KV>(a, stream);
  if (d == 256) return launch<256, KV>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace verify

}  // namespace

SKYT_DEFINE_ERROR_STRING

// Dynamic shared memory of a block (ops/paged_attention.py verify_plan
// holds the same number).
extern "C" int skyt_paged_verify_smem(int d, int kv_int8, int tile_rows,
                                      int stages, int m_tiles,
                                      int key_splits) {
  return static_cast<int>(verify::smem_bytes(d, kv_int8 != 0, tile_rows,
                                             stages, m_tiles,
                                             m_tiles * key_splits));
}

// T query tokens a slot (T = 1: a decode step; T > 1: the verify step).
// q [S, T, Hq, D] bf16 contiguous, token t at position lengths[s] + t;
// k_pool/v_pool [n_pages, Hkv, P, D] contiguous (one layer), bf16, or
// int8 when kv_int8 != 0 with k_scale/v_scale [n_pages, Hkv, P] f32
// contiguous (else ignored); tables [S, mp] int32; lengths [S] int32;
// out [S, T, Hq, D] bf16; D is 64, 128 or 256. With n_split > 1:
// part_acc f32 [S, Hkv, n_split, R, D] and part_ml f32
// [S, Hkv, n_split, R, 2] scratch (R = T*Hq/Hkv) and tickets int32
// [3, S, Hkv, n_mgroups], 0 before the first call and left 0 by each;
// with n_split == 1 these three are not touched. The plan (ops/
// paged_attention.py verify_plan): n_split blocks a (slot, kv head, row
// group), n_mgroups row groups of m_tiles 16-row tiles, key_splits warps
// an m-tile, pages cut into tiles of tile_rows rows, the last tile of a
// page tail_rows rows (its page rows rounded up to 16), a ring of
// `stages`, `mergers` blocks a group sharing the merge. Returns
// cudaErrorInvalidValue on a plan the kernel cannot run.
extern "C" int skyt_paged_verify(
    const void *q, const void *k_pool, const void *v_pool,
    const void *k_scale, const void *v_scale, const void *tables,
    const void *lengths, void *out, void *part_acc, void *part_ml,
    void *tickets, int slots, int t_count, int hq, int hkv, int d,
    int page_size, int n_pages, int mp, int n_split, int m_tiles,
    int n_mgroups, int key_splits, int tile_rows, int tail_rows, int stages,
    int mergers, int kv_int8, float scale, void *stream) {
  const int rows = hkv > 0 ? t_count * (hq / hkv) : 0;
  const int tiles = tile_rows > 0 ? (page_size + tile_rows - 1) / tile_rows
                                  : 0;
  const int last_rows = page_size - (tiles - 1) * tile_rows;
  if (hkv <= 0 || hq % hkv != 0 || t_count < 1 || slots < 1 || mp < 1 ||
      n_split < 1 || n_split > 65535 || m_tiles < 1 || n_mgroups < 1 ||
      key_splits < 1 || m_tiles * key_splits > verify::kMaxWarps ||
      m_tiles * n_mgroups * 16 < rows ||
      (n_mgroups - 1) * m_tiles * 16 >= rows ||
      static_cast<long long>(hkv) * n_mgroups > 65535 || page_size < 1 ||
      tile_rows < 16 || tile_rows % 16 != 0 ||
      tile_rows > verify::kTileRows ||
      tail_rows != (last_rows + 15) / 16 * 16 || tail_rows > tile_rows ||
      stages < 1 || mergers < 1 || mergers > n_split ||
      mergers > rows - (n_mgroups - 1) * m_tiles * 16 || out == nullptr ||
      (n_split > 1 &&
       (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const verify::Args a{q,          k_pool,    v_pool,    k_scale,
                       v_scale,    tables,    lengths,   out,
                       part_acc,   part_ml,   tickets,   slots,
                       t_count,    hq,        hkv,       page_size,
                       n_pages,    mp,        n_split,   m_tiles,
                       n_mgroups,  key_splits, tile_rows, tail_rows,
                       stages,     mergers,   scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? verify::launch_d<int8_t>(a, d, st)
                 : verify::launch_d<bf16>(a, d, st);
}
