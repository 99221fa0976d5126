// Paged decode attention for Hopper (sm_90a): bf16 queries, bf16 or int8
// KV pages, f32 accumulate.
//
// Two kernels replace the four TPU kernels of
// skypilot_tpu/ops/paged_attention.py:
//   paged_decode_split (T = 1, one query a slot):
//     bf16 pages      :50  _kernel      (paged_decode_attention)
//     int8 pages      :150 _kernel_q    (paged_decode_attention_q)
//   paged_decode_verify (T > 1, the speculative verify step):
//     bf16 pages      :98  _kernel_mq   (paged_decode_attention_mq)
//     int8 pages      :210 _kernel_mq_q (paged_decode_attention_mq_q)
// and one merge pass (paged_decode_merge) serves both.
// Each slot has T consecutive query tokens, token t at position
// lengths[s] + t, and attends that slot's KV pages, found through the
// block table, with an online softmax over the pages. Token t sees the
// keys at positions <= lengths[s] + t. Row r = t*G + g of a kv head's
// R = T*G query rows is token t, query head hk*G + g.
//
// What bounds them on this card: memory bandwidth. Each layer call must
// read every visible K and V row once, 2*Hkv*d*2 B*sum_s(lengths[s]+T)
// bytes from bf16 pages or (2*Hkv*d*1 B + 2*Hkv*4 B)*sum_s(lengths[s]+T)
// from int8 pages with their f32 scales, against 3.35 TB/s; a (kv head,
// page) pair does 2*R*P*d flops a product for its 2*P*d*2 bytes, R
// flops a byte (16 at llama3-8b's verify step), far below the
// tensor-core ridge.
//
// Both kernels split each (slot, kv head) walk over several blocks and
// write per-block softmax partials (m, l, acc); paged_decode_merge, one
// block per (slot, kv head, query row), merges them:
// m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
// out = acc / l, and l == 0 gives 0.
//
// Shared rules, exactly the TPU kernels':
//   * skip rule: page j is walked iff j*P <= lengths[s] + T-1 and
//     (tables[s, j] != 0 or j == 0). A released slot (all-zero row,
//     stale length) reads only dummy page 0, and page indices never
//     leave the slot's row. Positions a row cannot see are masked with
//     -1e30; p is rounded to bf16 before PV, as the TPU kernel's
//     p.astype(v.dtype). A partial a row sees nothing of keeps finite
//     junk (m = -1e30), which the next visible key (alpha = 0) or the
//     merge (weight e^(-1e30 - m) = 0) drops: position 0 is visible to
//     every row;
//   * int8 pages: the codes convert to bf16 (or f32) exactly, as the TPU
//     kernel's cast to the query dtype; the key scale multiplies the
//     score, and the value scale multiplies p before PV, where
//     p * v_scale is rounded to bf16 (the TPU kernel's pd). The running
//     sum l takes the unscaled p.
//
// paged_decode_split (T = 1) runs on the CUDA cores: one block of 4
// warps per (slot, kv head, group of at most kGroupRows query rows, run
// of `pages_per_split` pages); warp w takes pages w, w+4, ... of the run
// and reads its page's K and V rows straight from the page-major pool
// into registers with 16-byte loads (K) and 2-16 byte loads (V), several
// rows in flight per lane:
//   - scores: d/16 lanes per token, 16 elements each, a 2-3 step
//     shuffle reduction per row; q comes from shared memory;
//   - softmax update per row over the page (warp reductions);
//   - PV: lane owns d/32 output columns for every row.
// The 4 warps' states are merged in shared memory. A group holds at most
// 4 rows, fewer when the grid would not give each SM two blocks
// (choose_group); with one query a slot the G rows of a kv head are
// 1-8, so the walk per row stays short.
//
// paged_decode_verify (T > 1) puts a kv head's rows on the tensor cores.
// The walk per row of the CUDA-core design made the verify step's
// R = 16-32 rows 16-48x the bound, and its 4-row groups read each page
// again per group. Here:
//   * one block per (slot, kv head, split) holds all R rows of the kv
//     group, padded to 16-row m-tiles (R = 4 -> 16, 32 -> two tiles)
//     with zero rows that are never written, so each visible K/V byte
//     comes from HBM once a call. R above 128 rows (8 m-tiles) takes
//     several row groups (grid y), each reading the pages again;
//   * the block's pages are j = split, split + n_split, ... (strided,
//     so a short slot's pages spread over its splits); the host picks
//     n_split from mp, slots * Hkv and the SM count (ops/
//     paged_attention.py verify_plan: about 4 pages a block, at least a
//     block an SM), and the tile rows (64, or 32 for a block of one
//     m-tile over bf16 pages at d = 256, so two such blocks fit an SM);
//   * async loads (issue_tile): pages arrive by TMA into a ring of
//     `stages` (2) tiles of K and V (and the int8 scales, by 1-d bulk
//     copies) on mbarriers. Thread 0 issues the first `stages` tiles
//     before any product and refills a stage as soon as the block is
//     done with it, so the next tile's bytes are in flight during the
//     current tile's products. A (page, kv head) block of the pool is
//     one contiguous run of P*d elements: a tile is a box of up to
//     kTileRows rows of the pool viewed as [n_pages*Hkv*P, d], at row
//     (tables[s, j]*Hkv + hk)*P (+ 64 per tile of a longer page). Pages
//     of 16-64 rows in steps of 16, or a multiple of 64 rows, are taken
//     (a TMA box holds at most 256 rows; the wrapper refuses other page
//     sizes). The block's query rows are loaded (16 bytes a thread)
//     before the tiles are issued, into shared memory;
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
//     summed into the block's partial, 16 bytes a thread (m in natural
//     log units, as the merge reads it). A block with no visible tile
//     writes m = -1e30, l = 0 and a zero acc and exits.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// Shared memory a block can use on Hopper.
constexpr size_t kSmemLimit = 227 * 1024;

// ------------------------------------------------------------ T = 1
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Query rows one block keeps state for, at most (a group of the R = G
// rows): the register state's row bound.
constexpr int kGroupRows = 4;
// V rows with loads in flight in PV: 16 rows of D/32 columns a lane, 8
// at D = 256 (the same 64 registers).
__host__ __device__ constexpr int pv_unroll(int d) {
  return d == 256 ? 8 : 16;
}

// Shared memory of pass 1 for a group of R rows: q [R, D], per-warp
// scores [4, R, P], and the per-warp states for the final merge: m, l
// [4, R], acc [4, R, D].
inline size_t pass1_smem(int rows, int d, int page_size) {
  return sizeof(float) *
         (size_t(rows) * d + size_t(kWarps) * rows * page_size +
          2 * size_t(kWarps) * rows + size_t(kWarps) * rows * d);
}

// 16 consecutive elements of a K row: the raw 16-byte words a lane
// loads, and their conversion to f32.
template <typename KV>
struct KRow;

template <>
struct KRow<bf16> {
  static constexpr int kWords = 2;
  static constexpr int kUnroll = 4;    // token passes with loads in flight
  __device__ static void load(const bf16 *src, uint4 (&w)[kWords]) {
    const uint4 *row = reinterpret_cast<const uint4 *>(src);
    w[0] = row[0];
    w[1] = row[1];
  }
  __device__ static void convert(const uint4 (&w)[kWords], float (&out)[16]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 *pr =
          reinterpret_cast<const __nv_bfloat162 *>(&w[h]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        out[h * 8 + 2 * e] = f.x;
        out[h * 8 + 2 * e + 1] = f.y;
      }
    }
  }
};

template <>
struct KRow<int8_t> {
  static constexpr int kWords = 1;
  static constexpr int kUnroll = 8;
  __device__ static void load(const int8_t *src, uint4 (&w)[kWords]) {
    w[0] = *reinterpret_cast<const uint4 *>(src);
  }
  __device__ static void convert(const uint4 (&w)[kWords], float (&out)[16]) {
    const char4 *c = reinterpret_cast<const char4 *>(&w[0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[4 * e] = static_cast<float>(c[e].x);
      out[4 * e + 1] = static_cast<float>(c[e].y);
      out[4 * e + 2] = static_cast<float>(c[e].z);
      out[4 * e + 3] = static_cast<float>(c[e].w);
    }
  }
};

// The D/32 columns of a V row that one lane owns.
template <int D>
__device__ __forceinline__ void load_row_cols(const bf16 *src,
                                              float (&out)[D / 32]) {
  if constexpr (D == 256) {
    const uint4 w = *reinterpret_cast<const uint4 *>(src);
    const __nv_bfloat162 *pr = reinterpret_cast<const __nv_bfloat162 *>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pr[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else if constexpr (D == 128) {
    const uint2 w = *reinterpret_cast<const uint2 *>(src);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162 *>(&w.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162 *>(&w.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162 *>(src));
    out[0] = a.x;
    out[1] = a.y;
  }
}

template <int D>
__device__ __forceinline__ void load_row_cols(const int8_t *src,
                                              float (&out)[D / 32]) {
  if constexpr (D == 256) {
    const uint2 w = *reinterpret_cast<const uint2 *>(src);
    const char4 *c = reinterpret_cast<const char4 *>(&w);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      out[4 * e] = static_cast<float>(c[e].x);
      out[4 * e + 1] = static_cast<float>(c[e].y);
      out[4 * e + 2] = static_cast<float>(c[e].z);
      out[4 * e + 3] = static_cast<float>(c[e].w);
    }
  } else if constexpr (D == 128) {
    const char4 c = *reinterpret_cast<const char4 *>(src);
    out[0] = static_cast<float>(c.x);
    out[1] = static_cast<float>(c.y);
    out[2] = static_cast<float>(c.z);
    out[3] = static_cast<float>(c.w);
  } else {
    const char2 c = *reinterpret_cast<const char2 *>(src);
    out[0] = static_cast<float>(c.x);
    out[1] = static_cast<float>(c.y);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *lengths;
  void *out, *part_acc, *part_ml;
  int slots, hq, hkv, page_size, mp, pages_per_split;
  float scale;
};

inline int n_splits(const Args &a) {
  return (a.mp + a.pages_per_split - 1) / a.pages_per_split;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const bf16 *__restrict__ q,
                   const KV *__restrict__ k_pool,
                   const KV *__restrict__ v_pool,
                   const float *__restrict__ k_scale,  // int8 pages only
                   const float *__restrict__ v_scale,
                   const int *__restrict__ tables,
                   const int *__restrict__ lengths,
                   float *__restrict__ part_acc,   // [S, Hkv, n_split, G, D]
                   float *__restrict__ part_ml,    // [S, Hkv, n_split, G, 2]
                   int hq, int hkv, int page_size, int mp,
                   int pages_per_split, int group, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using Row = KRow<KV>;
  constexpr int kScoreUnroll = Row::kUnroll;
  constexpr int kLanesPerTok = D / 16;       // 16 elements per lane
  constexpr int kTokPerPass = 32 / kLanesPerTok;
  constexpr int kCols = D / 32;              // PV columns per lane
  constexpr int kPvUnroll = pv_unroll(D);
  extern __shared__ __align__(16) float smem[];
  const int rows_all = hq / hkv;
  const int n_groups = (rows_all + group - 1) / group;
  // This block's rows r0 .. r0 + rows of the kv group's G.
  const int r0 = blockIdx.y % n_groups * group;
  const int rows = min(group, rows_all - r0);
  float *qs = smem;                                       // [R, D]
  float *sc_all = qs + rows * D;                          // [4, R, P]
  float *wm = sc_all + kWarps * rows * page_size;         // [4, R]
  float *wl = wm + kWarps * rows;                         // [4, R]
  float *wacc = wl + kWarps * rows;                       // [4, R, D]

  const int s = blockIdx.x;
  const int hk = blockIdx.y / n_groups;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float *sc = sc_all + warp * rows * page_size;           // this warp's

  // Row r = g: head hk*G + g (heads h // G == hk share kv head hk).
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = r0 + i / D;
    qs[i] = __bfloat162float(
        q[(static_cast<long long>(s) * hq + hk * rows_all + r) * D + i % D]);
  }
  __syncthreads();

  const int pos = lengths[s];   // the query's position (attendable)
  float m_run[kGroupRows], l_run[kGroupRows], acc[kGroupRows][kCols];
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    m_run[r] = skyt::kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int *trow = tables + static_cast<long long>(s) * mp;
  const int n_visit = pos < 0 ? 0 : min(mp, pos / page_size + 1);
  const int j_end = min(n_visit, (split + 1) * pages_per_split);
  const long long page_elems = static_cast<long long>(page_size) * D;
  const int sub = lane % kLanesPerTok;

  for (int j = split * pages_per_split + warp; j < j_end; j += kWarps) {
    const int page = trow[j];
    if (page == 0 && j != 0) continue;   // unreserved entry
    const long long ph = static_cast<long long>(page) * hkv + hk;
    const KV *kp = k_pool + ph * page_elems;
    const KV *vp = v_pool + ph * page_elems;
    const float *ksp = nullptr, *vsp = nullptr;
    if constexpr (kQuant) {
      ksp = k_scale + ph * page_size;
      vsp = v_scale + ph * page_size;
    }

    // Scores: kScoreUnroll token passes of loads in flight at a time.
    for (int t0 = 0; t0 < page_size; t0 += kTokPerPass * kScoreUnroll) {
      uint4 kr[kScoreUnroll][Row::kWords];
      float ks[kScoreUnroll];
#pragma unroll
      for (int u = 0; u < kScoreUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + lane / kLanesPerTok;
        const int tc = t < page_size ? t : 0;
        Row::load(kp + static_cast<long long>(tc) * D + sub * 16, kr[u]);
        ks[u] = 1.f;
        if constexpr (kQuant) ks[u] = ksp[tc];
      }
#pragma unroll
      for (int u = 0; u < kScoreUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + lane / kLanesPerTok;
        float kv[16];
        Row::convert(kr[u], kv);
        const bool in_page = t < page_size;
        const int idx = j * page_size + t;
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          if (r < rows) {
            const float4 *qv =
                reinterpret_cast<const float4 *>(qs + r * D + sub * 16);
            float dot = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float4 qq = qv[w];
              dot += kv[4 * w] * qq.x + kv[4 * w + 1] * qq.y +
                     kv[4 * w + 2] * qq.z + kv[4 * w + 3] * qq.w;
            }
#pragma unroll
            for (int off = kLanesPerTok / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (sub == 0 && in_page) {
              float st = dot * scale;
              if constexpr (kQuant) st *= ks[u];
              sc[r * page_size + t] = idx <= pos ? st : skyt::kNegInf;
            }
          }
        }
      }
    }
    __syncwarp();

    // Online-softmax update per row: p (times the value scale for int8
    // pages, rounded to bf16) replaces the scores, and this page's
    // rescale multiplies the running sums.
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      if (r < rows) {
        float mx = skyt::kNegInf;
        for (int t = lane; t < page_size; t += 32)
          mx = fmaxf(mx, sc[r * page_size + t]);
        mx = skyt::warp_max(mx);
        const float m_new = fmaxf(m_run[r], mx);
        float sum = 0.f;
        for (int t = lane; t < page_size; t += 32) {
          const float p = __expf(sc[r * page_size + t] - m_new);
          float w = p;
          if constexpr (kQuant) w *= vsp[t];
          sc[r * page_size + t] = skyt::round_bf16(w);
          sum += p;
        }
        sum = skyt::warp_sum(sum);
        const float alpha = __expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] = alpha * l_run[r] + sum;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      }
    }
    __syncwarp();

    // PV: lane owns columns lane*kCols .. +kCols of every row.
    for (int t0 = 0; t0 < page_size; t0 += kPvUnroll) {
      float vr[kPvUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
        const int t = t0 + u < page_size ? t0 + u : 0;
        load_row_cols<D>(vp + static_cast<long long>(t) * D + lane * kCols,
                         vr[u]);
      }
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
        if (t0 + u < page_size) {
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) {
            if (r < rows) {
              const float p = sc[r * page_size + t0 + u];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[r][c] += p * vr[u][c];
            }
          }
        }
      }
    }
    __syncwarp();   // the next page overwrites this warp's scores
  }

  // Merge the 4 warps' states in shared memory.
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    if (r < rows) {
      if (lane == 0) {
        wm[warp * rows + r] = m_run[r];
        wl[warp * rows + r] = l_run[r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        wacc[(warp * rows + r) * D + lane * kCols + c] = acc[r][c];
    }
  }
  __syncthreads();
  const long long part =
      ((static_cast<long long>(s) * hkv + hk) * n_split + split) * rows_all +
      r0;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float m = skyt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * rows + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(wm[w * rows + r] - m);
      l += wl[w * rows + r] * e;
      a += wacc[(w * rows + r) * D + c] * e;
    }
    part_acc[(part + r) * D + c] = a;
    if (c == 0) {
      part_ml[(part + r) * 2] = m;
      part_ml[(part + r) * 2 + 1] = l;
    }
  }
}

// ------------------------------------------------------------ T > 1
namespace verify {

// Page rows a ring stage holds at most: a page of up to 64 rows is one
// tile, a longer one (a multiple of 64 rows) several.
constexpr int kTileRows = 64;
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

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
// walk_bytes and slice_bytes, the warps' (m, l) for 16 rows each, and one
// mbarrier a stage.
__host__ __device__ inline size_t smem_bytes(int d, bool quant, int rows,
                                             int stages, int m_tiles,
                                             int warps) {
  const size_t walk = walk_bytes(d, quant, rows, stages, m_tiles);
  const size_t slices = slice_bytes(d, quant, warps);
  return 1024 + (walk > slices ? walk : slices) +
         2 * size_t(warps) * 16 * 4 + size_t(stages) * 8;
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
  float *part_acc, *part_ml;   // [S, Hkv, n_split, R, D], [..., R, 2]
  int t_count, hq, hkv, page_size, mp, n_split, m_tiles, n_mgroups,
      key_splits, tile_rows, stages;
  float scale_log2;   // d^-0.5 * log2(e)
};

struct Maps {
  CUtensorMap k, v;
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
  skyt::mbar_expect_tx(bar, 2 * kv_tile + (L::kQuant ? 2 * tr * 4 : 0));
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
    tma_load_2d(dst + pn * tr * L::kRowBytes, &maps.k, bar, pn * L::kCols,
                row0);
    tma_load_2d(dst + kv_tile + pn * tr * L::kRowBytes, &maps.v, bar,
                pn * L::kCols, row0);
  }
  if constexpr (L::kQuant) {
    bulk_load(dst + 2 * kv_tile, p.k_scale + row0, tr * 4, bar);
    bulk_load(dst + 2 * kv_tile + tr * 4, p.v_scale + row0, tr * 4, bar);
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

  const int s = blockIdx.x;
  const int hk = blockIdx.y / p.n_mgroups;
  const int r0 = blockIdx.y % p.n_mgroups * p.m_tiles * 16;
  const int split = blockIdx.z;
  const int g_count = p.hq / p.hkv;
  const int rows_all = p.t_count * g_count;
  const int rows = min(p.m_tiles * 16, rows_all - r0);   // written rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp / p.key_splits, kslice = warp % p.key_splits;
  const int g = lane / 4, qd = lane % 4;

  const int pos = p.lengths[s];   // the first token's position
  const int last = pos + p.t_count - 1;
  const int n_visit = pos < 0 ? 0 : min(p.mp, last / p.page_size + 1);
  const int *trow = p.tables + static_cast<long long>(s) * p.mp;
  const long long part =
      ((static_cast<long long>(s) * p.hkv + hk) * p.n_split + split) *
          rows_all + r0;

  Walk walk{split, -1};
  if (!walk.next(trow, n_visit, p.n_split, p.page_size, tr, last)) {
    // No visible tile: a partial the merge weighs 0.
    for (int i = tid; i < rows * D; i += blockDim.x)
      p.part_acc[part * D + i] = 0.f;
    for (int r = tid; r < rows; r += blockDim.x) {
      p.part_ml[(part + r) * 2] = skyt::kNegInf;
      p.part_ml[(part + r) * 2 + 1] = 0.f;
    }
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

  // The ring: thread 0 issues the first `stages` tiles at once.
  Walk ahead = walk;   // the last tile issued
  if (tid == 0) {
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

  const int chunks = tr / 16;
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, its row
  int n = 0;
  do {
    const int stage = n % p.stages;
    skyt::mbar_wait(&full[stage], (n / p.stages) & 1);
    const uint8_t *kt = smem + stage * sbytes;
    const uint8_t *vt = kt + kv_tile;
    const float *ksc = reinterpret_cast<const float *>(vt + kv_tile);
    const float *vsc = ksc + tr;
    const int k0 = walk.j * p.page_size + walk.st * tr;
    const bool masked = k0 + tr - 1 > pos;   // some key past a row's limit

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
          if (masked && k0 + key > lim[e >> 1]) v = skyt::kNegInf;
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
  }
  // Each warp's O, rescaled to the block's m, into its own slice; then
  // the key splits' slices are summed into the partial, 16 bytes a
  // thread.
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
  if (kslice == 0 && qd == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r < rows) {
        p.part_ml[(part + r) * 2] = m_blk[h] * kLn2;
        p.part_ml[(part + r) * 2 + 1] = l_blk[h];
      }
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
    *reinterpret_cast<float4 *>(p.part_acc + (part + r) * D + c) = sum;
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *lengths;
  void *out, *part_acc, *part_ml;
  int slots, t_count, hq, hkv, page_size, n_pages, mp, n_split, m_tiles,
      n_mgroups, key_splits, tile_rows, stages;
  float scale;
};

// The 2-d map of a pool viewed as [rows, D] with boxes of kCols x
// tile_rows, swizzled as Tile says.
template <typename KV, int D>
bool encode_pool(CUtensorMap *map, const void *base, long long rows,
                 int tile_rows) {
  using L = Tile<KV, D>;
  const PFN_cuTensorMapEncodeTiled_v12000 fn = skyt::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * sizeof(KV)};
  const cuuint32_t box[2] = {cuuint32_t(L::kCols), cuuint32_t(tile_rows)};
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

}  // namespace verify

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge(const float *__restrict__ part_acc,
                   const float *__restrict__ part_ml,
                   bf16 *__restrict__ out, int t_count, int hq, int hkv,
                   int n_split) {
  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int r = blockIdx.z;
  const int tid = threadIdx.x;
  const int g_count = hq / hkv;
  const int rows = t_count * g_count;
  const long long base =
      (static_cast<long long>(s) * hkv + hk) * n_split * rows + r;
  float m = skyt::kNegInf;
  for (int i = 0; i < n_split; ++i)
    m = fmaxf(m, part_ml[(base + i * rows) * 2]);
  float l = 0.f, a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const long long idx = base + i * rows;
    const float w = __expf(part_ml[idx * 2] - m);
    l += part_ml[idx * 2 + 1] * w;
    a += part_acc[idx * D + tid] * w;
  }
  // Row r = t*G + g goes to out[s, t, hk*G + g]: token t's G rows are
  // contiguous there too.
  const int t = r / g_count;
  out[((static_cast<long long>(s) * t_count + t) * hq + hk * g_count +
       r - t * g_count) * D + tid] = __float2bfloat16(l == 0.f ? 0.f :
                                                       a / l);
}

template <int D, typename KV>
int launch(const Args &a, int group, cudaStream_t stream) {
  const int rows = a.hq / a.hkv;
  const int n_groups = (rows + group - 1) / group;
  const size_t bytes = pass1_smem(group, D, a.page_size);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split<D, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_split = n_splits(a);
  paged_decode_split<D, KV>
      <<<dim3(a.slots, a.hkv * n_groups, n_split), kThreads, bytes,
         stream>>>(
          static_cast<const bf16 *>(a.q), static_cast<const KV *>(a.k_pool),
          static_cast<const KV *>(a.v_pool),
          static_cast<const float *>(a.k_scale),
          static_cast<const float *>(a.v_scale),
          static_cast<const int *>(a.tables),
          static_cast<const int *>(a.lengths),
          static_cast<float *>(a.part_acc), static_cast<float *>(a.part_ml),
          a.hq, a.hkv, a.page_size, a.mp, a.pages_per_split, group, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge<D><<<dim3(a.slots, a.hkv, rows), D, 0, stream>>>(
      static_cast<const float *>(a.part_acc),
      static_cast<const float *>(a.part_ml), static_cast<bf16 *>(a.out),
      1, a.hq, a.hkv, n_split);
  return static_cast<int>(cudaGetLastError());
}

// Rows a block keeps state for: up to kGroupRows, fewer while the grid
// would leave the card's SMs without two blocks each (MQA decode:
// gemma-2b's one kv head gives 8 slots x 8 splits = 64 blocks a group).
int choose_group(const Args &a, int sms) {
  const int rows = a.hq / a.hkv;
  int group = std::min(rows, kGroupRows);
  const long long pairs = static_cast<long long>(a.slots) * a.hkv *
                          n_splits(a);
  while (group > 1 && pairs * ((rows + group - 1) / group) < 2LL * sms)
    group = (group + 1) / 2;
  return group;
}

template <int D, typename KV>
int launch_t(const Args &a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<D, KV>(a, choose_group(a, sms), stream);
}

template <typename KV>
int launch_d(const Args &a, int d, cudaStream_t stream) {
  if (d == 64) return launch_t<64, KV>(a, stream);
  if (d == 128) return launch_t<128, KV>(a, stream);
  if (d == 256) return launch_t<256, KV>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace verify {

template <int D, typename KV>
int launch(const Args &a, cudaStream_t stream) {
  using L = Tile<KV, D>;
  const long long pool_rows =
      static_cast<long long>(a.n_pages) * a.hkv * a.page_size;
  Maps maps;
  if (pool_rows >= (1LL << 31) ||
      !encode_pool<KV, D>(&maps.k, a.k_pool, pool_rows, a.tile_rows) ||
      !encode_pool<KV, D>(&maps.v, a.v_pool, pool_rows, a.tile_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = a.m_tiles * a.key_splits;
  const size_t bytes = smem_bytes(D, L::kQuant, a.tile_rows, a.stages,
                                  a.m_tiles, warps);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_verify<D, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const bf16 *>(a.q),
                 static_cast<const float *>(a.k_scale),
                 static_cast<const float *>(a.v_scale),
                 static_cast<const int *>(a.tables),
                 static_cast<const int *>(a.lengths),
                 static_cast<float *>(a.part_acc),
                 static_cast<float *>(a.part_ml),
                 a.t_count, a.hq, a.hkv, a.page_size, a.mp, a.n_split,
                 a.m_tiles, a.n_mgroups, a.key_splits, a.tile_rows, a.stages,
                 a.scale * 1.4426950408889634f};
  paged_decode_verify<D, KV>
      <<<dim3(a.slots, a.hkv * a.n_mgroups, a.n_split), warps * 32, bytes,
         stream>>>(p, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.t_count * (a.hq / a.hkv);
  paged_decode_merge<D><<<dim3(a.slots, a.hkv, rows), D, 0, stream>>>(
      static_cast<const float *>(a.part_acc),
      static_cast<const float *>(a.part_ml), static_cast<bf16 *>(a.out),
      a.t_count, a.hq, a.hkv, a.n_split);
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

// One query a slot. q [S, Hq, D] bf16 contiguous; k_pool/v_pool
// [n_pages, Hkv, P, D] contiguous (one layer), bf16, or int8 when
// kv_int8 != 0 with k_scale/v_scale [n_pages, Hkv, P] f32 contiguous
// (else ignored); tables [S, mp] int32; lengths [S] int32 (the query
// sits at lengths[s]); part_acc f32 [S, Hkv, n_split, G, D] and part_ml
// f32 [S, Hkv, n_split, G, 2] scratch with n_split = ceil(mp /
// pages_per_split); out [S, Hq, D] bf16 contiguous; D is 64, 128 or
// 256. A page size whose pass-1 shared memory passes kSmemLimit returns
// cudaErrorInvalidValue.
extern "C" int skyt_paged_decode(const void *q, const void *k_pool,
                                 const void *v_pool, const void *k_scale,
                                 const void *v_scale, const void *tables,
                                 const void *lengths, void *out,
                                 void *part_acc, void *part_ml, int slots,
                                 int hq, int hkv, int d, int page_size,
                                 int mp, int pages_per_split, int kv_int8,
                                 float scale, void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || pages_per_split <= 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       k_pool,  v_pool, k_scale,  v_scale,
               tables,  lengths, out,    part_acc, part_ml,
               slots,   hq,      hkv,    page_size, mp,
               pages_per_split,  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_d<int8_t>(a, d, st) : launch_d<bf16>(a, d, st);
}

// Dynamic shared memory of a verify block (ops/paged_attention.py
// verify_plan holds the same number).
extern "C" int skyt_paged_verify_smem(int d, int kv_int8, int tile_rows,
                                      int stages, int m_tiles,
                                      int key_splits) {
  return static_cast<int>(verify::smem_bytes(d, kv_int8 != 0, tile_rows,
                                             stages, m_tiles,
                                             m_tiles * key_splits));
}

// T query tokens a slot (the verify step). q [S, T, Hq, D] bf16
// contiguous, token t at position lengths[s] + t; pools, scales, tables
// and lengths as skyt_paged_decode's, n_pages pages; out [S, T, Hq, D];
// part_acc f32 [S, Hkv, n_split, R, D] and part_ml f32
// [S, Hkv, n_split, R, 2] with R = T*Hq/Hkv. The plan (ops/
// paged_attention.py verify_plan): n_split blocks a (slot, kv head, row
// group), n_mgroups row groups of m_tiles 16-row tiles, key_splits warps
// an m-tile, pages cut into tiles of tile_rows rows, a ring of `stages`.
// Returns cudaErrorInvalidValue on a plan the kernel cannot run.
extern "C" int skyt_paged_verify(
    const void *q, const void *k_pool, const void *v_pool,
    const void *k_scale, const void *v_scale, const void *tables,
    const void *lengths, void *out, void *part_acc, void *part_ml,
    int slots, int t_count, int hq, int hkv, int d, int page_size,
    int n_pages, int mp, int n_split, int m_tiles, int n_mgroups,
    int key_splits, int tile_rows, int stages, int kv_int8, float scale,
    void *stream) {
  const int rows = hkv > 0 ? t_count * (hq / hkv) : 0;
  if (hkv <= 0 || hq % hkv != 0 || t_count < 1 || slots < 1 || mp < 1 ||
      n_split < 1 || n_split > 65535 || m_tiles < 1 || n_mgroups < 1 ||
      key_splits < 1 || m_tiles * key_splits > verify::kMaxWarps ||
      m_tiles * n_mgroups * 16 < rows ||
      (n_mgroups - 1) * m_tiles * 16 >= rows ||
      static_cast<long long>(hkv) * n_mgroups > 65535 || tile_rows < 16 ||
      tile_rows % 16 != 0 || tile_rows > verify::kTileRows ||
      page_size % tile_rows != 0 || stages < 1 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const verify::Args a{q,         k_pool,    v_pool,     k_scale,
                       v_scale,   tables,    lengths,    out,
                       part_acc,  part_ml,   slots,      t_count,
                       hq,        hkv,       page_size,  n_pages,
                       mp,        n_split,   m_tiles,    n_mgroups,
                       key_splits, tile_rows, stages,    scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? verify::launch_d<int8_t>(a, d, st)
                 : verify::launch_d<bf16>(a, d, st);
}
