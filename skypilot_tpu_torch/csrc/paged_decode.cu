// Paged decode attention for Hopper (sm_90a): bf16 queries, bf16 or int8
// KV pages, f32 accumulate.
//
// One kernel template replaces the four TPU kernels of
// skypilot_tpu/ops/paged_attention.py:
//   T = 1, bf16 pages     :50  _kernel      (paged_decode_attention)
//   T = k+1, bf16 pages   :98  _kernel_mq   (paged_decode_attention_mq)
//   T = 1, int8 pages     :150 _kernel_q    (paged_decode_attention_q)
//   T = k+1, int8 pages   :210 _kernel_mq_q (paged_decode_attention_mq_q)
// Each slot has T consecutive query tokens (T > 1: the speculative
// verify step), token t at position lengths[s] + t, and attends that
// slot's KV pages, found through the block table, with an online softmax
// over the pages. Token t sees the keys at positions <= lengths[s] + t.
//
// What bounds it on this card: memory bandwidth. Each layer call must
// read every visible K and V row once, 2*Hkv*d*2 B*sum_s(lengths[s]+T)
// bytes from bf16 pages or (2*Hkv*d*1 B + 2*Hkv*4 B)*sum_s(lengths[s]+T)
// from int8 pages with their f32 scales, against 3.35 TB/s; the
// arithmetic (2 flops per byte read and query row, ~16-32 at T*G = 16)
// is far below the tensor-core ridge, so the products run on the CUDA
// cores, and the design is about keeping enough loads in flight.
//
// Design. The TPU kernels run a sequential (slot, page) grid with one
// [Hkv, P, d] page block per step. Decode has few (slot, kv head) pairs
// (64 for 8 slots of llama3-8b) and long page walks, so here the walk is
// split and each page goes to its own warp:
//   * pass 1: one block of 4 warps per (slot, kv head, group of query
//     rows, run of `pages_per_split` pages); warp w takes pages w,
//     w+4, ... of the run. A warp reads its page's K and V rows straight
//     from the page-major pool into registers with 16-byte loads (K) and
//     2-16 byte loads (V), several rows in flight per lane, and keeps its
//     own online-softmax state for the block's rows of the R = T*G query
//     rows of the kv group (row r = token r/G, head r%G), so each K/V row
//     is read once a group and used by each of its rows. A group holds
//     at most kGroupRows = 4 rows, fewer when the grid would not give
//     each SM two blocks (choose_group): a warp walks its page once per
//     row of its group, and with more rows that walk, not the bytes,
//     sets the time (16-row groups ran llama3-8b's verify step 1.29x
//     slower than 4-row groups, PERF.md). Each group reads the slot's K/V
//     again, mostly from L2. R is not bounded: gemma-2b's verify step
//     (G = 8, T = 4, R = 32) runs 8 groups;
//       - scores: d/16 lanes per token, 16 elements each, a 2-3 step
//         shuffle reduction per row; q comes from shared memory;
//       - softmax update per row over the page (warp reductions);
//       - PV: lane owns d/32 output columns for every row.
//     The 4 warps' states are merged in shared memory and the block
//     writes its run's (m, l, acc);
//   * pass 2: one block per (slot, kv head, query row) merges the runs:
//     m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//     out = acc / l, and l == 0 gives 0.
//   * int8 pages: the codes convert to f32 exactly (as the TPU kernel's
//     cast to the query dtype); the key scale multiplies the score, and
//     the value scale multiplies p before PV, where p * v_scale is
//     rounded to bf16 (the TPU kernel's pd). The running sum l takes the
//     unscaled p. Half the K/V bytes of bf16 pages, plus 4 B per row of
//     scales; the score pass keeps twice as many rows in flight.
//   * template: the head dim D (64, 128 or 256), the KV type, and kMulti
//     (T > 1): the T = 1 instantiations test visibility against
//     lengths[s] alone, which
//     keeps the single-query inner loop as lean as a kernel of its own;
//     the T > 1 ones against a per-row limit.
//   * skip rule, exactly the TPU kernels': page j is walked iff
//     j*P <= lengths[s] + T-1 and (tables[s, j] != 0 or j == 0). A
//     released slot (all-zero row, stale length) reads only dummy page
//     0, and page indices never leave the slot's row. Positions a row
//     cannot see are masked with -1e30; p is rounded to bf16 before PV,
//     as the TPU kernel's p.astype(v.dtype). A page a row sees nothing
//     of leaves finite junk in that warp's state, which the next visible
//     page (alpha = 0) or the merge (weight e^(-1e30 - m) = 0) drops:
//     page 0 is visible to every row.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Query rows one block keeps state for, at most (a group of the R =
// T*G rows): the register state's row bound.
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
  int slots, t_count, hq, hkv, page_size, mp, pages_per_split;
  float scale;
};

inline int n_splits(const Args &a) {
  return (a.mp + a.pages_per_split - 1) / a.pages_per_split;
}

// Shared memory a block can use on Hopper.
constexpr size_t kSmemLimit = 227 * 1024;

template <int D, typename KV, bool kMulti>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const bf16 *__restrict__ q,
                   const KV *__restrict__ k_pool,
                   const KV *__restrict__ v_pool,
                   const float *__restrict__ k_scale,  // int8 pages only
                   const float *__restrict__ v_scale,
                   const int *__restrict__ tables,
                   const int *__restrict__ lengths,
                   float *__restrict__ part_acc,   // [S, Hkv, n_split, R, D]
                   float *__restrict__ part_ml,    // [S, Hkv, n_split, R, 2]
                   int t_count, int hq, int hkv, int page_size, int mp,
                   int pages_per_split, int group, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using Row = KRow<KV>;
  constexpr int kScoreUnroll = Row::kUnroll;
  constexpr int kLanesPerTok = D / 16;       // 16 elements per lane
  constexpr int kTokPerPass = 32 / kLanesPerTok;
  constexpr int kCols = D / 32;              // PV columns per lane
  constexpr int kPvUnroll = pv_unroll(D);
  extern __shared__ __align__(16) float smem[];
  const int g_count = hq / hkv;
  const int rows_all = t_count * g_count;
  const int n_groups = (rows_all + group - 1) / group;
  // This block's rows r0 .. r0 + rows of the kv group's R.
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

  // Row r = t*G + g: query token t, head hk*G + g (heads h // G == hk
  // share kv head hk).
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = r0 + i / D;
    const int t = r / g_count;
    qs[i] = __bfloat162float(
        q[((static_cast<long long>(s) * t_count + t) * hq + hk * g_count +
           r - t * g_count) * D + i % D]);
  }
  __syncthreads();

  const int pos = lengths[s];   // the first token's position (attendable)
  float m_run[kGroupRows], l_run[kGroupRows], acc[kGroupRows][kCols];
  int lim[kGroupRows];          // kMulti: row r sees positions <= lim[r]
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    m_run[r] = skyt::kNegInf;
    l_run[r] = 0.f;
    lim[r] = pos + (r0 + r) / g_count;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int *trow = tables + static_cast<long long>(s) * mp;
  const int last = pos + t_count - 1;
  const int n_visit = pos < 0 ? 0 : min(mp, last / page_size + 1);
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
              const bool vis = kMulti ? idx <= lim[r] : idx <= pos;
              sc[r * page_size + t] = vis ? st : skyt::kNegInf;
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

template <int D, typename KV, bool kMulti>
int launch(const Args &a, int group, cudaStream_t stream) {
  const int rows = a.t_count * (a.hq / a.hkv);
  const int n_groups = (rows + group - 1) / group;
  const size_t bytes = pass1_smem(group, D, a.page_size);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split<D, KV, kMulti>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_split = n_splits(a);
  paged_decode_split<D, KV, kMulti>
      <<<dim3(a.slots, a.hkv * n_groups, n_split), kThreads, bytes,
         stream>>>(
          static_cast<const bf16 *>(a.q), static_cast<const KV *>(a.k_pool),
          static_cast<const KV *>(a.v_pool),
          static_cast<const float *>(a.k_scale),
          static_cast<const float *>(a.v_scale),
          static_cast<const int *>(a.tables),
          static_cast<const int *>(a.lengths),
          static_cast<float *>(a.part_acc), static_cast<float *>(a.part_ml),
          a.t_count, a.hq, a.hkv, a.page_size, a.mp, a.pages_per_split,
          group, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge<D><<<dim3(a.slots, a.hkv, rows), D, 0, stream>>>(
      static_cast<const float *>(a.part_acc),
      static_cast<const float *>(a.part_ml), static_cast<bf16 *>(a.out),
      a.t_count, a.hq, a.hkv, n_split);
  return static_cast<int>(cudaGetLastError());
}

// Rows a block keeps state for: up to kGroupRows, fewer while the grid
// would leave the card's SMs without two blocks each (MQA decode:
// gemma-2b's one kv head gives 8 slots x 8 splits = 64 blocks a group).
int choose_group(const Args &a, int sms) {
  const int rows = a.t_count * (a.hq / a.hkv);
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
  const int group = choose_group(a, sms);
  return a.t_count == 1 ? launch<D, KV, false>(a, group, stream)
                        : launch<D, KV, true>(a, group, stream);
}

template <typename KV>
int launch_d(const Args &a, int d, cudaStream_t stream) {
  if (d == 64) return launch_t<64, KV>(a, stream);
  if (d == 128) return launch_t<128, KV>(a, stream);
  if (d == 256) return launch_t<256, KV>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// q [S, T, Hq, D] bf16 contiguous; k_pool/v_pool [n_pages, Hkv, P, D]
// contiguous (one layer), bf16, or int8 when kv_int8 != 0 with k_scale/
// v_scale [n_pages, Hkv, P] f32 contiguous (else ignored); tables [S, mp]
// int32; lengths [S] int32 (token t of slot s sits at lengths[s] + t);
// part_acc f32 [S, Hkv, n_split, R, D] and part_ml f32
// [S, Hkv, n_split, R, 2] scratch with n_split = ceil(mp /
// pages_per_split) and R = T*Hq/Hkv; out [S, T, Hq, D] bf16 contiguous;
// D is 64, 128 or 256. A page size whose pass-1 shared memory passes
// kSmemLimit returns cudaErrorInvalidValue.
extern "C" int skyt_paged_decode(const void *q, const void *k_pool,
                                 const void *v_pool, const void *k_scale,
                                 const void *v_scale, const void *tables,
                                 const void *lengths, void *out,
                                 void *part_acc, void *part_ml, int slots,
                                 int t_count, int hq, int hkv, int d,
                                 int page_size, int mp, int pages_per_split,
                                 int kv_int8, float scale, void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || t_count < 1 || pages_per_split <= 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,        k_pool,   v_pool,  k_scale,   v_scale,
               tables,   lengths,  out,     part_acc,  part_ml,
               slots,    t_count,  hq,      hkv,       page_size,
               mp,       pages_per_split,   scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_d<int8_t>(a, d, st) : launch_d<bf16>(a, d, st);
}
