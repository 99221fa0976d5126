// Paged decode attention for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces skypilot_tpu/ops/paged_attention.py:50 _kernel (launched by
// paged_decode_attention): one query token per slot attends that slot's
// KV pages, found through the block table, with an online softmax over
// the pages.
//
// What bounds it on this card: memory bandwidth. Each layer call must
// read every visible K and V row once, 2*Hkv*d*2 B*sum_s(lengths[s]+1)
// bytes against 3.35 TB/s; the arithmetic (2 flops per byte read) is
// far below the tensor-core ridge, so the products run on the CUDA
// cores, and the design is about keeping enough loads in flight.
//
// Design. The TPU kernel runs a sequential (slot, page) grid with one
// [Hkv, P, d] page block per step. Decode has few (slot, kv head) pairs
// (64 for 8 slots of llama3-8b) and long page walks, so here the walk is
// split and each page goes to its own warp:
//   * pass 1: one block of 4 warps per (slot, kv head, run of
//     `pages_per_split` pages); warp w takes pages w, w+4, ... of the
//     run. A warp reads its page's K and V rows straight from the
//     page-major pool into registers with 16- and 8-byte loads, several
//     rows in flight per lane, and keeps its own online-softmax state
//     for all G = Hq/Hkv query heads of the kv group, so each K/V row is
//     read once and used G times:
//       - scores: d/16 lanes per token, 16 elements each, a 2-3 step
//         shuffle reduction per head; q comes from shared memory;
//       - softmax update per head over the page (warp reductions);
//       - PV: lane owns d/32 output columns for every head.
//     The 4 warps' states are merged in shared memory and the block
//     writes its run's (m, l, acc);
//   * pass 2: one block per (slot, kv head) merges the runs:
//     m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//     out = acc / l, and l == 0 gives 0.
//   * skip rule, exactly kernel 2's: page j is skipped iff
//     j*P > lengths[s] or (tables[s, j] == 0 and j != 0). A released
//     slot (all-zero row, stale length) reads only dummy page 0, and page
//     indices never leave the slot's row. Positions past lengths[s] are
//     masked with -1e30; p is rounded to bf16 before PV, as the TPU
//     kernel's p.astype(v.dtype).
#include <stdint.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kScoreUnroll = 4;    // token passes with loads in flight
constexpr int kPvUnroll = 16;      // V rows with loads in flight

// Shared memory of pass 1: q [G, D], per-warp scores [4, G, P], and the
// per-warp states for the final merge: m, l [4, G], acc [4, G, D].
inline size_t pass1_smem(int g_count, int d, int page_size) {
  return sizeof(float) *
         (size_t(g_count) * d + size_t(kWarps) * g_count * page_size +
          2 * size_t(kWarps) * g_count + size_t(kWarps) * g_count * d);
}

template <int D>
__device__ __forceinline__ void load_row_cols(const bf16 *src,
                                              float (&out)[D / 32]) {
  if constexpr (D == 128) {
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

template <int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const bf16 *__restrict__ q,
                   const bf16 *__restrict__ k_pool,
                   const bf16 *__restrict__ v_pool,
                   const int *__restrict__ tables,
                   const int *__restrict__ lengths,
                   float *__restrict__ part_acc,   // [S, Hkv, n_split, G, D]
                   float *__restrict__ part_ml,    // [S, Hkv, n_split, G, 2]
                   int hq, int hkv, int page_size, int mp,
                   int pages_per_split, float scale) {
  constexpr int kLanesPerTok = D / 16;       // 16 elements per lane
  constexpr int kTokPerPass = 32 / kLanesPerTok;
  constexpr int kCols = D / 32;              // PV columns per lane
  extern __shared__ __align__(16) float smem[];
  const int g_count = hq / hkv;
  float *qs = smem;                                       // [G, D]
  float *sc_all = qs + g_count * D;                       // [4, G, P]
  float *wm = sc_all + kWarps * g_count * page_size;      // [4, G]
  float *wl = wm + kWarps * g_count;                      // [4, G]
  float *wacc = wl + kWarps * g_count;                    // [4, G, D]

  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float *sc = sc_all + warp * g_count * page_size;        // this warp's

  // Heads hk*G .. hk*G+G-1 share kv head hk (h // G == hk).
  const bf16 *qrow = q + (static_cast<long long>(s) * hq + hk * g_count) * D;
  for (int i = tid; i < g_count * D; i += kThreads)
    qs[i] = __bfloat162float(qrow[i]);
  __syncthreads();

  float m_run[MAXG], l_run[MAXG], acc[MAXG][kCols];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_run[g] = skyt::kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }

  const int pos = lengths[s];   // this token's position (attendable)
  const int *trow = tables + static_cast<long long>(s) * mp;
  const int n_visit = pos < 0 ? 0 : min(mp, pos / page_size + 1);
  const int j_end = min(n_visit, (split + 1) * pages_per_split);
  const long long page_elems = static_cast<long long>(page_size) * D;
  const int sub = lane % kLanesPerTok;

  for (int j = split * pages_per_split + warp; j < j_end; j += kWarps) {
    const int page = trow[j];
    if (page == 0 && j != 0) continue;   // unreserved entry
    const bf16 *kp =
        k_pool + (static_cast<long long>(page) * hkv + hk) * page_elems;
    const bf16 *vp =
        v_pool + (static_cast<long long>(page) * hkv + hk) * page_elems;

    // Scores: kScoreUnroll token passes of loads in flight at a time.
    for (int t0 = 0; t0 < page_size; t0 += kTokPerPass * kScoreUnroll) {
      uint4 kr[kScoreUnroll][2];
#pragma unroll
      for (int u = 0; u < kScoreUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + lane / kLanesPerTok;
        const uint4 *row = reinterpret_cast<const uint4 *>(
            kp + static_cast<long long>(t < page_size ? t : 0) * D +
            sub * 16);
        kr[u][0] = row[0];
        kr[u][1] = row[1];
      }
#pragma unroll
      for (int u = 0; u < kScoreUnroll; ++u) {
        const int t = t0 + u * kTokPerPass + lane / kLanesPerTok;
        float kv[16];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 *pr =
              reinterpret_cast<const __nv_bfloat162 *>(&kr[u][h]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(pr[e]);
            kv[h * 8 + 2 * e] = f.x;
            kv[h * 8 + 2 * e + 1] = f.y;
          }
        }
        const bool in_page = t < page_size;
        const bool visible = in_page && j * page_size + t <= pos;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < g_count) {
            const float4 *qv =
                reinterpret_cast<const float4 *>(qs + g * D + sub * 16);
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
            if (sub == 0 && in_page)
              sc[g * page_size + t] = visible ? dot * scale : skyt::kNegInf;
          }
        }
      }
    }
    __syncwarp();

    // Online-softmax update per head; p (rounded to bf16) replaces the
    // scores, and this page's rescale multiplies the running sums.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < g_count) {
        float mx = skyt::kNegInf;
        for (int t = lane; t < page_size; t += 32)
          mx = fmaxf(mx, sc[g * page_size + t]);
        mx = skyt::warp_max(mx);
        const float m_new = fmaxf(m_run[g], mx);
        float sum = 0.f;
        for (int t = lane; t < page_size; t += 32) {
          const float p = __expf(sc[g * page_size + t] - m_new);
          sc[g * page_size + t] = skyt::round_bf16(p);
          sum += p;
        }
        sum = skyt::warp_sum(sum);
        const float alpha = __expf(m_run[g] - m_new);
        m_run[g] = m_new;
        l_run[g] = alpha * l_run[g] + sum;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha;
      }
    }
    __syncwarp();

    // PV: lane owns columns lane*kCols .. +kCols of every head.
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
          for (int g = 0; g < MAXG; ++g) {
            if (g < g_count) {
              const float p = sc[g * page_size + t0 + u];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[g][c] += p * vr[u][c];
            }
          }
        }
      }
    }
    __syncwarp();   // the next page overwrites this warp's scores
  }

  // Merge the 4 warps' states in shared memory.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < g_count) {
      if (lane == 0) {
        wm[warp * g_count + g] = m_run[g];
        wl[warp * g_count + g] = l_run[g];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        wacc[(warp * g_count + g) * D + lane * kCols + c] = acc[g][c];
    }
  }
  __syncthreads();
  const long long part =
      ((static_cast<long long>(s) * hkv + hk) * n_split + split) * g_count;
  for (int i = tid; i < g_count * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float m = skyt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * g_count + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(wm[w * g_count + g] - m);
      l += wl[w * g_count + g] * e;
      a += wacc[(w * g_count + g) * D + c] * e;
    }
    part_acc[(part + g) * D + c] = a;
    if (c == 0) {
      part_ml[(part + g) * 2] = m;
      part_ml[(part + g) * 2 + 1] = l;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge(const float *__restrict__ part_acc,
                   const float *__restrict__ part_ml,
                   bf16 *__restrict__ out, int hq, int hkv, int n_split) {
  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int g_count = hq / hkv;
  const long long base =
      (static_cast<long long>(s) * hkv + hk) * n_split * g_count;
  bf16 *orow = out + (static_cast<long long>(s) * hq + hk * g_count) * D;
  for (int g = 0; g < g_count; ++g) {
    float m = skyt::kNegInf;
    for (int i = 0; i < n_split; ++i)
      m = fmaxf(m, part_ml[(base + i * g_count + g) * 2]);
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const long long idx = base + i * g_count + g;
      const float w = __expf(part_ml[idx * 2] - m);
      l += part_ml[idx * 2 + 1] * w;
      a += part_acc[idx * D + tid] * w;
    }
    orow[g * D + tid] = __float2bfloat16(l == 0.f ? 0.f : a / l);
  }
}

template <int D, int MAXG>
int launch(const void *q, const void *k_pool, const void *v_pool,
           const void *tables, const void *lengths, void *out,
           void *part_acc, void *part_ml, int slots, int hq, int hkv,
           int page_size, int mp, int pages_per_split, float scale,
           cudaStream_t stream) {
  const int g_count = hq / hkv;
  const size_t bytes = pass1_smem(g_count, D, page_size);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split<D, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_split = (mp + pages_per_split - 1) / pages_per_split;
  paged_decode_split<D, MAXG>
      <<<dim3(slots, hkv, n_split), kThreads, bytes, stream>>>(
          static_cast<const bf16 *>(q), static_cast<const bf16 *>(k_pool),
          static_cast<const bf16 *>(v_pool),
          static_cast<const int *>(tables),
          static_cast<const int *>(lengths), static_cast<float *>(part_acc),
          static_cast<float *>(part_ml), hq, hkv, page_size, mp,
          pages_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge<D><<<dim3(slots, hkv), D, 0, stream>>>(
      static_cast<const float *>(part_acc),
      static_cast<const float *>(part_ml), static_cast<bf16 *>(out), hq,
      hkv, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g(const void *q, const void *k_pool, const void *v_pool,
             const void *tables, const void *lengths, void *out,
             void *part_acc, void *part_ml, int slots, int hq, int hkv,
             int page_size, int mp, int pages_per_split, float scale,
             cudaStream_t stream) {
  const int g = hq / hkv;
  if (g <= 4)
    return launch<D, 4>(q, k_pool, v_pool, tables, lengths, out, part_acc,
                        part_ml, slots, hq, hkv, page_size, mp,
                        pages_per_split, scale, stream);
  if (g <= 8)
    return launch<D, 8>(q, k_pool, v_pool, tables, lengths, out, part_acc,
                        part_ml, slots, hq, hkv, page_size, mp,
                        pages_per_split, scale, stream);
  return launch<D, 16>(q, k_pool, v_pool, tables, lengths, out, part_acc,
                       part_ml, slots, hq, hkv, page_size, mp,
                       pages_per_split, scale, stream);
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// q [S, Hq, D] bf16 contiguous; k_pool/v_pool [n_pages, Hkv, P, D] bf16
// contiguous (one layer); tables [S, mp] int32; lengths [S] int32;
// part_acc f32 [S, Hkv, n_split, G, D] and part_ml f32
// [S, Hkv, n_split, G, 2] scratch with n_split = ceil(mp /
// pages_per_split); out [S, Hq, D] bf16 contiguous. G = Hq/Hkv <= 16.
extern "C" int skyt_paged_decode(const void *q, const void *k_pool,
                                 const void *v_pool, const void *tables,
                                 const void *lengths, void *out,
                                 void *part_acc, void *part_ml, int slots,
                                 int hq, int hkv, int d, int page_size,
                                 int mp, int pages_per_split, float scale,
                                 void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > 16 || pages_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_g<64>(q, k_pool, v_pool, tables, lengths, out, part_acc,
                        part_ml, slots, hq, hkv, page_size, mp,
                        pages_per_split, scale, st);
  if (d == 128)
    return launch_g<128>(q, k_pool, v_pool, tables, lengths, out, part_acc,
                         part_ml, slots, hq, hkv, page_size, mp,
                         pages_per_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
