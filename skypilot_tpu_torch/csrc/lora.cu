// Grouped multi-LoRA delta for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// One kernel template replaces the two TPU kernels of
// skypilot_tpu/ops/lora.py:
//   per-sequence ids [B]     :64 _gather_kernel  (lora_gather)
//   per-token ids [B, S]     :74 _grouped_kernel (lora_grouped)
// Token t with adapter id a gets
//   delta[t] = bf16(bf16(bf16(x[t] @ A[a]) @ B[a]) * bf16(scale[t]))
// with x [T, in], A [N, in, r], B [N, r, out] (id 0 is the all-zeros
// "no adapter" entry), rounded where the JAX code rounds: the shrink t is
// cast to the activation dtype between the two dots, the expand's output
// too, and the scale multiply runs in that dtype. With a residual y the
// kernel writes bf16(y + delta) (the model's projection plus its delta),
// so a projection costs one launch beyond its matmul.
//
// What bounds it on this card: memory bandwidth. A call must read x and
// each distinct non-zero adapter's A and B once and write the output
// (and read y), against 2*tokens*r*(in + out) flops at r <= 128, far
// below the tensor-core ridge. At decode (8 slots, one token each) it is
// a few MB; the design is about enough blocks in flight, and few
// re-reads of A.
//
// Design. The TPU kernels walk a sequential grid: (sequence, seq block)
// with the adapter's A/B selected by the id in the index map, or (token
// block, adapter) with a masked accumulate over ALL adapters. Here one
// block of 4 warps owns 16 consecutive tokens (one m16 tile: for
// per-sequence ids the tile never crosses a sequence) and a chunk of
// output columns:
//   * the block lists the distinct non-zero ids of its 16 tokens (ids
//     out of [0, N) count as 0); per-sequence tiles have at most one,
//     and a token only ever meets its own adapter, never all N;
//   * shrink, per distinct id a: t = x_tile @ A[a] over `in`, on the
//     tensor cores (mma.sync m16n8k16 bf16, f32 accumulate). The blocks
//     of one token tile's column chunks form a thread block cluster
//     (up to 8) and split `in` between them: each stages its share of x
//     and A[a] through shared memory in chunks (512 at r <= 16) with
//     cp.async, over its 4 warps; the warps' partial sums meet in shared
//     memory, the cluster's in distributed shared memory, and the rows
//     of tokens with id a are rounded to bf16 into one [16, r] tile T in
//     every block, each token's row holding its own adapter's shrink. So
//     x and A[a] are read once per cluster, not once per column chunk;
//   * expand, 256 columns a pass at r <= 16 (64 per warp): for each
//     distinct id a, B[a][:, cols] is staged in shared memory (two
//     buffers: the next (pass, id) item loads while this one computes)
//     and mma.sync adds T_masked @ B[a], T's rows of other ids zeroed in
//     the A fragments, so each output gets exactly its own adapter's
//     term;
//   * epilogue: the rounding chain above into a shared [16, 256] tile,
//     then 16-byte stores of whole row segments, + y when given. Rows of
//     id 0 are written too (0, or y); in place (out == y) a row without
//     adapter already holds its result and is left as it is.
// The wrapper picks the chunk width, the chunk count (a multiple of the
// cluster size) and the cluster size so the grid covers the card about
// four times (ops/lora.py _grid): at decode 8 tiles of one token each
// take up to 56 chunks of 256 columns in clusters of 8; the packed 2048
// row's 128 tiles take 8 chunks. A cluster recomputes a tile's shrink
// once per (column chunks / cluster) group, a few times in*r*16 MACs.
// Still simple: no double buffering, no wgmma, no TMA.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

namespace {

constexpr int kTM = 16;        // tokens per block: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Output columns per expand pass (NC), a multiple of which is every
// block's column chunk; the wrapper's _PASS_COLS is the largest.
constexpr int kMaxNC = 256;

// Shared memory: region 0 holds the shrink staging (Xs [16, KC],
// As [KC, RN]), then the warps' partial sums [4, 16, RN] f32, then the
// expand's two staging buffers Bs [2, RN, NC]; the block's partial
// shrink [16, RN] f32 (read by the whole cluster), T [16, RN], the
// output staging Os [16, NC] and the tile's ids follow. KC, the `in`
// elements per staged chunk, and NC shrink as RN grows (512 and 256 at
// r <= 16), keeping As near 24 KB and Bs under 40 KB. Row pitches are 8
// bf16 past the width: 16-byte aligned rows and conflict-free fragment
// loads.
template <int RN>
struct Layout {
  static constexpr int KC = RN <= 16 ? 512 : RN <= 32 ? 256
                          : RN <= 64 ? 128 : 64;
  static constexpr int NC = RN <= 32 ? kMaxNC : RN <= 64 ? 128 : 64;
  static constexpr int WC = NC / kWarps;   // columns per warp
  static constexpr int LDX = KC + 8;
  static constexpr int LDA = RN + 8;
  static constexpr int LDB = NC + 8;
  static constexpr int LDT = RN + 8;
  static constexpr int LDO = NC + 8;
  static constexpr size_t xs = 0;
  static constexpr size_t as = xs + size_t(kTM) * LDX * 2;
  static constexpr size_t region0 =
      align16(max3(as + size_t(KC) * LDA * 2,
                   size_t(kWarps) * kTM * RN * 4, 2 * size_t(RN) * LDB * 2));
  static constexpr size_t part = region0;
  static constexpr size_t tt = part + size_t(kTM) * RN * 4;
  static constexpr size_t os = tt + align16(size_t(kTM) * LDT * 2);
  static constexpr size_t meta = os + align16(size_t(kTM) * LDO * 2);
  static constexpr size_t bytes = meta + (3 * kTM + 1) * 4;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16 *p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const bf16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

// Copy a [rows, cols] tile of a row-major bf16 matrix (row pitch ld_src
// elements; its first vrows x vcols are valid) into shared memory at
// pitch ld_dst, zeros outside the valid part. vec: 16-byte cp.async
// copies (cols, vcols, ld_src and src 8-element aligned); else 2-byte
// loads, for widths that are not multiples of 8. The caller waits
// (cp_async_wait_all) and synchronises.
__device__ __forceinline__ void stage(bf16 *dst, int ld_dst, const bf16 *src,
                                      long long ld_src, int rows, int cols,
                                      int vrows, int vcols, bool vec) {
  if (vec) {
    const int vpr = cols / 8;
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bool ok = r < vrows && c < vcols;
      skyt::cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src,
                       ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * ld_dst + c] = (r < vrows && c < vcols)
                                ? src[r * ld_src + c]
                                : __float2bfloat16(0.f);
    }
  }
}

template <int RN, bool kPerToken>
__global__ void __launch_bounds__(kThreads)
lora_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ A,
            const bf16 *__restrict__ B, const int *__restrict__ ids,
            const float *__restrict__ scale, const bf16 *y, bf16 *out,
            int n_tok, int seq, int din, int r, int dout, int n_adapters,
            int col_chunk, int vec_x, int vec_a, int vec_b, int vec_o) {
  using L = Layout<RN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + L::xs);
  bf16 *As = reinterpret_cast<bf16 *>(smem + L::as);
  float *red = reinterpret_cast<float *>(smem);
  bf16 *Bs = reinterpret_cast<bf16 *>(smem);
  float *part = reinterpret_cast<float *>(smem + L::part);
  bf16 *Tt = reinterpret_cast<bf16 *>(smem + L::tt);
  bf16 *Os = reinterpret_cast<bf16 *>(smem + L::os);
  int *tok_id = reinterpret_cast<int *>(smem + L::meta);
  float *tok_scale = reinterpret_cast<float *>(tok_id + kTM);
  int *uniq = reinterpret_cast<int *>(tok_scale + kTM);
  int *n_uniq = uniq + kTM;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;

  // This block's tokens: rows tok0 .. tok0 + n_rows - 1 of x and out.
  long long tok0;
  int n_rows, seq_idx = 0;
  if (kPerToken) {
    tok0 = static_cast<long long>(blockIdx.x) * kTM;
    n_rows = n_tok - tok0 < kTM ? static_cast<int>(n_tok - tok0) : kTM;
  } else {
    const int tiles = (seq + kTM - 1) / kTM;
    seq_idx = blockIdx.x / tiles;
    const int s0 = (blockIdx.x % tiles) * kTM;
    tok0 = static_cast<long long>(seq_idx) * seq + s0;
    n_rows = min(kTM, seq - s0);
  }
  if (tid < kTM) {
    int id = 0;
    float sc = 0.f;
    if (tid < n_rows) {
      const long long t = kPerToken ? tok0 + tid : seq_idx;
      id = ids[t];
      sc = scale[t];
      if (id < 0 || id >= n_adapters) id = 0;
    }
    tok_id[tid] = id;
    tok_scale[tid] = skyt::round_bf16(sc);
  }
  for (int i = tid; i < kTM * L::LDT; i += kThreads)
    Tt[i] = __float2bfloat16(0.f);
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int m = 0; m < kTM; ++m) {
      const int id = tok_id[m];
      bool seen = id == 0;
      for (int u = 0; u < n && !seen; ++u) seen = uniq[u] == id;
      if (!seen) uniq[n++] = id;
    }
    *n_uniq = n;
  }
  __syncthreads();
  const int nu = *n_uniq;
  const bool in_place = y == out;
  // Every block of the cluster has the same tile, so the same nu.
  if (nu == 0 && in_place) return;   // every row already holds y

  // ---- shrink: T[m] = bf16(x[m] @ A[id_m]) for the rows with an adapter.
  // This block's share of `in`: [k_lo, k_hi), a multiple of 16 wide.
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int span = ((din + n_ranks - 1) / n_ranks + 15) / 16 * 16;
  const int k_lo = static_cast<int>(cluster.block_rank()) * span;
  const int k_hi = min(din, k_lo + span);
  const bf16 *xt = x + tok0 * din;
  const int blk = lane / 8;          // ldmatrix: 8x8 block this lane addresses
  for (int u = 0; u < nu; ++u) {
    const int a = uniq[u];
    const bf16 *Aa = A + static_cast<long long>(a) * din * r;
    float acc[RN / 8][4];
#pragma unroll
    for (int j = 0; j < RN / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += L::KC) {
      __syncthreads();   // the previous chunk's (or red's) readers are done
      // Rows past the tile's tokens stay unset: mma rows are independent,
      // and those rows of T are never written (their id is 0).
      stage(Xs, L::LDX, xt + k0, din, n_rows, L::KC, n_rows, k_hi - k0,
            vec_x);
      stage(As, L::LDA, Aa + static_cast<long long>(k0) * r, r, L::KC, RN,
            k_hi - k0, r, vec_a);
      skyt::cp_async_wait_all();
      __syncthreads();
      const int steps = (min(L::KC, k_hi - k0) + 15) / 16;
      for (int st = warp; st < steps; st += kWarps) {
        const int kk = st * 16;
        const bf16 *xa = Xs + g4 * L::LDX + kk + 2 * t4;
        uint32_t af[4];
        af[0] = lds32(xa);
        af[1] = lds32(xa + 8 * L::LDX);
        af[2] = lds32(xa + 8);
        af[3] = lds32(xa + 8 * L::LDX + 8);
#pragma unroll
        for (int j = 0; j < RN / 16; ++j) {
          // Four 8x8 blocks of A: rows kk + {0..7, 8..15} x rank columns
          // (2j + {0, 1}) * 8 + 0..7; lane l addresses row l%8 of block l/8.
          const bf16 *p = As + (kk + (blk & 1) * 8 + lane % 8) * L::LDA +
                          (2 * j + (blk >> 1)) * 8;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, p);
          mma_bf16(acc[2 * j], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * j + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with Xs/As: red aliases them
#pragma unroll
    for (int j = 0; j < RN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g4 + (e >> 1) * 8;
        const int n = j * 8 + 2 * t4 + (e & 1);
        red[(warp * kTM + m) * RN + n] = acc[j][e];
      }
    }
    __syncthreads();
    for (int i = tid; i < kTM * RN; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kTM * RN + i];
      part[i] = s;
    }
    cluster.sync();    // every block's partial is written
    for (int i = tid; i < kTM * RN; i += kThreads) {
      const int m = i / RN, n = i % RN;
      if (tok_id[m] == a) {
        float s = 0.f;
        for (int q = 0; q < n_ranks; ++q)
          s += cluster.map_shared_rank(part, q)[i];
        Tt[m * L::LDT + n] = __float2bfloat16(s);
      }
    }
    cluster.sync();    // no block rewrites its partial (or exits) before
                       // every peer has read it
  }

  // ---- expand: out[m, c] for this block's columns, NC a pass. The
  // (pass, id) items run through two Bs buffers: item i+1's B[a] columns
  // load while item i's products run. A pass's results go through Os to
  // 16-byte stores of whole row segments.
  const int c_begin = blockIdx.y * col_chunk;
  const int c_end = min(dout, c_begin + col_chunk);
  const int passes = c_end > c_begin ? (c_end - c_begin + L::NC - 1) / L::NC
                                     : 0;
  const int items = passes * nu;
  auto stage_b = [&](int item) {
    const int cb = c_begin + (item / nu) * L::NC;
    const bf16 *src = B + static_cast<long long>(uniq[item % nu]) * r * dout;
    stage(Bs + (item & 1) * RN * L::LDB, L::LDB, src + cb, dout, RN, L::NC,
          r, dout - cb, vec_b);
  };
  if (items > 0) stage_b(0);
  int item = 0;
  for (int p = 0; p < passes; ++p) {
    const int cb = c_begin + p * L::NC;
    float acc[L::WC / 8][4];
#pragma unroll
    for (int nt = 0; nt < L::WC / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int u = 0; u < nu; ++u, ++item) {
      skyt::cp_async_wait_all();
      __syncthreads();   // this item's Bs is in; the other buffer is free
      if (item + 1 < items) stage_b(item + 1);
      const bf16 *bs = Bs + (item & 1) * RN * L::LDB;
      const int a = uniq[u];
      const bool m0 = tok_id[g4] == a, m1 = tok_id[g4 + 8] == a;
#pragma unroll
      for (int ks = 0; ks < RN / 16; ++ks) {
        const bf16 *ta = Tt + g4 * L::LDT + ks * 16 + 2 * t4;
        uint32_t af[4];
        af[0] = m0 ? lds32(ta) : 0u;
        af[1] = m1 ? lds32(ta + 8 * L::LDT) : 0u;
        af[2] = m0 ? lds32(ta + 8) : 0u;
        af[3] = m1 ? lds32(ta + 8 * L::LDT + 8) : 0u;
#pragma unroll
        for (int h = 0; h < L::WC / 16; ++h) {
          const bf16 *q = bs + (ks * 16 + (blk & 1) * 8 + lane % 8) * L::LDB +
                          warp * L::WC + (2 * h + (blk >> 1)) * 8;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, q);
          mma_bf16(acc[2 * h], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * h + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    // The delta, rounded as JAX rounds it: this lane's rows g4 and g4 + 8,
    // columns 2*t4 and 2*t4 + 1 of each n8 tile.
    __syncthreads();     // the previous pass's stores are done with Os
#pragma unroll
    for (int nt = 0; nt < L::WC / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = g4 + half * 8;
        const float sc = tok_scale[m];
        *reinterpret_cast<__nv_bfloat162 *>(
            Os + m * L::LDO + warp * L::WC + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(
                skyt::round_bf16(acc[nt][2 * half]) * sc,
                skyt::round_bf16(acc[nt][2 * half + 1]) * sc);
      }
    }
    __syncthreads();
    constexpr int kVecs = L::NC / 8;   // 16-byte segments per row
    for (int i = tid; i < kTM * kVecs; i += kThreads) {
      const int m = i / kVecs, v = (i % kVecs) * 8, c = cb + v;
      if (m >= n_rows || c >= c_end || (in_place && tok_id[m] == 0))
        continue;
      const bf16 *o = Os + m * L::LDO + v;
      const long long at = (tok0 + m) * dout + c;
      if (vec_o) {   // dout % 8 == 0: the segment is whole
        uint4 dv = *reinterpret_cast<const uint4 *>(o);
        if (y) {
          const uint4 yv = *reinterpret_cast<const uint4 *>(y + at);
          const __nv_bfloat162 *y2 =
              reinterpret_cast<const __nv_bfloat162 *>(&yv);
          __nv_bfloat162 *d2 = reinterpret_cast<__nv_bfloat162 *>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 yf = __bfloat1622float2(y2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            d2[e] = __floats2bfloat162_rn(yf.x + df.x, yf.y + df.y);
          }
        }
        *reinterpret_cast<uint4 *>(out + at) = dv;
      } else {
        for (int e = 0; e < 8 && c + e < c_end; ++e) {
          const float d = __bfloat162float(o[e]);
          out[at + e] =
              __float2bfloat16(y ? __bfloat162float(y[at + e]) + d : d);
        }
      }
    }
  }
}

template <int RN, bool kPerToken>
int launch(const void *x, const void *a, const void *b, const void *ids,
           const void *scale, const void *y, void *out, int n_seq, int seq,
           int din, int r, int dout, int n_adapters, int col_chunk,
           int col_tiles, int cluster, cudaStream_t stream) {
  const size_t bytes = Layout<RN>::bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_kernel<RN, kPerToken>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_tok = static_cast<long long>(n_seq) * seq;
  const long long row_tiles =
      kPerToken ? (n_tok + kTM - 1) / kTM
                : static_cast<long long>(n_seq) * ((seq + kTM - 1) / kTM);
  auto aligned = [](const void *p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = din % 8 == 0 && aligned(x);
  const int vec_a = r % 8 == 0 && aligned(a);
  const int vec_b = dout % 8 == 0 && aligned(b);
  const int vec_o = dout % 8 == 0 && aligned(out) && (!y || aligned(y));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_tiles), col_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lora_kernel<RN, kPerToken>, static_cast<const bf16 *>(x),
      static_cast<const bf16 *>(a), static_cast<const bf16 *>(b),
      static_cast<const int *>(ids), static_cast<const float *>(scale),
      static_cast<const bf16 *>(y), static_cast<bf16 *>(out),
      static_cast<int>(n_tok), seq, din, r, dout, n_adapters, col_chunk,
      vec_x, vec_a, vec_b, vec_o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPerToken>
int dispatch(const void *x, const void *a, const void *b, const void *ids,
             const void *scale, const void *y, void *out, int n_seq, int seq,
             int din, int r, int dout, int n_adapters, int col_chunk,
             int col_tiles, int cluster, cudaStream_t st) {
#define SKYT_LORA_LAUNCH(RN)                                                \
  launch<RN, kPerToken>(x, a, b, ids, scale, y, out, n_seq, seq, din, r,   \
                        dout, n_adapters, col_chunk, col_tiles, cluster, st)
  if (r <= 16) return SKYT_LORA_LAUNCH(16);
  if (r <= 32) return SKYT_LORA_LAUNCH(32);
  if (r <= 64) return SKYT_LORA_LAUNCH(64);
  return SKYT_LORA_LAUNCH(128);
#undef SKYT_LORA_LAUNCH
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// x [n_seq * seq, in], a [N, in, r], b [N, r, out], y / out
// [n_seq * seq, out]: bf16, contiguous. ids / scale: int32 / f32, [n_seq]
// (per_token 0) or [n_seq * seq] (per_token 1). y may be null (out =
// delta) or equal out (in place). col_chunk: output columns per block, a
// positive multiple of 256; col_tiles blocks per token tile (at least
// ceil(out / col_chunk); blocks past `out` only share the shrink), a
// multiple of cluster, which is 1, 2, 4 or 8. 1 <= r <= 128.
extern "C" int skyt_lora(const void *x, const void *a, const void *b,
                         const void *ids, const void *scale, const void *y,
                         void *out, int n_seq, int seq, int din, int r,
                         int dout, int n_adapters, int per_token,
                         int col_chunk, int col_tiles, int cluster,
                         void *stream) {
  if (n_seq <= 0 || seq <= 0 || din <= 0 || dout <= 0 || r < 1 || r > 128 ||
      n_adapters < 1 || col_chunk <= 0 || col_chunk % kMaxNC != 0 ||
      static_cast<long long>(col_chunk) * col_tiles < dout ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      col_tiles % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_token)
    return dispatch<true>(x, a, b, ids, scale, y, out, n_seq, seq, din, r,
                          dout, n_adapters, col_chunk, col_tiles, cluster,
                          st);
  return dispatch<false>(x, a, b, ids, scale, y, out, n_seq, seq, din, r,
                         dout, n_adapters, col_chunk, col_tiles, cluster, st);
}
