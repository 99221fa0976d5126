// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces skypilot_tpu/ops/flash_attention.py:108 _fwd_kernel (launched
// by _flash_fwd_impl): FA2 online-softmax attention with causal,
// segment-id and sliding-window masks, GQA (query head h reads kv head
// h // (Hq/Hkv)) and the per-row logsumexp.
//
// What bounds it on this card: tensor-core FLOPs at long packed rows
// (useful work 4*Hq*d*sum_j n_j(n_j+1)/2 over the segments against
// 989 TFLOP/s bf16); q, k, v and out cross memory once.
//
// Design. The TPU kernel walks a sequential (q block, k block) grid
// carrying m/l/acc in VMEM scratch. Here one block of 4 warps owns one
// (64-row q tile, query head, batch) and walks the k tiles itself:
//   * the loop stops at the causal diagonal (no tile past the tile's
//     last query row is touched) and, with a sliding window, starts at
//     the first tile that reaches the lowest query's window
//     (_qk_block_overlaps), so a windowed row costs O(window); with
//     segment ids a tile whose keys share no segment with the tile's
//     queries (that can see them, with a window) is skipped before its
//     K/V are loaded (the ids of 8 tiles are checked in one pass), so a
//     packed row costs about the sum of its segments' own triangles,
//     not the whole row's;
//   * Q, K, V tiles are staged in shared memory with 16-byte cp.async
//     copies, all in flight at once, read through the [B, S, H, D]
//     strides (no transpose copies);
//   * each warp owns 16 query rows and keeps everything of them in
//     registers, as FA2 does: S = QK^T and O += PV run on the tensor
//     cores as mma.sync m16n8k16 bf16 with f32 accumulation; a thread
//     holds 2 rows x 16 scores, so a row's max and sum take 2 shuffles;
//     the softmax weights P go from the S accumulators straight into
//     the A operand of PV (bf16), and the O accumulators are rescaled
//     by exp(m_prev - m_new) in registers. V's B operand comes from
//     shared memory through ldmatrix.trans;
//   * masks follow _block_mask: causal on the packed index (q >= k),
//     q - k < window when a window is given (causal or not: a non-causal
//     row sees a one-sided band), and q_seg == k_seg when segment ids
//     are given (id 0 padding is masked like any other segment). Masked
//     scores use the TPU kernel's -1e30 with exact zeros for p, guarded
//     by value: a row may see nothing in the first tile it visits (with
//     a window that is routine), and then its running max is -1e30 and
//     exp(s - m) would be 1. A row with no visible key gives out 0 and
//     lse 0. The window is a second instantiation (kWindow), so the
//     unwindowed kernel carries none of its arithmetic.
// Still simple: one K/V buffer (no double buffering), no wgmma, TMA or
// warp specialisation.
#include "common.cuh"

#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kBM = 64;       // query rows per block (16 per warp)
constexpr int kBN = 64;       // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;     // k tiles per segment-id pass

template <int D>
struct Layout {
  static constexpr int LD = D + 8;   // bf16 row pitch: 16-byte aligned
                                     // rows, conflict-free fragments
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(kBM) * LD * 2;
  static constexpr size_t v = k + size_t(kBN) * LD * 2;
  static constexpr size_t qseg = v + size_t(kBN) * LD * 2;
  static constexpr size_t kseg = qseg + size_t(kBM) * 4;
  static constexpr size_t hit = kseg + size_t(kBN) * kBatch * 4;
  static constexpr size_t bytes = hit + size_t(kBatch) * 4;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t *>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                 const bf16 *__restrict__ v, const int *__restrict__ seg,
                 bf16 *__restrict__ out, float *__restrict__ lse,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int sq, int sk, int hq, int hkv, int causal,
                 int window_arg, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int kDSteps = D / 16;    // k-steps of S = QK^T
  constexpr int kSTiles = kBN / 8;   // n8 tiles of S
  constexpr int kOTiles = D / 8;     // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Qs = reinterpret_cast<bf16 *>(smem + L::q);
  bf16 *Ks = reinterpret_cast<bf16 *>(smem + L::k);
  bf16 *Vs = reinterpret_cast<bf16 *>(smem + L::v);
  int *qsegs = reinterpret_cast<int *>(smem + L::qseg);
  int *ksegs = reinterpret_cast<int *>(smem + L::kseg);   // a batch's ids
  int *tile_hit = reinterpret_cast<int *>(smem + L::hit);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;           // fragment row within 8
  const int t4 = lane % 4;           // fragment column pair
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16 *qb = q + b * q_sb + h * q_sh;
  const bf16 *kb = k + b * k_sb + hk * k_sh;
  const bf16 *vb = v + b * v_sb + hk * v_sh;
  // Packed self-attention: one [B, S] id row serves queries and keys.
  const int *segb = seg ? seg + static_cast<long long>(b) * sk : nullptr;

  constexpr int kVecPerRow = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < kBM * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    const bool in = q0 + r < sq;
    skyt::cp_async16(Qs + r * LD + c, in ? qb + (q0 + r) * q_ss + c : qb,
                     in ? 16 : 0);
  }
  for (int i = tid; i < kBM; i += kThreads)
    qsegs[i] = (segb && q0 + i < sq) ? segb[q0 + i] : 0;
  skyt::cp_async_wait_all();
  __syncthreads();

  // This thread's rows within the block: r0 and r0 + 8.
  const int r0 = warp * 16 + g4;
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const int qseg0 = qsegs[r0], qseg1 = qsegs[r0 + 8];
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks) {
    const bf16 *base = Qs + r0 * LD + ks * 16 + 2 * t4;
    qf[ks][0] = lds32(base);
    qf[ks][1] = lds32(base + 8 * LD);
    qf[ks][2] = lds32(base + 8);
    qf[ks][3] = lds32(base + 8 * LD + 8);
  }

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = skyt::kNegInf, m1 = skyt::kNegInf, l0 = 0.f, l1 = 0.f;

  // Causal: keys past the tile's last query row are all masked. Window
  // (query i sees key j only when i - j < window): keys at or below the
  // lowest query's q0 - window are all masked, so the loop starts at the
  // tile holding q0 - window + 1.
  const int window = kWindow ? window_arg : 0;
  const int k_end = causal ? min(sk, q0 + kBM) : sk;
  const int k_begin = kWindow ? max(0, q0 - window + 1) / kBN * kBN : 0;
  // k tiles are taken in batches of kBatch: with segment ids, one pass
  // over a batch's ids marks the tiles holding a key whose id some query
  // row of this tile has (and that a causal row, or a row whose window
  // reaches it, can see); the others are skipped without loading their
  // K/V.
  for (int kb0 = k_begin; kb0 < k_end; kb0 += kBN * kBatch) {
    unsigned hits = ~0u;
    if (segb) {
      __syncthreads();   // every warp is done with the previous batch
      if (tid < kBatch) tile_hit[tid] = 0;
      __syncthreads();
      for (int i = tid; i < kBN * kBatch; i += kThreads) {
        const int kj = kb0 + i;
        const int ks = kj < sk ? segb[kj] : -1;
        ksegs[i] = ks;
        if (kj < k_end && (!causal || kj < q0 + kBM)) {
          // With a window, only rows q0 + r in [kj, kj + window) (from 0
          // when not causal), below sq, see the key.
          const int r_lo = kWindow && causal ? max(0, kj - q0) : 0;
          const int r_hi =
              kWindow ? min(kBM, min(sq, kj + window) - q0) : kBM;
          for (int r = r_lo; r < r_hi; ++r) {
            if (qsegs[r] == ks) {
              tile_hit[i / kBN] = 1;
              break;
            }
          }
        }
      }
      __syncthreads();
      hits = 0;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) hits |= tile_hit[t] ? 1u << t : 0u;
    }
    for (int tt = 0; tt < kBatch; ++tt) {
      const int k0 = kb0 + tt * kBN;
      if (k0 >= k_end) break;
      if (!((hits >> tt) & 1u)) continue;
      const int *ktile_seg = ksegs + tt * kBN;
      __syncthreads();   // every warp is done with the previous tile
      for (int i = tid; i < kBN * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
        const bool in = k0 + r < sk;
        skyt::cp_async16(Ks + r * LD + c, in ? kb + (k0 + r) * k_ss + c : kb,
                         in ? 16 : 0);
        skyt::cp_async16(Vs + r * LD + c, in ? vb + (k0 + r) * v_ss + c : vb,
                         in ? 16 : 0);
      }
      skyt::cp_async_wait_all();
      __syncthreads();

      // S [16, kBN] for this warp: n8 tile nt covers keys nt*8 .. +8.
      float s[kSTiles][4];
#pragma unroll
      for (int nt = 0; nt < kSTiles; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const bf16 *kr = Ks + (nt * 8 + g4) * LD + 2 * t4;
#pragma unroll
        for (int ks = 0; ks < kDSteps; ++ks)
          mma_bf16(s[nt], qf[ks], lds32(kr + ks * 16), lds32(kr + ks * 16 + 8));
      }

      // Scale, mask and the online-softmax update of rows qi0 and qi1.
      float mx0 = skyt::kNegInf, mx1 = skyt::kNegInf;
#pragma unroll
      for (int nt = 0; nt < kSTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          const int kj = k0 + c;
          const int qi = e < 2 ? qi0 : qi1;
          const int qsg = e < 2 ? qseg0 : qseg1;
          const bool ok = qi < sq && kj < sk && (!causal || kj <= qi) &&
                          (!kWindow || qi - kj < window) &&
                          (!segb || qsg == ktile_seg[c]);
          s[nt][e] = ok ? s[nt][e] * scale : skyt::kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kSTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn0 : mn1;
          // Exact zeros for masked entries (the TPU kernel's guard).
          s[nt][e] = s[nt][e] <= skyt::kNegInf / 2 ? 0.f
                                                   : __expf(s[nt][e] - mn);
        }
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }

      // O [16, D] += P [16, kBN] . V [kBN, D]; P's A fragments come from
      // the S accumulators (k-step j uses S tiles 2j and 2j+1).
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int nt = 0; nt < kOTiles; nt += 2) {
          // Four 8x8 blocks of V: keys j*16 + {0..7, 8..15} x dims
          // nt*8 + {0..7, 8..15}; lane l addresses row l%8 of block l/8.
          const int blk = lane / 8;
          const bf16 *p = Vs + (j * 16 + (blk & 1) * 8 + lane % 8) * LD +
                          (nt + (blk >> 1)) * 8;
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, p);
          mma_bf16(o[nt], pa, vf[0], vf[1]);
          mma_bf16(o[nt + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // out [B, Sq, Hq, D] contiguous; lse [B, Hq, Sq].
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  bf16 *orow0 = out + ((static_cast<long long>(b) * sq + qi0) * hq + h) * D;
  bf16 *orow1 = out + ((static_cast<long long>(b) * sq + qi1) * hq + h) * D;
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    const int c = nt * 8 + 2 * t4;
    if (qi0 < sq)
      *reinterpret_cast<__nv_bfloat162 *>(orow0 + c) =
          __floats2bfloat162_rn(o[nt][0] * inv0, o[nt][1] * inv0);
    if (qi1 < sq)
      *reinterpret_cast<__nv_bfloat162 *>(orow1 + c) =
          __floats2bfloat162_rn(o[nt][2] * inv1, o[nt][3] * inv1);
  }
  if (t4 == 0) {
    float *lrow = lse + (static_cast<long long>(b) * hq + h) * sq;
    if (qi0 < sq) lrow[qi0] = l0 > 0.f ? m0 + logf(l0) : 0.f;
    if (qi1 < sq) lrow[qi1] = l1 > 0.f ? m1 + logf(l1) : 0.f;
  }
}

template <int D, bool kWindow>
int launch(const void *q, const void *k, const void *v, const void *seg,
           void *out, void *lse, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, int b, int sq,
           int sk, int hq, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((sq + kBM - 1) / kBM, hq, b);
  flash_fwd_kernel<D, kWindow><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16 *>(q), static_cast<const bf16 *>(k),
      static_cast<const bf16 *>(v), static_cast<const int *>(seg),
      static_cast<bf16 *>(out), static_cast<float *>(lse), q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sq, sk, hq, hkv, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void *q, const void *k, const void *v, const void *seg,
             void *out, void *lse, long long q_sb, long long q_ss,
             long long q_sh, long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh, int b, int sq,
             int sk, int hq, int hkv, int causal, int window, float scale,
             cudaStream_t stream) {
  return window > 0
             ? launch<D, true>(q, k, v, seg, out, lse, q_sb, q_ss, q_sh, k_sb,
                               k_ss, k_sh, v_sb, v_ss, v_sh, b, sq, sk, hq,
                               hkv, causal, window, scale, stream)
             : launch<D, false>(q, k, v, seg, out, lse, q_sb, q_ss, q_sh,
                                k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, b, sq, sk,
                                hq, hkv, causal, 0, scale, stream);
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 with unit last stride and
// 16-byte aligned rows (strides in elements); seg [B, S] int32 or null;
// out [B, Sq, Hq, D] bf16 contiguous; lse [B, Hq, Sq] f32 contiguous.
// window > 0: query i sees key j only when i - j < window (0: no window).
extern "C" int skyt_flash_fwd(const void *q, const void *k, const void *v,
                              const void *seg, void *out, void *lse,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              int b, int sq, int sk, int hq, int hkv, int d,
                              int causal, int window, float scale,
                              void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_d<64>(q, k, v, seg, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss,
                        k_sh, v_sb, v_ss, v_sh, b, sq, sk, hq, hkv, causal,
                        window, scale, st);
  if (d == 128)
    return launch_d<128>(q, k, v, seg, out, lse, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, b, sq, sk, hq, hkv,
                         causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
