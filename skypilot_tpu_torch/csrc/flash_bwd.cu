// Flash attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces skypilot_tpu/ops/flash_attention.py:168 _dq_kernel and :216
// _dkv_kernel (both launched by _bwd_rule). From the forward's residuals
// (q, k, v, the row logsumexp L) and delta = rowsum(dO * O), both
// recompute p = exp(s - L) tile by tile, with s = q.k * scale masked as
// _block_mask masks it (causal on the packed index, q_seg == k_seg when
// segment ids are given), and
//   dp = dO . v^T,  ds = p * (dp - delta) * scale,
//   dq = ds . k,    dk = ds^T . q,    dv = p^T . dO.
// A row with no visible key has L = 0 and p exactly 0, as there.
//
// What bounds it on this card: tensor-core FLOPs. Per query head and
// visible (q, k) pair the dq kernel does 6*d flops (s, dp, dq) and the
// dk/dv kernel 8*d (s, dp, dv, dk) against 989 TFLOP/s bf16; each input
// crosses memory about once per tile that reads it. The designs therefore
// stop at the causal diagonal and skip tiles that share no segment before
// their loads, as the forward does (csrc/flash_fwd.cu).
//
// Design. The TPU kernels walk sequential grids carrying dq (or dk, dv)
// in VMEM scratch. Here a block of 4 warps owns its output tile and
// walks the other sequence axis itself:
//   * dq: one block per (64-row q tile, query head, batch). Q and dO stay
//     in shared memory; each 64-key tile of K and V is staged with 16-byte
//     cp.async copies through the [B, S, H, D] strides. Each warp owns 16
//     query rows: S = Q K^T and dP = dO V^T run as mma.sync m16n8k16 with
//     f32 accumulators, p and ds are formed in registers, and ds goes
//     straight from the accumulators into the A operand of dq += ds . K
//     (K's B operand through ldmatrix.trans), as the forward's P . V.
//   * dk/dv: one block per (64-key tile, kv head, batch). It walks the
//     kv head's whole query group and the q tiles from the diagonal down,
//     so dk and dv are summed over the group inside the block (JAX keeps
//     per-query-head [B, Hq, S, D] results and reduces them afterwards).
//     Each warp owns 16 key rows and computes the transposed tiles
//     S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T sit in the
//     accumulators in the A-operand layout of dv += P^T . dO and
//     dk += dS^T . Q: no transpose is staged anywhere. For head_dim 128
//     the q tile is 32 rows, which keeps the two [16, 128] f32
//     accumulators and the score tiles in registers.
//   * p is rounded to bf16 before P^T . dO and ds before ds . k and
//     dS^T . q, as the TPU kernels cast them to the operand dtype.
//   * The heaviest causal tiles are scheduled first (the dq grid runs
//     its q tiles from the last).
// Still simple: one buffer per operand (no double buffering), no wgmma,
// TMA or warp specialisation.
#include "common.cuh"

#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kBM = 64;       // dq: query rows per block; dkv: keys per block
constexpr int kBN = 64;       // dq: keys per k tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// A operand (16 rows from `row`, k-step ks) of a row-major tile in shared
// memory at pitch LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16 *tile,
                                       int row, int ks, int t4) {
  const bf16 *base = tile + row * LD + ks * 16 + 2 * t4;
  a[0] = lds32(base);
  a[1] = lds32(base + 8 * LD);
  a[2] = lds32(base + 8);
  a[3] = lds32(base + 8 * LD + 8);
}

// Stage `rows` rows of D bf16 (row r at src + r * stride) into shared
// memory at pitch D + 8 with 16-byte cp.async copies; rows at or past
// `valid` are zero-filled. The caller waits and synchronises.
template <int D>
__device__ __forceinline__ void stage_rows(bf16 *dst, const bf16 *src,
                                           long long stride, int rows,
                                           int valid, int tid) {
  constexpr int kVec = D / 8;
  for (int i = tid; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool in = r < valid;
    skyt::cp_async16(dst + r * (D + 8) + c, in ? src + r * stride + c : src,
                     in ? 16 : 0);
  }
}

// Accumulators [16, D] of rows `row0` and `row0 + 8` (rows at or past
// `s` skipped) into a contiguous [B, S, H, D] bf16 tensor at `base` (the
// (b, h) origin, row pitch H * D).
template <int D>
__device__ __forceinline__ void store_rows(bf16 *base, long long pitch,
                                           int row0, int s, int t4,
                                           const float (&acc)[D / 8][4]) {
  bf16 *p0 = base + row0 * pitch;
  bf16 *p1 = p0 + 8 * pitch;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t4;
    if (row0 < s)
      *reinterpret_cast<__nv_bfloat162 *>(p0 + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (row0 + 8 < s)
      *reinterpret_cast<__nv_bfloat162 *>(p1 + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

template <int D>
struct DqLayout {
  static constexpr int LD = D + 8;   // 16-byte aligned rows, conflict-free
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + size_t(kBM) * LD * 2;
  static constexpr size_t k = dout + size_t(kBM) * LD * 2;
  static constexpr size_t v = k + size_t(kBN) * LD * 2;
  static constexpr size_t qseg = v + size_t(kBN) * LD * 2;
  static constexpr size_t kseg = qseg + size_t(kBM) * 4;
  static constexpr size_t bytes = kseg + size_t(kBN) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                const bf16 *__restrict__ v, const bf16 *__restrict__ dout,
                const float *__restrict__ lse,
                const float *__restrict__ delta, const int *__restrict__ seg,
                bf16 *__restrict__ dq, long long q_sb, long long q_ss,
                long long q_sh, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, long long o_sb, long long o_ss,
                long long o_sh, int s, int hq, int hkv, int causal,
                float scale) {
  using L = DqLayout<D>;
  constexpr int LD = L::LD;
  constexpr int kDSteps = D / 16;    // k-steps of S and dP
  constexpr int kSTiles = kBN / 8;   // n8 tiles of S and dP
  constexpr int kOTiles = D / 8;     // n8 tiles of dq
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Qs = reinterpret_cast<bf16 *>(smem + L::q);
  bf16 *dOs = reinterpret_cast<bf16 *>(smem + L::dout);
  bf16 *Ks = reinterpret_cast<bf16 *>(smem + L::k);
  bf16 *Vs = reinterpret_cast<bf16 *>(smem + L::v);
  int *qsegs = reinterpret_cast<int *>(smem + L::qseg);
  int *ksegs = reinterpret_cast<int *>(smem + L::kseg);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  // Causal: the last q tiles walk the most k tiles; start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16 *kb = k + b * k_sb + hk * k_sh;
  const bf16 *vb = v + b * v_sb + hk * v_sh;
  const int *segb = seg ? seg + static_cast<long long>(b) * s : nullptr;

  stage_rows<D>(Qs, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, kBM, s - q0,
                tid);
  stage_rows<D>(dOs, dout + b * o_sb + h * o_sh + q0 * o_ss, o_ss, kBM,
                s - q0, tid);
  for (int i = tid; i < kBM; i += kThreads)
    qsegs[i] = (segb && q0 + i < s) ? segb[q0 + i] : -1;
  skyt::cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16 + g4;     // this thread's rows r0 and r0 + 8
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const int qseg0 = qsegs[r0], qseg1 = qsegs[r0 + 8];
  const float *lrow = lse + (static_cast<long long>(b) * hq + h) * s;
  const float *drow = delta + (static_cast<long long>(b) * hq + h) * s;
  const float lse0 = qi0 < s ? lrow[qi0] : 0.f;
  const float lse1 = qi1 < s ? lrow[qi1] : 0.f;
  const float dl0 = qi0 < s ? drow[qi0] : 0.f;
  const float dl1 = qi1 < s ? drow[qi1] : 0.f;

  float acc[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  // Causal: keys past the tile's last query row are all masked.
  const int k_end = causal ? min(s, q0 + kBM) : s;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();   // every warp is done with the previous tile
    if (segb) {
      // Skip a tile whose keys share no segment with a visible query row.
      int hit = 0;
      if (tid < kBN) {
        const int kj = k0 + tid;
        const int ks = kj < s ? segb[kj] : -2;
        ksegs[tid] = ks;
        if (kj < k_end) {
          for (int r = 0; r < kBM; ++r) {
            if (qsegs[r] == ks && (!causal || kj <= q0 + r)) {
              hit = 1;
              break;
            }
          }
        }
      }
      if (!__syncthreads_or(hit)) continue;
    }
    stage_rows<D>(Ks, kb + k0 * k_ss, k_ss, kBN, s - k0, tid);
    stage_rows<D>(Vs, vb + k0 * v_ss, v_ss, kBN, s - k0, tid);
    skyt::cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x kBN keys.
    float sc[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int nt = 0; nt < kSTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, r0, ks, t4);
      load_a<LD>(da, dOs, r0, ks, t4);
#pragma unroll
      for (int nt = 0; nt < kSTiles; ++nt) {
        const bf16 *kr = Ks + (nt * 8 + g4) * LD + ks * 16 + 2 * t4;
        const bf16 *vr = Vs + (nt * 8 + g4) * LD + ks * 16 + 2 * t4;
        mma_bf16(sc[nt], qa, lds32(kr), lds32(kr + 8));
        mma_bf16(dp[nt], da, lds32(vr), lds32(vr + 8));
      }
    }

    // p = exp(s - L) on visible entries (exact zeros elsewhere), then
    // ds = p * (dp - delta) * scale, in place of s.
#pragma unroll
    for (int nt = 0; nt < kSTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const int kj = k0 + c;
        const int qi = e < 2 ? qi0 : qi1;
        const int qsg = e < 2 ? qseg0 : qseg1;
        const bool ok = qi < s && kj < s && (!causal || kj <= qi) &&
                        (!segb || qsg == ksegs[c]);
        const float p =
            ok ? __expf(sc[nt][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * scale;
      }
    }

    // dq [16, D] += dS [16, kBN] . K [kBN, D]; dS's A fragments come from
    // the accumulators (k-step j uses tiles 2j and 2j+1).
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
#pragma unroll
      for (int nt = 0; nt < kOTiles; nt += 2) {
        // Four 8x8 blocks of K: keys j*16 + {0..7, 8..15} x dims
        // nt*8 + {0..7, 8..15}; lane l addresses row l%8 of block l/8.
        const int blk = lane / 8;
        const bf16 *p = Ks + (j * 16 + (blk & 1) * 8 + lane % 8) * LD +
                        (nt + (blk >> 1)) * 8;
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, p);
        mma_bf16(acc[nt], pa, kf[0], kf[1]);
        mma_bf16(acc[nt + 1], pa, kf[2], kf[3]);
      }
    }
  }

  // dq [B, S, Hq, D] contiguous.
  store_rows<D>(dq + (static_cast<long long>(b) * s * hq + h) * D,
                static_cast<long long>(hq) * D, qi0, s, t4, acc);
}

template <int D, int BQ>
struct DkvLayout {
  static constexpr int LD = D + 8;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + size_t(kBM) * LD * 2;
  static constexpr size_t q = v + size_t(kBM) * LD * 2;
  static constexpr size_t dout = q + size_t(BQ) * LD * 2;
  static constexpr size_t lse = dout + size_t(BQ) * LD * 2;
  static constexpr size_t delta = lse + size_t(BQ) * 4;
  static constexpr size_t qseg = delta + size_t(BQ) * 4;
  static constexpr size_t kseg = qseg + size_t(BQ) * 4;
  static constexpr size_t bytes = kseg + size_t(kBM) * 4;
};

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                 const bf16 *__restrict__ v, const bf16 *__restrict__ dout,
                 const float *__restrict__ lse,
                 const float *__restrict__ delta,
                 const int *__restrict__ seg, bf16 *__restrict__ dk,
                 bf16 *__restrict__ dv, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, int s, int hq, int hkv, int causal,
                 float scale) {
  using L = DkvLayout<D, BQ>;
  constexpr int LD = L::LD;
  constexpr int kDSteps = D / 16;    // k-steps of S^T and dP^T
  constexpr int kQTiles = BQ / 8;    // n8 tiles of S^T and dP^T
  constexpr int kOTiles = D / 8;     // n8 tiles of dk and dv
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Ks = reinterpret_cast<bf16 *>(smem + L::k);
  bf16 *Vs = reinterpret_cast<bf16 *>(smem + L::v);
  bf16 *Qs = reinterpret_cast<bf16 *>(smem + L::q);
  bf16 *dOs = reinterpret_cast<bf16 *>(smem + L::dout);
  float *lses = reinterpret_cast<float *>(smem + L::lse);
  float *deltas = reinterpret_cast<float *>(smem + L::delta);
  int *qsegs = reinterpret_cast<int *>(smem + L::qseg);
  int *ksegs = reinterpret_cast<int *>(smem + L::kseg);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  // Causal: the first k tiles see the most q tiles; they start first.
  const int k0 = blockIdx.x * kBM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int *segb = seg ? seg + static_cast<long long>(b) * s : nullptr;

  stage_rows<D>(Ks, k + b * k_sb + hk * k_sh + k0 * k_ss, k_ss, kBM, s - k0,
                tid);
  stage_rows<D>(Vs, v + b * v_sb + hk * v_sh + k0 * v_ss, v_ss, kBM, s - k0,
                tid);
  for (int i = tid; i < kBM; i += kThreads)
    ksegs[i] = (segb && k0 + i < s) ? segb[k0 + i] : -2;
  skyt::cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16 + g4;     // this thread's key rows r0, r0 + 8
  const int kj0 = k0 + r0, kj1 = kj0 + 8;
  const int kseg0 = ksegs[r0], kseg1 = ksegs[r0 + 8];

  float dka[kOTiles][4], dva[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  // Causal: q tiles wholly above the tile's first key see none of it.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < s; q0 += BQ) {
    __syncthreads();   // every warp is done with the previous q tile
    if (segb) {
      // Skip a q tile whose rows share no segment with a visible key.
      int hit = 0;
      if (tid < BQ) {
        const int qi = q0 + tid;
        const int qs = qi < s ? segb[qi] : -1;
        qsegs[tid] = qs;
        if (qi < s) {
          for (int c = 0; c < kBM; ++c) {
            if (ksegs[c] == qs && (!causal || k0 + c <= qi)) {
              hit = 1;
              break;
            }
          }
        }
      }
      if (!__syncthreads_or(hit)) continue;
    }
    for (int hh = 0; hh < group; ++hh) {
      const int h = hk * group + hh;
      if (hh > 0) __syncthreads();   // done with the previous head's rows
      stage_rows<D>(Qs, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, BQ,
                    s - q0, tid);
      stage_rows<D>(dOs, dout + b * o_sb + h * o_sh + q0 * o_ss, o_ss, BQ,
                    s - q0, tid);
      const long long row = (static_cast<long long>(b) * hq + h) * s;
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = q0 + i < s;
        lses[i] = in ? lse[row + q0 + i] : 0.f;
        deltas[i] = in ? delta[row + q0 + i] : 0.f;
      }
      skyt::cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries.
      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, r0, ks, t4);
        load_a<LD>(va, Vs, r0, ks, t4);
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt) {
          const bf16 *qr = Qs + (nt * 8 + g4) * LD + ks * 16 + 2 * t4;
          const bf16 *dr = dOs + (nt * 8 + g4) * LD + ks * 16 + 2 * t4;
          mma_bf16(st[nt], ka, lds32(qr), lds32(qr + 8));
          mma_bf16(dpt[nt], va, lds32(dr), lds32(dr + 8));
        }
      }

      // P^T = exp(S^T - L) on visible entries, dS^T = P^T (dP^T - delta)
      // * scale; column c is query q0 + c.
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          const int qi = q0 + c;
          const int kj = e < 2 ? kj0 : kj1;
          const int ksg = e < 2 ? kseg0 : kseg1;
          const bool ok = qi < s && kj < s && (!causal || kj <= qi) &&
                          (!segb || qsegs[c] == ksg);
          const float p = ok ? __expf(st[nt][e] * scale - lses[c]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - deltas[c]) * scale;
        }
      }

      // dv [16, D] += P^T [16, BQ] . dO [BQ, D] and
      // dk [16, D] += dS^T [16, BQ] . Q [BQ, D]; the A fragments come
      // from the accumulators, the B fragments through ldmatrix.trans.
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(st[2 * j][0], st[2 * j][1]);
        pa[1] = pack_bf16(st[2 * j][2], st[2 * j][3]);
        pa[2] = pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]);
        pa[3] = pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3]);
        sa[0] = pack_bf16(dpt[2 * j][0], dpt[2 * j][1]);
        sa[1] = pack_bf16(dpt[2 * j][2], dpt[2 * j][3]);
        sa[2] = pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]);
        sa[3] = pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3]);
        const int blk = lane / 8;
        const int rr = j * 16 + (blk & 1) * 8 + lane % 8;
#pragma unroll
        for (int nt = 0; nt < kOTiles; nt += 2) {
          const int cc = (nt + (blk >> 1)) * 8;
          uint32_t of[4], qf[4];
          ldmatrix_x4_trans(of, dOs + rr * LD + cc);
          mma_bf16(dva[nt], pa, of[0], of[1]);
          mma_bf16(dva[nt + 1], pa, of[2], of[3]);
          ldmatrix_x4_trans(qf, Qs + rr * LD + cc);
          mma_bf16(dka[nt], sa, qf[0], qf[1]);
          mma_bf16(dka[nt + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }

  // dk, dv [B, S, Hkv, D] contiguous.
  const long long origin = (static_cast<long long>(b) * s * hkv + hk) * D;
  const long long pitch = static_cast<long long>(hkv) * D;
  store_rows<D>(dk + origin, pitch, kj0, s, t4, dka);
  store_rows<D>(dv + origin, pitch, kj0, s, t4, dva);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg;
  bf16 *out0, *out1;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
  int b, s, hq, hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args &a) {
  const size_t bytes = DqLayout<D>::bytes;
  const int err = set_smem(flash_dq_kernel<D>, bytes);
  if (err) return err;
  dim3 grid((a.s + kBM - 1) / kBM, a.hq, a.b);
  flash_dq_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, a.out0, a.q_sb, a.q_ss,
      a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss,
      a.o_sh, a.s, a.hq, a.hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ>
int launch_dkv(const Args &a) {
  const size_t bytes = DkvLayout<D, BQ>::bytes;
  const int err = set_smem(flash_dkv_kernel<D, BQ>, bytes);
  if (err) return err;
  dim3 grid((a.s + kBM - 1) / kBM, a.hkv, a.b);
  flash_dkv_kernel<D, BQ><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, a.out0, a.out1, a.q_sb,
      a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb,
      a.o_ss, a.o_sh, a.s, a.hq, a.hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void *q, const void *k, const void *v, const void *dout,
               const void *lse, const void *delta, const void *seg,
               void *out0, void *out1, long long q_sb, long long q_ss,
               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh, long long o_sb,
               long long o_ss, long long o_sh, int b, int s, int hq, int hkv,
               int causal, float scale, void *stream) {
  return Args{static_cast<const bf16 *>(q), static_cast<const bf16 *>(k),
              static_cast<const bf16 *>(v), static_cast<const bf16 *>(dout),
              static_cast<const float *>(lse),
              static_cast<const float *>(delta),
              static_cast<const int *>(seg), static_cast<bf16 *>(out0),
              static_cast<bf16 *>(out1), q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
              v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, b, s, hq, hkv, causal, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// Both entry points take the same arguments: q [B, S, Hq, D], k/v
// [B, S, Hkv, D] and dO [B, S, Hq, D] bf16 with unit last stride and
// 16-byte aligned rows (strides in elements); lse and delta [B, Hq, S]
// f32 contiguous; seg [B, S] int32 or null. skyt_flash_bwd_dq writes dq
// [B, S, Hq, D] to out0 (out1 unused); skyt_flash_bwd_dkv writes dk and
// dv [B, S, Hkv, D] to out0 and out1. All outputs bf16 contiguous.
#define SKYT_BWD_PARAMS                                                       \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, const void *seg, void *out0,       \
      void *out1, long long q_sb, long long q_ss, long long q_sh,            \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, long long o_sb, long long o_ss,        \
      long long o_sh, int b, int s, int hq, int hkv, int d, int causal,      \
      float scale, void *stream
#define SKYT_BWD_ARGS                                                         \
  make_args(q, k, v, dout, lse, delta, seg, out0, out1, q_sb, q_ss, q_sh,    \
            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, b, s, hq,  \
            hkv, causal, scale, stream)

extern "C" int skyt_flash_bwd_dq(SKYT_BWD_PARAMS) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = SKYT_BWD_ARGS;
  if (d == 64) return launch_dq<64>(a);
  if (d == 128) return launch_dq<128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int skyt_flash_bwd_dkv(SKYT_BWD_PARAMS) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = SKYT_BWD_ARGS;
  if (d == 64) return launch_dkv<64, 64>(a);
  if (d == 128) return launch_dkv<128, 32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
