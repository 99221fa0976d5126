// Flash attention backward for Hopper (sm_90a), bf16 in, f32 accumulate:
// one pass over key tiles.
//
// Replaces skypilot_tpu/ops/flash_attention.py:168 _dq_kernel and :216
// _dkv_kernel (both launched by _bwd_rule). From the forward's residuals
// (q, k, v, the row logsumexp L) and delta = rowsum(dO * O), it
// recomputes p = exp(s - L) tile by tile, with s = q.k * scale masked as
// _block_mask masks it (causal on the packed index, q - k < window when a
// sliding window is given, q_seg == k_seg when segment ids are), and
//   dp = dO . v^T,  ds = p * (dp - delta) * scale,
//   dq = ds . k,    dk = ds^T . q,    dv = p^T . dO.
// A row with no visible key has L = 0 and p exactly 0, as there.
//
// What bounds it on this card: tensor-core FLOPs. Per query head and
// visible (q, k) pair one pass does 10*d flops (s, dp, dv, dk, dq)
// against 989 TFLOP/s bf16; at the sft shape [8, 2048, 32, 64] causal
// with 8 kv heads that is 3.438e11 flops, 0.3476 ms, against 0.081 ms
// for the 272.6 MB it must read and write once. (The two kernels it
// replaces recomputed s and dp in both: 14*d, a 0.4867 ms bound.) At
// gemma-2b's sft shape [4, 2048, 8, 256] causal with 1 kv head: 1.719e11
// flops, 0.1738 ms.
//
// Design (FA2's order, on wgmma). One warpgroup (4 warps) per (64-key
// tile, kv head, batch) walks its kv head's whole query group and, when
// causal, the 64-row q tiles from the diagonal down, and with a sliding
// window only to the last q tile whose first query lies within
// window - 1 of the tile's last key (_qk_block_overlaps), so a windowed
// key tile costs O(window); two such blocks share an SM, so one's
// tensor-core phases overlap the other's exp and store phases.
//   * Per (q tile, head) step it computes the transposed tiles
//     S^T = K Q^T and dP^T = V dO^T once (wgmma m64n64k16; at head_dim 64
//     K and V are register A operands held for the whole block), forms
//     P^T and dS^T = P^T (dP^T - delta) scale in the accumulators, and
//     adds dv += P^T dO and dk += dS^T Q (P^T and dS^T as register A
//     operands, dO and Q read transposed) into f32 registers. dk and dv
//     are summed over the group in the block and written once.
//   * dS^T (bf16) goes to shared memory (stmatrix). In the next step the
//     block computes that step's dq = dS K over its 64 keys (wgmma with
//     dS and K read transposed), stages it in shared memory, and after
//     the following barrier one thread adds it into the f32 accumulator
//     [B, S, Hq, D] with a TMA reduce-add; the wrapper zeroes the
//     accumulator and casts it to bf16.
//   * dq's adds land in no fixed order, so dq's last bits may differ from
//     call to call (dk and dv do not), unless the caller asks for ordered
//     adds (a second instantiation). Then each (batch, kv head, q tile)
//     has a row of bits, one per key tile, zeroed with the accumulator:
//     key tile j adds into the group's dq tiles once the bits of the key
//     tiles above it that can see the q tile are set, and sets its own
//     bit once its adds have completed (a key tile that sees none of the
//     q tile sets it at once). The adds land from the last key tile down, and dq is
//     the same bit for bit on every call (a resumed training run equals
//     the unbroken one). The grid then starts a group's last key tile
//     first, so a block waits only on blocks launched before it, and a
//     key tile reaches each q tile a group of steps after the key tile
//     above it. With a sliding window (its own instantiation, so the
//     unwindowed kernel carries none of its arithmetic) a key tile walks
//     only the q tiles its window reaches; a key tile that waits for q
//     tile t waits only on key tiles above it, whose windows reach t too,
//     so each of them sets its bit there (adds or passes) and no key tile
//     waits on a bit that is never set. On an H100 the waits and the
//     fences that order the adds cost ~35% of the kernel's time at the
//     sft shape.
//   * Tiles live in shared memory as 64-column panels of 128-byte rows in
//     the 128-byte swizzle that TMA writes and wgmma descriptors read.
//   * Pipelined operands: one thread stages the next step's Q and dO by
//     TMA on an mbarrier (lse, delta and q segment ids by 4-byte
//     cp.async) into a second buffer while the current step computes;
//     dS^T and, at head_dim 64, the dq stage are double-buffered, so each
//     step has one barrier. S^T, dP^T and the products after them run in
//     separate wgmma groups: the exp runs beside dP^T, dS beside dv.
//   * Mask classes, decided once per (key tile, q tile) in the prologue:
//     wholly hidden (skipped before its loads), wholly visible (no
//     per-element mask), or cut by the causal diagonal, the window's
//     edge, a segment boundary or the ragged end (per-element mask).
//   * p and ds are rounded to bf16 before their products, as the TPU
//     kernels cast them to the operand dtype; dq is summed in f32 across
//     key tiles and rounded once.
// Grid: ceil(S / 64) x Hkv x B blocks of 128 threads, a (kv head, batch)
// group's blocks one after another (its dq rows stay in L2 while they
// add into them), the heaviest causal key tiles first (the last first
// when ordered; with a window the first (S - window) / 64 key tiles tie
// for the heaviest, and the order stays); at the sft shape 32 x 8 x 8 =
// 2,048 blocks. Shared memory: 101,920 bytes at head_dim 64 (two blocks
// per SM), 151,072 at head_dim 128 (one), 1 KB of it to align the
// swizzled tiles, plus 4 bytes per q tile for the mask classes.
//
// Head_dim 256 (Gemma). The design above does not fit as it stands: dk
// and dv of a 64-key tile in f32 would take 64 x 256 x 2 / 128 = 256
// registers a thread, past the 255 limit before S^T and dP^T, and
// double-buffered Q and dO beside K, V and a 64 KB dq stage ~275 KB of
// shared memory, past 227 KB. So the grid gets a second factor over the
// two 128-column blocks of D (column blocks, neighbours in the grid: a
// key tile's two blocks read the same K, V, Q and dO, mostly from L2):
//   * each block computes S^T and dP^T over all 256 columns (16 k-steps)
//     but accumulates dk, dv and its dq only for its own 128 columns, so
//     its accumulators are head_dim 128's (64 + 64 f32 registers a thread
//     for dk and dv, 64 for dq, its dq stage 32 KB). S^T and dP^T are
//     computed once per column block: 14*d flops a visible pair per q
//     head instead of 10*d. ptxas for sm_90a: 242 registers (240 with the
//     window, 246 and 244 with ordered adds), no spills;
//   * Q and dO are single-buffered (32 KB each): one thread stages the
//     next step's Q and dO after the barrier that ends a step, and the
//     block computes the previous step's dq product while they arrive.
//     Shared memory: 32 + 32 (K, V) + 64 (Q, dO) + 16 (dS^T) + 32 (dq
//     stage) KB and the small rows, 183,840 bytes plus 4 per q tile: one
//     block an SM;
//   * the two column blocks' dq adds touch disjoint columns; ordered adds
//     keep one row of bits per column block, so each orders its own.
// At gemma-2b's sft shape [4, 2048, 8, 256] with 1 kv head (MQA) the grid
// is 32 key tiles x 2 column blocks x 1 x 4 = 256 blocks, each walking
// the group's 8 query heads; the heaviest key tiles still start first.
#include "common.cuh"
#include "hopper.cuh"

#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

using namespace skyt;

constexpr int kBN = 64;       // keys per block
constexpr int kBQ = 64;       // query rows per step
constexpr int kThreads = 128; // one warpgroup; warp w owns keys 16 w ..
constexpr float kLog2e = 1.4426950408889634f;

// Mask classes of a (key tile, q tile) pair.
constexpr int kHidden = 0;
constexpr int kFull = 1;
constexpr int kPartial = 2;

// The tensor maps of one call (host-encoded, passed by value): Q and dO
// bf16 [B, S, H, D] as 4-d tensors {D, H, S, B} with 64 x 1 x 64 x 1
// boxes, the f32 dq accumulator {D, Hq, S, B} with 32 x 1 x 64 x 1 boxes;
// all with the 128-byte swizzle.
struct Maps {
  CUtensorMap q, o, dq;
};

// Spin until bits lo..hi (0 <= lo <= hi) of the bit row at m are all set
// (acquire). The blocks it waits on run for milliseconds at most; after
// ~2^34 cycles (seconds) the launch fails with an error rather than hang.
__device__ __forceinline__ void wait_bits(const unsigned *m, int lo, int hi) {
  const long long t0 = clock64();
  for (int w = lo >> 5; w <= hi >> 5; ++w) {
    const int a = max(lo - 32 * w, 0), z = min(hi - 32 * w, 31);
    const unsigned want =
        (z - a == 31 ? ~0u : ((1u << (z - a + 1)) - 1u)) << a;
    for (;;) {
      unsigned x;
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                   : "=r"(x)
                   : "l"(m + w)
                   : "memory");
      if ((x & want) == want) break;
      __nanosleep(32);
      if (clock64() - t0 > (1ll << 34)) __trap();
    }
  }
}

// Set bit i of the bit row at m, after this thread's earlier writes
// (release) or with no order (relaxed).
__device__ __forceinline__ void set_bit_release(unsigned *m, int i) {
  asm volatile("red.release.gpu.global.or.b32 [%0], %1;\n" ::"l"(m + (i >> 5)),
               "r"(1u << (i & 31))
               : "memory");
}
__device__ __forceinline__ void set_bit_relaxed(unsigned *m, int i) {
  asm volatile("red.relaxed.gpu.global.or.b32 [%0], %1;\n" ::"l"(m + (i >> 5)),
               "r"(1u << (i & 31))
               : "memory");
}

// Stage `rows` rows of D bf16 (row r at src + r * stride) as D / 64
// swizzled panels of `rows` x 128 bytes with 16-byte cp.async copies;
// rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char *dst,
                                           const bf16 *src, long long stride,
                                           int rows, int valid, int tid) {
  constexpr int kVec = D / 8;
  for (int i = tid; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    const bool in = r < valid;
    skyt::cp_async16(dst + (c / 8) * rows * 128 + swz(r, c % 8),
                     in ? src + r * stride + c * 8 : src, in ? 16 : 0);
  }
}

template <int D>
struct Layout {
  // Column blocks: past head_dim 128 a block owns one 128-column block
  // of dq, dk and dv (cols columns), so its accumulators stay those of
  // head_dim 128; S^T and dP^T still take all D columns.
  static constexpr int col_blocks = D > 128 ? D / 128 : 1;
  static constexpr int cols = D / col_blocks;
  // Q and dO buffers: two (the next step's loads overlap this step) up to
  // head_dim 128; one at 256, where two do not fit beside K and V.
  static constexpr int q_bufs = col_blocks == 1 ? 2 : 1;
  static constexpr size_t kv_tile = size_t(kBN) * D * 2;   // K or V
  static constexpr size_t q_tile = size_t(kBQ) * D * 2;    // Q or dO buffer
  static constexpr size_t ds_tile = size_t(kBN) * kBQ * 2; // dS^T buffer
  static constexpr size_t dq_box = size_t(kBQ) * 32 * 4;   // 64 x 32 f32
  // dq stages: two at head_dim 64; one from 128, where two do not fit.
  static constexpr int dq_stages = D == 64 ? 2 : 1;
  static constexpr size_t dq_stage = size_t(cols / 32) * dq_box;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kv_tile;
  static constexpr size_t q = v + kv_tile;
  static constexpr size_t dout = q + q_bufs * q_tile;
  static constexpr size_t ds = dout + q_bufs * q_tile;    // 2 buffers
  static constexpr size_t dq = ds + 2 * ds_tile;
  static constexpr size_t lse = dq + dq_stages * dq_stage;   // 2 buffers
  static constexpr size_t delta = lse + 2 * size_t(kBQ) * 4; // 2 buffers
  static constexpr size_t qseg = delta + 2 * size_t(kBQ) * 4; // 2 buffers
  static constexpr size_t kseg = qseg + 2 * size_t(kBQ) * 4;
  static constexpr size_t dseg = kseg + size_t(kBN) * 4;  // distinct key
  static constexpr size_t dmin = dseg + size_t(kBN) * 4;  // segments, their
  static constexpr size_t dmax = dmin + size_t(kBN) * 4;  // first and last
  static constexpr size_t ndist = dmax + size_t(kBN) * 4; // keys
  static constexpr size_t bar = ndist + 16;      // 2 mbarriers
  static constexpr size_t cls = bar + 16;        // + 4 bytes per q tile
  // 1024 bytes of slack to align the swizzled tiles.
  static size_t bytes(int s) {
    return 1024 + cls + 4 * size_t((s + kBQ - 1) / kBQ);
  }
};

struct Params {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg;
  float *dq;        // f32 accumulator [B, S, Hq, D], zeroed by the caller
  // [B, Hkv, column blocks, q tiles, words] key-tile bits, zeroed too
  unsigned *done;
  bf16 *dk, *dv;    // [B, S, Hkv, D]
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
  int s, hq, hkv, causal;
  int window;       // > 0: query i sees key j only when i - j < window
  float scale;
};

template <int D, bool kOrdered, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const Params p, const __grid_constant__ Maps m) {
  using L = Layout<D>;
  constexpr int kPanels = D / 64;   // panels of Q, dO, K and V
  constexpr int kKSteps = D / 16;   // k-steps of S^T and dP^T
  constexpr int DC = L::cols;       // the block's columns of dq, dk, dv
  constexpr int kCPanels = DC / 64;
  constexpr int kAcc = DC / 2;      // dk, dv, dq registers per thread
  constexpr bool kRegKV = D == 64;  // K, V as register A operands
  constexpr bool kOneBuf = L::q_bufs == 1;
  // With one Q and dO buffer, the single dq stage's barrier publishes each
  // step's loads.
  static_assert(!kOneBuf || L::dq_stages == 1, "one buffer, one stage");
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char *Ks = smem + L::k;
  unsigned char *Vs = smem + L::v;
  unsigned char *Qs = smem + L::q;
  unsigned char *dOs = smem + L::dout;
  unsigned char *dSs = smem + L::ds;
  unsigned char *dqs = smem + L::dq;
  float *lses = reinterpret_cast<float *>(smem + L::lse);
  float *deltas = reinterpret_cast<float *>(smem + L::delta);
  int *qsegs = reinterpret_cast<int *>(smem + L::qseg);
  int *ksegs = reinterpret_cast<int *>(smem + L::kseg);
  int *dseg = reinterpret_cast<int *>(smem + L::dseg);
  int *dmin = reinterpret_cast<int *>(smem + L::dmin);
  int *dmax = reinterpret_cast<int *>(smem + L::dmax);
  int *ndist = reinterpret_cast<int *>(smem + L::ndist);
  uint64_t *bars = reinterpret_cast<uint64_t *>(smem + L::bar);
  int *cls = reinterpret_cast<int *>(smem + L::cls);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  // Accumulator rows: this thread's keys r0 and r0 + 8 of the tile, and
  // in dq its q rows r0 and r0 + 8 of the step.
  const int r0 = warp * 16 + g4;
  const int s = p.s;
  const bool causal = p.causal != 0;
  // The window is its own instantiation: without it, none of its
  // arithmetic is compiled in.
  const int window = kWindow ? p.window : 0;
  // A (kv head, batch) group's blocks run together, so its dq rows stay
  // in L2 while they add into them. Within the group the first key tiles
  // (when causal, those that see the most q tiles) start first; when the
  // adds are ordered, the last key tile starts first: key tile j adds
  // into a q tile after the key tiles above it, which run ahead of it.
  // A key tile's column blocks are neighbours in the grid (they read the
  // same K, V, Q and dO).
  const int nkt = (s + kBN - 1) / kBN;
  const int cb = L::col_blocks > 1 ? blockIdx.x % L::col_blocks : 0;
  const int c0 = cb * DC;           // the block's first column
  const int kt_i = blockIdx.x / L::col_blocks;
  const int kt = kOrdered ? nkt - 1 - kt_i : kt_i;
  const int k0 = kt * kBN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int nqt = (s + kBQ - 1) / kBQ;
  const int *segb = p.seg ? p.seg + static_cast<long long>(b) * s : nullptr;
  // Causal: q tiles wholly above the tile's first key see none of it.
  // Window: q tiles whose first query lies at or beyond the tile's last
  // key + window - 1 see none of it; the walk ends before the first.
  const int t_begin = causal ? k0 / kBQ : 0;
  const int t_end =
      window > 0 ? min(nqt, (k0 + kBN + window - 2) / kBQ + 1) : nqt;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_rows<D>(Ks, p.k + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss, p.k_ss,
                kBN, s - k0, tid);
  stage_rows<D>(Vs, p.v + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss, p.v_ss,
                kBN, s - k0, tid);
  if (segb) {
    // Mask classes: the key tile's distinct segment ids, each with its
    // first and last key; a q row sees the tile iff some distinct id
    // equals its own (at a key at or before it when causal, and the last
    // such key within the window). Ids that are not contiguous can make
    // a row "visible" that sees nothing: its tile is masked per element.
    if (tid == 0) *ndist = 0;
    for (int t = tid; t < nqt; t += kThreads) cls[t] = 0;
    if (tid < kBN) ksegs[tid] = k0 + tid < s ? segb[k0 + tid] : -2;
    __syncthreads();
    if (tid < kBN && k0 + tid < s) {
      const int ks = ksegs[tid];
      bool first = true;
      for (int c = 0; c < tid && first; ++c) first = ksegs[c] != ks;
      if (first) {
        int last = tid;
        if (kWindow)
          for (int c = tid + 1; c < kBN; ++c)
            last = ksegs[c] == ks ? c : last;
        const int i = atomicAdd(ndist, 1);
        dseg[i] = ks;
        dmin[i] = k0 + tid;
        dmax[i] = k0 + last;
      }
    }
    __syncthreads();
    const int nd = *ndist;
    const bool uniform = nd == 1 && k0 + kBN <= s;
    for (int qi = t_begin * kBQ + tid; qi < t_end * kBQ; qi += kThreads) {
      int bits = 2;   // bit 0: some key visible; bit 1: some key hidden
      if (qi < s) {
        const int qs = segb[qi];
        bool any = false;
        for (int i = 0; i < nd; ++i)
          any |= dseg[i] == qs && (!causal || dmin[i] <= qi) &&
                 (window <= 0 || qi - dmax[i] < window);
        const bool full = uniform && dseg[0] == qs &&
                          (!causal || qi >= k0 + kBN - 1) &&
                          (window <= 0 || qi - k0 < window);
        bits = (any ? 1 : 0) | (full ? 0 : 2);
      }
      atomicOr(&cls[qi / kBQ], bits);
    }
  }
  skyt::cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  auto tile_class = [&](int t) -> int {
    if (segb) {
      const int bits = cls[t];
      return !(bits & 1) ? kHidden : (bits & 2) ? kPartial : kFull;
    }
    const int q0 = t * kBQ;
    if (causal && q0 + kBQ - 1 < k0) return kHidden;
    if (window > 0 && q0 >= k0 + kBN - 1 + window) return kHidden;
    const bool full = q0 + kBQ <= s && k0 + kBN <= s &&
                      (!causal || q0 >= k0 + kBN - 1) &&
                      (window <= 0 || q0 + kBQ - 1 - k0 < window);
    return full ? kFull : kPartial;
  };
  // Ordered adds: each q tile t of the group has a row of bits, one per
  // key tile, set when that key tile's adds into the group's dq tiles of
  // t have completed or when it sees none of t. Key tile kt adds once
  // the bits of the key tiles above it that can see t are set: the adds
  // land from the last key tile down, on every call. With a window, the
  // key tiles above kt up to last_kt(t) all reach t (their windows end
  // later), so each sets its bit there. Each column block has rows of its
  // own: it orders only its own adds.
  const bool issuer = tid == 0;
  const int words = (nkt + 31) / 32;
  auto done_row = [&](int t) -> unsigned * {
    return p.done +
           (((static_cast<long long>(b) * p.hkv + hk) * L::col_blocks + cb) *
                nqt + t) * words;
  };
  // The last key tile that can see q tile t.
  auto last_kt = [&](int t) -> int {
    return causal ? min((t * kBQ + kBQ - 1) / kBN, nkt - 1) : nkt - 1;
  };
  // A q tile this key tile does not see.
  auto pass = [&](int t) {
    if (kOrdered && issuer) set_bit_relaxed(done_row(t), kt);
  };
  // The next q tile after t that the key tile sees (t_end if none),
  // passing those it does not.
  auto next_tile = [&](int t) -> int {
    for (++t; t < t_end && tile_class(t) == kHidden; ++t) pass(t);
    return t;
  };

  const int kj0 = k0 + r0, kj1 = kj0 + 8;
  const int kseg0 = segb ? ksegs[r0] : 0;
  const int kseg1 = segb ? ksegs[r0 + 8] : 0;

  float dka[kAcc], dva[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dka[i] = dva[i] = 0.f;

  // Head_dim 64: this warp's 16 keys of K and V as A fragments
  // (ldmatrix from the swizzled tiles) for the whole block, so S^T and
  // dP^T read only Q and dO from shared memory.
  uint32_t ka[kRegKV ? kKSteps : 1][4], va[kRegKV ? kKSteps : 1][4];
  if constexpr (kRegKV) {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int off = swz(row, 2 * ks + lane / 16);
      ldmatrix_x4(ka[ks], Ks + off);
      ldmatrix_x4(va[ks], Vs + off);
    }
  }

  // Descriptors (address field in 16-byte units: offsets add to it).
  const uint64_t k_desc = smem_desc(Ks);
  const uint64_t v_desc = smem_desc(Vs);
  const uint64_t q_desc = smem_desc(Qs);
  const uint64_t o_desc = smem_desc(dOs);
  const uint64_t ds_desc = smem_desc(dSs);

  // Stage step (q tile t, head hh of the group) into buffer buf: Q and
  // dO by TMA (one thread, counted on the buffer's mbarrier; with one Q
  // and dO buffer, buffer 0), lse, delta and segment ids by 4-byte
  // cp.async.
  auto issue = [&](int buf, int t, int hh) {
    const int h = hk * group + hh;
    const int q0 = t * kBQ;
    const int qb = kOneBuf ? 0 : buf;
    if (tid == 0) {
      mbar_expect_tx(&bars[qb], static_cast<int>(2 * L::q_tile));
#pragma unroll
      for (int np = 0; np < kPanels; ++np) {
        tma_load(Qs + qb * L::q_tile + np * kBQ * 128, &m.q, &bars[qb],
                 np * 64, h, q0, b);
        tma_load(dOs + qb * L::q_tile + np * kBQ * 128, &m.o, &bars[qb],
                 np * 64, h, q0, b);
      }
    }
    if (tid < kBQ) {
      const long long row = (static_cast<long long>(b) * p.hq + h) * s;
      const bool in = q0 + tid < s;
      const long long off = in ? row + q0 + tid : 0;
      cp_async4(lses + buf * kBQ + tid, p.lse + off, in ? 4 : 0);
      cp_async4(deltas + buf * kBQ + tid, p.delta + off, in ? 4 : 0);
      if (segb)
        cp_async4(qsegs + buf * kBQ + tid, segb + (in ? q0 + tid : 0),
                  in ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // Wait for the step staged into buffer buf (each thread: its own
  // cp.async copies and the TMA bytes; a barrier follows).
  uint32_t phase = 0;   // bit i: parity of mbarrier i's next completion
  auto wait_loads = [&](int buf) {
    const int qb = kOneBuf ? 0 : buf;
    skyt::cp_async_wait_all();
    mbar_wait(&bars[qb], (phase >> qb) & 1);
    phase ^= 1u << qb;
  };

  // dq [64, DC] = dS [64, 64] . K [64, c0 .. c0 + DC) of the step whose
  // dS^T is in buffer buf (dS and K read transposed).
  float dqa[kAcc];
  auto dq_issue = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t a = ds_desc + ((buf * L::ds_tile + kk * 2048) >> 4);
#pragma unroll
      for (int np = 0; np < kCPanels; ++np)
        wgmma_ss_n64<1, 1>(
            panel(dqa, np), a,
            k_desc + (((c0 / 64 + np) * kBN * 128 + kk * 2048) >> 4),
            kk > 0);
    }
  };
  // dq goes to the f32 accumulator by TMA reduce-adds from a stage in
  // shared memory (32-column boxes in the 128-byte swizzle): the stage is
  // written when the product lands and added after the next step's
  // barrier, whose proxy fence makes the writes visible; with two stages
  // the add has read its stage long before the stage is written again.
  auto dq_stage = [&](int i) {
    unsigned char *stage = dqs + i * L::dq_stage;
    if constexpr (L::dq_stages == 1) {
      if (issuer) bulk_wait_read();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      // Columns 8 j + 2 t4 (+1): box j / 4, 16-byte chunk 2 (j % 4) +
      // t4 / 2, bytes 8 (t4 % 2).
      unsigned char *box = stage + (j / 4) * L::dq_box + 8 * (t4 & 1);
      const int chunk = 2 * (j % 4) + (t4 >> 1);
      *reinterpret_cast<float2 *>(box + swz(r0, chunk)) =
          make_float2(dqa[4 * j], dqa[4 * j + 1]);
      *reinterpret_cast<float2 *>(box + swz(r0 + 8, chunk)) =
          make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
    }
  };
  // Ordered adds: the row of the q tile whose last head was just added;
  // its bit is set once the adds have completed (their writes made, and
  // ordered before the bit), at the next step's barrier.
  unsigned *pending = nullptr;
  auto retire = [&]() {
    if (kOrdered && issuer && pending != nullptr) {
      bulk_wait();
      fence_async_global();
      set_bit_release(pending, kt);
      pending = nullptr;
    }
  };
  // After a barrier: add stage i (step (t, hh)) into the accumulator (when
  // ordered, once the key tiles above have added theirs).
  auto dq_add = [&](int i, int t, int hh) {
    if (issuer) {
      unsigned *row = nullptr;
      if constexpr (kOrdered) {
        retire();
        row = done_row(t);
        if (hh == 0 && kt < last_kt(t)) {
          wait_bits(row, kt + 1, last_kt(t));
          fence_async_global();
        }
      }
#pragma unroll
      for (int x = 0; x < DC / 32; ++x)
        tma_reduce_add(&m.dq, dqs + i * L::dq_stage + x * L::dq_box,
                       c0 + x * 32, hk * group + hh, t * kBQ, b);
      bulk_commit();
      pending = hh == group - 1 ? row : nullptr;
    }
  };

  const float sl2 = p.scale * kLog2e;
  int t = next_tile(t_begin - 1), hh = 0;
  int prev_t = -1, prev_h = 0;
  int buf = 0;
  if (t < t_end) issue(0, t, 0);
  int staged_t = -1, staged_h = 0, stage = 0;   // dq staged, not yet added
  while (t < t_end) {
    if constexpr (!kOneBuf) {
      wait_loads(buf);
      // The stage written in this step was last added a step ago; when
      // ordered, that add's bit is set once it has completed.
      if (L::dq_stages == 2 && issuer) bulk_wait_read();
      retire();
      fence_async_smem();
      // Step (t, hh) is staged; the previous step is done with its
      // buffers, its dS^T and its dq stage are written.
      __syncthreads();
    }
    // (One Q and dO buffer: the barrier at the end of the previous step
    // stands for this one, and the loads are awaited below, after the
    // previous step's dq product.)
    if (staged_t >= 0) {
      dq_add(stage, staged_t, staged_h);
      stage = (stage + 1) % L::dq_stages;
      staged_t = -1;
    }
    int nt_ = t, nh = hh + 1;
    if (nh == group) {
      nh = 0;
      nt_ = next_tile(t);
    }
    if (!kOneBuf && nt_ < t_end) issue(buf ^ 1, nt_, nh);

    // The previous step's dq, staged; then S^T = K Q^T and dP^T = V dO^T
    // (64 keys x 64 queries) in their own commit groups, so that the exp
    // runs beside dP^T.
    if (prev_t >= 0) {
      wgmma_fence();
      dq_issue(buf ^ 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      // The single stage's barrier (dq_stage) also publishes the loads.
      if constexpr (kOneBuf) wait_loads(buf);
      dq_stage(stage);
      staged_t = prev_t;
      staged_h = prev_h;
    } else if constexpr (kOneBuf) {
      wait_loads(buf);
      __syncthreads();
    }
    float st[32], dpt[32];
    const size_t qoff = kOneBuf ? 0 : buf * L::q_tile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const size_t kb = (ks / 4) * kBN * 128 + (ks % 4) * 32;
      const size_t qb = qoff + (ks / 4) * kBQ * 128 + (ks % 4) * 32;
      if constexpr (kRegKV)
        wgmma_rs_n64<0>(st, ka[ks], q_desc + (qb >> 4), ks > 0);
      else
        wgmma_ss_n64<0, 0>(st, k_desc + (kb >> 4), q_desc + (qb >> 4),
                           ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const size_t kb = (ks / 4) * kBN * 128 + (ks % 4) * 32;
      const size_t qb = qoff + (ks / 4) * kBQ * 128 + (ks % 4) * 32;
      if constexpr (kRegKV)
        wgmma_rs_n64<0>(dpt, va[ks], o_desc + (qb >> 4), ks > 0);
      else
        wgmma_ss_n64<0, 0>(dpt, v_desc + (kb >> 4), o_desc + (qb >> 4),
                           ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp(S^T - L) on visible entries (accumulator chunk j holds
    // queries q0 + 8 j + 2 t4 (+1)), then dv [64, DC] += P^T [64, 64] .
    // dO [64, c0 .. c0 + DC) (P^T as the register A operand, dO read
    // transposed).
    const float *lb = lses + buf * kBQ;
    const float *db = deltas + buf * kBQ;
    const int *qsb = qsegs + buf * kBQ;
    const int q0 = t * kBQ;
    auto exp_p = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const int c = j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2 *>(lb + c);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pv = ex2(fmaf(st[i], sl2, nl[e & 1]));
          if constexpr (decltype(masked)::value) {
            const int qi = q0 + c + (e & 1);
            const int kj = e < 2 ? kj0 : kj1;
            const bool ok = qi < s && kj < s && (!causal || kj <= qi) &&
                            (window <= 0 || qi - kj < window) &&
                            (!segb || qsb[c + (e & 1)] ==
                                          (e < 2 ? kseg0 : kseg1));
            pv = ok ? pv : 0.f;
          }
          st[i] = pv;
        }
      }
    };
    if (tile_class(t) == kPartial)
      exp_p(std::true_type());
    else
      exp_p(std::false_type());
    uint32_t pa[kBQ / 16][4];
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[j][e] = pack_bf16(st[8 * j + 2 * e], st[8 * j + 2 * e + 1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
#pragma unroll
      for (int np = 0; np < kCPanels; ++np)
        wgmma_rs_n64<1>(
            panel(dva, np), pa[j],
            o_desc + ((qoff + (c0 / 64 + np) * kBQ * 128 + j * 2048) >> 4));
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) * scale, to shared memory (bf16) for dq,
    // and dk [64, DC] += dS^T . Q [64, c0 .. c0 + DC) (Q read transposed).
    wgmma_wait<1>();
    fence_regs(dpt);
    uint32_t sa[kBQ / 16][4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2 *>(db + j * 8 + 2 * t4);
      const float nd[2] = {-d2.x * p.scale, -d2.y * p.scale};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * fmaf(dpt[i], p.scale, nd[e & 1]);
      }
    }
    unsigned char *dSb = dSs + buf * L::ds_tile;
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sa[j][e] = pack_bf16(dpt[8 * j + 2 * e], dpt[8 * j + 2 * e + 1]);
      // sa[j][e] is the fragment of the 8 x 8 block of keys
      // warp * 16 + 8 (e % 2) .. and queries 16 j + 8 (e / 2) ..: its
      // 16-byte chunk is 2 j + e / 2.
      const int mi = lane / 8;
      stmatrix_x4(dSb + swz(warp * 16 + (mi & 1) * 8 + lane % 8,
                            2 * j + mi / 2),
                  sa[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
#pragma unroll
      for (int np = 0; np < kCPanels; ++np)
        wgmma_rs_n64<1>(
            panel(dka, np), sa[j],
            q_desc + ((qoff + (c0 / 64 + np) * kBQ * 128 + j * 2048) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    if constexpr (kOneBuf) {
      // Every thread is done with Q and dO and has written its dS^T and
      // dq stage: stage the next step into the one buffer.
      fence_async_smem();
      __syncthreads();
      if (nt_ < t_end) issue(buf ^ 1, nt_, nh);
    }

    prev_t = t;
    prev_h = hh;
    t = nt_;
    hh = nh;
    buf ^= 1;
  }
  if (prev_t >= 0) {
    // The last step's dq (after the stage before it is added).
    if (L::dq_stages == 2 && issuer) bulk_wait_read();
    retire();
    fence_async_smem();
    __syncthreads();
    if (staged_t >= 0) {
      dq_add(stage, staged_t, staged_h);
      stage = (stage + 1) % L::dq_stages;
    }
    wgmma_fence();
    dq_issue(buf ^ 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    dq_stage(stage);
    fence_async_smem();
    __syncthreads();
    dq_add(stage, prev_t, prev_h);
  }
  if (issuer) bulk_wait();
  retire();

  // dk, dv [B, S, Hkv, D] contiguous; register 4 n + e holds column
  // c0 + 8 n + 2 t4 (+1).
  const long long pitch = static_cast<long long>(p.hkv) * D;
  bf16 *dkb = p.dk + (static_cast<long long>(b) * s * p.hkv + hk) * D + c0;
  bf16 *dvb = p.dv + (static_cast<long long>(b) * s * p.hkv + hk) * D + c0;
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (kj0 < s) {
      *reinterpret_cast<__nv_bfloat162 *>(dkb + kj0 * pitch + c) =
          __floats2bfloat162_rn(dka[4 * n], dka[4 * n + 1]);
      *reinterpret_cast<__nv_bfloat162 *>(dvb + kj0 * pitch + c) =
          __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
    }
    if (kj1 < s) {
      *reinterpret_cast<__nv_bfloat162 *>(dkb + kj1 * pitch + c) =
          __floats2bfloat162_rn(dka[4 * n + 2], dka[4 * n + 3]);
      *reinterpret_cast<__nv_bfloat162 *>(dvb + kj1 * pitch + c) =
          __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
}

template <int D, bool kOrdered, bool kWindow>
int launch(const Params &p, int b, cudaStream_t stream) {
  Maps maps;
  const long long dq_ss = static_cast<long long>(p.hq) * D;
  if (!encode(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.q, D, p.hq,
              p.s, b, p.q_sh, p.q_ss, p.q_sb, 64, kBQ) ||
      !encode(&maps.o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.dout, D, p.hq,
              p.s, b, p.o_sh, p.o_ss, p.o_sb, 64, kBQ) ||
      !encode(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.dq, D, p.hq,
              p.s, b, D, dq_ss, p.s * dq_ss, 32, kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Layout<D>::bytes(p.s);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, kOrdered, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.s + kBN - 1) / kBN * Layout<D>::col_blocks, p.hkv, b);
  flash_bwd_kernel<D, kOrdered, kWindow>
      <<<grid, kThreads, bytes, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kOrdered>
int launch_w(const Params &p, int b, cudaStream_t stream) {
  return p.window > 0 ? launch<D, kOrdered, true>(p, b, stream)
                      : launch<D, kOrdered, false>(p, b, stream);
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// q [B, S, Hq, D], k/v [B, S, Hkv, D] and dO [B, S, Hq, D] bf16 with unit
// last stride and 16-byte aligned rows (strides in elements); lse and
// delta [B, Hq, S] f32 contiguous; seg [B, S] int32 or null. Adds dq into
// dq_acc [B, S, Hq, D] f32 contiguous (zeroed by the caller) and writes
// dk, dv [B, S, Hkv, D] bf16 contiguous. With done [B, Hkv, ceil(D / 128),
// ceil(S / 64), ceil(S / 2048)] int32, zeroed by the caller, dq's adds go
// in a fixed order (the same bits on every call); with done null, in any
// order. d is 64, 128 or 256.
// window > 0: query i sees key j only when i - j < window (0: no window).
extern "C" int skyt_flash_bwd(
    const void *q, const void *k, const void *v, const void *dout,
    const void *lse, const void *delta, const void *seg, void *dq_acc,
    void *done, void *dk, void *dv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int b, int s, int hq, int hkv, int d,
    int causal, int window, float scale, void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16 *>(q), static_cast<const bf16 *>(k),
                 static_cast<const bf16 *>(v),
                 static_cast<const bf16 *>(dout),
                 static_cast<const float *>(lse),
                 static_cast<const float *>(delta),
                 static_cast<const int *>(seg), static_cast<float *>(dq_acc),
                 static_cast<unsigned *>(done), static_cast<bf16 *>(dk),
                 static_cast<bf16 *>(dv), q_sb, q_ss, q_sh, k_sb, k_ss,
                 k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, s, hq, hkv,
                 causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ordered = done != nullptr;
  if (d == 64)
    return ordered ? launch_w<64, true>(p, b, st)
                   : launch_w<64, false>(p, b, st);
  if (d == 128)
    return ordered ? launch_w<128, true>(p, b, st)
                   : launch_w<128, false>(p, b, st);
  if (d == 256)
    return ordered ? launch_w<256, true>(p, b, st)
                   : launch_w<256, false>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
