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
// replaces recomputed s and dp in both: 14*d, a 0.4867 ms bound.)
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
#include "common.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kBN = 64;       // keys per block
constexpr int kBQ = 64;       // query rows per step
constexpr int kThreads = 128; // one warpgroup; warp w owns keys 16 w ..
constexpr float kLog2e = 1.4426950408889634f;

// Mask classes of a (key tile, q tile) pair.
constexpr int kHidden = 0;
constexpr int kFull = 1;
constexpr int kPartial = 2;

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Four 8 x 8 b16 matrices from mma fragments to shared memory; lanes
// 8 i .. 8 i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void stmatrix_x4(void *p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_u32(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t *>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte cp.async (zero-filled when src_bytes is 0).
__device__ __forceinline__ void cp_async4(void *smem, const void *gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

// The tensor maps of one call (host-encoded, passed by value): Q and dO
// bf16 [B, S, H, D] as 4-d tensors {D, H, S, B} with 64 x 1 x 64 x 1
// boxes, the f32 dq accumulator {D, Hq, S, B} with 32 x 1 x 64 x 1 boxes;
// all with the 128-byte swizzle.
struct Maps {
  CUtensorMap q, o, dq;
};

__device__ __forceinline__ void mbar_init(uint64_t *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at (c0, c1, c2, c3) into shared memory, counted on
// `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void *smem, const CUtensorMap *map,
                                         uint64_t *bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(smem)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: add the box in shared memory into `map` at (c0, c1, c2, c3) in f32,
// asynchronously (elements outside the tensor are dropped); one bulk group
// per issuing thread.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap *map,
                                               const void *smem, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(smem_u32(smem)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's global-memory accesses through the async proxy
// (TMA) with its generic ones.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

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

// Make this thread's shared-memory writes (st.shared, stmatrix, cp.async)
// visible to wgmma and TMA, which read through the async proxy; a barrier
// follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulators across wgmma's async
// window.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 32 accumulator registers of 64-column panel np.
template <int R>
__device__ __forceinline__ float (&panel(float (&acc)[R], int np))[32] {
  return *reinterpret_cast<float(*)[32]>(acc + np * 32);
}

// Descriptor of a 128-byte-swizzled operand in shared memory: 8-row
// groups 1024 bytes apart (SBO); the leading offset is unused by these
// single-panel operands. Its address field counts 16-byte units, so a
// byte offset b adds b >> 4.
__device__ __forceinline__ uint64_t smem_desc(const void *p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a panel of
// 128-byte rows under the 128-byte swizzle (as TMA writes it).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
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

// D[64, 64] (+)= A[64, 16] . B[16, 64], A and B from shared memory
// (acc 0: D = A . B).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A[64, 16] . B[16, 64], A from registers (per warp the
// mma.sync m16n8k16 A-fragment layout), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

template <int D>
struct Layout {
  static constexpr size_t kv_tile = size_t(kBN) * D * 2;   // K or V
  static constexpr size_t q_tile = size_t(kBQ) * D * 2;    // Q or dO buffer
  static constexpr size_t ds_tile = size_t(kBN) * kBQ * 2; // dS^T buffer
  static constexpr size_t dq_box = size_t(kBQ) * 32 * 4;   // 64 x 32 f32
  // dq stages: two at head_dim 64; one at 128, where two do not fit.
  static constexpr int dq_stages = D == 64 ? 2 : 1;
  static constexpr size_t dq_stage = size_t(D / 32) * dq_box;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kv_tile;
  static constexpr size_t q = v + kv_tile;           // 2 buffers
  static constexpr size_t dout = q + 2 * q_tile;     // 2 buffers
  static constexpr size_t ds = dout + 2 * q_tile;    // 2 buffers
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
  unsigned *done;   // [B, Hkv, q tiles, words] key-tile bits, zeroed too
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
  constexpr int kPanels = D / 64;
  constexpr int kKSteps = D / 16;   // k-steps of S^T and dP^T
  constexpr int kAcc = D / 2;       // dk, dv, dq registers per thread
  constexpr bool kRegKV = D == 64;  // K, V as register A operands
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
  const int nkt = (s + kBN - 1) / kBN;
  const int kt = kOrdered ? nkt - 1 - blockIdx.x : blockIdx.x;
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
  // later), so each sets its bit there.
  const bool issuer = tid == 0;
  const int words = (nkt + 31) / 32;
  auto done_row = [&](int t) -> unsigned * {
    return p.done +
           ((static_cast<long long>(b) * p.hkv + hk) * nqt + t) * words;
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
  // dO by TMA (one thread, counted on the buffer's mbarrier), lse, delta
  // and segment ids by 4-byte cp.async.
  auto issue = [&](int buf, int t, int hh) {
    const int h = hk * group + hh;
    const int q0 = t * kBQ;
    if (tid == 0) {
      mbar_expect_tx(&bars[buf], static_cast<int>(2 * L::q_tile));
#pragma unroll
      for (int np = 0; np < kPanels; ++np) {
        tma_load(Qs + buf * L::q_tile + np * kBQ * 128, &m.q, &bars[buf],
                 np * 64, h, q0, b);
        tma_load(dOs + buf * L::q_tile + np * kBQ * 128, &m.o, &bars[buf],
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

  // dq [64, D] = dS [64, 64] . K [64, D] of the step whose dS^T is in
  // buffer buf (dS and K read transposed).
  float dqa[kAcc];
  auto dq_issue = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t a = ds_desc + ((buf * L::ds_tile + kk * 2048) >> 4);
#pragma unroll
      for (int np = 0; np < kPanels; ++np)
        wgmma_ss_n64<1, 1>(panel(dqa, np), a,
                           k_desc + ((np * kBN * 128 + kk * 2048) >> 4),
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
    for (int j = 0; j < D / 8; ++j) {
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
      for (int x = 0; x < D / 32; ++x)
        tma_reduce_add(&m.dq, dqs + i * L::dq_stage + x * L::dq_box, x * 32,
                       hk * group + hh, t * kBQ, b);
      bulk_commit();
      pending = hh == group - 1 ? row : nullptr;
    }
  };

  const float sl2 = p.scale * kLog2e;
  int t = next_tile(t_begin - 1), hh = 0;
  int prev_t = -1, prev_h = 0;
  int buf = 0;
  if (t < t_end) issue(0, t, 0);
  uint32_t phase = 0;   // bit i: parity of buffer i's next completion
  int staged_t = -1, staged_h = 0, stage = 0;   // dq staged, not yet added
  while (t < t_end) {
    skyt::cp_async_wait_all();
    mbar_wait(&bars[buf], (phase >> buf) & 1);
    phase ^= 1u << buf;
    // The stage written in this step was last added a step ago; when
    // ordered, that add's bit is set once it has completed.
    if (L::dq_stages == 2 && issuer) bulk_wait_read();
    retire();
    fence_async_smem();
    // Step (t, hh) is staged; the previous step is done with its buffers,
    // its dS^T and its dq stage are written.
    __syncthreads();
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
    if (nt_ < t_end) issue(buf ^ 1, nt_, nh);

    // The previous step's dq, staged; then S^T = K Q^T and dP^T = V dO^T
    // (64 keys x 64 queries) in their own commit groups, so that the exp
    // runs beside dP^T.
    if (prev_t >= 0) {
      wgmma_fence();
      dq_issue(buf ^ 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      dq_stage(stage);
      staged_t = prev_t;
      staged_h = prev_h;
    }
    float st[32], dpt[32];
    const size_t qoff = buf * L::q_tile;
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
    // queries q0 + 8 j + 2 t4 (+1)), then dv [64, D] += P^T [64, 64] .
    // dO [64, D] (P^T as the register A operand, dO read transposed).
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
      for (int np = 0; np < kPanels; ++np)
        wgmma_rs_n64<1>(panel(dva, np), pa[j],
                        o_desc + ((qoff + np * kBQ * 128 + j * 2048) >> 4));
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) * scale, to shared memory (bf16) for dq,
    // and dk [64, D] += dS^T . Q (Q read transposed).
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
      for (int np = 0; np < kPanels; ++np)
        wgmma_rs_n64<1>(panel(dka, np), sa[j],
                        q_desc + ((qoff + np * kBQ * 128 + j * 2048) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);

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
  // 8 n + 2 t4 (+1).
  const long long pitch = static_cast<long long>(p.hkv) * D;
  bf16 *dkb = p.dk + (static_cast<long long>(b) * s * p.hkv + hk) * D;
  bf16 *dvb = p.dv + (static_cast<long long>(b) * s * p.hkv + hk) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
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

// cuTensorMapEncodeTiled, through the runtime (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void *ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The 4-d map {D, H, S, B} of a [B, S, H, D] tensor (strides in
// elements) with boxes of box0 x 1 x 64 x 1, 128-byte swizzle.
bool encode(CUtensorMap *map, CUtensorMapDataType type, int esize,
            const void *base, int d, int h, int s, int b, long long sh,
            long long ss, long long sb, int box0) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(h), cuuint64_t(s),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(sh * esize),
                                 cuuint64_t(ss * esize),
                                 cuuint64_t(sb * esize)};
  const cuuint32_t box[4] = {cuuint32_t(box0), 1, cuuint32_t(kBQ), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void *>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kOrdered, bool kWindow>
int launch(const Params &p, int b, cudaStream_t stream) {
  Maps maps;
  const long long dq_ss = static_cast<long long>(p.hq) * D;
  if (!encode(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.q, D, p.hq,
              p.s, b, p.q_sh, p.q_ss, p.q_sb, 64) ||
      !encode(&maps.o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.dout, D, p.hq,
              p.s, b, p.o_sh, p.o_ss, p.o_sb, 64) ||
      !encode(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.dq, D, p.hq,
              p.s, b, D, dq_ss, p.s * dq_ss, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Layout<D>::bytes(p.s);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, kOrdered, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.s + kBN - 1) / kBN, p.hkv, b);
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
// dk, dv [B, S, Hkv, D] bf16 contiguous. With done [B, Hkv, ceil(S / 64),
// ceil(S / 2048)] int32, zeroed by the caller, dq's adds go in a fixed
// order (the same bits on every call); with done null, in any order.
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
  return static_cast<int>(cudaErrorInvalidValue);
}
