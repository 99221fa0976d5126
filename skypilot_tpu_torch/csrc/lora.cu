// Grouped multi-LoRA delta for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// One kernel replaces the two TPU kernels of skypilot_tpu/ops/lora.py:
//   per-sequence ids [B]     :64 _gather_kernel  (lora_gather)
//   per-token ids [B, S]     :74 _grouped_kernel (lora_grouped)
// Token t with adapter id a gets
//   delta[t] = bf16(bf16(bf16(x[t] @ A[a]) @ B[a]) * bf16(scale[t]))
// with x [T, in], A [N, in, r], B [N, r, out] (id 0 is the all-zeros
// "no adapter" entry), rounded where the JAX code rounds: the shrink t is
// cast to the activation dtype between the two dots, the expand's output
// too, and the scale multiply runs in that dtype. With a residual y the
// kernel writes bf16(y + delta) into y (the projection plus its delta),
// so a projection costs one launch beyond its matmul.
//
// What bounds it on this card: memory bandwidth. A call must read x and
// each distinct non-zero adapter's A and B once and write the output
// (and read y), against 2*tokens*r*(in + out) flops, far below the
// tensor-core ridge at any LoRA rank. At decode (8 slots, one token
// each) that is about 2 MB, so the time is the chain of dependent steps
// a block takes; for the packed prefill row it is the 60-120 MB of output
// (and y) streamed through the blocks.
//
// Design. The TPU kernels walk a sequential grid: (sequence, seq block)
// with the adapter's A/B selected by the id in the index map, or (token
// block, adapter) with a masked accumulate over ALL adapters. Here one
// block is 4 consumer warps (one warpgroup) and a producer warp:
//   * tiles follow tokens, for both id layouts (token t of a per-sequence
//     call has ids[t / S]): a tile of 16, 32 or 64 tokens and a chunk of
//     `cpb` 128-column passes of the output is one block; at decode and
//     verify one tile holds every token, so each distinct adapter's B
//     columns are read once per column chunk, not once per sequence. The
//     blocks of one tile's column chunks form a thread block cluster (up
//     to 16) that splits the shrink's `in` between them;
//   * the tile's items: its distinct non-zero ids, listed in order of
//     first appearance by the producer's warp vote (__match_any_sync) over
//     the ids it loads;
//   * every load is started as soon as its address is known, onto the
//     rings' mbarriers, by the producer warp: x's tile by TMA (for the
//     first shrink stages before the ids arrive), each item's share of A
//     by one 1-D bulk copy where its rows are contiguous (one rank tile),
//     else by TMA, each item's B columns by TMA (one box of two swizzled
//     64-column panels), y's tile by TMA. x, y and the output are 128-byte
//     swizzled 64-column panels of the tile's rows in shared memory, moved
//     a box of 64 columns (and tm or 16 rows) an instruction: a 1-D bulk
//     copy a row costs the TMA unit about as much as a box. The stack's
//     maps are cached by (stack, shape), the activations' by (pointer,
//     shape): the caching allocator hands a step's tensors the same
//     addresses again. Operands whose strides TMA cannot take (widths or
//     ranks not multiples of 8, `out` not of 64 for B) are staged element
//     by element by the producer into the same layouts;
//   * ranks are cut into rank tiles of at most 128 columns ("items": (id,
//     rank tile)); the shrink treats the A of the tile's items as one
//     operand [in, items * width] in passes of at most 128 columns
//     (mma.sync m16n8k16 over the block's share of `in`, split further
//     between the warps of a 16-row m-tile), with one reduction over the
//     warps and one exchange in the cluster a pass, both in a fixed order
//     (bit-equal calls, no atomics): each quad (4 columns of a row) of the
//     block's partial goes to the block that owns it, and the owner sums
//     the partials it received in rank order, rounds them to bf16, keeps
//     them only for tokens on the item's id and sends them to every
//     block's T (wgmma's A operand, 128-byte swizzled panels). Both sends
//     are st.async stores counted on the receiver's mbarrier: no fence,
//     no remote load;
//   * the expand, T [tile, K] x B [K, 128 columns] with K the pass's items
//     stacked, runs on wgmma m64n64k16 (the consumer warpgroup), B tiles
//     from the producer's TMA ring, accumulating over every item and rank
//     tile in f32 and rounding once; since T is zero off a token's own
//     id, each output row gets exactly its own adapter's term;
//   * epilogue, in bf16x2: the rounding chain above (+ y) into a staging
//     tile; each warp's 16 rows leave by two TMA stores (one a panel),
//     which run while the block goes on with its next pass: a warp waits
//     for its own previous stores to have read the staging before it
//     writes its rows again, so no barrier joins the warps. Rows of id 0
//     are written as 0 (delta) or keep y's bits (in place: a tile of one
//     group writes them back as loaded); a warp whose rows are not all
//     written this pass (another group's, or id 0 in place in a tile of
//     several groups) stores the others with 16-byte stores.
// When the tile's distinct ids need more T columns than the plan's
// capacity, they go in groups that fit (each id whole): a token's row is
// written in its id's group, so nothing is added across groups.
// ops/lora.py lora_plan picks tile rows, the column chunk, the cluster,
// the rank-tile width, items a pass, T's capacity and the rings, and
// checks the shared memory that skyt_lora_smem reports.
#include <cooperative_groups.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

namespace {

using namespace skyt;

constexpr int kNC = 128;                 // output columns a pass (2 panels)
constexpr int kConsumers = 128;          // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxRows = 64;             // wgmma m64: tile rows <= 64
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int align_up(int n, int a) {
  return (n + a - 1) / a * a;
}

// Shared memory, from a 1024-byte-aligned base (1024 bytes of slack in
// `bytes`): T [kt / 64 panels of tm rows x 128 bytes]; the expand ring
// (B: an item's two 64-column panels of wr rows after another's, wp rows
// a stage; y: two panels of tm rows when in place); the shrink ring (x:
// ceil(kc / 64) panels of tm rows, then ipp items of A [kc, wr], 1024-
// byte aligned); an output staging tile (two panels of tm rows; not in
// place: there the y tile is the staging); the partials a block receives,
// [ncl][its quads][4] f32 (at most tm * wp floats and 15 quads of
// padding); the
// warps' partials [ks, tm, wp] f32 when warps split `in` (ks = 64 / tm >
// 1); scales, distinct ids, each row's index in them and group, their
// count; the mbarriers. ops/lora.py lora_smem_bytes holds the same count.
// The kernel reads the offsets from its parameters (computed on the
// host), so they take no registers.
struct Layout {
  int t, eb, eb_stage, ey, ey_stage, s, s_stage, x_bytes, out, out_stage,
      part, red, meta, bars, bytes;
  Layout() = default;
  Layout(int tm, int wr, int ipp, int kt, int kc, int s1, int s2,
         int in_place) {
    const int wp = ipp * wr;
    t = 0;
    eb = align_up(t + tm * kt * 2, 1024);
    eb_stage = align_up(wp * 256, 1024);
    ey = eb + s2 * eb_stage;
    ey_stage = in_place ? align_up(tm * 256, 1024) : 0;
    s = ey + s2 * ey_stage;
    x_bytes = align_up(kc, 64) / 64 * tm * 128;
    s_stage = align_up(x_bytes + ipp * kc * wr * 2, 1024);
    out = s + s1 * s_stage;
    // In place the epilogue stages over the y tile of the expand ring.
    out_stage = in_place ? 0 : align_up(tm * 256, 1024);
    part = out + out_stage;
    red = part + tm * wp * 4 + 256;
    meta = red + (kMaxRows / tm > 1 ? kMaxRows / tm * tm * wp * 4 : 0);
    bars = meta + 4 * kMaxRows * 4 + 16;
    bytes = 1024 + bars + (2 * s1 + 2 * s2 + 2) * 8;
  }
};

struct Params {
  const bf16 *x, *a, *b;
  const int *ids;
  const float *scale;
  bf16 *out;            // y when in place
  long long n_tok;
  int div;              // tokens a sequence (per-sequence ids), else 1
  int din, r, dout, n_adapters;
  int tm, cpb, span, wr, n_rt, ipp, per_group, kc, s1, s2;
  int in_place, vec_x, vec_a, vec_b, vec_o;
  int bulk_a;   // A by one bulk copy an item (vec_a, one rank tile, in % 16 == 0)
  Layout lay;
};

// ------------------------------------------------------------ primitives
// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void *smem, const void *gmem,
                                          int bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA: the box in shared memory into `map` at (c0, c1, 0, 0), in this
// thread's current bulk group (elements outside the tensor are dropped).
__device__ __forceinline__ void tma_store(const CUtensorMap *map,
                                          const void *smem, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %4}], [%1];\n" ::"l"(map),
      "r"(smem_u32(smem)), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}

// Raise the bytes `bar`'s current phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect(uint64_t *bar, int bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Store 8 bytes at `local`'s offset in block `rank`'s shared memory,
// counted (8 bytes) on the mbarrier at `bar`'s offset there: the store
// signals its own arrival, no fence and no arrive.
__device__ __forceinline__ void st_async_peer(void *local, int rank,
                                              uint2 v, uint64_t *bar) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(ra),
      "r"(v.x), "r"(v.y), "r"(rb)
      : "memory");
}

// The same for 16 bytes of f32.
__device__ __forceinline__ void st_async_peer_f4(float *local, int rank,
                                                 float4 v, uint64_t *bar) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(ra),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rb)
      : "memory");
}

// Whether the phase of `bar` with this parity has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint64_t *bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16 *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}



// ---------------------------------------------------------------- kernel
// The walk both roles follow: ids in groups of `per_group` (whole ids,
// their rank tiles together), a group's items (id, rank tile) in passes
// of ipp; the shrink takes (group, pass, chunk of `in`) items from the
// shrink ring, the expand (group, column pass, pass) items from the
// expand ring, the y tile riding with a column pass's last pass.
struct Walk {
  int nu, per_group, n_groups, n_rt, ipp;
  __device__ int ids_in(int g) const { return min(per_group, nu - g * per_group); }
  __device__ int items(int g) const { return ids_in(g) * n_rt; }
  __device__ int passes(int g) const { return (items(g) + ipp - 1) / ipp; }
};

// KS: a pass's width (ipp * wr columns) in 16-column steps, 1-8; the
// shrink's n-tiles and the expand's k-steps are unrolled over it, so no
// branch splits them (a pass short of items computes zeros there).
template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
    lora_kernel(const __grid_constant__ Params p,
                const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap omap) {
  extern __shared__ unsigned char smem_raw[];
  // Offset from smem_raw (not through an integer), so that the compiler
  // keeps shared-memory accesses in the shared window (LDS/STS).
  unsigned char *sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout &L = p.lay;
  const int wp = p.ipp * p.wr;
  float *s_sc = reinterpret_cast<float *>(sm + L.meta);
  int *s_uniq = reinterpret_cast<int *>(s_sc + kMaxRows);
  int *s_rowu = s_uniq + kMaxRows;
  int *s_rowg = s_rowu + kMaxRows;   // the row's group, -1: id 0
  int *s_nu = s_rowg + kMaxRows;
  uint64_t *full1 = reinterpret_cast<uint64_t *>(sm + L.bars);
  uint64_t *empty1 = full1 + p.s1;
  uint64_t *full2 = empty1 + p.s1;
  uint64_t *empty2 = full2 + p.s2;
  uint64_t *pready = empty2 + p.s2;    // partials received
  uint64_t *tready = pready + 1;       // T values received

  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long tok0 = static_cast<long long>(blockIdx.x) * p.tm;
  const int n_rows =
      static_cast<int>(p.n_tok - tok0 < p.tm ? p.n_tok - tok0 : p.tm);
  const int k_lo = crank * p.span;
  const int k_hi = min(p.din, k_lo + p.span);
  const int n_chunks = k_hi > k_lo ? (k_hi - k_lo + p.kc - 1) / p.kc : 0;

  if (tid == 0) {
    for (int s = 0; s < p.s1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 4);
    }
    for (int s = 0; s < p.s2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 4);
    }
    mbar_init(pready, 1);   // one local arrive + the bytes pushed
    mbar_init(tready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Each block's barriers are initialised before a peer's stores count on
  // them: arrive here, wait before the first remote store.
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  __syncthreads();
  // The producer starts x's rows for the first shrink stages (group 0,
  // pass 0: they need no ids), then loads the ids and lists the tile's
  // distinct non-zero ids (in order of first appearance) by a warp vote,
  // and each row's index among them (-1: id 0).
  const int pre = p.vec_x ? min(p.s1, n_chunks) : 0;
  const int x_boxes = (p.kc + 63) / 64;
  // x's tile [tm, kc] of `in` from k0 into a shrink stage's panels by TMA
  // (lane 0; rows past the tokens and columns past `in` arrive as zeros),
  // counted on the stage's barrier.
  auto load_x = [&](int st, int k0) {
    for (int b = 0; b < x_boxes; ++b)
      tma_load(sm + L.s + st * L.s_stage + b * p.tm * 128, &xmap, &full1[st],
               k0 + 64 * b, static_cast<int>(tok0), 0, 0);
  };
  if (warp == 4) {
    if (lane == 0) {   // the maps' first use would wait for them
      if (p.vec_x)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&xmap) : "memory");
      if (p.vec_a && !p.bulk_a)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&amap) : "memory");
      if (p.vec_b)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&bmap) : "memory");
      if (p.vec_o)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&omap) : "memory");
    }
    // The ids' loads first (the copies' asm would hold them back): their
    // latency passes while the copies start.
    int v[2];
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = lane + 32 * h;
      v[h] = 0;
      sc[h] = 0.f;
      if (m < n_rows) {
        const long long t = (tok0 + m) / p.div;
        v[h] = p.ids[t];
        sc[h] = p.scale[t];
      }
    }
    for (int k = 0; k < pre && lane == 0; ++k) {
      // The bytes only: the stage's arrival comes with its A.
      mbar_expect(&full1[k], x_boxes * p.tm * 128);
      load_x(k, k_lo + k * p.kc);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (v[h] < 0 || v[h] >= p.n_adapters) v[h] = 0;
    int nu = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned same = __match_any_sync(0xffffffffu, v[h]);
      bool fresh = v[h] != 0 && lane == __ffs(same) - 1;
      for (int u = 0; u < nu && fresh; ++u) fresh = s_uniq[u] != v[h];
      const unsigned vote = __ballot_sync(0xffffffffu, fresh);
      if (fresh) s_uniq[nu + __popc(vote & ((1u << lane) - 1))] = v[h];
      nu += __popc(vote);
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int u = -1;
      for (int i = 0; i < nu && v[h] != 0; ++i)
        if (s_uniq[i] == v[h]) u = i;
      s_rowu[lane + 32 * h] = u;
      s_rowg[lane + 32 * h] = u >= 0 ? u / p.per_group : -1;
      s_sc[lane + 32 * h] = round_bf16(sc[h]);
    }
    if (lane == 0) *s_nu = nu;
    __syncwarp();
  }
  // The lists are written before the consumers read them.
  named_sync(2, kThreads);

  const int nu = *s_nu;
  if (warp == 4 && nu == 0) {
    // No item reads the x rows started above: let them land first.
    for (int k = 0; k < pre; ++k) {
      if (lane == 0) mbar_arrive(&full1[k]);
      mbar_wait(&full1[k], 0);
    }
  }
  // Every block of the cluster has the tile, so the same nu: with no
  // adapter in the tile, in place, every row already holds its result.
  if (nu == 0 && p.in_place) return;
  Walk walk;
  walk.nu = nu;
  walk.per_group = p.per_group;
  walk.n_groups = nu == 0 ? 1 : (nu + walk.per_group - 1) / walk.per_group;
  walk.n_rt = p.n_rt;
  walk.ipp = p.ipp;
  const int passes_c = (p.dout + kNC - 1) / kNC;
  const int c_first = blockIdx.y * p.cpb;
  const int n_c = max(0, min(p.cpb, passes_c - c_first));
  // The tiles of a column chunk walk its passes from different starts, so
  // they do not all read the same B columns at once.
  const int c_rot =
      n_c > 0 ? static_cast<int>(blockIdx.x % n_c) : 0;
  // A's row pitch in a shrink stage: the rank itself where an id's rows
  // are one contiguous copy, else the rank-tile width.
  const int ap = (p.vec_a && p.n_rt == 1) ? p.r : p.wr;
  const int abox = p.n_rt == 1 ? p.r : p.wr;   // A's TMA box columns
  bf16 *T = reinterpret_cast<bf16 *>(sm + L.t);

  if (warp == 4) {
    // ================================================= producer warp
    int sg = 0, sp = 0, sk = 0;
    bool s_more = nu > 0 && n_chunks > 0;
    int eg = 0, ec = 0, ep = 0;
    bool e_more = nu > 0 && n_c > 0;
    int n1 = 0, n2 = 0;
    // The order: the shrink ring's first fill, then any expand item whose
    // stage is free now (one test, no spinning: B needs no shrink result),
    // else the earlier of the two rings' next items in the consumers'
    // order (a group's shrink items before its expand items), waited for
    // with try_wait, which suspends the warp. Every wait is for a stage
    // that an item the consumers already have frees, so none deadlocks.
    while (s_more || e_more) {
      int go;
      if (s_more && n1 < p.s1) {
        go = 1;
      } else {
        int free_e = 0;
        if (lane == 0)
          free_e = e_more && (n2 < p.s2 || mbar_test(&empty2[n2 % p.s2],
                                                     ((n2 / p.s2) & 1) ^ 1));
        if (__shfl_sync(0xffffffffu, free_e, 0)) {
          go = 2;
        } else if (s_more && (!e_more || sg <= eg)) {
          mbar_wait(&empty1[n1 % p.s1], ((n1 / p.s1) & 1) ^ 1);
          go = 1;
        } else {
          mbar_wait(&empty2[n2 % p.s2], ((n2 / p.s2) & 1) ^ 1);
          go = 2;
        }
      }
      if (go == 1) {
        // x rows [n_rows, kc] and the pass's items of A [kc, width].
        const int st = n1 % p.s1;
        unsigned char *xs = sm + L.s + st * L.s_stage;
        bf16 *as = reinterpret_cast<bf16 *>(xs + L.x_bytes);
        const int k0 = k_lo + sk * p.kc;
        const int rows = min(p.kc, k_hi - k0);
        const int it0 = sp * p.ipp;
        const int n_it = min(p.ipp, walk.items(sg) - it0);
        const int u0 = sg * walk.per_group;
        const bool x_now = p.vec_x && n1 >= pre;
        if (!p.vec_x) {   // zeros past the rows: the last 16-row step is exact
          for (int i = lane; i < p.tm * p.kc; i += 32) {
            const int m = i / p.kc, kk = i % p.kc;
            *reinterpret_cast<bf16 *>(xs + (kk / 64) * p.tm * 128 +
                                      swz(m, (kk % 64) / 8) + (kk % 8) * 2) =
                (m < n_rows && kk < rows)
                    ? p.x[(tok0 + m) * p.din + k0 + kk]
                    : __float2bfloat16(0.f);
          }
        }
        if (!p.vec_a) {
          for (int it = 0; it < n_it; ++it) {
            const int gi = it0 + it;
            const int a = s_uniq[u0 + gi / p.n_rt], j = gi % p.n_rt;
            const bf16 *src = p.a + (static_cast<long long>(a) * p.din + k0) *
                                        p.r + j * p.wr;
            bf16 *dst = as + it * p.kc * p.wr;
            for (int i = lane; i < p.kc * p.wr; i += 32) {
              const int rr = i / p.wr, cc = i % p.wr;
              dst[i] = (rr < rows && j * p.wr + cc < p.r)
                           ? src[static_cast<long long>(rr) * p.r + cc]
                           : __float2bfloat16(0.f);
            }
          }
        }
        __syncwarp();
        if (lane == 0) {
          int bytes = x_now ? x_boxes * p.tm * 128 : 0;
          if (p.bulk_a)
            bytes += n_it * rows * p.r * 2;
          else if (p.vec_a)
            bytes += n_it * p.kc * abox * 2;
          mbar_expect_tx(&full1[st], bytes);
          // A by TMA: one box [kc, abox] an item (rows past `in` and
          // columns past r arrive as zeros).
          if (p.vec_a && !p.bulk_a)
            for (int it = 0; it < n_it; ++it) {
              const int gi = it0 + it;
              for (int b0 = 0; b0 < p.kc; b0 += 256)   // kc 512: 2 boxes
                tma_load(as + it * p.kc * p.wr + b0 * ap, &amap, &full1[st],
                         (gi % p.n_rt) * p.wr, k0 + b0,
                         s_uniq[u0 + gi / p.n_rt], 0);
            }
        }
        // A by bulk copies: an item's rows [k0, k0 + rows) are contiguous.
        if (p.bulk_a && lane < n_it)
          bulk_load(as + lane * p.kc * p.wr,
                    p.a + (static_cast<long long>(s_uniq[u0 + it0 + lane]) *
                               p.din + k0) * p.r,
                    rows * p.r * 2, &full1[st]);
        if (x_now && lane == 0) load_x(st, k0);
        ++n1;
        if (++sk == n_chunks) {
          sk = 0;
          if (++sp == walk.passes(sg)) {
            sp = 0;
            if (++sg == walk.n_groups) s_more = false;
          }
        }
      } else if (go == 2) {
        // The pass's B tiles [width, 128 columns] (+ y's tile [n_rows, 128]
        // with a column pass's last pass, in place). A pass short of items
        // gets zeros in their place (T is zero there too, and stale shared
        // memory need not be finite).
        const int st = n2 % p.s2;
        unsigned char *eb = sm + L.eb + st * L.eb_stage;
        unsigned char *ys = sm + L.ey + st * L.ey_stage;
        const int c0 = (c_first + (ec + c_rot) % n_c) * kNC;
        // y's boxes: 16 rows of a 64-column panel, those with columns and
        // rows in the tensor.
        const int y_panels = p.dout - c0 > 64 ? 2 : 1;
        const int y_rows = (n_rows + 15) / 16;
        const int it0 = ep * p.ipp;
        const int n_it = min(p.ipp, walk.items(eg) - it0);
        const int u0 = eg * walk.per_group;
        const bool with_y =
            p.in_place && p.vec_o && ep == walk.passes(eg) - 1;
        if (!p.vec_b) {
          for (int it = 0; it < p.ipp; ++it) {
            const int gi = it0 + it;
            const int a = it < n_it ? s_uniq[u0 + gi / p.n_rt] : 0;
            const int j = it < n_it ? gi % p.n_rt : 0;
            for (int i = lane; i < p.wr * kNC; i += 32) {
              const int kk = i / kNC, n = i % kNC;
              const int k = j * p.wr + kk;
              const bf16 v =
                  (k < p.r && c0 + n < p.dout)
                      ? p.b[(static_cast<long long>(a) * p.r + k) * p.dout +
                            c0 + n]
                      : __float2bfloat16(0.f);
              *reinterpret_cast<bf16 *>(eb + (2 * it + n / 64) * p.wr * 128 +
                                        swz(kk, (n % 64) / 8) +
                                        (n % 8) * 2) = v;
            }
          }
        } else {
          for (int i = lane; i < (p.ipp - n_it) * p.wr * 16; i += 32)
            *reinterpret_cast<uint4 *>(eb + 2 * n_it * p.wr * 128 + 16 * i) =
                make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();   // visible to wgmma
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full2[st],
                         (p.vec_b ? n_it * 2 * p.wr * 128 : 0) +
                             (with_y ? y_panels * y_rows * 16 * 128 : 0));
          for (int it = 0; it < n_it && p.vec_b; ++it) {
            const int gi = it0 + it;
            // Both 64-column panels in one box: [2][wr][64], swizzled.
            tma_load(eb + 2 * it * p.wr * 128, &bmap, &full2[st], 0,
                     (gi % p.n_rt) * p.wr, c0 / 64,
                     s_uniq[u0 + gi / p.n_rt]);
          }
        }
        if (with_y && lane < y_panels * y_rows) {
          const int np = lane / y_rows, rb = lane % y_rows;
          tma_load(ys + np * p.tm * 128 + rb * 16 * 128, &omap, &full2[st],
                   c0 + 64 * np, static_cast<int>(tok0) + 16 * rb, 0, 0);
        }
        ++n2;
        if (++ep == walk.passes(eg)) {
          ep = 0;
          if (++ec == n_c) {
            ec = 0;
            if (++eg == walk.n_groups) e_more = false;
          }
        }
      }
    }
    return;
  }

  // =================================================== consumer warpgroup
  const int g4 = lane / 4, t4 = lane % 4;
  const int blk = lane / 8;              // ldmatrix: 8x8 block addressed
  const int m_tiles = p.tm / 16;
  const int ks = 4 / m_tiles;            // warps splitting `in` a m-tile
  const int mt = warp % m_tiles, slot = warp / m_tiles;
  float *part = reinterpret_cast<float *>(sm + L.part);   // received
  float *red = reinterpret_cast<float *>(sm + L.red);     // warps' partials
  int n1 = 0, n2 = 0, pc = 0;   // the rings' items, passes
  auto release = [&](uint64_t *bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto panel_of = [&](int tcol) {   // T's shared-memory byte offset
    return (tcol / 64) * p.tm * 128;
  };
  int items = 0, u0 = 0;   // the current group's
  // Whether row m's id is item gi's (gi < items).
  auto own_id = [&](int m, int gi) {
    return gi < items && s_rowu[m] == u0 + gi / p.n_rt;
  };

  for (int g = 0; g < walk.n_groups; ++g) {
    u0 = g * walk.per_group;
    items = nu > 0 ? walk.items(g) : 0;
    const int passes = nu > 0 ? walk.passes(g) : 0;
    // ---- shrink: T[m, item cols] = bf16(x[m] @ A[id, rank tile]) for the
    // rows on the item's id, else 0.
    for (int pp = 0; pp < passes; ++pp) {
      const int it0 = pp * p.ipp;
      float acc[2 * KS][4];
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k = 0; k < n_chunks; ++k) {
        const int st = n1 % p.s1;
        mbar_wait(&full1[st], (n1 / p.s1) & 1);
        const unsigned char *xs = sm + L.s + st * L.s_stage;
        const bf16 *as = reinterpret_cast<const bf16 *>(
            sm + L.s + st * L.s_stage + L.x_bytes);
        const int rows = min(p.kc, k_hi - (k_lo + k * p.kc));
        const int steps = (rows + 15) / 16;
        for (int s = slot; s < steps; s += ks) {
          const int kk = s * 16;
          // x's A fragment from its swizzled panel: lane l addresses row
          // l % 16 of the m-tile, 8-column chunk l / 16 of the step.
          uint32_t af[4];
          ldmatrix_x4(af, xs + (kk / 64) * p.tm * 128 +
                              swz(mt * 16 + lane % 16, (kk % 64) / 8 + lane / 16));
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const int it = (16 * j) / p.wr, cc = (16 * j) % p.wr;
            const bf16 *q = as + it * p.kc * p.wr +
                            (kk + (blk & 1) * 8 + lane % 8) * ap + cc +
                            (blk >> 1) * 8;
            uint32_t bfr[4];
            ldmatrix_x4_trans(bfr, q);
            mma_bf16(acc[2 * j], af, bfr[0], bfr[1]);
            mma_bf16(acc[2 * j + 1], af, bfr[2], bfr[3]);
          }
        }
        release(&empty1[st]);
        ++n1;
      }
      // The exchange, pushed both ways (st.async, each store counted on
      // the receiver's barrier: no fence, no remote load): every block
      // sends each of its partial's quads to the quad's owner; an owner
      // sums what it received in rank order and sends the rounded, masked
      // values to every block's T. One buffer of partials serves every
      // pass: a block pushes the next pass's partials only once it has all
      // of this pass's T values, which each owner sends after reading what
      // it received. Only the pass's items' columns (uw) travel: quad i
      // (4 columns of a row) is block i % ncl's, at its index i / ncl
      // among them; each block zeroes the rest of the pass in its own T.
      const int uw = min(p.ipp, items - it0) * p.wr;
      const int uq = uw / 4;   // quads a row
      const int quads = p.tm * uq;
      const int owned = (quads - crank + ncl - 1) / ncl;
      const int n_owned = (quads + ncl - 1) / ncl;   // the most a block owns
      float *pb = part;   // [ncl][n_owned][4]
      if (tid == 0) {
        mbar_expect_tx(pready, owned * ncl * 16);
        mbar_expect_tx(tready, p.tm * uw * 2);
      }
      for (int i = tid; i < p.tm * (wp - uw) / 8; i += kConsumers) {
        const int m = i / ((wp - uw) / 8);
        const int tcol = it0 * p.wr + uw + 8 * (i % ((wp - uw) / 8));
        *reinterpret_cast<uint4 *>(reinterpret_cast<unsigned char *>(T) +
                                   panel_of(tcol) + swz(m, (tcol % 64) / 8)) =
            make_uint4(0, 0, 0, 0);
      }
      if (pc == 0) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
      // Each quad's value, summed over the warps that split `in` (in slot
      // order), goes to its owner.
      auto push = [&](int q, float4 v) {
        st_async_peer_f4(pb + (crank * n_owned + q / ncl) * 4, q % ncl, v,
                         pready);
      };
      if (ks == 1) {
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Lanes t4 and t4 ^ 1 hold a quad's two halves.
            const float o0 = __shfl_xor_sync(0xffffffffu, acc[j][2 * h], 1);
            const float o1 =
                __shfl_xor_sync(0xffffffffu, acc[j][2 * h + 1], 1);
            const int m = mt * 16 + g4 + 8 * h, c = 8 * j + 2 * t4;
            if ((t4 & 1) == 0 && c < uw) {
              push(m * uq + c / 4,
                   make_float4(acc[j][2 * h], acc[j][2 * h + 1], o0, o1));
            }
          }
        }
      } else {
        float *dst = red + slot * p.tm * wp;
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j) {
          const int m = mt * 16 + g4, c = 8 * j + 2 * t4;
          *reinterpret_cast<float2 *>(dst + m * wp + c) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2 *>(dst + (m + 8) * wp + c) =
              make_float2(acc[j][2], acc[j][3]);
        }
        named_sync(1, kConsumers);
        for (int q = tid; q < quads; q += kConsumers) {
          const int at = (q / uq) * wp + 4 * (q % uq);
          float4 v = *reinterpret_cast<const float4 *>(red + at);
          for (int w = 1; w < ks; ++w) {
            const float4 u = *reinterpret_cast<const float4 *>(
                red + w * p.tm * wp + at);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          push(q, v);
        }
        named_sync(1, kConsumers);   // red is free for the next pass
      }
      mbar_wait(pready, pc & 1);
      for (int k = tid; k < owned; k += kConsumers) {
        const int i = crank + ncl * k;
        const int m = i / uq, c = 4 * (i % uq);
        float4 sum = *reinterpret_cast<const float4 *>(pb + k * 4);
        for (int q = 1; q < ncl; ++q) {
          const float4 v =
              *reinterpret_cast<const float4 *>(pb + (q * n_owned + k) * 4);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        const int it = c / p.wr, cc = c % p.wr, gi = it0 + it;
        const int valid =
            own_id(m, gi) ? min(p.wr, p.r - (gi % p.n_rt) * p.wr) : 0;
        const int tcol = it0 * p.wr + c;
        uint2 t2;
        t2.x = pack_bf16(cc < valid ? sum.x : 0.f,
                         cc + 1 < valid ? sum.y : 0.f);
        t2.y = pack_bf16(cc + 2 < valid ? sum.z : 0.f,
                         cc + 3 < valid ? sum.w : 0.f);
        void *t = reinterpret_cast<unsigned char *>(T) + panel_of(tcol) +
                  swz(m, (tcol % 64) / 8) + (tcol % 8) * 2;
        for (int q = 0; q < ncl; ++q) st_async_peer(t, q, t2, tready);
      }
      // Every block's T values are in this block's T, so every block has
      // also read what this block sent it (the buffer is free again).
      mbar_wait(tready, pc & 1);
      ++pc;
    }
    fence_async_smem();
    named_sync(1, kConsumers);   // T is whole, and visible to wgmma

    // ---- expand: out[m, c0 .. c0 + 127] for the rows on this group's ids
    // (and, in group 0, rows of id 0 as zeros unless in place).
    for (int c = 0; c < n_c; ++c) {
      const int c0 = (c_first + (c + c_rot) % n_c) * kNC;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int y_stage = -1;
      for (int pp = 0; pp < passes; ++pp) {
        const int st = n2 % p.s2;
        mbar_wait(&full2[st], (n2 / p.s2) & 1);
        const uint64_t bdesc = smem_desc(sm + L.eb + st * L.eb_stage);
        const uint64_t tdesc = smem_desc(T);
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int tcol = pp * wp + 16 * s;
          const uint64_t ta =
              tdesc + ((panel_of(tcol) + (tcol % 64) * 2) >> 4);
#pragma unroll
          for (int np = 0; np < 2; ++np)
            wgmma_ss_n64<0, 1>(
                panel(acc, np), ta,
                bdesc + (((2 * ((16 * s) / p.wr) + np) * p.wr +
                          (16 * s) % p.wr) * 128 >> 4),
                1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (p.in_place && pp == passes - 1)
          y_stage = st;   // its y tile is the staging: released after
        else
          release(&empty2[st]);
        ++n2;
      }
      // Epilogue into the staging tile (two swizzled panels), each warp
      // its own 16 rows; in place over the y tile (each thread reads the
      // values it overwrites). Not in place, a warp's lane 0 stored its
      // rows from the staging last pass: it waits until those stores have
      // read it.
      unsigned char *os =
          y_stage >= 0 ? sm + L.ey + y_stage * L.ey_stage : sm + L.out;
      const bool with_y = y_stage >= 0 && p.vec_o;
      if (!p.vec_o) {
        named_sync(1, kConsumers);   // the last pass's stores read os
      } else if (y_stage < 0) {
        bulk_wait_read();
        __syncwarp();
      }
      // Element (m, col)'s byte in a staging tile.
      auto at_tile = [&](int m, int col) {
        return (col / 64) * p.tm * 128 + swz(m, (col % 64) / 8) +
               (col % 8) * 2;
      };
      // Branch-free, in bf16x2: the expand's output rounded (one pack),
      // times the bf16 scale (a bf16 product is exact in f32, so HMUL2
      // rounds it once, as the f32 multiply and cast would), plus y (HADD2
      // rounds the f32 sum once too). The accumulators are mma fragments
      // of 8 x 8 blocks: stmatrix writes four at a time into the swizzled
      // panels (ldmatrix reads y's the same way), lane l addressing row
      // l % 16 of the warp's rows in 8-column chunk 2q + l / 16.
      auto epilogue = [&](auto add_y) {
        const int m0 = warp * 16 + g4;
        const __nv_bfloat162 sc2[2] = {
            __float2bfloat162_rn(s_rowu[m0] >= 0 ? s_sc[m0] : 0.f),
            __float2bfloat162_rn(s_rowu[m0 + 8] >= 0 ? s_sc[m0 + 8] : 0.f)};
        const bool own[2] = {s_rowu[m0] >= 0, s_rowu[m0 + 8] >= 0};
        const int er = warp * 16 + (lane & 15);
        unsigned char *erow = os + er * 128;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            unsigned char *at = erow + np * p.tm * 128 +
                                (((2 * q + (lane >> 4)) ^ (er & 7)) << 4);
            uint32_t r[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float *a2 = acc + np * 32 + 4 * (2 * q + i / 2) + 2 * (i % 2);
              __nv_bfloat162 d =
                  __hmul2(__floats2bfloat162_rn(a2[0], a2[1]), sc2[i % 2]);
              r[i] = *reinterpret_cast<uint32_t *>(&d);
            }
            if constexpr (decltype(add_y)::value) {
              uint32_t yv[4];
              ldmatrix_x4(yv, at);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                __nv_bfloat162 d =
                    __hadd2(*reinterpret_cast<__nv_bfloat162 *>(&yv[i]),
                            *reinterpret_cast<__nv_bfloat162 *>(&r[i]));
                // A row without an adapter keeps y's bits (-0 stays -0).
                r[i] = own[i % 2] ? *reinterpret_cast<uint32_t *>(&d) : yv[i];
              }
            }
            stmatrix_x4(at, r);
          }
        }
      };
      if (warp * 16 < p.tm) {   // rows past the tile hold nothing
        if (with_y)
          epilogue(std::true_type());
        else
          epilogue(std::false_type());
      }
      auto selected = [&](int m) {
        const int rg = s_rowg[m];
        return rg >= 0 ? rg == g : (!p.in_place && g == 0);
      };
      const int ncols = min(kNC, p.dout - c0);
      if (p.vec_o) {
        // A warp whose rows all take this pass's values stores them by
        // TMA, a box of 16 rows a panel (rows past the tokens and columns
        // past `out` are dropped); so does, in place, a tile of one group,
        // its rows without an adapter holding y as it was. Else a warp
        // stores its rows that take them by 16-byte stores (a row of
        // another group may hold a stale y in the tile).
        const int m = warp * 16 + lane % 16;
        if (__all_sync(0xffffffffu, m >= n_rows || selected(m) ||
                                        (with_y && walk.n_groups == 1))) {
          fence_async_smem();
          __syncwarp();
          if (lane == 0 && warp * 16 < n_rows) {
            for (int np = 0; np < 2 && 64 * np < ncols; ++np)
              tma_store(&omap, os + np * p.tm * 128 + warp * 16 * 128,
                        c0 + 64 * np, static_cast<int>(tok0) + warp * 16);
            bulk_commit();
          }
        } else {
          __syncwarp();
          for (int i = lane; i < 16 * (kNC / 8); i += 32) {
            const int mm = warp * 16 + i / (kNC / 8), v = (i % (kNC / 8)) * 8;
            if (mm < n_rows && v < ncols && selected(mm))
              *reinterpret_cast<uint4 *>(p.out + (tok0 + mm) * p.dout + c0 +
                                         v) =
                  *reinterpret_cast<const uint4 *>(os + at_tile(mm, v));
          }
        }
        // In place the stage goes back once this warp's stores have read
        // its rows.
        if (y_stage >= 0 && lane == 0) bulk_wait_read();
      } else {
        named_sync(1, kConsumers);
        for (int i = tid; i < n_rows * kNC; i += kConsumers) {
          const int m = i / kNC, col = i % kNC;
          if (col < ncols && selected(m)) {
            const long long at = (tok0 + m) * p.dout + c0 + col;
            const float d = __bfloat162float(
                *reinterpret_cast<const bf16 *>(os + at_tile(m, col)));
            p.out[at] = __float2bfloat16(
                p.in_place ? __bfloat162float(p.out[at]) + d : d);
          }
        }
      }
      if (y_stage >= 0) release(&empty2[y_stage]);
    }
    // The next group's shrink writes T: every warp's expand has read it.
    if (g + 1 < walk.n_groups) named_sync(1, kConsumers);
  }
  // No peer reads this block's partials or writes its T any more: each
  // arrived on tready after its last reads and pushes. The staging stays
  // until the last stores have read it.
  bulk_wait_read();
}

// ------------------------------------------------------------------ host
// B [N, r, out] as the 4-d map {64, r, out / 64, N} (a column's panel
// outer to its rows), boxes of 64 columns x wr rows x 2 panels, 128-byte
// swizzle: one box is an item's two panels [2][wr][64] (rows past r
// arrive as zeros).
bool encode_b(CUtensorMap *map, const void *base, int dout, int r, int n,
              int wr) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, cuuint64_t(r), cuuint64_t(dout / 64),
                              cuuint64_t(n)};
  const cuuint64_t strides[3] = {cuuint64_t(dout) * 2, 128,
                                 cuuint64_t(dout) * r * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(wr), 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void *>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [N, in, r] as the 4-d map {r, in, N, 1}, boxes of `cols` columns x
// kc rows, no swizzle (rows past `in`, columns past r arrive as zeros).
bool encode_a(CUtensorMap *map, const void *base, int din, int r, int n,
              int cols, int kc) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(r), cuuint64_t(din), cuuint64_t(n),
                              1};
  const cuuint64_t strides[3] = {cuuint64_t(r) * 2, cuuint64_t(r) * din * 2,
                                 cuuint64_t(r) * din * n * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), cuuint32_t(kc), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void *>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [rows, cols] activation (x, y, the output) as the 4-d map {cols,
// rows, 1, 1}, boxes of 64 columns x box_rows rows, 128-byte swizzle: one
// box is a panel [box_rows][64] (rows and columns outside the tensor
// arrive as zeros, and are dropped by a store).
bool encode_rows(CUtensorMap *map, const void *base, int cols, int rows,
                 int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(rows), 1, 1};
  const cuuint64_t bytes = cuuint64_t(cols) * rows * 2;
  const cuuint64_t strides[3] = {cuuint64_t(cols) * 2, bytes, bytes};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void *>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct MapKey {
  const void *base;
  int which, d0, d1, n, box0, box1;   // which: 0 A, 1 B, 2 rows
  bool operator==(const MapKey &o) const {
    return base == o.base && which == o.which && d0 == o.d0 &&
           d1 == o.d1 && n == o.n && box0 == o.box0 && box1 == o.box1;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey &k) const {
    return std::hash<const void *>()(k.base) ^
           (static_cast<size_t>(k.d0) * 31 + k.which) ^
           (static_cast<size_t>(k.d1) << 20) ^
           (static_cast<size_t>(k.n) << 36) ^
           (static_cast<size_t>(k.box0 * 257 + k.box1) << 44);
  }
};

// Maps encoded once per (tensor, shape, box): a projection's call looks
// them up instead of encoding them. Activations are keyed by pointer too:
// the caching allocator gives a step's tensors the same addresses again,
// and a map holds nothing but the address, shape and box.
bool cached_map(CUtensorMap *map, const MapKey &key) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!(key.which == 0   ? encode_a(map, key.base, key.d0, key.d1, key.n,
                                     key.box0, key.box1)
        : key.which == 1 ? encode_b(map, key.base, key.d0, key.d1, key.n,
                                     key.box0)
                         : encode_rows(map, key.base, key.d0, key.d1,
                                       key.box1)))
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

using Kernel = void (*)(const Params, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap);

// The instantiation for a pass of ks 16-column steps (1-8).
Kernel kernel_for(int ks) {
  static const Kernel kernels[8] = {
      lora_kernel<1>, lora_kernel<2>, lora_kernel<3>, lora_kernel<4>,
      lora_kernel<5>, lora_kernel<6>, lora_kernel<7>, lora_kernel<8>};
  return kernels[ks - 1];
}

// An instantiation's dynamic shared-memory limit, raised once per device
// to the largest size asked for.
cudaError_t allow_smem(int ks, int bytes) {
  constexpr int kDevices = 64;
  static std::atomic<int> allowed[8][kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[ks - 1][dev].load() >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_for(ks),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_for(ks),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess && dev < kDevices) {
    int cur = allowed[ks - 1][dev].load();
    while (cur < bytes &&
           !allowed[ks - 1][dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

bool aligned16(const void *ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

SKYT_DEFINE_ERROR_STRING


// Dynamic shared memory of a block (ops/lora.py lora_smem_bytes holds the
// same number).
extern "C" int skyt_lora_smem(int tm, int wr, int ipp, int kt, int kc,
                              int s1, int s2, int in_place) {
  return Layout(tm, wr, ipp, kt, kc, s1, s2, in_place).bytes;
}

// The launch lora_plan picks, as ops/lora.py's _PlanArgs lays it out (one
// pointer a call rather than twelve arguments).
struct PlanArgs {
  int tm, cpb, col_tiles, cluster, span, wr, ipp, kt, per_group, kc, s1, s2;
};

// x [n_seq * seq, in], a [N, in, r], b [N, r, out], y / out
// [n_seq * seq, out]: bf16, contiguous. ids / scale: int32 / f32, [n_seq]
// (per_token 0) or [n_seq * seq] (per_token 1). y is null (out = delta)
// or equals out (in place). The plan (ops/lora.py lora_plan): tiles of tm
// tokens (16, 32 or 64), each with col_tiles blocks of cpb 128-column
// passes (col_tiles a multiple of cluster, 1-16; blocks past `out` only
// share the shrink), `in` split in spans of `span` (a multiple of 16)
// between a cluster's blocks; rank tiles of wr columns (a multiple of 16,
// <= 128; n_rt = ceil(r / wr)), ipp of them a pass (ipp * wr <= 128); kt
// columns of T (a multiple of 64) holding the passes of per_group ids;
// shrink chunks of kc rows of `in` (a multiple of 16 up to 256, or 512)
// in a ring of s1, an expand ring of s2. Returns cudaErrorInvalidValue on a plan
// the kernel cannot run.
extern "C" int skyt_lora(const void *x, const void *a, const void *b,
                         const void *ids, const void *scale, const void *y,
                         void *out, int n_seq, int seq, int din, int r,
                         int dout, int n_adapters, int per_token,
                         const PlanArgs *plan, void *stream) {
  const int tm = plan->tm, cpb = plan->cpb, col_tiles = plan->col_tiles,
            cluster = plan->cluster, span = plan->span, wr = plan->wr,
            ipp = plan->ipp, kt = plan->kt, per_group = plan->per_group,
            kc = plan->kc, s1 = plan->s1, s2 = plan->s2;
  const int n_rt = wr > 0 ? (r + wr - 1) / wr : 0;
  const long long n_tok = static_cast<long long>(n_seq) * seq;
  const int passes_c = (dout + kNC - 1) / kNC;
  if (n_seq <= 0 || seq <= 0 || din <= 0 || dout <= 0 || r < 1 ||
      n_adapters < 1 || (tm != 16 && tm != 32 && tm != 64) || cpb < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
       cluster != 16) ||
      col_tiles < 1 || col_tiles % cluster != 0 ||
      static_cast<long long>(cpb) * col_tiles < passes_c || span < 16 ||
      span % 16 != 0 || static_cast<long long>(span) * cluster < din ||
      wr < 16 || wr > 128 || wr % 16 != 0 || (n_rt > 1 && wr != 128) ||
      ipp < 1 || ipp * wr > 128 || kt < 64 || kt % 64 != 0 ||
      per_group < 1 ||
      (per_group * n_rt + ipp - 1) / ipp * ipp * wr > kt || kc < 16 ||
      (kc > 256 && kc != 512) || kc % 16 != 0 || s1 < 1 || s2 < 1 ||
      (y != nullptr && y != out) ||
      n_tok > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int in_place = y != nullptr;
  const Layout lay(tm, wr, ipp, kt, kc, s1, s2, in_place);
  if (lay.bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16 *>(x);
  p.a = static_cast<const bf16 *>(a);
  p.b = static_cast<const bf16 *>(b);
  p.ids = static_cast<const int *>(ids);
  p.scale = static_cast<const float *>(scale);
  p.out = static_cast<bf16 *>(out);
  p.n_tok = n_tok;
  p.div = per_token ? 1 : seq;
  p.din = din;
  p.r = r;
  p.dout = dout;
  p.n_adapters = n_adapters;
  p.tm = tm;
  p.cpb = cpb;
  p.span = span;
  p.wr = wr;
  p.n_rt = n_rt;
  p.ipp = ipp;
  p.per_group = per_group;
  p.kc = kc;
  p.s1 = s1;
  p.s2 = s2;
  p.in_place = in_place;
  p.vec_x = din % 8 == 0 && aligned16(x);
  p.vec_a = r % 8 == 0 && aligned16(a);
  p.vec_b = dout % 64 == 0 && aligned16(b);
  p.vec_o = dout % 8 == 0 && aligned16(out);
  p.bulk_a = p.vec_a && n_rt == 1 && din % 16 == 0;
  p.lay = lay;
  CUtensorMap amap{}, bmap{}, xmap{}, omap{};
  const int rows = static_cast<int>(n_tok);
  if ((p.vec_a && !p.bulk_a &&
       !cached_map(&amap, MapKey{a, 0, din, r, n_adapters, n_rt == 1 ? r : wr,
                                 kc < 256 ? kc : 256})) ||
      (p.vec_b &&
       !cached_map(&bmap, MapKey{b, 1, dout, r, n_adapters, wr, 0})) ||
      (p.vec_x && !cached_map(&xmap, MapKey{x, 2, din, rows, 1, 64, tm})) ||
      (p.vec_o && !cached_map(&omap, MapKey{out, 2, dout, rows, 1, 64, 16})))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = ipp * wr / 16;
  cudaError_t err = allow_smem(ks, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n_tok + tm - 1) / tm),
                     static_cast<unsigned>(col_tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(lay.bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_for(ks), p, amap, bmap, xmap, omap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
