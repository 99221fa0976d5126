// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces skypilot_tpu/ops/flash_attention.py:108 _fwd_kernel (launched
// by _flash_fwd_impl): FA2's online-softmax attention with causal,
// segment-id and sliding-window masks, GQA (query head h reads kv head
// h // (Hq/Hkv)) and the per-row logsumexp, out [B, Sq, Hq, D] bf16 and
// lse [B, Hq, Sq] f32.
//
// What bounds it on this card: tensor-core FLOPs. Per query head and
// visible (q, k) pair it does 4*d flops (S = Q K^T and O += P V) against
// 989 TFLOP/s bf16: at llama3-1b's training shape [8, 2048, 32, 64]
// causal that is 1.375e11 flops, 0.1390 ms, against 0.040 ms for the
// 134 MB it must read and write once; at gemma-2b's [4, 2048, 8, 256]
// with 1 kv head 0.0695 ms. A short row is bound by its bytes instead
// ([1, 512, 32, 128] causal: 0.0031 ms). And per pair the card's
// special-function units do one exp at ~1/256 of the tensor rate, as
// long as 4*d = 256 flops at head_dim 64: the exp must run under the
// products, or half the bound is the ceiling there.
//
// Design (FA3's shape). A persistent grid of one block an SM (fewer when
// there are fewer items), each block of three warpgroups walking work
// items, an item being a (128-row q tile, query head, batch):
//   * a producer warpgroup, of which one thread issues every load: each
//     item's Q, then each visited key tile's K and V by TMA (4-d tensor
//     maps over the [B, S, H, D] strides, 128-byte swizzle; rows past the
//     end arrive as zeros) into a ring of stages with a full and an empty
//     mbarrier for K and for V each. The ring runs on across items, and Q
//     has two buffers up to head_dim 128, so the next item's loads land
//     while the consumers finish this one. With segment ids its other
//     three warps work out the next item's mask classes (below) into one
//     of two buffers. It gives up its registers (setmaxnreg 56) to
//   * two consumer warpgroups (setmaxnreg 224), each owning 64 query
//     rows: S = Q K^T by wgmma with both operands in shared memory (m64
//     n128 k16 at head_dim 64 and 128 with 128-key tiles, m64 n64 k16 at
//     256 with 64-key tiles), the online softmax in registers in the
//     exp2 domain (scale * log2 e folded into one FMA a score), and
//     O += P V by wgmma with P as the register A operand (bf16, packed
//     straight from the S accumulators) and V read transposed from
//     shared memory (MN-major), one m64 n64 k16 per 64-column panel;
//   * the exp overlaps the products twice over. Within a warpgroup, key
//     tile j's S is issued together with tile j-1's P V, and the softmax
//     of tile j runs while that P V is in flight; O is rescaled once it
//     lands. Across the two warpgroups, named barriers make them take
//     turns at issuing (FA3's ping-pong), so one's exp runs under the
//     other's products. K is released (its empty barrier) as soon as S
//     lands, V once P V does. Every batch of wgmmas follows its own
//     wgmma.fence, with the registers it reads pinned before it: else
//     ptxas serializes the wgmmas;
//   * mask classes, decided once per (q tile, key tile): a key tile that
//     no row of the q tile can see (past the causal diagonal, outside the
//     window, or, with segment ids, sharing no segment with the q tile's
//     rows that can reach it) is skipped before its loads, the producer
//     and the consumers walking the same list; a tile wholly visible to a
//     warpgroup's 64 rows takes no per-element mask; the rest (cut by the
//     diagonal, the window's edge, a segment boundary or the ragged end)
//     is masked per element. So a packed row costs about the sum of its
//     segments' own triangles, and a windowed row O(window);
//   * masks follow _block_mask: causal on the packed index (q >= k), q -
//     k < window when a window is given (causal or not: a non-causal row
//     sees a one-sided band; its own instantiation, so the unwindowed
//     kernel carries none of its arithmetic), q_seg == k_seg when segment
//     ids are given (id 0 padding is masked like any other id). Masked
//     scores are the TPU kernel's -1e30 with exact zeros for p: a row
//     that has seen no key yet scales by 0, not by its -1e30 running
//     max. A row that sees no key gives out 0 and lse 0. p is rounded to
//     bf16 for P V, as the TPU kernel casts it; its row sum is taken in
//     f32;
//   * items are ordered q tiles slowest, so a (batch, kv head) group's
//     heads run together (its K and V stay in L2), and when causal the
//     last q tiles, which visit the most key tiles, come first. A block
//     takes the items of rounds of gridDim.x in alternate directions (b,
//     2G - 1 - b, 2G + b, ...): a block that drew a heavy item early draws
//     a light one next;
//   * deterministic: each item owns its rows' whole key range, with no
//     atomics, so out and lse are the same bits on every call.
// Shared memory: the Q buffers (128 x D bf16 each), the K and V stages (3
// at head_dim 64, 2 at 128 and 256), the mbarriers and 1 KB to align the
// swizzled tiles: 132,256 bytes at head_dim 64, 197,760 at 128, 197,744 at
// 256; with segment ids 4,128 more and 16 a key tile. One block an SM.
// ptxas for sm_90a: 168 registers a thread at launch in all six
// instantiations (head_dim 64, 128, 256, each with and without the
// window), no spills.
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

using namespace skyt;

constexpr int kBM = 128;               // query rows per work item
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr float kLog2e = 1.4426950408889634f;
// Segment id of a row past Sq, and of a key tile whose ids differ.
constexpr int kNoSeg = INT_MIN;

// The tensor maps of one call (host-encoded, passed by value): Q
// {D, Hq, Sq, B} with 64 x 1 x 128 x 1 boxes, K and V {D, Hkv, Sk, B}
// with 64 x 1 x BN x 1 boxes; 128-byte swizzle.
struct Maps {
  CUtensorMap q, k, v;
};

struct Params {
  const int *seg;   // [B, S] int32 or null
  bf16 *out;        // [B, Sq, Hq, D] contiguous
  float *lse;       // [B, Hq, Sq] contiguous
  int b, sq, sk, hq, hkv, causal;
  int window;       // > 0: query i sees key j only when i - j < window
  float scale;
};

template <int D>
struct Cfg {
  static constexpr int BN = D <= 128 ? 128 : 64;   // keys per tile
  static constexpr int stages = D == 64 ? 3 : 2;
  // Q buffers: two (the next work item's Q loads under this one) up to
  // head_dim 128; one at 256, where two do not fit beside K and V.
  static constexpr int q_bufs = D <= 128 ? 2 : 1;
  static constexpr int panels = D / 64;
  static constexpr size_t q_tile = size_t(kBM) * D * 2;
  static constexpr size_t kv_tile = size_t(BN) * D * 2;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + q_bufs * q_tile;
  static constexpr size_t v = k + stages * kv_tile;
  // mbarriers: Q full and empty per Q buffer; K full, V full, K empty and
  // V empty per stage; mask classes full and empty per class buffer.
  static constexpr size_t bar = v + stages * kv_tile;
  static constexpr int bars = 2 * q_bufs + 4 * stages + 4;
  // Two mask-class buffers (with segment ids), each: the q tile's
  // segment ids; its distinct ids, each with its first and last row; the
  // number of distinct ids and each consumer's one id (or kNoSeg); per
  // key tile, visible to some row and its one id (or kNoSeg).
  static constexpr size_t cls = bar + 8 * bars;
  static constexpr size_t c_qseg = 0;
  static constexpr size_t c_dseg = c_qseg + 4 * kBM;
  static constexpr size_t c_dlo = c_dseg + 4 * kBM;
  static constexpr size_t c_dhi = c_dlo + 4 * kBM;
  static constexpr size_t c_misc = c_dhi + 4 * kBM;
  static constexpr size_t c_tiles = c_misc + 16;
  __host__ __device__ static size_t cls_bytes(int key_tiles) {
    return c_tiles + 8 * size_t(key_tiles);
  }
  static size_t bytes(int key_tiles, bool seg) {
    return 1024 + cls + (seg ? 2 * cls_bytes(key_tiles) : 0);
  }
};

// One work item: a (128-row q tile, query head, batch).
struct Item {
  int q0, h, b, hk;
  int t_begin, t_end;   // the key tiles its rows can reach
  const int *seg;       // its batch row's segment ids, or null
};

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const Params p, const __grid_constant__ Maps m) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  constexpr int kKSteps = D / 16;    // k-steps of S = Q K^T
  constexpr int kPSteps = BN / 16;   // k-steps of O += P V
  constexpr int kS = BN / 2;         // S registers a thread (64 x BN / 128)
  constexpr int kO = D / 2;          // O registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char *Qs = smem + C::q;
  unsigned char *Ks = smem + C::k;
  unsigned char *Vs = smem + C::v;
  uint64_t *qfull = reinterpret_cast<uint64_t *>(smem + C::bar);
  uint64_t *qempty = qfull + C::q_bufs;
  uint64_t *kfull = qempty + C::q_bufs;
  uint64_t *vfull = kfull + C::stages;
  uint64_t *kempty = vfull + C::stages;
  uint64_t *vempty = kempty + C::stages;
  uint64_t *cfull = vempty + C::stages;
  uint64_t *cempty = cfull + 2;
  const int sq = p.sq, sk = p.sk;
  const int nkt = (sk + BN - 1) / BN;
  // The class buffer of work item n (the block's n-th).
  auto cls_buf = [&](int n) -> unsigned char * {
    return smem + C::cls + (n & 1) * C::cls_bytes(nkt);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;          // 0: producer; 1, 2: consumers
  const bool causal = p.causal != 0;
  const bool seg = p.seg != nullptr;
  const int window = kWindow ? p.window : 0;
  // Work items, q tiles slowest: the heaviest causal ones (the last)
  // first, the heads of a kv group side by side. The grid is one block an
  // SM (or fewer), each walking its share of the items.
  const int nqt = (sq + kBM - 1) / kBM;
  const int heads = p.b * p.hq;
  const int items = nqt * heads;
  // The block's n-th work item: rounds of gridDim.x items, walked in
  // alternate directions (block b takes b, 2G - 1 - b, 2G + b, ...), so a
  // block that drew a heavy item early draws a light one next.
  auto item_index = [&](int n) -> int {
    const int g = gridDim.x, b = blockIdx.x;
    return n * g + ((n & 1) ? g - 1 - b : b);
  };
  auto item = [&](int w) -> Item {
    Item it;
    const int rank = w / heads;
    it.q0 = (causal ? nqt - 1 - rank : rank) * kBM;
    it.h = w % heads % p.hq;
    it.b = w % heads / p.hq;
    it.hk = it.h / (p.hq / p.hkv);
    // Causal rows see nothing past the tile's last row; windowed rows
    // nothing at or below q0 - window.
    const int k_end = causal ? min(sk, it.q0 + kBM) : sk;
    it.t_begin = kWindow ? max(0, it.q0 - window + 1) / BN : 0;
    it.t_end = (k_end + BN - 1) / BN;
    it.seg = seg ? p.seg + static_cast<long long>(it.b) * sk : nullptr;
    return it;
  };
  // The next key tile after t that the item visits (its t_end if none):
  // without segment ids every tile of [t_begin, t_end).
  auto next_tile = [](const Item &it, const int *vis, int t) -> int {
    for (++t; t < it.t_end && vis != nullptr && !vis[t]; ++t) {
    }
    return t;
  };

  if (tid == 0) {
    for (int i = 0; i < C::q_bufs; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 4 * kConsumers);   // one arrival a warp
    }
    for (int s = 0; s < C::stages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 4 * kConsumers);
      mbar_init(&vempty[s], 4 * kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&cfull[i], 1);
      // The consumers' warps and the producer thread.
      mbar_init(&cempty[i], 4 * kConsumers + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      // Producer: one thread keeps the ring full, running ahead into the
      // next work item while the consumers finish this one. The ring
      // counter i runs across items, as the consumers' does.
      int i = 0;
      for (int n = 0, w = item_index(0); w < items; w = item_index(++n)) {
        const Item it = item(w);
        const int *vis = nullptr;
        if (seg) {
          mbar_wait(&cfull[n & 1], (n >> 1) & 1);
          vis = reinterpret_cast<const int *>(cls_buf(n) + C::c_tiles);
        }
        // Q after the first tile's K (its buffer may wait on the
        // consumers' last products of an earlier item).
        const int qb = n % C::q_bufs;
        auto load_q = [&]() {
          if (n >= C::q_bufs)
            mbar_wait(&qempty[qb], ((n / C::q_bufs) & 1) ^ 1);
          mbar_expect_tx(&qfull[qb], static_cast<int>(C::q_tile));
#pragma unroll
          for (int np = 0; np < C::panels; ++np)
            tma_load(Qs + qb * C::q_tile + np * kBM * 128, &m.q, &qfull[qb],
                     np * 64, it.h, it.q0, it.b);
        };
        int t = next_tile(it, vis, it.t_begin - 1);
        if (t >= it.t_end) load_q();
        for (bool first = true; t < it.t_end;
             t = next_tile(it, vis, t), ++i, first = false) {
          const int s = i % C::stages;
          const uint32_t ph = (i / C::stages) & 1;
          // Stage s last held tile i - stages: wait until both consumers
          // are done with its K (then V).
          if (i >= C::stages) mbar_wait(&kempty[s], ph ^ 1);
          mbar_expect_tx(&kfull[s], static_cast<int>(C::kv_tile));
#pragma unroll
          for (int np = 0; np < C::panels; ++np)
            tma_load(Ks + s * C::kv_tile + np * BN * 128, &m.k, &kfull[s],
                     np * 64, it.hk, t * BN, it.b);
          if (first) load_q();
          if (i >= C::stages) mbar_wait(&vempty[s], ph ^ 1);
          mbar_expect_tx(&vfull[s], static_cast<int>(C::kv_tile));
#pragma unroll
          for (int np = 0; np < C::panels; ++np)
            tma_load(Vs + s * C::kv_tile + np * BN * 128, &m.v, &vfull[s],
                     np * 64, it.hk, t * BN, it.b);
        }
        if (seg) mbar_arrive(&cempty[n & 1]);
      }
    } else if (seg && tid >= 32) {
      // Mask classes with segment ids, by the producer's other three
      // warps, an item ahead of the consumers: the q tile's distinct
      // ids, each with its first and last row below Sq (ids that are not
      // contiguous stand for the rows between too: a tile is then masked
      // per element, never skipped wrongly); a key tile is visible when
      // one of its keys has an id of the tile whose rows reach it (at or
      // after it when causal, within the window); its one id when all its
      // keys share it.
      constexpr int kN = 96;
      const int ct = tid - 32;
      const int cwarp = ct / 32, lane = ct % 32;
      for (int n = 0, w = item_index(0); w < items; w = item_index(++n)) {
        const Item it = item(w);
        unsigned char *cb = cls_buf(n);
        int *qsegs = reinterpret_cast<int *>(cb + C::c_qseg);
        int *dseg = reinterpret_cast<int *>(cb + C::c_dseg);
        int *dlo = reinterpret_cast<int *>(cb + C::c_dlo);
        int *dhi = reinterpret_cast<int *>(cb + C::c_dhi);
        int *misc = reinterpret_cast<int *>(cb + C::c_misc);
        int *vis = reinterpret_cast<int *>(cb + C::c_tiles);
        int *kuni = vis + nkt;
        if (n >= 2) mbar_wait(&cempty[n & 1], ((n >> 1) & 1) ^ 1);
        for (int r = ct; r < kBM; r += kN)
          qsegs[r] = it.q0 + r < sq ? it.seg[it.q0 + r] : kNoSeg;
        if (ct == 0) misc[0] = 0;
        named_sync(3, kN);
        for (int r = ct; r < kBM && it.q0 + r < sq; r += kN) {
          const int id = qsegs[r];
          bool first = true;
          for (int c = 0; c < r && first; ++c) first = qsegs[c] != id;
          if (first) {
            int last = r;
            for (int c = r + 1; c < kBM; ++c)
              last = qsegs[c] == id ? c : last;
            const int d = atomicAdd(&misc[0], 1);
            dseg[d] = id;
            dlo[d] = it.q0 + r;
            dhi[d] = it.q0 + last;
          }
        }
        if (ct < kConsumers) {
          // Consumer ct's one id: all of its rows below Sq carry it.
          const int r0 = 64 * ct;
          int id = it.q0 + r0 < sq ? qsegs[r0] : kNoSeg;
          for (int r = r0 + 1; r < r0 + 64 && it.q0 + r < sq; ++r)
            id = qsegs[r] == id ? id : kNoSeg;
          misc[1 + ct] = id;
        }
        named_sync(3, kN);
        const int nd = misc[0];
        for (int t = it.t_begin + cwarp; t < it.t_end; t += kN / 32) {
          const int k0 = t * BN;
          const int id0 = it.seg[k0];
          bool any = false, same = k0 + BN <= sk;
          for (int c = lane; c < BN && k0 + c < sk; c += 32) {
            const int kj = k0 + c;
            const int ks = it.seg[kj];
            same &= ks == id0;
            for (int d = 0; d < nd; ++d) {
              if (dseg[d] != ks) continue;
              const int lo = causal ? max(dlo[d], kj) : dlo[d];
              const int hi = kWindow ? min(dhi[d], kj + window - 1) : dhi[d];
              any |= lo <= hi;
            }
          }
          any = __any_sync(0xffffffffu, any);
          same = __all_sync(0xffffffffu, same);
          if (lane == 0) {
            vis[t] = any;
            kuni[t] = same ? id0 : kNoSeg;
          }
        }
        named_sync(3, kN);
        if (ct == 0) mbar_arrive(&cfull[n & 1]);
      }
    }
    return;
  }

  // Consumer c: rows q0 + 64 c .. + 63 of each item; this thread's rows
  // r0 and r0 + 8 of them (the wgmma accumulator layout: register 4 n + e
  // holds column 8 n + 2 t4 + (e & 1) of row r0 + 8 (e >> 1)).
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int ctid = tid % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16 + g4;
  const float sl2 = p.scale * kLog2e;
  const uint64_t k_desc = smem_desc(Ks);
  const uint64_t v_desc = smem_desc(Vs);
  // Release a barrier: one arrival a warp, once the warp's products that
  // read its buffer have landed.
  auto release = [&](uint64_t *bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ping-pong: consumer c issues its products after the other one has
  // (named barrier 1 + c); consumer 0 goes first in each item. Both walk
  // the same tiles, so every arrival is matched: consumer 1 skips its
  // last one.
  const int my_turn = 1 + c, their_turn = 2 - c;

  int i = 0;   // the ring counter, as the producer's
  for (int n = 0, w = item_index(0); w < items; w = item_index(++n)) {
    const Item it = item(w);
    const int qlo = it.q0 + 64 * c;
    const int qi0 = qlo + r0, qi1 = qi0 + 8;
    // Row qi sees keys lo .. hi (and, with segment ids, its own
    // segment's only): causal up to itself, a window from
    // qi - window + 1.
    const int lo0 = kWindow ? qi0 - window + 1 : 0;
    const int lo1 = kWindow ? qi1 - window + 1 : 0;
    const int hi0 = causal ? min(qi0, sk - 1) : sk - 1;
    const int hi1 = causal ? min(qi1, sk - 1) : sk - 1;
    const int *vis = nullptr, *kuni = nullptr;
    int qs0 = 0, qs1 = 0, quni = 0;
    if (seg) {
      mbar_wait(&cfull[n & 1], (n >> 1) & 1);
      const unsigned char *cb = cls_buf(n);
      const int *qsegs = reinterpret_cast<const int *>(cb + C::c_qseg);
      qs0 = qsegs[64 * c + r0];
      qs1 = qsegs[64 * c + r0 + 8];
      quni = reinterpret_cast<const int *>(cb + C::c_misc)[1 + c];
      vis = reinterpret_cast<const int *>(cb + C::c_tiles);
      kuni = vis + nkt;
    }
    const int qb = n % C::q_bufs;
    const uint32_t qph = (n / C::q_bufs) & 1;
    const uint64_t q_desc = smem_desc(Qs + qb * C::q_tile + 64 * c * 128);

    float o[kO];
#pragma unroll
    for (int j = 0; j < kO; ++j) o[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    uint32_t pa[kPSteps][4];

    // S [64, BN] = Q [64, D] . K [BN, D]^T of the tile in stage st.
    auto scores = [&](float (&sacc)[kS], int st) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const size_t qoff = (ks / 4) * kBM * 128 + (ks % 4) * 32;
        const size_t koff =
            st * C::kv_tile + (ks / 4) * BN * 128 + (ks % 4) * 32;
        if constexpr (BN == 128)
          wgmma_ss_n128<0, 0>(sacc, q_desc + (qoff >> 4),
                              k_desc + (koff >> 4), ks > 0);
        else
          wgmma_ss_n64<0, 0>(sacc, q_desc + (qoff >> 4),
                             k_desc + (koff >> 4), ks > 0);
      }
    };
    // O [64, D] += P [64, BN] . V [BN, D] of the tile in stage st.
    auto pv = [&](int st) {
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int np = 0; np < C::panels; ++np)
          wgmma_rs_n64<1>(
              panel(o, np), pa[j],
              v_desc + ((st * C::kv_tile + np * BN * 128 + j * 2048) >> 4));
    };
    // Mask key tile t's scores (when it is not wholly visible to this
    // warpgroup), then the online softmax of rows qi0 and qi1 in units of
    // scale * log2 e: p into sacc, the running max and sum updated;
    // returns the rows' rescale factors for O.
    auto softmax = [&](float (&sacc)[kS], int t) -> float2 {
      const int k0 = t * BN;
      const bool full =
          k0 + BN <= sk && (!causal || k0 + BN - 1 <= qlo) &&
          (!kWindow || qlo + 63 - k0 < window) &&
          (!seg || (quni != kNoSeg && kuni[t] == quni));
      if (!full) {
#pragma unroll
        for (int n8 = 0; n8 < BN / 8; ++n8) {
          const int kj = k0 + 8 * n8 + 2 * t4;
          int ks0 = 0, ks1 = 0;
          if (seg) {
            ks0 = kj < sk ? it.seg[kj] : kNoSeg;
            ks1 = kj + 1 < sk ? it.seg[kj + 1] : kNoSeg;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = kj + (e & 1);
            const bool ok = kk >= (e < 2 ? lo0 : lo1) &&
                            kk <= (e < 2 ? hi0 : hi1) &&
                            (!seg || (e < 2 ? qs0 : qs1) ==
                                         ((e & 1) ? ks1 : ks0));
            sacc[4 * n8 + e] = ok ? sacc[4 * n8 + e] : kNegInf;
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * n8], sacc[4 * n8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * n8 + 2], sacc[4 * n8 + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // A row that has seen no key yet (running max -1e30) scales by 0,
      // so its masked scores give exact zeros rather than exp(0).
      const float ms0 = mn0 == kNegInf ? 0.f : mn0 * sl2;
      const float ms1 = mn1 == kNegInf ? 0.f : mn1 * sl2;
      const float a0 = ex2(fmaf(m0, sl2, -ms0));
      const float a1 = ex2(fmaf(m1, sl2, -ms1));
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
        sacc[4 * n8] = ex2(fmaf(sacc[4 * n8], sl2, -ms0));
        sacc[4 * n8 + 1] = ex2(fmaf(sacc[4 * n8 + 1], sl2, -ms0));
        sacc[4 * n8 + 2] = ex2(fmaf(sacc[4 * n8 + 2], sl2, -ms1));
        sacc[4 * n8 + 3] = ex2(fmaf(sacc[4 * n8 + 3], sl2, -ms1));
        sum0 += sacc[4 * n8] + sacc[4 * n8 + 1];
        sum1 += sacc[4 * n8 + 2] + sacc[4 * n8 + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
      return make_float2(a0, a1);
    };
    // P (bf16) as the A operand of the next P V: k-step j takes S
    // columns 16 j .. 16 j + 15.
    auto pack_p = [&](const float (&sacc)[kS]) {
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[j][e] = pack_bf16(sacc[8 * j + 2 * e], sacc[8 * j + 2 * e + 1]);
    };

    int t = next_tile(it, vis, it.t_begin - 1);
    if (t < it.t_end) {
      if (c == 1) named_arrive(1, 2 * 128);
      // The first tile: S alone (O is still 0).
      int nt = next_tile(it, vis, t);
      int prev = i % C::stages;
      uint32_t prev_ph = (i / C::stages) & 1;
      {
        float sacc[kS];
        mbar_wait(&kfull[prev], prev_ph);
        mbar_wait(&qfull[qb], qph);
        named_sync(my_turn, 2 * 128);
        wgmma_fence();
        scores(sacc, prev);
        wgmma_commit();
        if (c == 0 || nt < it.t_end) named_arrive(their_turn, 2 * 128);
        wgmma_wait<0>();
        fence_regs(sacc);
        release(&kempty[prev]);
        if (nt >= it.t_end) release(&qempty[qb]);
        softmax(sacc, t);
        pack_p(sacc);
      }
      ++i;
      // Then each tile's S with the previous tile's P V in flight: the
      // softmax of tile t runs while P V of the tile before lands.
      for (; (t = nt) < it.t_end; ++i) {
        nt = next_tile(it, vis, t);
        const int s = i % C::stages;
        const uint32_t ph = (i / C::stages) & 1;
        float sacc[kS];
        mbar_wait(&kfull[s], ph);
        named_sync(my_turn, 2 * 128);
        // O's rescale and P's packing land before the fence.
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
        scores(sacc, s);
        wgmma_commit();
        mbar_wait(&vfull[prev], prev_ph);
        // The wait's spin loop may leave the warps apart: fence again.
        wgmma_fence();
        pv(prev);
        wgmma_commit();
        if (c == 0 || nt < it.t_end) named_arrive(their_turn, 2 * 128);
        wgmma_wait<1>();
        fence_regs(sacc);
        release(&kempty[s]);
        if (nt >= it.t_end) release(&qempty[qb]);
        const float2 a = softmax(sacc, t);
        wgmma_wait<0>();
        fence_regs(o);
        release(&vempty[prev]);
#pragma unroll
        for (int j = 0; j < kO / 4; ++j) {
          o[4 * j] *= a.x;
          o[4 * j + 1] *= a.x;
          o[4 * j + 2] *= a.y;
          o[4 * j + 3] *= a.y;
        }
        pack_p(sacc);
        prev = s;
        prev_ph = ph;
      }
      // The last tile's P V.
      mbar_wait(&vfull[prev], prev_ph);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      pv(prev);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(&vempty[prev]);
    } else {
      // No key to see: the Q buffer's turn passes unread.
      mbar_wait(&qfull[qb], qph);
      release(&qempty[qb]);
    }
    if (seg) release(&cempty[n & 1]);

    // out [B, Sq, Hq, D] contiguous; lse [B, Hq, Sq].
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    bf16 *orow0 =
        p.out + ((static_cast<long long>(it.b) * sq + qi0) * p.hq + it.h) * D;
    bf16 *orow1 = orow0 + 8ll * p.hq * D;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * t4;
      if (qi0 < sq)
        *reinterpret_cast<__nv_bfloat162 *>(orow0 + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (qi1 < sq)
        *reinterpret_cast<__nv_bfloat162 *>(orow1 + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (t4 == 0) {
      float *lrow =
          p.lse + (static_cast<long long>(it.b) * p.hq + it.h) * sq;
      if (qi0 < sq) lrow[qi0] = l0 > 0.f ? m0 * p.scale + logf(l0) : 0.f;
      if (qi1 < sq) lrow[qi1] = l1 > 0.f ? m1 * p.scale + logf(l1) : 0.f;
    }
  }
}

template <int D, bool kWindow>
int launch(const void *q, const void *k, const void *v, const Params &p,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, cudaStream_t stream) {
  using C = Cfg<D>;
  Maps maps;
  if (!encode(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, D, p.hq,
              p.sq, p.b, q_sh, q_ss, q_sb, 64, kBM) ||
      !encode(&maps.k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, D, p.hkv,
              p.sk, p.b, k_sh, k_ss, k_sb, 64, C::BN) ||
      !encode(&maps.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, D, p.hkv,
              p.sk, p.b, v_sh, v_ss, v_sb, 64, C::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      C::bytes((p.sk + C::BN - 1) / C::BN, p.seg != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block an SM, each walking work items; fewer when there are fewer
  // items.
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long items =
      static_cast<long long>((p.sq + kBM - 1) / kBM) * p.hq * p.b;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_kernel<D, kWindow><<<grid, kThreads, bytes, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void *q, const void *k, const void *v, const Params &p,
             long long q_sb, long long q_ss, long long q_sh, long long k_sb,
             long long k_ss, long long k_sh, long long v_sb, long long v_ss,
             long long v_sh, cudaStream_t stream) {
  return p.window > 0
             ? launch<D, true>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss,
                               k_sh, v_sb, v_ss, v_sh, stream)
             : launch<D, false>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh, stream);
}

}  // namespace

SKYT_DEFINE_ERROR_STRING

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 with unit last stride and
// 16-byte aligned bases and strides (strides in elements); seg [B, S]
// int32 or null (Sq == Sk); out [B, Sq, Hq, D] bf16 contiguous; lse
// [B, Hq, Sq] f32 contiguous. window > 0: query i sees key j only when
// i - j < window (0: no window).
extern "C" int skyt_flash_fwd(const void *q, const void *k, const void *v,
                              const void *seg, void *out, void *lse,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              int b, int sq, int sk, int hq, int hkv, int d,
                              int causal, int window, float scale,
                              void *stream) {
  if (hkv <= 0 || hq % hkv != 0 || window < 0 || b <= 0 || sq <= 0 ||
      sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const int *>(seg), static_cast<bf16 *>(out),
                 static_cast<float *>(lse), b, sq, sk, hq, hkv, causal,
                 window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_d<64>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                        v_sb, v_ss, v_sh, st);
  if (d == 128)
    return launch_d<128>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, st);
  if (d == 256)
    return launch_d<256>(q, k, v, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
