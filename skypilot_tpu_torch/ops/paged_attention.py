"""Paged decode attention: the CUDA kernel of csrc/paged_decode.cu and
its plain versions (counterpart of skypilot_tpu/ops/paged_attention.py).

Four wrappers, replacing the four TPU kernels of that module:

  * paged_decode_attention       -> :50  _kernel       (one query, bf16)
  * paged_decode_attention_mq    -> :98  _kernel_mq    (T queries, bf16)
  * paged_decode_attention_q     -> :150 _kernel_q     (one query, int8)
  * paged_decode_attention_mq_q  -> :210 _kernel_mq_q  (T queries, int8)

Each slot attends its pages of one layer's KV pool through the block
table. The multi-query variants serve the speculative verify step: T
consecutive tokens per slot, token t at position lengths[s] + t, masked
causally per token (all T tokens' KV already appended). The int8
variants read int8 pages plus f32 per-token, per-head scales
[n_pages, Hkv, P]: the key scale multiplies the score, and the value
scale multiplies the softmax weight p before PV (p * v_scale is rounded
to the query dtype there, as the TPU kernel's).

What bounds them on an H100: memory bandwidth. A call reads every
visible K and V row once: 2*Hkv*d*2 B*sum_s(lengths[s]+T) bytes for bf16
pools, (2*Hkv*d*1 B + 2*Hkv*4 B)*sum_s(lengths[s]+T) for int8, against
3.35 TB/s, at ~2*T*G flops per byte (16 at T*G = 16) — far below the
tensor-core ridge. One kernel (csrc/paged_decode.cu paged_decode_verify)
serves every T, the single-query decode step (T = 1) as the verify step:
one block per (slot, kv head, split) holds all R = T*G query rows of the
kv group on the tensor cores (mma.sync, R padded to 16-row tiles), its
pages (every n_split-th of the slot's row) arriving by TMA into a ring of
stages ahead of use. The splits' softmax partials are merged inside the
same launch: the last blocks of a (slot, kv head, row group) to start,
by a ticket counter, wait for its other blocks and merge the partials in
split order, so two calls on the same inputs give bit-equal outputs.
verify_plan picks the splits, warps, tiles, stages, mergers and shared
memory from the shapes and the card's SM count.

Head dims 64, 128 and 256 are built; every page size is taken (a TMA box
is at most VERIFY_TILE_ROWS rows; a page that its tiles do not divide
ends in a smaller box of its last rows rounded up to 16, and the box's
rows past the page are masked).

Skip rule, the TPU kernels': page j is walked iff
j*P <= lengths[s] + T-1 and (tables[s, j] != 0 or j == 0). A released
slot (all-zero table row, stale length) reads only dummy page 0.

On a CUDA tensor each wrapper launches the kernel or raises; the plain
versions (*_reference) run only for CPU tensors. The kernel's merge
counters (three int32 per (slot, kv head, row group), zeroed once per
device and left at 0 by every call) assume the calls on a device are
issued on one stream, as the engine issues them.
"""
import collections
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention as attention_ops

# Kernel launches since the last reset, per kernel (chip_smoke.py reads
# them to show the serving path went through each kernel).
KERNELS = ('paged_decode', 'paged_decode_mq', 'paged_decode_q',
           'paged_decode_mq_q')
launches = dict.fromkeys(KERNELS, 0)
# The same launches by (kernel, query rows a kv head: T*G).
launches_by_rows: Dict[Tuple[str, int], int] = collections.Counter()

# Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 128, 256)

# The kernel's plan (every T). Page rows a ring stage (one TMA box)
# holds: a page of up to 64 rows is one tile (its rows rounded up to 16),
# a longer page several. A block of one m-tile over bf16 pages at
# head_dim 256 takes 32-row tiles: a 64-row ring (2 x 64 KB) would leave
# it alone on its SM, where a block of two or more m-tiles (8 warps) is
# alone by its registers anyway.
VERIFY_TILE_ROWS = 64
VERIFY_TILE_ROWS_D256 = 32
# Warps a block at most; 16-row m-tiles a block at most (more rows take
# several row groups, each reading the pages again).
VERIFY_MAX_WARPS = 8
VERIFY_MAX_M_TILES = 8
# Ring stages: the next tile lands while the current one is used.
VERIFY_STAGES = 2
# Pages a block aims to walk: enough to spread its fixed cost (the first
# loads' latency, the merge of its warps, its partial) over several
# pages, few enough to split a long slot over many SMs.
VERIFY_PAGES_PER_BLOCK = 4
SMEM_LIMIT = 227 * 1024
# int32 merge counters allocated at once per device (grown if a call
# needs more): three per (slot, kv head, row group).
TICKETS = 1 << 16


class VerifyPlan(NamedTuple):
    """How the kernel runs one call, at any T (csrc/paged_decode.cu
    skyt_paged_verify takes these fields)."""
    rows: int             # R = T*G query rows a kv head
    m_tiles: int          # 16-row m-tiles a block holds
    n_mgroups: int        # row groups (blocks) a (slot, kv head, split)
    key_splits: int       # warps an m-tile, each a share of a tile's keys
    tile_rows: int        # page rows a ring stage holds
    tail_rows: int        # box rows of a page's last tile (= tile_rows
                          # unless tile_rows does not divide the page)
    stages: int           # ring stages
    n_split: int          # blocks a (slot, kv head, row group): block i
    pages_per_block: int  # walks pages i, i + n_split, ... (at most this)
    mergers: int          # blocks a group that share the merge
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    part_acc_shape: Tuple[int, ...]   # f32 scratch of the partials
    part_ml_shape: Tuple[int, ...]


def verify_smem_bytes(d: int, quant: bool, tile_rows: int, stages: int,
                      m_tiles: int, warps: int) -> int:
    """A block's dynamic shared memory (csrc/paged_decode.cu
    smem_bytes): 1024 bytes to align the ring; the ring (a stage: K and
    V tiles and, int8, their f32 scales, rounded up to 1024 bytes, the
    128-byte swizzle's period) and the staged queries [m_tiles*16, d+8]
    bf16, or, after the walk, the warps' O slices [warps, 16, d+8 (int8:
    d+4)] f32 in the same bytes, whichever is larger; the warps' (m, l);
    an mbarrier a stage; 16 bytes for the block's ticket."""
    stage = 2 * tile_rows * d * (1 if quant else 2) + \
        (2 * tile_rows * 4 if quant else 0)
    walk = stages * (-(-stage // 1024) * 1024) + \
        m_tiles * 16 * (d + 8) * 2
    slices = warps * 16 * (d + (4 if quant else 8)) * 4
    return 1024 + max(walk, slices) + 2 * warps * 16 * 4 + 8 * stages + 16


@functools.lru_cache(maxsize=1024)
def verify_plan(slots: int, t: int, hq: int, hkv: int, d: int,
                page_size: int, mp: int, quant: bool,
                sms: int) -> VerifyPlan:
    """The kernel's launch for q [slots, t, hq, d] (t = 1: a decode
    step) over pages of page_size rows, tables [slots, mp], on a card
    with `sms` SMs (cached: a layer call looks it up).

    All R = t*hq/hkv rows of a kv head share a block (up to
    VERIFY_MAX_M_TILES 16-row tiles). An m-tile takes up to 4 warps, one
    16-key chunk of a tile each, while the block stays within
    VERIFY_MAX_WARPS. Block i of a (slot, kv head) walks pages i,
    i + n_split, ...: n_split gives a full table row about
    VERIFY_PAGES_PER_BLOCK pages a block, and more while the grid would
    leave an SM without a block (at most mp). The lengths are on the
    card, so the plan cannot see them: a split past a slot's last page
    writes an empty partial at once. Any page size: a page of up to
    VERIFY_TILE_ROWS rows is one tile of its rows rounded up to 16, a
    longer one tiles of tile_rows and, where they do not divide it, a
    last box of tail_rows (its last rows rounded up to 16)."""
    if page_size <= 0:
        raise ValueError(f'page_size must be positive, got {page_size}')
    rows = t * (hq // hkv)
    tiles_all = -(-rows // 16)
    n_mgroups = -(-tiles_all // VERIFY_MAX_M_TILES)
    m_tiles = -(-tiles_all // n_mgroups)
    tile_rows = min(-(-page_size // 16) * 16, VERIFY_TILE_ROWS)
    if d == 256 and not quant and m_tiles == 1 and \
            page_size % VERIFY_TILE_ROWS_D256 == 0:
        tile_rows = VERIFY_TILE_ROWS_D256
    last_rows = page_size - (-(-page_size // tile_rows) - 1) * tile_rows
    tail_rows = -(-last_rows // 16) * 16
    key_splits = max(1, min(tile_rows // 16, VERIFY_MAX_WARPS // m_tiles))
    warps = m_tiles * key_splits
    stages = VERIFY_STAGES
    pairs = slots * hkv * n_mgroups
    n_split = min(mp, max(-(-mp // VERIFY_PAGES_PER_BLOCK),
                          -(-sms // pairs)))
    # On a grid of at most two blocks an SM, the merge is shared by the
    # group's last `mergers` blocks to start, a share of the rows each (on
    # a larger grid, blocks queue behind the mergers' waits). All but the
    # last may wait on a block not yet started: while mergers * groups
    # stays below the SM count, such a block always finds an SM.
    groups = pairs
    rows_last_group = rows - (n_mgroups - 1) * m_tiles * 16
    mergers = 1
    if groups * n_split <= 2 * sms:
        mergers = max(1, min(n_split, rows_last_group, (sms - 1) // groups))
    smem = verify_smem_bytes(d, quant, tile_rows, stages, m_tiles, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f'verify block needs {smem} bytes of shared '
                         f'memory, the card gives {SMEM_LIMIT}')
    return VerifyPlan(
        rows=rows, m_tiles=m_tiles, n_mgroups=n_mgroups,
        key_splits=key_splits, tile_rows=tile_rows, tail_rows=tail_rows,
        stages=stages,
        n_split=n_split, pages_per_block=-(-mp // n_split),
        mergers=mergers,
        threads=32 * warps, smem_bytes=smem,
        grid=(slots, hkv * n_mgroups, n_split),
        part_acc_shape=(slots, hkv, n_split, rows, d),
        part_ml_shape=(slots, hkv, n_split, rows, 2))


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    launches_by_rows.clear()


# ------------------------------------------------------- plain versions
def _attend_view(q, k_view, v_view, tables, lengths, page_size):
    """q [S, T, Hq, d] over the gathered views [S, mp*P, Hkv, d]: token t
    at position lengths[s] + t, the kernels' skip rule (unreserved
    entries past page 0 invisible) as key segment ids."""
    s_slots, t = q.shape[:2]
    mp = tables.shape[1]
    first = torch.arange(mp, device=tables.device) == 0
    reserved = ((tables != 0) | first).to(torch.int32)        # [S, mp]
    kv_seg = reserved.repeat_interleave(page_size, dim=1)     # [S, mp*P]
    ones = torch.ones((s_slots, t), dtype=torch.int32, device=q.device)
    q_pos = lengths.long()[:, None] + torch.arange(t, device=q.device)
    return attention_ops.mha_reference(
        q, k_view, v_view, q_positions=q_pos, segment_ids=ones,
        kv_segment_ids=kv_seg)


def paged_decode_attention_mq_reference(q: torch.Tensor,
                                        k_pool: torch.Tensor,
                                        v_pool: torch.Tensor,
                                        tables: torch.Tensor,
                                        lengths: torch.Tensor
                                        ) -> torch.Tensor:
    """Plain version of the multi-query kernel: the gathered per-slot
    view (paged_cache gather_view_layer) attended by mha_reference at
    q_positions = lengths + arange(T)."""
    return _attend_view(q, PagePool.gather_view_layer(k_pool, tables),
                        PagePool.gather_view_layer(v_pool, tables),
                        tables, lengths, k_pool.shape[2])


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the single-query kernel: the gathered per-slot
    view attended by mha_reference at q_positions = lengths, with the
    skip rule as key segment ids."""
    s_slots, _, _ = q.shape
    page_size = k_pool.shape[2]
    k_view = PagePool.gather_view_layer(k_pool, tables)
    v_view = PagePool.gather_view_layer(v_pool, tables)
    mp = tables.shape[1]
    first = torch.arange(mp, device=tables.device) == 0
    reserved = ((tables != 0) | first).to(torch.int32)        # [S, mp]
    kv_seg = reserved.repeat_interleave(page_size, dim=1)     # [S, mp*P]
    ones = torch.ones((s_slots, 1), dtype=torch.int32, device=q.device)
    out = attention_ops.mha_reference(
        q[:, None], k_view, v_view, q_positions=lengths[:, None].long(),
        segment_ids=ones, kv_segment_ids=kv_seg)
    return out[:, 0]


def paged_decode_attention_mq_q_reference(q: torch.Tensor,
                                          k_pool: torch.Tensor,
                                          v_pool: torch.Tensor,
                                          k_scale: torch.Tensor,
                                          v_scale: torch.Tensor,
                                          tables: torch.Tensor,
                                          lengths: torch.Tensor
                                          ) -> torch.Tensor:
    """Plain version of the int8 multi-query kernel: the dequantizing
    gather (gather_view_layer_q, at q's dtype), then as the float one."""
    return _attend_view(
        q, PagePool.gather_view_layer_q(k_pool, k_scale, tables, q.dtype),
        PagePool.gather_view_layer_q(v_pool, v_scale, tables, q.dtype),
        tables, lengths, k_pool.shape[2])


def paged_decode_attention_q_reference(q: torch.Tensor,
                                       k_pool: torch.Tensor,
                                       v_pool: torch.Tensor,
                                       k_scale: torch.Tensor,
                                       v_scale: torch.Tensor,
                                       tables: torch.Tensor,
                                       lengths: torch.Tensor
                                       ) -> torch.Tensor:
    """Plain version of the int8 single-query kernel."""
    return paged_decode_attention_mq_q_reference(
        q[:, None], k_pool, v_pool, k_scale, v_scale, tables,
        lengths)[:, 0]


# ------------------------------------------------------------- kernels
def _paged_operands(name: str, q, k_pool, v_pool, k_scale, v_scale, tables,
                    lengths, sms: int = 132) -> VerifyPlan:
    """The kernel's checks on q [S, T, Hq, d] and its operands (int8
    pools when k_scale is given), on tensors of any device, before any
    launch. Returns the kernel's plan on a card with `sms` SMs (an H100
    SXM's 132 by default)."""
    s_slots, t, hq, d = q.shape
    n_pages, hkv, page_size, dp = k_pool.shape
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape or dp != d:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, pools '
                         f'{tuple(k_pool.shape)}/{tuple(v_pool.shape)}')
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    for what, x, dt in (('q', q, torch.bfloat16), ('k_pool', k_pool, kv_dtype),
                        ('v_pool', v_pool, kv_dtype)):
        if x.dtype != dt:
            raise TypeError(f'{name} takes {dt} {what}, got {x.dtype}')
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError(f'{what} must be contiguous on {q.device}')
    if quant:
        for what, x in (('k_scale', k_scale), ('v_scale', v_scale)):
            if x.dtype != torch.float32 or \
                    tuple(x.shape) != (n_pages, hkv, page_size) or \
                    not x.is_contiguous() or x.device != q.device:
                raise ValueError(
                    f'{what} must be a contiguous float32 '
                    f'{(n_pages, hkv, page_size)} on {q.device}')
    for what, x, shape in (('tables', tables, (s_slots, tables.shape[-1])),
                           ('lengths', lengths, (s_slots,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape or \
                not x.is_contiguous() or x.device != q.device:
            raise ValueError(f'{what} must be a contiguous int32 '
                             f'{shape} on {q.device}')
    if d not in HEAD_DIMS:
        raise ValueError(f'{name} builds head_dim {HEAD_DIMS}, got {d} '
                         '(other head dims wait in ROADMAP.md queue 2 A)')
    if hq % hkv:
        raise ValueError(f'{name} needs Hq % Hkv == 0 (Hq={hq}, Hkv={hkv})')
    # The queries' 16-byte loads, the TMA maps and bulk copies: 16-byte
    # aligned bases, row coordinates below 2^31.
    bases = [q, k_pool, v_pool] + ([k_scale, v_scale] if quant else [])
    if any(x.data_ptr() % 16 for x in bases):
        raise ValueError(f'{name} needs 16-byte aligned q, pools and '
                         'scales')
    if n_pages * hkv * page_size >= 2 ** 31:
        raise ValueError(f'{name}: pools of {n_pages * hkv * page_size} '
                         'rows pass the TMA coordinates (2^31)')
    return verify_plan(s_slots, t, hq, hkv, d, page_size, tables.shape[1],
                       quant, sms)


# Per device: the kernel's merge counters (int32, zeroed once; each call
# leaves its counters at 0).
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, TICKETS), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def _paged_cuda(name: str, q, k_pool, v_pool, k_scale, v_scale, tables,
                lengths):
    """Launch csrc/paged_decode.cu on q [S, T, Hq, d] (T = 1: a decode
    step); int8 pools when k_scale is given."""
    plan = _paged_operands(
        name, q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
        torch.cuda.get_device_properties(q.device).multi_processor_count
        if q.is_cuda else 132)
    s_slots, t, hq, d = q.shape
    n_pages, hkv, page_size, _ = k_pool.shape
    quant = k_scale is not None
    out = torch.empty_like(q)
    scratch = (None, None, None)
    if plan.n_split > 1:   # one split writes the output itself
        part_acc = torch.empty(plan.part_acc_shape, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(plan.part_ml_shape, dtype=torch.float32,
                              device=q.device)
        tickets = _ticket_buffer(q.device, 3 * plan.grid[0] * plan.grid[1])
        scratch = (part_acc.data_ptr(), part_ml.data_ptr(),
                   tickets.data_ptr())
    lib = _build.load('paged_decode')
    rc = lib.skyt_paged_verify(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), *scratch,
        s_slots, t, hq, hkv, d, page_size, n_pages, tables.shape[1],
        plan.n_split, plan.m_tiles, plan.n_mgroups, plan.key_splits,
        plan.tile_rows, plan.tail_rows, plan.stages, plan.mergers,
        int(quant), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    launches[name] += 1
    launches_by_rows[name, plan.rows] += 1
    return out


def _dispatch(name, reference, q, k_pool, v_pool, tables, lengths,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None, single=False):
    if q.is_cuda:
        out = _paged_cuda(name, q[:, None] if single else q, k_pool, v_pool,
                          k_scale, v_scale, tables, lengths)
        return out[:, 0] if single else out
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    scales = () if k_scale is None else (k_scale, v_scale)
    return reference(q, k_pool, v_pool, *scales, tables, lengths)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: [S, Hq, d] (one token per slot); k_pool/v_pool:
    [n_pages, Hkv, P, d] (one layer, page-major); tables: [S, mp] int32;
    lengths: [S] int32 — the position each slot's query sits at (it
    attends positions <= lengths[s], its own KV already written).
    Returns [S, Hq, d]."""
    return _dispatch('paged_decode', paged_decode_attention_reference, q,
                     k_pool, v_pool, tables, lengths, single=True)


def paged_decode_attention_mq(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Multi-query paged decode (speculative verify): q [S, T, Hq, d] —
    token t of slot s at position lengths[s] + t, all T tokens' KV
    already appended. Returns [S, T, Hq, d]."""
    return _dispatch('paged_decode_mq', paged_decode_attention_mq_reference,
                     q, k_pool, v_pool, tables, lengths)


def paged_decode_attention_q(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """int8-KV single-query paged decode: paged_decode_attention's
    contract over int8 pools plus their f32 scale pools
    [n_pages, Hkv, P] (one layer)."""
    return _dispatch('paged_decode_q', paged_decode_attention_q_reference,
                     q, k_pool, v_pool, tables, lengths, k_scale, v_scale,
                     single=True)


def paged_decode_attention_mq_q(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """int8-KV multi-query paged decode: paged_decode_attention_mq's
    contract plus the scale pools."""
    return _dispatch('paged_decode_mq_q',
                     paged_decode_attention_mq_q_reference, q, k_pool,
                     v_pool, tables, lengths, k_scale, v_scale)
