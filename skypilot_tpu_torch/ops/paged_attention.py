"""Paged decode attention: the CUDA kernels of csrc/paged_decode.cu and
their plain versions (counterpart of skypilot_tpu/ops/paged_attention.py).

Four kernels, one design, replacing the four TPU kernels of that module:

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
tensor-core ridge. The design (csrc/paged_decode.cu) splits each (slot,
kv head) walk into runs of PAGES_PER_SPLIT pages, one block each and one
page per warp, so a few long slots still fill the card with loads in
flight; a warp reads each K/V row once for a group of the T*G query
rows of its kv group (up to 4, fewer where the grid would leave SMs
idle; more rows take more blocks, so any GQA group and T run), walks
only the pages some token can see, and a second small pass merges the
runs' softmax partials. Head dims 64, 128 and 256 are built.

Skip rule, the TPU kernels': page j is walked iff
j*P <= lengths[s] + T-1 and (tables[s, j] != 0 or j == 0). A released
slot (all-zero table row, stale length) reads only dummy page 0.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
versions (*_reference) run only for CPU tensors.
"""
import collections
from typing import Dict, Optional, Tuple

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

# Pages per block in the split pass, one per warp: 8 slots x 8 kv heads
# at 2048 tokens (32 pages of 64) make 512 blocks.
PAGES_PER_SPLIT = 4
# Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 128, 256)


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
def _paged_cuda(name: str, q, k_pool, v_pool, k_scale, v_scale, tables,
                lengths):
    """Launch csrc/paged_decode.cu on q [S, T, Hq, d]; int8 pools when
    k_scale is given."""
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
    rows = t * (hq // hkv)
    mp = tables.shape[1]
    n_split = -(-mp // PAGES_PER_SPLIT)
    out = torch.empty_like(q)
    part_acc = torch.empty((s_slots, hkv, n_split, rows, d),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((s_slots, hkv, n_split, rows, 2),
                          dtype=torch.float32, device=q.device)
    lib = _build.load('paged_decode')
    rc = lib.skyt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), s_slots, t, hq, hkv, d,
        page_size, mp, PAGES_PER_SPLIT, int(quant), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    launches[name] += 1
    launches_by_rows[name, rows] += 1
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
