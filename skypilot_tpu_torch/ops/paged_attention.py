"""Paged decode attention: the CUDA kernel csrc/paged_decode.cu and its
plain version (counterpart of skypilot_tpu/ops/paged_attention.py).

Replaces ops/paged_attention.py:50 _kernel (launched by
paged_decode_attention :434): one query per slot attends the slot's
pages of one layer's KV pool through the block table.

What bounds it on an H100: memory bandwidth — a call reads every visible
K and V row once, 2*Hkv*d*2 B*sum_s(lengths[s]+1) bytes against
3.35 TB/s, at ~2 flops per byte. The design (csrc/paged_decode.cu)
splits each (slot, kv head) walk into runs of PAGES_PER_SPLIT pages, one
block each and one page per warp, so a few long slots still fill the
card with loads in flight; a warp reads each K/V row once for all
G = Hq/Hkv heads of its kv group, walks only the pages up to
lengths[s], and a second small pass merges the runs' softmax partials.

Skip rule, the same as kernel 2's: page j is skipped iff
j*P > lengths[s] or (tables[s, j] == 0 and j != 0). A released slot
(all-zero table row, stale length) reads only dummy page 0.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version (paged_decode_attention_reference) runs only for CPU tensors.
"""
import torch

from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention as attention_ops

# Kernel launches since the last reset (chip_smoke.py reads it to show
# the serving path went through the kernel).
launches = 0

_SMEM_LIMIT = 227 * 1024  # shared memory a block can use on Hopper
# Pages per block in the split pass, one per warp: 8 slots x 8 kv heads
# at 2048 tokens (32 pages of 64) make 512 blocks.
PAGES_PER_SPLIT = 4


def reset_launches() -> None:
    global launches
    launches = 0


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: the gathered per-slot view (paged_cache
    gather_view_layer) attended by mha_reference at q_positions =
    lengths, with the kernel's skip rule (unreserved entries past page 0
    are invisible) as key segment ids."""
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


def _paged_cuda(q, k_pool, v_pool, tables, lengths):
    global launches
    s_slots, hq, d = q.shape
    n_pages, hkv, page_size, dp = k_pool.shape
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or dp != d:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, pools '
                         f'{tuple(k_pool.shape)}/{tuple(v_pool.shape)}')
    for name, x in (('q', q), ('k_pool', k_pool), ('v_pool', v_pool)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f'paged kernel takes bfloat16, {name} is '
                            f'{x.dtype}')
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError(f'{name} must be contiguous on {q.device}')
    for name, x, shape in (('tables', tables, (s_slots, tables.shape[-1])),
                           ('lengths', lengths, (s_slots,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape or \
                not x.is_contiguous() or x.device != q.device:
            raise ValueError(f'{name} must be a contiguous int32 '
                             f'{shape} on {q.device}')
    if d not in (64, 128):
        raise ValueError(f'paged kernel supports head_dim 64 and 128, '
                         f'got {d}')
    if hq % hkv or hq // hkv > 16:
        raise ValueError(f'paged kernel needs Hq % Hkv == 0 and at most 16 '
                         f'query heads per kv head (Hq={hq}, Hkv={hkv})')
    g = hq // hkv
    if 4 * g * (2 * d + 4 * page_size + 8 + 3 * d) > _SMEM_LIMIT:
        raise ValueError(f'page_size {page_size} with {g} heads per kv '
                         'head exceeds the kernel\'s shared memory')
    mp = tables.shape[1]
    n_split = -(-mp // PAGES_PER_SPLIT)
    out = torch.empty_like(q)
    part_acc = torch.empty((s_slots, hkv, n_split, g, d),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((s_slots, hkv, n_split, g, 2),
                          dtype=torch.float32, device=q.device)
    lib = _build.load('paged_decode')
    rc = lib.skyt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), s_slots, hq, hkv, d,
        page_size, mp, PAGES_PER_SPLIT, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, 'paged_decode')
    launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: [S, Hq, d] (one token per slot); k_pool/v_pool:
    [n_pages, Hkv, P, d] (one layer, page-major); tables: [S, mp] int32;
    lengths: [S] int32 — the position each slot's query sits at (it
    attends positions <= lengths[s], its own KV already written).
    Returns [S, Hq, d]."""
    if q.is_cuda:
        return _paged_cuda(q, k_pool, v_pool, tables, lengths)
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                            lengths)
