"""Flash attention, forward and backward: the CUDA kernels
csrc/flash_fwd.cu and csrc/flash_bwd.cu and their plain versions
(counterpart of skypilot_tpu/ops/flash_attention.py).

Replaces ops/flash_attention.py:108 _fwd_kernel (launched by
_flash_fwd_impl :345, public entries flash_attention :286 and
flash_attention_fwd_lse :271), and the backward's :168 _dq_kernel and
:216 _dkv_kernel (launched by _bwd_rule :420). flash_attention is
differentiable through the FlashAttention autograd Function, as the
JAX entry is through its custom_vjp; flash_attention_fwd_lse stays
forward-only, as there.

Masks are _block_mask's: causal on the packed index (q >= k), q_seg ==
k_seg when segment ids are given, and with window > 0 (Mistral's
sliding window) q - k < window, for causal and non-causal rows alike; 0
is no window. The kernels skip the key tiles wholly outside a tile's
window (_qk_block_overlaps), so a windowed row costs O(window), not
O(S).

What bounds it on an H100: tensor-core FLOPs at long packed rows — the
useful work is 4*Hq*d*sum_j n_j(n_j+1)/2 over the row's segments
against 989 TFLOP/s bf16; q, k, v and out cross memory once. The design
(csrc/flash_fwd.cu) therefore stops each q tile's k loop at the causal
diagonal and skips k tiles that share no segment with the tile, so a
packed row costs about its segments' own triangles; the products run on
the tensor cores (WMMA bf16, f32 accumulation).

The backward (csrc/flash_bwd.cu) is one kernel that makes one pass
over key tiles: a block (one warpgroup) per (64-key tile, kv head) walks
its query group and q tiles, recomputes p = exp(s - lse) once per tile
pair on wgmma, sums dk and dv in registers and adds its share of dq by
TMA reduce-adds into an f32 accumulator that the wrapper zeroes and
casts to bf16. Those adds land in no fixed order unless
torch.use_deterministic_algorithms(True) is on; then they go in
key-tile order and every call gives the same bits. It is bound by
tensor-core FLOPs (10*d per query head and visible pair). At head_dim
256 each key tile takes two blocks, one per 128-column block of dq, dk
and dv, each recomputing s and dp over all 256 columns.

Layout is the JAX package's: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], read
through their strides (no transpose copies); lse [B, Hq, Sq] f32.

On a CUDA tensor the wrappers launch the kernels or raise; the plain
versions (flash_attention_reference, flash_attention_bwd_reference) run
only for CPU tensors.
"""
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention as attention_ops

# Kernel launches since the last reset (chip_smoke.py reads them to show
# the serving and training paths went through the kernels): the forward
# and the backward.
launches = 0
launches_bwd = 0

# Head dims each kernel is instantiated for (csrc/flash_fwd.cu,
# csrc/flash_bwd.cu); the wrappers raise on any other.
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)


def reset_launches() -> None:
    global launches, launches_bwd
    launches = launches_bwd = 0


def _check_window(window) -> int:
    """The sliding window as the kernels take it: an int >= 0 (0: none).
    Raises on anything else, before any launch. (A window longer than
    the query rows masks nothing; the wrappers pass at most Sq + 1 to
    the kernels' 32-bit ints.)"""
    if isinstance(window, bool) or not isinstance(window, int):
        raise TypeError(f'window must be an int, got {window!r}')
    if window < 0:
        raise ValueError(f'window must be >= 0, got {window}')
    return window


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              segment_ids: Optional[torch.Tensor] = None,
                              window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, built on mha_reference: (out, lse).
    Rows with no visible key give out 0 and lse 0, as the kernel's
    l == 0 guard does."""
    out = attention_ops.mha_reference(q, k, v, causal=causal,
                                      segment_ids=segment_ids,
                                      window=window)
    logits, mask = attention_ops.masked_logits(q, k, causal, segment_ids,
                                               window=window)
    b, sq, hq, _ = q.shape
    lse = torch.logsumexp(logits, dim=-1)           # [B, Hkv, G, Sq]
    if mask is not None:
        seen = mask.expand(logits.shape).any(dim=-1)
        lse = torch.where(seen, lse, torch.zeros_like(lse))
        out = torch.where(
            seen.reshape(b, hq, sq).transpose(1, 2)[..., None], out,
            torch.zeros_like(out))
    return out, lse.reshape(b, hq, sq)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True,
                                  segment_ids: Optional[torch.Tensor] = None,
                                  window: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of the backward kernel: (dq, dk, dv) in the
    inputs' dtypes, computed in f32 from the forward's out and lse [B,
    Hq, Sq] and the output gradient do. p = exp(s - lse) on the entries
    _block_mask leaves visible and exactly 0 elsewhere (a row with no
    visible key has lse 0 and p 0); dk and dv are summed over each kv
    head's query group."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    s, mask = attention_ops.masked_logits(q, k, causal, segment_ids,
                                          window=window)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    dog = do.float().reshape(b, sq, hkv, g, d)
    delta = (dog * out.float().reshape(b, sq, hkv, g, d)).sum(-1)
    dp = torch.einsum('bqhgd,bkhd->bhgqk', dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum('bhgqk,bkhd->bqhgd', ds, k.float()).reshape(
        b, sq, hq, d)
    dk = torch.einsum('bhgqk,bqhgd->bkhd', ds,
                      q.float().reshape(b, sq, hkv, g, d))
    dv = torch.einsum('bhgqk,bqhgd->bkhd', p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f'{name} must be [B, S, H, D], got {tuple(x.shape)}')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'flash kernel takes bfloat16, {name} is {x.dtype}')
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or \
            x.data_ptr() % 16:
        raise ValueError(f'{name} needs a unit last stride and 16-byte '
                         f'aligned rows, got strides {x.stride()}')


def _flash_cuda(q, k, v, segment_ids, causal, window=0):
    global launches
    window = _check_window(window)
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    for name, x in (('q', q), ('k', k), ('v', v)):
        _check_operand(name, x)
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    if d not in FWD_HEAD_DIMS:
        raise ValueError(f'flash kernel builds head_dim {FWD_HEAD_DIMS}, '
                         f'got {d} (other multiples of 64 up to 512 wait '
                         'in ROADMAP.md queue 2 A)')
    if hq % hkv:
        raise ValueError(f'q heads ({hq}) must be a multiple of kv heads '
                         f'({hkv})')
    seg_ptr = None
    if segment_ids is not None:
        if sq != sk or tuple(segment_ids.shape) != (b, sq) or \
                segment_ids.dtype != torch.int32 or \
                not segment_ids.is_contiguous() or \
                segment_ids.device != q.device:
            raise ValueError('segment_ids must be a contiguous int32 [B, S] '
                             'on the same device, with Sq == Sk')
        seg_ptr = segment_ids.data_ptr()
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _build.load('flash_fwd')
    rc = lib.skyt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, out.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, sq, sk, hq, hkv, d, int(causal), min(window, sq + 1), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, 'flash_fwd')
    launches += 1
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta, segment_ids, causal,
                  window=0):
    """Check the backward kernel's operands (raise on anything it does
    not take); returns the C entry point's arguments that come before
    the output pointers and those after them but the stream, which the
    launch adds (so the checks run on tensors of any device)."""
    window = _check_window(window)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    for name, x in (('q', q), ('k', k), ('v', v), ('do', do)):
        _check_operand(name, x)
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
    if k.shape[1] != s or v.shape != k.shape or do.shape != q.shape or \
            k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'the backward kernel takes Sq == Sk: q '
                         f'{tuple(q.shape)}, k {tuple(k.shape)}, v '
                         f'{tuple(v.shape)}, do {tuple(do.shape)}')
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f'flash backward builds head_dim {BWD_HEAD_DIMS}, '
                         f'got {d} (other multiples of 64 up to 512 wait '
                         'in ROADMAP.md queue 2 A)')
    if hq % hkv:
        raise ValueError(f'q heads ({hq}) must be a multiple of kv heads '
                         f'({hkv})')
    for name, x in (('lse', lse), ('delta', delta)):
        if tuple(x.shape) != (b, hq, s) or x.dtype != torch.float32 or \
                not x.is_contiguous() or x.device != q.device:
            raise ValueError(f'{name} must be a contiguous f32 [B, Hq, S] '
                             f'on the same device, got {tuple(x.shape)} '
                             f'{x.dtype}')
    seg_ptr = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, s) or \
                segment_ids.dtype != torch.int32 or \
                not segment_ids.is_contiguous() or \
                segment_ids.device != q.device:
            raise ValueError('segment_ids must be a contiguous int32 [B, S] '
                             'on the same device')
        seg_ptr = segment_ids.data_ptr()
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), seg_ptr)
    rest = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], b, s, hq, hkv, d, int(causal),
            min(window, s + 1), d ** -0.5)
    return ins, rest


def flash_bwd_cuda(q, k, v, do, lse, delta, segment_ids=None,
                   causal=True, window=0) -> Tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """Kernels 8-9 as one (csrc/flash_bwd.cu flash_bwd_kernel): dq [B, S,
    Hq, D] and dk, dv [B, S, Hkv, D] (each summed over its kv head's
    query group) from the forward's lse and delta = rowsum(do * out),
    both [B, Hq, S] f32. The kernel adds dq into an f32 accumulator
    zeroed here, one add per key tile, and the sum is cast to q's dtype
    once. The adds land in no fixed order, so dq's last bits may differ
    from call to call, unless torch.use_deterministic_algorithms(True)
    is on: then they go in key-tile order, kept by a row of bits per
    (batch, kv head, 64-row q tile) zeroed with the accumulator, and
    every call gives the same bits (at ~1.35x the kernel's time).
    window > 0: the sliding window, as in the forward. Head dims 64, 128
    and 256 (as two 128-column blocks); other multiples of 64 up to 512
    raise (ROADMAP.md queue 2 A)."""
    global launches_bwd
    ins, rest = _bwd_operands(q, k, v, do, lse, delta, segment_ids, causal,
                              window)
    b, s, _, d = q.shape
    n = q.numel()
    tiles = -(-s // 64)
    ordered = torch.are_deterministic_algorithms_enabled()
    # One zeroed buffer: the accumulator, then (ordered) the bit rows, one
    # bit per 64-key tile in 32-bit words, a row per (batch, kv head,
    # 128-column block of D, q tile): the kernel's grid
    # (csrc/flash_bwd.cu Layout::col_blocks).
    col_blocks = -(-d // 128)
    bits = (b * k.shape[2] * col_blocks * tiles * -(-tiles // 32)
            if ordered else 0)
    buf = torch.zeros(n + bits, dtype=torch.float32, device=q.device)
    dq_acc = buf[:n].view(q.shape)
    done = buf[n:].data_ptr() if ordered else None
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    lib = _build.load('flash_bwd')
    _build.check(lib, lib.skyt_flash_bwd(
        *ins, dq_acc.data_ptr(), done, dk.data_ptr(), dv.data_ptr(), *rest,
        torch.cuda.current_stream(q.device).cuda_stream), 'flash_bwd')
    launches_bwd += 1
    return dq_acc.to(q.dtype), dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from the forward's out and lse and
    the output gradient do. delta = rowsum(do * out) is one elementwise
    pass in f32 (outside the kernel, as in the JAX backward); CUDA
    tensors then launch the backward kernel (bf16, head_dim 64, 128 or
    256, Sq == Sk; anything else raises), CPU tensors run the plain
    version."""
    window = _check_window(window)
    if q.is_cuda:
        do = do.contiguous()
        delta = do.float().mul_(out).sum(-1).transpose(1, 2).contiguous()
        return flash_bwd_cuda(q, k, v, do, lse, delta, segment_ids, causal,
                              window)
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                         causal=causal,
                                         segment_ids=segment_ids,
                                         window=window)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of the JAX
    custom_vjp): the forward saves (q, k, v, out, lse, segment_ids) and
    the window, the backward runs flash_attention_bwd on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, window=0):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                           segment_ids=segment_ids,
                                           window=window)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal = causal
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         segment_ids=segment_ids,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only flash attention with the per-row logsumexp:
    (out [B, Sq, Hq, D], lse [B, Hq, Sq] f32). CUDA tensors launch the
    kernel (bf16, head_dim 64, 128 or 256; anything else raises); CPU
    tensors run the plain version."""
    window = _check_window(window)
    if q.is_cuda:
        return _flash_cuda(q, k, v, segment_ids, causal, window)
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    return flash_attention_reference(q, k, v, causal=causal,
                                     segment_ids=segment_ids, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    window: int = 0) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D].
    segment_ids: optional [B, S] int32 packed-sequence ids (Sq == Sk).
    window > 0: query p sees key k only when p - k < window. Differentiable
    in q, k and v (FlashAttention) when autograd records; otherwise the
    forward alone."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, segment_ids, window)
    return flash_attention_fwd_lse(q, k, v, causal=causal,
                                   segment_ids=segment_ids,
                                   window=window)[0]
