"""Flash attention forward: the CUDA kernel csrc/flash_fwd.cu and its plain
version (counterpart of skypilot_tpu/ops/flash_attention.py).

Replaces ops/flash_attention.py:108 _fwd_kernel (launched by
_flash_fwd_impl :345, public entries flash_attention :286 and
flash_attention_fwd_lse :271).

What bounds it on an H100: tensor-core FLOPs at long packed rows — the
useful work is 4*Hq*d*sum_j n_j(n_j+1)/2 over the row's segments
against 989 TFLOP/s bf16; q, k, v and out cross memory once. The design
(csrc/flash_fwd.cu) therefore stops each q tile's k loop at the causal
diagonal and skips k tiles that share no segment with the tile, so a
packed row costs about its segments' own triangles; the products run on
the tensor cores (WMMA bf16, f32 accumulation).

Layout is the JAX package's: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], read
through their strides (no transpose copies); lse [B, Hq, Sq] f32.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version (flash_attention_reference) runs only for CPU tensors.
"""
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention as attention_ops

# Kernel launches since the last reset (chip_smoke.py reads it to show
# the serving path went through the kernel).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, built on mha_reference: (out, lse).
    Rows with no visible key give out 0 and lse 0, as the kernel's
    l == 0 guard does."""
    out = attention_ops.mha_reference(q, k, v, causal=causal,
                                      segment_ids=segment_ids)
    logits, mask = attention_ops.masked_logits(q, k, causal, segment_ids)
    b, sq, hq, _ = q.shape
    lse = torch.logsumexp(logits, dim=-1)           # [B, Hkv, G, Sq]
    if mask is not None:
        seen = mask.expand(logits.shape).any(dim=-1)
        lse = torch.where(seen, lse, torch.zeros_like(lse))
        out = torch.where(
            seen.reshape(b, hq, sq).transpose(1, 2)[..., None], out,
            torch.zeros_like(out))
    return out, lse.reshape(b, hq, sq)


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f'{name} must be [B, S, H, D], got {tuple(x.shape)}')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'flash kernel takes bfloat16, {name} is {x.dtype}')
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or \
            x.data_ptr() % 16:
        raise ValueError(f'{name} needs a unit last stride and 16-byte '
                         f'aligned rows, got strides {x.stride()}')


def _flash_cuda(q, k, v, segment_ids, causal):
    global launches
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    for name, x in (('q', q), ('k', k), ('v', v)):
        _check_operand(name, x)
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    if d not in (64, 128):
        raise ValueError(f'flash kernel supports head_dim 64 and 128, '
                         f'got {d}')
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
        b, sq, sk, hq, hkv, d, int(causal), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, 'flash_fwd')
    launches += 1
    return out, lse


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only flash attention with the per-row logsumexp:
    (out [B, Sq, Hq, D], lse [B, Hq, Sq] f32). CUDA tensors launch the
    kernel (bf16, head_dim 64 or 128; anything else raises); CPU tensors
    run the plain version."""
    if q.is_cuda:
        return _flash_cuda(q, k, v, segment_ids, causal)
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    return flash_attention_reference(q, k, v, causal=causal,
                                     segment_ids=segment_ids)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D].
    segment_ids: optional [B, S] int32 packed-sequence ids (Sq == Sk)."""
    return flash_attention_fwd_lse(q, k, v, causal=causal,
                                   segment_ids=segment_ids)[0]
