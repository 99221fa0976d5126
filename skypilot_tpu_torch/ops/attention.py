"""Attention ops (counterpart of skypilot_tpu/ops/attention.py): the plain
reference and the dispatch to the flash kernel.

mha_reference is the plain PyTorch version every attention kernel of the
port is held to. GQA is folded into the einsum (no K/V repeat). Logits
and softmax are float32.

A static sliding window (window > 0: Mistral, Phi-3) takes the flash
kernels under impl 'auto' and 'flash'. The JAX package sends it there
only under SKYT_WINDOW_FLASH=on (and to XLA otherwise); the port has no
environment switches, and the math is the same either way (the CPU
tests hold the windowed plain versions to both the Pallas kernels and
the XLA reference).
"""
from typing import Optional, Tuple

import torch

NEG_INF = -1e9  # logits are f32 until softmax, so -1e9 never overflows


def masked_logits(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  softmax_scale: Optional[float] = None, window: int = 0,
                  logit_softcap: float = 0.0
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked f32 logits [B, Hkv, G, Sq, Sk] and the boolean mask
    (broadcastable to the logits; None when nothing is masked)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f'q heads ({hq}) must be a multiple of kv heads '
                         f'({hkv})')
    groups = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, groups, d)
    logits = torch.einsum('bqhgd,bkhd->bhgqk', qg.float(), k.float())
    logits = logits * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)

    dev = q.device
    k_pos = torch.arange(sk, device=dev)[None, None, None, None, :]
    if q_positions is not None:
        q_pos = q_positions[:, None, None, :, None]
    else:
        q_pos = torch.arange(sq, device=dev)[None, None, None, :, None]
    mask = (q_pos >= k_pos) if (causal or q_positions is not None) \
        else None
    if window > 0:
        wmask = (q_pos - k_pos) < window
        mask = wmask if mask is None else (mask & wmask)
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None \
            else segment_ids
        seg_mask = (segment_ids[:, None, None, :, None] ==
                    kv_seg[:, None, None, None, :])
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=dev))
    return logits, mask


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  softmax_scale: Optional[float] = None,
                  window: int = 0,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; Hq % Hkv == 0.

    Returns [B, Sq, Hq, D] in v's dtype.

    q_positions: optional [B, Sq] query positions for the causal mask
    (keys sit at 0..Sk-1). window: query p also needs p - k_pos < window.
    logit_softcap: cap * tanh(logits / cap), after the scale, before the
    mask."""
    b, sq, hq, d = q.shape
    logits, _ = masked_logits(q, k, causal, segment_ids, kv_segment_ids,
                              q_positions, softmax_scale, window,
                              logit_softcap)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhgqk,bkhd->bqhgd', probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              window: int = 0,
              logit_softcap: float = 0.0,
              softmax_scale: Optional[float] = None,
              impl: str = 'auto') -> torch.Tensor:
    """Public entry: the flash kernels (ops/flash_attention.py,
    differentiable: the forward kernel, and the backward kernel in the
    backward), sliding window included — on a CUDA tensor they launch
    or raise, on a CPU tensor their plain versions run — unless impl is
    'xla' or the attention has a soft-cap or a scale override, which the
    kernels do not compute: those take the reference (differentiated by
    autograd), as the JAX package's soft-capped and rescaled models take
    XLA."""
    if impl not in ('auto', 'flash', 'xla'):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got "
                         f'{impl!r}')
    if impl != 'xla' and logit_softcap <= 0.0 and softmax_scale is None:
        from skypilot_tpu_torch.ops import flash_attention
        return flash_attention.flash_attention(
            q, k, v, causal=causal, segment_ids=segment_ids, window=window)
    return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids,
                         window=window, logit_softcap=logit_softcap,
                         softmax_scale=softmax_scale)
