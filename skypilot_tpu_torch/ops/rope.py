"""Rotary position embeddings (counterpart of skypilot_tpu/ops/rope.py),
including the Llama-3.1 frequency scaling. Computed in float32 and
applied with the split-half rotation (the HF/Llama convention).
"""
import math
from typing import Optional, Tuple

import torch


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 500000.0,
               use_llama31_scaling: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape positions.shape + (head_dim//2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    # Correctly rounded f32 frequencies (via float64), as XLA computes
    # them; a float32 pow is off by an ulp for some, which shows up as
    # ~6e-8 * position in the angles.
    freqs = (1.0 / (theta ** exponent.double())).float()
    if use_llama31_scaling:
        # Llama-3.1 NTK-by-parts scaling (factor 8, original context
        # 8192), as in Meta's llama3 reference implementation.
        factor, low_mult, high_mult, old_ctx = 8.0, 1.0, 4.0, 8192
        low = old_ctx / low_mult
        high = old_ctx / high_mult
        wavelen = 2.0 * math.pi / freqs
        smooth = ((old_ctx / wavelen - low_mult) /
                  (high_mult - low_mult)).clamp(0.0, 1.0)
        scaled = torch.where(wavelen > low, freqs / factor, freqs)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        in_mid = (wavelen <= low) & (wavelen >= high)
        freqs = torch.where(in_mid, mid, scaled)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim//2]."""
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def positions_from_segment_ids(segment_ids: Optional[torch.Tensor],
                               batch: int, seq: int,
                               device=None) -> torch.Tensor:
    """Positions 0..seq-1 per example; with segment ids, positions
    restart at 0 wherever the id changes from the previous token."""
    if segment_ids is None:
        return torch.arange(seq, device=device).expand(batch, seq)
    seg = segment_ids
    idx = torch.arange(seq, device=seg.device).expand(batch, seq)
    change = torch.ones_like(seg, dtype=torch.bool)
    change[:, 1:] = seg[:, 1:] != seg[:, :-1]
    # Index of the most recent segment start at or before each token.
    starts = torch.where(change, idx, torch.zeros_like(idx))
    starts = torch.cummax(starts, dim=1).values
    return idx - starts
