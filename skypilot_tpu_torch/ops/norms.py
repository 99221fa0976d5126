"""Normalization ops (counterpart of skypilot_tpu/ops/norms.py).

RMSNorm in float32 whatever the input dtype, cast back on return. A
plain elementwise op: no kernel of its own.
"""
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             zero_centered: bool = False) -> torch.Tensor:
    """y = x / rms(x) * w   (w applied as (1+w) when zero_centered, the
    Gemma convention)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if zero_centered:
        w = 1.0 + w
    return (y * w).to(x.dtype)
