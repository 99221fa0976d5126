"""Weight-only int8/int4 quantization for serving (the port's copy of
skypilot_tpu/models/quant.py, in torch).

Every projection weight (a 2-D floating `.weight` of the state_dict:
the seven per-layer projections and lm_head) becomes

  * int8: codes [out, in] int8 with a per-output-channel symmetric
    scale [out] f32 (w ~ codes * scale), or
  * int4: codes in [-7, 7] on groups of G = INT4_GROUP along `in`
    (one group spanning `in` when G does not divide it), packed two a
    byte (models/llama.py QuantLinear4 documents the nibble order), with
    scales [in / G, out] f32 — the reference's layout.

The port keeps HF's [out, in], so the reference's reduction axis -2
(`in` of its [in, out] kernels) is -1 here. The arithmetic is the
reference's, in f32 and in its order: amax over `in` (or a group),
scale = where(amax > 0, amax / 127, 1) (int4: / 7), round(w / scale)
(a division, rounding half to even), clip to +-127 (int4: +-7). IEEE
f32 division and round-half-even on the CPU and on the card, so the
codes and scales are byte-equal to the reference's wherever they are
made. The embedding and the norm weights stay float; lm_head is
quantized like any projection.

A MoE model's expert weights (models/moe.py: `<layer>.moe_mlp.w_gate`,
`w_up`, `w_down`, [E, out, in]) take int8 only, as the reference's
quantize_params MoE branch: codes [E, out, in] and a scale per (expert,
out-channel) under `<name>_scale`; the router stays float.
"""
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

# int4 group size along `in` (GPTQ/AWQ's standard grouping).
INT4_GROUP = 128
MODES = ('int8', 'int4')
# MoE expert weights (models/moe.py MoeMLP); int8 only (the reference's
# refusal, word for word).
MOE_EXPERT_KEYS = ('w_gate', 'w_up', 'w_down')
INT4_MOE = 'int4 is llama-family only; MoE expert weights support int8'


def int4_group_size(din: int, group: int = INT4_GROUP) -> int:
    """The group size used for an `in` dim: the standard group when it
    divides evenly, else one group spanning the whole axis (debug models
    with din < 128). The module (llama.QuantLinear4) and this quantizer
    share it."""
    return group if din >= group and din % group == 0 else din


def _amax_abs(wf: torch.Tensor) -> torch.Tensor:
    """max |w| over the last axis, without an |w| temporary the size of
    w (max |x| = max(max x, -min x), exactly)."""
    return torch.maximum(wf.amax(dim=-1), wf.amin(dim=-1).neg())


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """where(amax > 0, amax / qmax, 1). The divisor is a tensor: CUDA
    turns a division by a Python scalar into a product with its
    reciprocal, which is not the reference's (or the CPU's) IEEE
    division, and the card's codes then differ from the CPU's."""
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., out, in] float -> (codes int8 [..., out, in], scale f32
    [..., out]): per-output-channel symmetric, on w's device."""
    wf = w.to(torch.float32, copy=True)
    amax = _amax_abs(wf)
    scale = _scale(amax, 127.0)
    # In place on the f32 copy (one weight-sized temporary on the load
    # path), the reference's ops in its order.
    q = wf.div_(scale[..., None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_kernel_int4(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [out, in] float -> (codes int8 in [-7, 7] [out, in], unpacked;
    scale f32 [in / G, out]) with symmetric per-(group, out-channel)
    scales (the int4 -8 code is unused so the scheme stays symmetric)."""
    if w.dim() != 2:
        raise ValueError(f'int4 quantizes 2-D weights, got {list(w.shape)}')
    dout, din = w.shape
    g = int4_group_size(din)
    wf = w.to(torch.float32, copy=True).reshape(dout, din // g, g)
    amax = _amax_abs(wf)                             # [out, n_g]
    scale = _scale(amax, 7.0)
    q = wf.div_(scale[..., None]).round_().clamp_(-7, 7)
    return q.to(torch.int8).reshape(dout, din), scale.t().contiguous()


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes [out, in] (int8 in [-8, 7], `in` even) -> uint8
    [out, in / 2]: code 2j in the low nibble of byte j, code 2j + 1 in
    the high nibble, each as 4-bit two's complement."""
    if codes.shape[-1] % 2:
        raise ValueError(f'int4 packing needs an even `in`, got '
                         f'{codes.shape[-1]}')
    nib = codes.to(torch.int16) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_int4: uint8 [out, in / 2] -> int8 codes
    [out, in]."""
    # Each nibble moved to the top of an int8 and shifted back down:
    # the arithmetic shift sign-extends it.
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def quantize_weight(w: torch.Tensor, mode: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One projection weight [out, in] -> (the weight a QuantLinear
    (int8) or QuantLinear4 (packed uint8) stores, its f32 scale)."""
    if mode == 'int8':
        return quantize_kernel(w)
    if mode == 'int4':
        q, scale = quantize_kernel_int4(w)
        return pack_int4(q), scale
    raise ValueError(f'unknown quantize mode {mode!r}')


def is_projection(key: str, t: torch.Tensor) -> bool:
    """The state_dict entries quantize_params converts: a 2-D floating
    `.weight` (the projections and lm_head; norms are 1-D and the
    embedding is the bare `tok_embed`), as the reference converts every
    floating `kernel` of ndim >= 2."""
    return key.endswith('.weight') and t.dim() == 2 and \
        t.is_floating_point()


def is_expert_weight(key: str, t: torch.Tensor) -> bool:
    """A MoE expert weight of the state_dict: a floating [E, out, in]
    `<layer>.moe_mlp.w_gate` / `w_up` / `w_down`."""
    return key.rsplit('.', 1)[-1] in MOE_EXPERT_KEYS and t.dim() == 3 and \
        t.is_floating_point()


def scale_key(key: str) -> str:
    """Where a quantized weight's scale lives: `<p>.weight` ->
    `<p>.scale`, an expert weight `<p>.w_up` -> `<p>.w_up_scale`."""
    return key[:-len('weight')] + 'scale' if key.endswith('.weight') \
        else key + '_scale'


def quantize_params(params: Union[Mapping[str, torch.Tensor], nn.Module],
                    mode: str = 'int8') -> Dict[str, torch.Tensor]:
    """A float state_dict (or a module's) -> the state_dict of the same
    model with quant=mode: each projection's `.weight` replaced by its
    codes and a `.scale` added beside it, each MoE expert weight by its
    codes and a `<name>_scale` (int8 only: int4 raises the reference's
    NotImplementedError); every other entry as it was. Each weight is
    quantized on its own device."""
    if mode not in MODES:
        raise ValueError(f'unknown quantize mode {mode!r}')
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    out: Dict[str, torch.Tensor] = {}
    for key, t in sd.items():
        if is_expert_weight(key, t):
            if mode != 'int8':
                raise NotImplementedError(INT4_MOE)
            out[key], out[scale_key(key)] = quantize_kernel(t)
        elif is_projection(key, t):
            out[key], out[scale_key(key)] = quantize_weight(t, mode)
        else:
            out[key] = t
    return out


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_kernel: codes [..., out, in] + scale [..., out]
    -> float [..., out, in] (tests, export)."""
    return (q.float() * scale[..., None]).to(dtype)


def dequantize_kernel_int4(q: torch.Tensor, scale: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Inverse of quantize_kernel_int4: codes [out, in] (unpacked) +
    scale [in / G, out] -> float [out, in]."""
    dout, din = q.shape
    n_g = scale.shape[0]
    qf = q.float().reshape(dout, n_g, din // n_g)
    return (qf * scale.t()[..., None]).reshape(dout, din).to(dtype)
