"""Mixture-of-Experts decoder in PyTorch (counterpart of
skypilot_tpu/models/moe.py): the Llama backbone (the port's
LlamaAttention, RMSNorm and RoPE, so q/k norms, the paged branch and the
attention kernels come as they are) with a routed expert MLP in every
layer. Mixtral-8x7B and Qwen3-30B-A3B ride this one class, as in the
reference.

MoeMLP computes the reference's GShard routing exactly:

  * router logits x @ W_r in f32, softmax;
  * top-k by a stable descending sort (the lower expert index first on a
    tie, as jax.lax.top_k);
  * the k gates renormalised, divided by max(sum, 1e-9);
  * capacity = max(int(capacity_factor * s * k / e), 1) a batch row, s
    the row's length padding included;
  * slot-major positions: every choice-j assignment to an expert goes
    after all choice-<j assignments to it in the row;
  * an assignment at pos >= capacity is dropped (its gate 0);
  * the expert FFN silu(x W_gate) * (x W_up) W_down in the compute
    dtype; int8 experts as (x @ W.to(dtype)) * scale, a scale per
    (expert, out-channel);
  * the gated sum over the k choices in f32, then cast.

It never builds the reference's dense [B, S, E, C] dispatch and combine
tensors (at qwen3-30b-a3b's packed 2048-token row they would be 1 GiB a
layer): pos comes from the [B, S, k, E] one-hot cumsum, the kept
assignments are sorted by expert and run through one grouped product a
weight (torch._grouped_mm, device-side offsets: no host sync, the same
code on the CPU and the card), and the results are put back in
assignment order. Rows past the kept ones (the dropped assignments) are
never read. The reference's expert FFN is einsums, not a Pallas kernel:
here it is plain torch too (ROADMAP queue 2 C queues a hand-written
grouped-GEMM kernel).

Weights: the router [E, dim] (HF's gate.weight; the reference keeps its
transpose), expert weights [E, out, in] (HF's per-expert [out, in]
stacked) in param_dtype, or with quant 'int8' int8 codes beside an f32
`<name>_scale` [E, out] (models/quant.py). int4 raises, as the
reference's quantize_params does.

Serving only: the load-balance and router-z aux losses the reference's
forward returns for its trainer are not computed (training MoE waits
for a later slice), and LoRA adapters are refused (the reference model
takes none).
"""
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quant as quant_lib


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # The reference's aux-loss weights (its trainer's; unused here).
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


def capacity(moe: MoeConfig, s: int) -> int:
    """An expert's slots a batch row of s tokens (padding counted)."""
    return max(int(moe.capacity_factor * s * moe.experts_per_token /
                   moe.num_experts), 1)


def route(logits: torch.Tensor, k: int, cap: int):
    """Router logits [B, S, E] f32 -> (gates [B, S, k] f32, 0 where
    dropped; experts [B, S, k] int64; keep [B, S, k] bool; kept [B, E]
    int32, each row's kept assignments an expert)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], idx[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = torch.zeros(experts.shape + (e,), dtype=torch.int32,
                         device=logits.device)
    onehot.scatter_(-1, experts[..., None], 1)                # [B,S,k,E]
    pos_in_slot = onehot.cumsum(1, dtype=torch.int32) - onehot
    slot_counts = onehot.sum(1, dtype=torch.int32)            # [B,k,E]
    slot_offset = slot_counts.cumsum(1, dtype=torch.int32) - slot_counts
    pos = (pos_in_slot + slot_offset[:, None]).gather(
        -1, experts[..., None])[..., 0]                       # [B,S,k]
    keep = pos < cap
    kept = slot_counts.sum(1, dtype=torch.int32).clamp_(max=cap)
    return gates * keep, experts, keep, kept


class MoeMLP(nn.Module):
    """The routed expert MLP: x [B, S, dim] -> [B, S, dim]."""

    def __init__(self, cfg: llama.LlamaConfig, moe: MoeConfig,
                 device=None) -> None:
        super().__init__()
        self.moe = moe
        self.quantized = cfg.quant == 'int8'
        self.compute_dtype = llama.torch_dtype(cfg.dtype)
        self.param_dtype = llama.torch_dtype(cfg.param_dtype)
        e, d, m = moe.num_experts, cfg.dim, cfg.mlp_dim
        self.router = nn.Parameter(torch.empty((e, d), device=device,
                                               dtype=self.param_dtype))
        for name, shape in (('w_gate', (e, m, d)), ('w_up', (e, m, d)),
                            ('w_down', (e, d, m))):
            if self.quantized:
                self.register_buffer(name, torch.zeros(
                    shape, dtype=torch.int8, device=device))
                self.register_buffer(name + '_scale', torch.ones(
                    shape[:2], dtype=torch.float32, device=device))
            else:
                setattr(self, name, nn.Parameter(torch.empty(
                    shape, device=device, dtype=self.param_dtype)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The router and each expert weight N(0, 1/fan_in) (flax's
        lecun_normal variance, batch axis 0 for the experts; untruncated,
        as the port's Linear). int8: each weight drawn in param_dtype,
        quantized and freed before the next."""
        self.router.normal_(0.0, 1.0 / math.sqrt(self.router.shape[1]),
                            generator=generator)
        for name in quant_lib.MOE_EXPERT_KEYS:
            w = getattr(self, name)
            std = 1.0 / math.sqrt(w.shape[-1])
            if not self.quantized:
                w.normal_(0.0, std, generator=generator)
                continue
            f = torch.empty(w.shape, dtype=self.param_dtype, device=w.device)
            f.normal_(0.0, std, generator=generator)
            q, scale = quant_lib.quantize_kernel(f)
            del f
            w.copy_(q)
            getattr(self, name + '_scale').copy_(scale)

    def _grouped(self, x, name, offs, row_expert):
        """x [M, in] (rows sorted by expert, group g ending at offs[g]) @
        each group's expert weight -> [M, out] in the compute dtype."""
        dt = self.compute_dtype
        w = getattr(self, name)
        y = torch._grouped_mm(x, w.to(dt).transpose(-2, -1), offs=offs)
        if self.quantized:
            y = y * getattr(self, name + '_scale').to(dt)[row_expert]
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        moe, dt = self.moe, self.compute_dtype
        b, s, d = x.shape
        e, k = moe.num_experts, moe.experts_per_token
        logits = F.linear(x.float(), self.router.float())
        gates, experts, keep, kept = route(logits, k, capacity(moe, s))
        # Kept assignments sorted by expert (dropped ones last, under the
        # sentinel e), grouped by the kept counts' running sum.
        key = torch.where(keep, experts, e).reshape(-1)
        order = torch.argsort(key, stable=True)
        offs = kept.sum(0).cumsum(0, dtype=torch.int32)
        row_expert = key[order].clamp_(max=e - 1)
        xs = x.reshape(b * s, d).to(dt).index_select(0, order // k)
        hidden = F.silu(self._grouped(xs, 'w_gate', offs, row_expert)) * \
            self._grouped(xs, 'w_up', offs, row_expert)
        y = self._grouped(hidden, 'w_down', offs, row_expert)
        ys = torch.empty_like(y).index_copy_(0, order, y)
        ys = ys.view(b, s, k, d).float() * gates[..., None]
        return torch.where(keep[..., None], ys, 0.0).sum(2).to(dt)


class MoeBlock(nn.Module):
    """Pre-norm attention and the routed MLP (the reference's MoeBlock:
    no sandwich norms; the window, where the config has one, on every
    layer)."""

    def __init__(self, cfg: llama.LlamaConfig, moe: MoeConfig,
                 device=None) -> None:
        super().__init__()
        self.attn_norm = llama.RMSNorm(cfg.dim, cfg, device)
        self.attn = llama.LlamaAttention(cfg, device, cfg.sliding_window)
        self.mlp_norm = llama.RMSNorm(cfg.dim, cfg, device)
        self.moe_mlp = MoeMLP(cfg, moe, device)

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None, lora=None):
        del lora   # MixtralModel.forward refuses adapters
        x = x + self.attn(self.attn_norm(x), cos, sin, segment_ids, cache,
                          positions)
        return x + self.moe_mlp(self.mlp_norm(x))


# LlamaConfig knobs LlamaModel.forward applies that the reference's
# MixtralModel has no counterpart of.
_NOT_MOE = ('tie_embeddings', 'embed_scale', 'sandwich_norms',
            'final_softcap')


class MixtralModel(llama.LlamaModel):
    """LlamaModel's embedding, RoPE, final norm and lm_head around
    MoeBlocks: forward has LlamaModel.forward's signature and cache
    contract (dense or paged, int8 pools, logit_positions), so the
    engine runs it unchanged."""

    def __init__(self, cfg: llama.LlamaConfig, moe: MoeConfig = MoeConfig(),
                 device=None) -> None:
        if cfg.quant == 'int4':
            raise NotImplementedError(quant_lib.INT4_MOE)
        bad = [f for f in _NOT_MOE if getattr(cfg, f)]
        if cfg.mlp_act != 'silu':
            bad.append(f'mlp_act={cfg.mlp_act!r}')
        if bad:
            raise ValueError(f'MixtralModel does not take {", ".join(bad)}')
        super().__init__(cfg, device,
                         block=lambda c, dev, i: MoeBlock(c, moe, dev))
        self.moe = moe

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """LlamaModel's init for the embedding, attention, norms and
        lm_head, then each layer's router and experts."""
        super().init_weights(generator)
        for layer in self.layers:
            layer.moe_mlp.init_weights(generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                logit_positions: Optional[torch.Tensor] = None,
                lora: Optional[Dict[str, Any]] = None,
                lora_ids: Optional[torch.Tensor] = None):
        if lora is not None or lora_ids is not None:
            raise ValueError('MixtralModel takes no LoRA adapters (nor '
                             'does the reference model)')
        return super().forward(tokens, positions, segment_ids, cache,
                               logit_positions)


# The reference's presets, value for value: Mixtral-8x7B (vocab 32000,
# dim 4096, 32 layers, 8 experts top-2) and Qwen3-30B-A3B (qk-norm
# attention, 128 experts top-8 sized by moe_intermediate_size).
MIXTRAL_CONFIGS = {
    'debug-moe': (llama.LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq_len=128, dtype='float32',
        param_dtype='float32', use_llama31_rope=False, remat=False),
        MoeConfig(num_experts=4, experts_per_token=2)),
    'mixtral-8x7b': (llama.LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_dim=14336, max_seq_len=32768, rope_theta=1e6,
        use_llama31_rope=False),
        MoeConfig(num_experts=8, experts_per_token=2)),
    'qwen3-30b-a3b': (llama.LlamaConfig(
        vocab_size=151936, dim=2048, n_layers=48, n_heads=32,
        n_kv_heads=4, head_dim_override=128, mlp_dim=768,
        max_seq_len=32768, rope_theta=1e6, use_llama31_rope=False,
        norm_eps=1e-6, qk_norm=True),
        MoeConfig(num_experts=128, experts_per_token=8)),
}
