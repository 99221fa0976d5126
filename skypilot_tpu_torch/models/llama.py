"""Llama-family transformer in PyTorch (counterpart of
skypilot_tpu/models/llama.py).

GQA, SwiGLU, RMSNorm, RoPE theta 5e5 with the Llama-3.1 scaling, vocab
128256, and Mistral's sliding window (sliding_window, window_pattern:
layer i attends only the last `sliding_window` positions iff
i % window_pattern == 0). The layer stack is a Python loop (the JAX
package scans it), so each layer's window is a static int, the
counterpart of _window_args there. Attention has five branches, as
LlamaAttention there:

  * no cache: causal attention over the row (segment ids optional);
  * dense cache, fresh prefill (positions None): the prompt's K/V are
    written from index 0 and attention is causal over the fresh K/V —
    on the card the flash kernel, unpacked;
  * dense cache with segment ids: the packed ragged prefill, flash with
    segment masks;
  * dense cache with positions: the reference attention over the cache
    (q_positions masks);
  * paged cache (k_pool, v_pool, tables), plus (k_scale, v_scale) for
    int8 pools: each slot's s tokens are appended into its pages at
    positions[:, 0] + j, then a paged decode kernel attends the slot's
    pages — the single-query kernel for s == 1, the multi-query one for
    the speculative verify step (s = k+1), their int8 variants for
    quantized pools. A windowed layer attends through the gather view
    and the reference attention instead (the JAX package's _xla_gather:
    the paged kernels take no window), there as here.

Every branch takes the layer's window; the flash kernels compute it.

Training (as the JAX model trains): parameters live in param_dtype
(f32 masters by default) and are cast to the compute dtype where they are
used, as flax's Dense and the embedding's astype do, so gradients land
in the masters; with remat each block runs under
torch.utils.checkpoint (nn.remat's 'full' policy: only the block input
is kept, the block is recomputed in the backward); attention without a
cache takes the differentiable flash path (attn_impl 'auto' or 'flash')
or the plain reference, differentiated by autograd ('xla').

Multi-LoRA (forward's lora / lora_ids, as the JAX model's 'lora' and
'lora_ids' collections): each of the seven projections adds its batched
adapter delta (_proj, the counterpart of _proj / _lora_delta) through
ops/lora.py — per-sequence ids [B] take the gather kernel, per-token ids
[B, S] the grouped one. The stack (infer/lora.py) is an argument, never
part of the state_dict.

Gemma (the gemma-2b and gemma-7b presets) is this module with four
knobs, as in the JAX LlamaConfig: head_dim_override (head_dim 256, so
wq/wk/wv/wo map dim <-> heads*head_dim, which is not dim), mlp_act
'gelu_tanh' (GeGLU), norm_zero_centered (RMSNorm weights applied as
1 + w and initialised to 0) and embed_scale (embeddings times sqrt(dim)
rounded to the compute dtype first).

Weight-only quantization for serving (quant 'int8' | 'int4', the JAX
LlamaConfig's field): every projection and lm_head is a QuantLinear
(int8 codes, a scale per output channel) or a QuantLinear4 (int4 codes
packed two a byte, a scale per group of 128 inputs and output channel),
the counterparts of QuantDense and QuantDense4, in plain torch: the
reference has no Pallas kernel there. The embedding and the norms stay
float. models/quant.py makes the codes.

The other families (the qwen2-*, qwen3-*, phi3-mini and gemma2-*
presets) are this module with the JAX LlamaConfig's remaining knobs:
attn_bias (Qwen2: float biases on q/k/v, added after the product and
before a LoRA delta), qk_norm (Qwen3: an RMSNorm over head_dim of each q
and k head, before RoPE), sandwich_norms (Gemma-2: attn_post_norm and
mlp_post_norm on the residual branches), attn_softcap and attn_scale
(Gemma-2: cap * tanh(logits / cap) and 1/sqrt(query_pre_attn_scalar) in
every attention), final_softcap (Gemma-2's lm-head cap) and hf_layout
(Phi-3's fused checkpoint tensors: I/O only, models/weights.py). The
kernels compute neither a soft-cap nor a scale, so a model that
needs_xla_attention (a window, a cap or a scale) attends through the
plain reference on every branch that can see them: attention() routes
the capped and scaled calls there, and the paged branch takes the gather
view on every layer, window 0 included, as the JAX package does.

Not ported here (raise NotImplementedError): remat_policy 'dots' and
attn_impl 'ring'.
"""
import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.models import quant as quant_lib
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import lora as lora_ops
from skypilot_tpu_torch.ops import norms, paged_attention, rope

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f'unknown dtype {name!r}')
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    use_llama31_rope: bool = True
    norm_eps: float = 1e-5
    dtype: str = 'bfloat16'          # activations / compute dtype
    param_dtype: str = 'float32'     # master parameter dtype
    remat: bool = True               # checkpoint each block (training)
    remat_policy: str = 'full'       # 'dots' is not ported
    attn_impl: str = 'auto'          # 'auto' | 'flash' | 'xla' ('ring': no)
    tie_embeddings: bool = False
    # Weight-only quantization for serving: 'none' | 'int8' | 'int4'
    # (QuantLinear / QuantLinear4 below; models/quant.py).
    quant: str = 'none'
    # Sliding-window attention (Mistral: every layer): query p attends
    # keys in (p - window, p]. 0 = off. Layer i is windowed iff
    # i % window_pattern == 0.
    sliding_window: int = 0
    window_pattern: int = 1
    # Gemma family knobs (the JAX LlamaConfig's).
    head_dim_override: int = 0       # head_dim != dim / n_heads
    mlp_act: str = 'silu'            # 'silu' | 'gelu_tanh' (GeGLU)
    norm_zero_centered: bool = False  # norm weight applied as (1 + w)
    embed_scale: bool = False        # embeddings * sqrt(dim)
    # Qwen / Phi-3 / Gemma-2 knobs (the JAX LlamaConfig's).
    attn_bias: bool = False          # Qwen2: biases on q/k/v
    qk_norm: bool = False            # Qwen3: RMSNorm over head_dim of q, k
    attn_softcap: float = 0.0        # Gemma-2: 50.0 (tanh soft-cap)
    final_softcap: float = 0.0       # Gemma-2: 30.0 (lm-head logits)
    # Softmax scale; 0 = 1/sqrt(head_dim) (Gemma-2:
    # 1/sqrt(query_pre_attn_scalar)).
    attn_scale: float = 0.0
    sandwich_norms: bool = False     # Gemma-2: post-attn / post-mlp norms
    # HF tensor layout: 'llama' or 'phi3' (fused qkv_proj, gate_up_proj);
    # checkpoint I/O only, the module math is the same.
    hf_layout: str = 'llama'

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def needs_xla_attention(self) -> bool:
        """A window, a soft-cap or a scale override: attention the paged
        kernels do not compute, so every layer's decode takes the gather
        view and the plain reference (the JAX package's rule of the same
        name)."""
        return (self.sliding_window > 0 or self.attn_softcap > 0.0 or
                self.attn_scale != 0.0)

    def layer_window(self, i: int) -> int:
        """Layer i's sliding window (0: none), the counterpart of the
        JAX package's _window_args for a static layer index."""
        if self.sliding_window <= 0 or i % max(1, self.window_pattern):
            return 0
        return self.sliding_window

    def num_params(self) -> int:
        """Analytic parameter count (embedding counted once if tied)."""
        d, v, hd = self.dim, self.vocab_size, self.head_dim
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        if self.attn_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.qk_norm:
            attn += 2 * hd
        per_layer = attn + 3 * d * self.mlp_dim + \
            (4 if self.sandwich_norms else 2) * d
        embeds = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embeds + d


# Presets: 'debug' for unit tests; the others follow the released shapes
# (the same values as the JAX package's CONFIGS).
CONFIGS = {
    'debug': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                         dtype='float32', param_dtype='float32',
                         use_llama31_rope=False, remat=False),
    'llama3-1b': LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                             n_heads=32, n_kv_heads=8, mlp_dim=8192,
                             tie_embeddings=True),
    'llama3-8b': LlamaConfig(),  # the defaults above are 8B
    'llama3-70b': LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, mlp_dim=28672),
    # Qwen2.5 released shapes (HF Qwen2Config: q/k/v biases, rope 1e6).
    'qwen2-1.5b': LlamaConfig(vocab_size=151936, dim=1536, n_layers=28,
                              n_heads=12, n_kv_heads=2, mlp_dim=8960,
                              max_seq_len=32768, rope_theta=1e6,
                              use_llama31_rope=False, norm_eps=1e-6,
                              tie_embeddings=True, attn_bias=True),
    'qwen2-7b': LlamaConfig(vocab_size=152064, dim=3584, n_layers=28,
                            n_heads=28, n_kv_heads=4, mlp_dim=18944,
                            max_seq_len=32768, rope_theta=1e6,
                            use_llama31_rope=False, norm_eps=1e-6,
                            attn_bias=True),
    # Qwen3 released shapes (HF Qwen3Config: per-head q/k RMSNorm, no
    # attention biases, decoupled head_dim 128).
    'qwen3-0.6b': LlamaConfig(vocab_size=151936, dim=1024, n_layers=28,
                              n_heads=16, n_kv_heads=8, mlp_dim=3072,
                              head_dim_override=128, max_seq_len=32768,
                              rope_theta=1e6, use_llama31_rope=False,
                              norm_eps=1e-6, tie_embeddings=True,
                              qk_norm=True),
    'qwen3-8b': LlamaConfig(vocab_size=151936, dim=4096, n_layers=36,
                            n_heads=32, n_kv_heads=8, mlp_dim=12288,
                            head_dim_override=128, max_seq_len=32768,
                            rope_theta=1e6, use_llama31_rope=False,
                            norm_eps=1e-6, qk_norm=True),
    # Phi-3-mini (HF Phi3Config): llama math behind fused qkv_proj /
    # gate_up_proj checkpoint tensors; the -4k variant's 2047-token
    # sliding window.
    'phi3-mini': LlamaConfig(vocab_size=32064, dim=3072, n_layers=32,
                             n_heads=32, n_kv_heads=32, mlp_dim=8192,
                             max_seq_len=4096, rope_theta=10000.0,
                             use_llama31_rope=False, norm_eps=1e-5,
                             sliding_window=2047, hf_layout='phi3'),
    # Mistral-7B-v0.1 (HF MistralConfig): llama + sliding-window
    # attention on every layer.
    'mistral-7b': LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, mlp_dim=14336,
                              max_seq_len=32768, sliding_window=4096,
                              rope_theta=10000.0,
                              use_llama31_rope=False, norm_eps=1e-6),
    # Gemma-2 released shapes (HF Gemma2Config): Gemma's conventions plus
    # sandwich norms, tanh soft-caps (attention 50, lm-head 30), the
    # 1/sqrt(query_pre_attn_scalar) scale and a 4096 window on every
    # other layer (pattern 2, starting with a windowed layer).
    'gemma2-2b': LlamaConfig(vocab_size=256000, dim=2304, n_layers=26,
                             n_heads=8, n_kv_heads=4, mlp_dim=9216,
                             head_dim_override=256, max_seq_len=8192,
                             rope_theta=10000.0, use_llama31_rope=False,
                             norm_eps=1e-6, tie_embeddings=True,
                             mlp_act='gelu_tanh', norm_zero_centered=True,
                             embed_scale=True, sliding_window=4096,
                             window_pattern=2, attn_softcap=50.0,
                             final_softcap=30.0,
                             attn_scale=256.0 ** -0.5,
                             sandwich_norms=True),
    'gemma2-9b': LlamaConfig(vocab_size=256000, dim=3584, n_layers=42,
                             n_heads=16, n_kv_heads=8, mlp_dim=14336,
                             head_dim_override=256, max_seq_len=8192,
                             rope_theta=10000.0, use_llama31_rope=False,
                             norm_eps=1e-6, tie_embeddings=True,
                             mlp_act='gelu_tanh', norm_zero_centered=True,
                             embed_scale=True, sliding_window=4096,
                             window_pattern=2, attn_softcap=50.0,
                             final_softcap=30.0,
                             attn_scale=256.0 ** -0.5,
                             sandwich_norms=True),
    # Gemma released shapes (HF GemmaConfig: GeGLU, 1+w norms,
    # sqrt(dim) embed scale, head_dim 256, tied embeddings).
    'gemma-2b': LlamaConfig(vocab_size=256000, dim=2048, n_layers=18,
                            n_heads=8, n_kv_heads=1, mlp_dim=16384,
                            head_dim_override=256, max_seq_len=8192,
                            rope_theta=10000.0, use_llama31_rope=False,
                            norm_eps=1e-6, tie_embeddings=True,
                            mlp_act='gelu_tanh', norm_zero_centered=True,
                            embed_scale=True),
    'gemma-7b': LlamaConfig(vocab_size=256000, dim=3072, n_layers=28,
                            n_heads=16, n_kv_heads=16, mlp_dim=24576,
                            head_dim_override=256, max_seq_len=8192,
                            rope_theta=10000.0, use_llama31_rope=False,
                            norm_eps=1e-6, tie_embeddings=True,
                            mlp_act='gelu_tanh', norm_zero_centered=True,
                            embed_scale=True),
}


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The projection's float bias (Qwen2's q/k/v), cast to the compute
    dtype and added after the product, as flax's Dense and the
    reference's QuantDense add it."""
    return y if bias is None else y + bias.to(y.dtype)


class Linear(nn.Linear):
    """Projection y = x @ W^T (W [out, in]; flax Dense keeps the
    transpose), plus a bias where asked (zero at init), W stored in
    param_dtype and cast to the compute dtype at use (a no-op when the
    two agree, as when serving)."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig, device=None, bias: bool = False) -> None:
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=torch_dtype(cfg.param_dtype))
        self.compute_dtype = torch_dtype(cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _add_bias(F.linear(x, self.weight.to(self.compute_dtype)),
                         self.bias)


def _bias_buffer(module: nn.Module, out_features: int, cfg: LlamaConfig,
                 bias: bool, device) -> None:
    """A quantized projection's bias: float (param_dtype), never
    quantized, a buffer like its codes (None without one)."""
    module.register_buffer('bias', torch.zeros(
        (out_features,), dtype=torch_dtype(cfg.param_dtype),
        device=device) if bias else None)


class QuantLinear(nn.Module):
    """Weight-only int8 projection (QuantDense): `weight` int8 [out, in]
    and a per-output-channel f32 `scale` [out], both buffers, and an
    optional float `bias`. y = (x @ W^T) * scale (+ bias) with W cast to
    the compute dtype, in the reference's order (an exact rewrite for
    per-column scales). Eager torch fuses nothing: the cast writes and
    reads a compute-dtype copy of W every call."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig, device=None, bias: bool = False) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = torch_dtype(cfg.dtype)
        self.register_buffer('weight', torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer('scale', torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        _bias_buffer(self, out_features, cfg, bias, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return _add_bias(F.linear(x, self.weight.to(dt)) * self.scale.to(dt),
                         self.bias)


class QuantLinear4(nn.Module):
    """Weight-only int4 projection (QuantDense4): codes in [-7, 7] on
    groups of G = quant.int4_group_size(in) inputs, `weight` uint8
    [out, in / 2] holding two codes a byte — input 2j in the low nibble
    of byte j, input 2j + 1 in the high nibble, each as 4-bit two's
    complement — and `scale` f32 [in / G, out] (the reference's layout).

    y = sum_g (x_g @ W_g^T) * s_g: each group's dot in the compute dtype,
    the scale-multiply and the cross-group sum in f32, one rounding at
    the end, as QuantDense4 does."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig, device=None, bias: bool = False) -> None:
        super().__init__()
        if in_features % 2:
            raise ValueError(f'int4 packs two inputs a byte: in_features '
                             f'{in_features} is odd')
        self.in_features, self.out_features = in_features, out_features
        self.group = quant_lib.int4_group_size(in_features)
        self.compute_dtype = torch_dtype(cfg.dtype)
        self.register_buffer('weight', torch.zeros(
            (out_features, in_features // 2), dtype=torch.uint8,
            device=device))
        self.register_buffer('scale', torch.ones(
            (in_features // self.group, out_features), dtype=torch.float32,
            device=device))
        _bias_buffer(self, out_features, cfg, bias, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        n_g, g = self.in_features // self.group, self.group
        lead = x.shape[:-1]
        xg = x.reshape(-1, n_g, g).transpose(0, 1)           # [n_g, N, g]
        w = quant_lib.unpack_int4(self.weight).to(dt)
        wg = w.view(self.out_features, n_g, g).permute(1, 2, 0)  # [n_g, g, out]
        partial = torch.bmm(xg, wg)                           # [n_g, N, out]
        y = (partial.float() * self.scale[:, None, :]).sum(0)
        return _add_bias(y.to(dt).reshape(*lead, self.out_features),
                         self.bias)


_QUANT_LINEARS = {'none': Linear, 'int8': QuantLinear, 'int4': QuantLinear4}


def _linear(in_features: int, out_features: int, cfg: LlamaConfig,
            device=None, bias: bool = False) -> nn.Module:
    """A projection of cfg.quant's kind (the reference's _dense)."""
    return _QUANT_LINEARS[cfg.quant](in_features, out_features, cfg, device,
                                     bias)


def _proj(linear: nn.Linear, x: torch.Tensor, lora, name: str):
    """A projection (its bias included) plus its multi-LoRA delta
    (counterpart of _proj / _lora_delta): lora is None or (stack,
    'layers.<i>.', ids, scale); a projection the stack does not adapt is
    the plain matmul."""
    y = linear(x)
    if lora is None:
        return y
    stack, prefix, ids, scale = lora
    ab = stack.get(prefix + name)
    if ab is None:
        return y
    return lora_ops.add_lora_delta_(y, x, ab[0], ab[1], ids, scale)


# The gate activations of the MLP: SwiGLU's SiLU, Gemma's GeGLU (GELU
# with the tanh approximation, as flax's nn.gelu(approximate=True)).
_ACTS = {'silu': F.silu,
         'gelu_tanh': functools.partial(F.gelu, approximate='tanh')}


class RMSNorm(nn.Module):
    """RMSNorm over the last dim (dim: the model width, or head_dim for
    Qwen3's q_norm / k_norm)."""

    def __init__(self, dim: int, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.zero_centered = cfg.norm_zero_centered
        self.weight = nn.Parameter(torch.empty(
            (dim,), device=device, dtype=torch_dtype(cfg.param_dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # rms_norm computes in f32 with the weight cast to f32 and returns
        # x's dtype, as the JAX RMSNorm does with its param_dtype weight.
        return norms.rms_norm(x, self.weight, eps=self.eps,
                              zero_centered=self.zero_centered)


class LlamaMLP(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        if cfg.mlp_act not in _ACTS:
            raise ValueError(f'unknown mlp_act {cfg.mlp_act!r}')
        self.act = _ACTS[cfg.mlp_act]
        self.w_gate = _linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_up = _linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_down = _linear(cfg.mlp_dim, cfg.dim, cfg, device)

    def forward(self, x: torch.Tensor, lora=None) -> torch.Tensor:
        hidden = self.act(_proj(self.w_gate, x, lora, 'mlp.w_gate')) * \
            _proj(self.w_up, x, lora, 'mlp.w_up')
        return _proj(self.w_down, hidden, lora, 'mlp.w_down')


class LlamaAttention(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None,
                 window: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.window = window
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _linear(cfg.dim, h * hd, cfg, device, cfg.attn_bias)
        self.wk = _linear(cfg.dim, hk * hd, cfg, device, cfg.attn_bias)
        self.wv = _linear(cfg.dim, hk * hd, cfg, device, cfg.attn_bias)
        self.wo = _linear(h * hd, cfg.dim, cfg, device)
        self.q_norm = RMSNorm(hd, cfg, device) if cfg.qk_norm else None
        self.k_norm = RMSNorm(hd, cfg, device) if cfg.qk_norm else None
        # What the kernels do not compute: soft-cap and scale (None: the
        # default 1/sqrt(head_dim)).
        self.softcap = cfg.attn_softcap
        self.scale = cfg.attn_scale or None

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None, lora=None):
        """cache: None, a dense (k, v) pair of [B, S_cache, Hkv, Hd], or
        a paged (k_pool [n_pages, Hkv, P, Hd], v_pool, tables [B, mp])
        triple for one layer, with (k_scale, v_scale) [n_pages, Hkv, P]
        appended for int8 pools. Caches are written in place. lora: the
        layer's adapter routing (see _proj) or None."""
        cfg, window = self.cfg, self.window
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b, s, _ = x.shape
        fam = dict(logit_softcap=self.softcap, softmax_scale=self.scale)
        q = _proj(self.wq, x, lora, 'attn.wq').view(b, s, h, hd)
        k = _proj(self.wk, x, lora, 'attn.wk').view(b, s, hk, hd)
        if self.q_norm is not None:
            # Qwen3: each head's q and k normed over head_dim, before RoPE.
            q, k = self.q_norm(q), self.k_norm(k)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
        v = _proj(self.wv, x, lora, 'attn.wv').view(b, s, hk, hd)

        if cache is None:
            out = attention_ops.attention(q, k, v, causal=True,
                                          segment_ids=segment_ids,
                                          window=window, impl=cfg.attn_impl,
                                          **fam)
        elif len(cache) in (3, 5):
            if positions is None:
                raise ValueError('the paged cache path needs positions')
            out = self._paged(q, k, v, cache, positions, window,
                              cfg.needs_xla_attention, **fam)
        elif len(cache) == 2:
            k_cache, v_cache = cache
            if positions is None:
                # Fresh prefill: the prompt fills the cache from index 0.
                k_cache[:, :s] = k
                v_cache[:, :s] = v
            else:
                start = positions[:, :1].long().clamp(
                    0, k_cache.shape[1] - s)
                idx = start + torch.arange(s, device=x.device)[None, :]
                rows = torch.arange(b, device=x.device)[:, None]
                k_cache[rows, idx] = k
                v_cache[rows, idx] = v
            if segment_ids is not None:
                # Packed ragged prefill: the cache starts zeroed and the
                # writes cover the whole packed row, so attending the
                # fresh k/v with segment masks IS attention over the
                # cache.
                out = attention_ops.attention(q, k, v, causal=True,
                                              segment_ids=segment_ids,
                                              window=window, **fam)
            elif positions is None:
                # Queries at 0..s-1 over a cache written from 0: causal
                # attention over the fresh k/v.
                out = attention_ops.attention(q, k, v, causal=True,
                                              window=window, **fam)
            else:
                out = attention_ops.mha_reference(
                    q, k_cache, v_cache, q_positions=positions,
                    window=window, **fam)
        else:
            raise ValueError(f'a layer cache has 2, 3 or 5 entries, got '
                             f'{len(cache)}')
        return _proj(self.wo, out.reshape(b, s, h * hd), lora, 'attn.wo')

    @staticmethod
    def _paged(q, k, v, cache, positions, window=0, plain=False,
               logit_softcap=0.0, softmax_scale=None):
        """Append the s new tokens of every slot (token j at
        positions[:, 0] + j) into the pools, then attend the slot's pages:
        a paged kernel, or with a window — or for any layer of a model
        whose attention the kernels cannot compute (plain: a window, a
        soft-cap or a scale on the model) — the gather view and the
        reference attention (the JAX package's _xla_gather)."""
        s = q.shape[1]
        pos = positions[:, 0].to(torch.int32).contiguous()
        quantized = len(cache) == 5
        k_pool, v_pool, tables = cache[:3]
        k_scale, v_scale = cache[3:] if quantized else (None, None)
        if quantized and s == 1:
            PagePool.append_token_layer_q(k_pool, k_scale, k[:, 0], tables,
                                          pos)
            PagePool.append_token_layer_q(v_pool, v_scale, v[:, 0], tables,
                                          pos)
        elif quantized:
            PagePool.append_tokens_layer_q(k_pool, k_scale, k, tables, pos)
            PagePool.append_tokens_layer_q(v_pool, v_scale, v, tables, pos)
        elif s == 1:
            PagePool.append_token_layer(k_pool, k[:, 0], tables, pos)
            PagePool.append_token_layer(v_pool, v[:, 0], tables, pos)
        else:
            PagePool.append_tokens_layer(k_pool, k, tables, pos)
            PagePool.append_tokens_layer(v_pool, v, tables, pos)
        if window > 0 or plain:
            if quantized:
                k_view = PagePool.gather_view_layer_q(k_pool, k_scale,
                                                      tables, q.dtype)
                v_view = PagePool.gather_view_layer_q(v_pool, v_scale,
                                                      tables, q.dtype)
            else:
                k_view = PagePool.gather_view_layer(k_pool, tables)
                v_view = PagePool.gather_view_layer(v_pool, tables)
            return attention_ops.mha_reference(
                q, k_view, v_view, q_positions=positions, window=window,
                logit_softcap=logit_softcap, softmax_scale=softmax_scale)
        if quantized and s == 1:
            return paged_attention.paged_decode_attention_q(
                q[:, 0].contiguous(), k_pool, v_pool, k_scale, v_scale,
                tables, pos)[:, None]
        if quantized:
            return paged_attention.paged_decode_attention_mq_q(
                q.contiguous(), k_pool, v_pool, k_scale, v_scale, tables,
                pos)
        if s == 1:
            return paged_attention.paged_decode_attention(
                q[:, 0].contiguous(), k_pool, v_pool, tables, pos)[:, None]
        return paged_attention.paged_decode_attention_mq(
            q.contiguous(), k_pool, v_pool, tables, pos)


class LlamaBlock(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None,
                 layer_idx: int = 0) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg, device)
        self.attn = LlamaAttention(cfg, device, cfg.layer_window(layer_idx))
        self.mlp_norm = RMSNorm(cfg.dim, cfg, device)
        self.mlp = LlamaMLP(cfg, device)
        # Gemma-2's sandwich norms: each residual branch normed again.
        sandwich = cfg.sandwich_norms
        self.attn_post_norm = RMSNorm(cfg.dim, cfg, device) if sandwich \
            else None
        self.mlp_post_norm = RMSNorm(cfg.dim, cfg, device) if sandwich \
            else None

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None, lora=None):
        a = self.attn(self.attn_norm(x), cos, sin, segment_ids, cache,
                      positions, lora)
        if self.attn_post_norm is not None:
            a = self.attn_post_norm(a)
        x = x + a
        m = self.mlp(self.mlp_norm(x), lora)
        if self.mlp_post_norm is not None:
            m = self.mlp_post_norm(m)
        return x + m


class LlamaModel(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None, block=LlamaBlock
                 ) -> None:
        """block(cfg, device, layer_idx): the layer's module (models/moe.py
        passes its MoeBlock)."""
        super().__init__()
        if cfg.quant not in _QUANT_LINEARS:
            raise ValueError(f'unknown quant mode {cfg.quant!r}; '
                             f'choose from {sorted(_QUANT_LINEARS)}')
        if cfg.remat_policy != 'full':
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported; 'full' "
                'recomputes each block')
        if cfg.attn_impl not in ('auto', 'flash', 'xla'):
            raise NotImplementedError(
                f'attn_impl {cfg.attn_impl!r} is not ported (ring attention '
                "waits for the parallelism slice); use 'auto', 'flash' or "
                "'xla'")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.param_dtype = torch_dtype(cfg.param_dtype)
        self.tok_embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.dim), device=device,
            dtype=self.param_dtype))
        self.layers = nn.ModuleList(
            [block(cfg, device, i) for i in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.dim, cfg, device)
        self.lm_head = None if cfg.tie_embeddings else _linear(
            cfg.dim, cfg.vocab_size, cfg, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`: embedding N(0, 0.02), each
        projection N(0, 1/fan_in) (the variance of flax's lecun_normal,
        untruncated), norm weights 1, or 0 when zero-centred (applied as
        1 + w: the identity either way, as the JAX init). With quant,
        each projection is drawn in param_dtype from the same generator
        in the same order as the float model's, then quantized: the
        quantized version of the float model's random weights (the
        reference's fused init-then-quantize). Biases start at 0, as
        flax's zeros_init."""
        self.tok_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if getattr(mod, 'bias', None) is not None:
                mod.bias.zero_()
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=generator)
            elif isinstance(mod, (QuantLinear, QuantLinear4)):
                w = torch.empty((mod.out_features, mod.in_features),
                                dtype=self.param_dtype,
                                device=mod.weight.device)
                w.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                          generator=generator)
                q, scale = quant_lib.quantize_weight(w, self.cfg.quant)
                del w
                mod.weight.copy_(q)
                mod.scale.copy_(scale)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(0.0 if mod.zero_centered else 1.0)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                logit_positions: Optional[torch.Tensor] = None,
                lora: Optional[Dict[str, Any]] = None,
                lora_ids: Optional[torch.Tensor] = None):
        """tokens: [B, S] int -> logits [B, S, vocab] (compute dtype).

        cache: optional {'k': [L, ...], 'v': [L, ...]} — dense
        [L, B, S_cache, Hkv, Hd] for prefill, or the paged pools
        [L, n_pages, Hkv, P, Hd] plus 'tables' [B, mp] for decode (and
        'k_scale'/'v_scale' [L, n_pages, Hkv, P] for int8 pools) —
        updated in place; the return is then (logits, cache). With a
        dense cache, positions None means a fresh prefill at 0..S-1.

        logit_positions: optional [B, P] — logits only at these token
        indices.

        lora / lora_ids: a multi-LoRA stack (infer/lora.py) and int32
        adapter ids, [B] per sequence or [B, S] per token (0: no
        adapter); the scale is lora['scaling'][lora_ids], as the JAX
        model takes it. Without both the forward is the plain model's."""
        cfg = self.cfg
        b, s = tokens.shape
        # embed.astype(dtype)[tokens], gathered before the cast (the same
        # values without a cast copy of the whole table).
        x = self.tok_embed[tokens].to(self.dtype)
        if cfg.embed_scale:
            # Gemma: sqrt(dim) rounded to the compute dtype first, as the
            # JAX model (and HF) round the normalizer.
            x = x * torch.tensor(cfg.dim ** 0.5, dtype=self.dtype)
        rope_pos = positions if positions is not None else \
            rope.positions_from_segment_ids(segment_ids, b, s,
                                            device=tokens.device)
        cos, sin = rope.rope_freqs(rope_pos, cfg.head_dim, cfg.rope_theta,
                                   use_llama31_scaling=cfg.use_llama31_rope)
        tables = cache.get('tables') if cache is not None else None
        lora_scale = None
        if lora is not None and lora_ids is not None:
            lora_scale = lora['scaling'][lora_ids]
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            lc = None
            if cache is not None:
                lc = (cache['k'][i], cache['v'][i])
                if tables is not None:
                    lc = lc + (tables,)
                    if 'k_scale' in cache:
                        lc = lc + (cache['k_scale'][i], cache['v_scale'][i])
            ll = None if lora_scale is None else \
                (lora, f'layers.{i}.', lora_ids, lora_scale)
            if remat:
                # nn.remat: keep only the block's input; the backward runs
                # the block again (no RNG inside, so no RNG state to keep).
                x = checkpoint_lib.checkpoint(
                    layer, x, cos, sin, segment_ids, lc, positions, ll,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, cos, sin, segment_ids, lc, positions, ll)
        x = self.final_norm(x)
        if logit_positions is not None:
            x = torch.gather(
                x, 1, logit_positions.long()[:, :, None].expand(
                    -1, -1, x.shape[-1]))
        if self.lm_head is None:
            logits = x @ self.tok_embed.to(self.dtype).t()
        else:
            logits = self.lm_head(x)
        if cfg.final_softcap > 0.0:
            # Gemma-2's lm-head soft-cap, in the logits' dtype.
            cap = torch.tensor(cfg.final_softcap, dtype=logits.dtype,
                               device=logits.device)
            logits = cap * torch.tanh(logits / cap)
        return (logits, cache) if cache is not None else logits
