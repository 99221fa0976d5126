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

Not ported here (raise NotImplementedError): quantized weights,
remat_policy 'dots' and attn_impl 'ring'. The JAX LlamaConfig's other
family knobs (attn_bias, qk_norm, the sandwich norms, the soft-caps and
attn_scale) and the Qwen, Phi-3 and Gemma-2 presets wait for a later
slice.
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
    quant: str = 'none'              # weight-only quantization: not ported
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

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

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
        per_layer = attn + 3 * d * self.mlp_dim + 2 * d
        embeds = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embeds + d


# Presets: 'debug' for unit tests; the others follow the Llama-3.x
# released shapes (the same values as the JAX package's CONFIGS).
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
    # Mistral-7B-v0.1 (HF MistralConfig): llama + sliding-window
    # attention on every layer.
    'mistral-7b': LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, mlp_dim=14336,
                              max_seq_len=32768, sliding_window=4096,
                              rope_theta=10000.0,
                              use_llama31_rope=False, norm_eps=1e-6),
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


class Linear(nn.Linear):
    """Bias-free projection y = x @ W^T (W [out, in]; flax Dense keeps
    the transpose), W stored in param_dtype and cast to the compute dtype
    at use (a no-op when the two agree, as when serving)."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig, device=None) -> None:
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=torch_dtype(cfg.param_dtype))
        self.compute_dtype = torch_dtype(cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.compute_dtype))


def _proj(linear: nn.Linear, x: torch.Tensor, lora, name: str):
    """A projection plus its multi-LoRA delta (counterpart of _proj /
    _lora_delta): lora is None or (stack, 'layers.<i>.', ids, scale); a
    projection the stack does not adapt is the plain matmul."""
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
        self.w_gate = Linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_up = Linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_down = Linear(cfg.mlp_dim, cfg.dim, cfg, device)

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
        self.wq = Linear(cfg.dim, h * hd, cfg, device)
        self.wk = Linear(cfg.dim, hk * hd, cfg, device)
        self.wv = Linear(cfg.dim, hk * hd, cfg, device)
        self.wo = Linear(h * hd, cfg.dim, cfg, device)

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
        q = rope.apply_rope(
            _proj(self.wq, x, lora, 'attn.wq').view(b, s, h, hd), cos, sin)
        k = rope.apply_rope(
            _proj(self.wk, x, lora, 'attn.wk').view(b, s, hk, hd), cos, sin)
        v = _proj(self.wv, x, lora, 'attn.wv').view(b, s, hk, hd)

        if cache is None:
            out = attention_ops.attention(q, k, v, causal=True,
                                          segment_ids=segment_ids,
                                          window=window, impl=cfg.attn_impl)
        elif len(cache) in (3, 5):
            if positions is None:
                raise ValueError('the paged cache path needs positions')
            out = self._paged(q, k, v, cache, positions, window)
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
                                              window=window)
            elif positions is None:
                # Queries at 0..s-1 over a cache written from 0: causal
                # attention over the fresh k/v.
                out = attention_ops.attention(q, k, v, causal=True,
                                              window=window)
            else:
                out = attention_ops.mha_reference(
                    q, k_cache, v_cache, q_positions=positions,
                    window=window)
        else:
            raise ValueError(f'a layer cache has 2, 3 or 5 entries, got '
                             f'{len(cache)}')
        return _proj(self.wo, out.reshape(b, s, h * hd), lora, 'attn.wo')

    @staticmethod
    def _paged(q, k, v, cache, positions, window=0):
        """Append the s new tokens of every slot (token j at
        positions[:, 0] + j) into the pools, then attend the slot's pages:
        a paged kernel, or with a window the gather view and the
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
        if window > 0:
            if quantized:
                k_view = PagePool.gather_view_layer_q(k_pool, k_scale,
                                                      tables, q.dtype)
                v_view = PagePool.gather_view_layer_q(v_pool, v_scale,
                                                      tables, q.dtype)
            else:
                k_view = PagePool.gather_view_layer(k_pool, tables)
                v_view = PagePool.gather_view_layer(v_pool, tables)
            return attention_ops.mha_reference(q, k_view, v_view,
                                               q_positions=positions,
                                               window=window)
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

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None, lora=None):
        x = x + self.attn(self.attn_norm(x), cos, sin, segment_ids, cache,
                          positions, lora)
        return x + self.mlp(self.mlp_norm(x), lora)


class LlamaModel(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        if cfg.quant != 'none':
            raise NotImplementedError(
                f'quantized weights ({cfg.quant}) are not ported')
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
            [LlamaBlock(cfg, device, i) for i in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.dim, cfg, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.dim, cfg.vocab_size, cfg, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`: embedding N(0, 0.02), each
        projection N(0, 1/fan_in) (the variance of flax's lecun_normal,
        untruncated), norm weights 1, or 0 when zero-centred (applied as
        1 + w: the identity either way, as the JAX init)."""
        self.tok_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=generator)
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
        return (logits, cache) if cache is not None else logits
