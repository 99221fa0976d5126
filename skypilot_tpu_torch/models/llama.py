"""Llama-family transformer in PyTorch (counterpart of
skypilot_tpu/models/llama.py).

GQA, SwiGLU, RMSNorm, RoPE theta 5e5 with the Llama-3.1 scaling, vocab
128256. The layer stack is a Python loop (the JAX package scans it).
Attention has four branches, as LlamaAttention there:

  * no cache: causal attention over the row (segment ids optional);
  * dense cache, fresh prefill (positions None): the prompt's K/V are
    written from index 0 and attention is causal over the fresh K/V —
    on the card the flash kernel, unpacked;
  * dense cache with segment ids: the packed ragged prefill, flash with
    segment masks;
  * paged cache (k_pool, v_pool, tables), plus (k_scale, v_scale) for
    int8 pools: each slot's s tokens are appended into its pages at
    positions[:, 0] + j, then a paged decode kernel attends the slot's
    pages — the single-query kernel for s == 1, the multi-query one for
    the speculative verify step (s = k+1), their int8 variants for
    quantized pools.

Not ported here (raise NotImplementedError): quantized weights and LoRA
adapters. The Qwen/Gemma/Mistral family knobs of the JAX LlamaConfig
wait for a later slice.
"""
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.ops import attention as attention_ops
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
    dtype: str = 'bfloat16'          # parameters and activations
    tie_embeddings: bool = False
    quant: str = 'none'              # weight-only quantization: not ported

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

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
                         dtype='float32', use_llama31_rope=False),
    'llama3-1b': LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                             n_heads=32, n_kv_heads=8, mlp_dim=8192,
                             tie_embeddings=True),
    'llama3-8b': LlamaConfig(),  # the defaults above are 8B
    'llama3-70b': LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, mlp_dim=28672),
}


def Linear(in_features: int, out_features: int, cfg: LlamaConfig,
           device=None) -> nn.Linear:
    """Bias-free projection y = x @ W^T (W [out, in]; flax Dense keeps
    the transpose)."""
    return nn.Linear(in_features, out_features, bias=False, device=device,
                     dtype=torch_dtype(cfg.dtype))


class RMSNorm(nn.Module):

    def __init__(self, dim: int, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.weight = nn.Parameter(torch.empty(
            (dim,), device=device, dtype=torch_dtype(cfg.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norms.rms_norm(x, self.weight, eps=self.eps)


class LlamaMLP(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.w_gate = Linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_up = Linear(cfg.dim, cfg.mlp_dim, cfg, device)
        self.w_down = Linear(cfg.mlp_dim, cfg.dim, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class LlamaAttention(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Linear(cfg.dim, h * hd, cfg, device)
        self.wk = Linear(cfg.dim, hk * hd, cfg, device)
        self.wv = Linear(cfg.dim, hk * hd, cfg, device)
        self.wo = Linear(h * hd, cfg.dim, cfg, device)

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None):
        """cache: None, a dense (k, v) pair of [B, S_cache, Hkv, Hd], or
        a paged (k_pool [n_pages, Hkv, P, Hd], v_pool, tables [B, mp])
        triple for one layer, with (k_scale, v_scale) [n_pages, Hkv, P]
        appended for int8 pools. Caches are written in place."""
        cfg = self.cfg
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b, s, _ = x.shape
        q = rope.apply_rope(self.wq(x).view(b, s, h, hd), cos, sin)
        k = rope.apply_rope(self.wk(x).view(b, s, hk, hd), cos, sin)
        v = self.wv(x).view(b, s, hk, hd)

        if cache is None:
            out = attention_ops.attention(q, k, v, causal=True,
                                          segment_ids=segment_ids)
        elif len(cache) in (3, 5):
            if positions is None:
                raise ValueError('the paged cache path needs positions')
            out = self._paged(q, k, v, cache,
                              positions[:, 0].to(torch.int32).contiguous())
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
                                              segment_ids=segment_ids)
            elif positions is None:
                # Queries at 0..s-1 over a cache written from 0: causal
                # attention over the fresh k/v.
                out = attention_ops.attention(q, k, v, causal=True)
            else:
                out = attention_ops.mha_reference(
                    q, k_cache, v_cache, q_positions=positions)
        else:
            raise ValueError(f'a layer cache has 2, 3 or 5 entries, got '
                             f'{len(cache)}')
        return self.wo(out.reshape(b, s, h * hd))

    @staticmethod
    def _paged(q, k, v, cache, pos):
        """Append the s new tokens of every slot (token j at pos + j)
        into the pools, then attend the slot's pages."""
        s = q.shape[1]
        if len(cache) == 5:
            k_pool, v_pool, tables, k_scale, v_scale = cache
            if s == 1:
                PagePool.append_token_layer_q(k_pool, k_scale, k[:, 0],
                                              tables, pos)
                PagePool.append_token_layer_q(v_pool, v_scale, v[:, 0],
                                              tables, pos)
                return paged_attention.paged_decode_attention_q(
                    q[:, 0].contiguous(), k_pool, v_pool, k_scale, v_scale,
                    tables, pos)[:, None]
            PagePool.append_tokens_layer_q(k_pool, k_scale, k, tables, pos)
            PagePool.append_tokens_layer_q(v_pool, v_scale, v, tables, pos)
            return paged_attention.paged_decode_attention_mq_q(
                q.contiguous(), k_pool, v_pool, k_scale, v_scale, tables,
                pos)
        k_pool, v_pool, tables = cache
        if s == 1:
            PagePool.append_token_layer(k_pool, k[:, 0], tables, pos)
            PagePool.append_token_layer(v_pool, v[:, 0], tables, pos)
            return paged_attention.paged_decode_attention(
                q[:, 0].contiguous(), k_pool, v_pool, tables, pos)[:, None]
        PagePool.append_tokens_layer(k_pool, k, tables, pos)
        PagePool.append_tokens_layer(v_pool, v, tables, pos)
        return paged_attention.paged_decode_attention_mq(
            q.contiguous(), k_pool, v_pool, tables, pos)


class LlamaBlock(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg, device)
        self.attn = LlamaAttention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                positions=None):
        x = x + self.attn(self.attn_norm(x), cos, sin, segment_ids, cache,
                          positions)
        return x + self.mlp(self.mlp_norm(x))


class LlamaModel(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        if cfg.quant != 'none':
            raise NotImplementedError(
                f'quantized weights ({cfg.quant}) are not ported')
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.tok_embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.dim), device=device, dtype=self.dtype))
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, device) for _ in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.dim, cfg, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.dim, cfg.vocab_size, cfg, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`: embedding N(0, 0.02), each
        projection N(0, 1/fan_in) (the variance of flax's lecun_normal,
        untruncated), norm weights 1."""
        self.tok_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                logit_positions: Optional[torch.Tensor] = None):
        """tokens: [B, S] int -> logits [B, S, vocab] (compute dtype).

        cache: optional {'k': [L, ...], 'v': [L, ...]} — dense
        [L, B, S_cache, Hkv, Hd] for prefill, or the paged pools
        [L, n_pages, Hkv, P, Hd] plus 'tables' [B, mp] for decode (and
        'k_scale'/'v_scale' [L, n_pages, Hkv, P] for int8 pools) —
        updated in place; the return is then (logits, cache). With a
        dense cache, positions None means a fresh prefill at 0..S-1.

        logit_positions: optional [B, P] — logits only at these token
        indices."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.tok_embed[tokens]
        rope_pos = positions if positions is not None else \
            rope.positions_from_segment_ids(segment_ids, b, s,
                                            device=tokens.device)
        cos, sin = rope.rope_freqs(rope_pos, cfg.head_dim, cfg.rope_theta,
                                   use_llama31_scaling=cfg.use_llama31_rope)
        tables = cache.get('tables') if cache is not None else None
        for i, layer in enumerate(self.layers):
            lc = None
            if cache is not None:
                lc = (cache['k'][i], cache['v'][i])
                if tables is not None:
                    lc = lc + (tables,)
                    if 'k_scale' in cache:
                        lc = lc + (cache['k_scale'][i], cache['v_scale'][i])
            x = layer(x, cos, sin, segment_ids, lc, positions)
        x = self.final_norm(x)
        if logit_positions is not None:
            x = torch.gather(
                x, 1, logit_positions.long()[:, :, None].expand(
                    -1, -1, x.shape[-1]))
        if self.lm_head is None:
            logits = x @ self.tok_embed.t()
        else:
            logits = self.lm_head(x)
        return (logits, cache) if cache is not None else logits
