"""Weights for the port's Llama model.

params_from_jax is the one place that knows the JAX package's parameter
layout: it maps the tree skypilot_tpu's LlamaModel.init returns (with
its leaves already converted to numpy arrays by the caller) to this
package's LlamaModel state_dict. Dense kernels are [in, out] there and
[out, in] here; the scanned layer stack carries a leading L axis
(params['layers'][...]), the unscanned one names each block layer_{i}.
Each leaf keeps its dtype (the training trees' f32 masters stay f32);
load_state_dict then copies it into the model's param_dtype. A gradient
tree of the same layout (jax.grad of the params) maps the same way. So
does a Gemma tree: tied (no lm_head), zero-centred norm weights as
stored (the model applies 1 + w), and projections between dim and
heads*head_dim, which differ there (gemma-7b: 3072 and 4096). A
quantized tree (the reference's quantize_params: int8 `kernel` + `scale`,
or ml_dtypes int4 kernels with group scales) maps to the QuantLinear /
QuantLinear4 layout, int4 codes read through a numpy int8 cast. The
family leaves cross too: Qwen2's q/k/v biases (a float `bias` beside a
kernel, quantized or not), Qwen3's attn q_norm / k_norm and Gemma-2's
attn_post_norm / mlp_post_norm. A MixtralModel tree (models/moe.py)
maps the same way, each block's moe_mlp scope to the router [E, dim]
and the expert weights [E, out, in] (their int8 codes and
`<name>_scale` when quantized).

HF checkpoints (the counterparts of skypilot_tpu/models/weights.py's
functions of the same names, for the llama, mistral, gemma, qwen2, qwen3,
gemma2 and phi3 families; Phi-3's fused qkv_proj and gate_up_proj are
split on load by row reads of the fused tensor and fused again on save):
config_from_hf / config_to_hf / load_config / checkpoint_model_type,
load_llama_params (safetensors -> the port's state_dict on a device;
with quantize, each projection quantized as it leaves the reader, so the
float model is never whole in memory), load_checkpoint (config + model,
the family routing) and save_hf_checkpoint (config.json + one
model.safetensors). The port keeps HF's [out, in] weights: no transpose.
MoE checkpoints (model_type mixtral and qwen3_moe, the reference's two
_MOE_SCHEMES): load_mixtral_config (with the reference's refusals),
load_mixtral_params (each expert weight stacked from its E tensors on the
device, int8 quantized there as it loads; the router stays float) and
save_hf_mixtral_checkpoint. The safetensors format is read and written
by models/safetensors_io.py.
"""
import dataclasses
import json
import os
import re
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Tuple,
                    Union)

import numpy as np
import torch

from skypilot_tpu_torch.models import quant as quant_lib
from skypilot_tpu_torch.models import safetensors_io
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

_ATTN = ('wq', 'wk', 'wv', 'wo')
_MLP = ('w_gate', 'w_up', 'w_down')


def to_tensor(arr: Any) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor of
    its own."""
    a = np.asarray(arr)
    if a.dtype.name == 'bfloat16':   # ml_dtypes bfloat16: reinterpret
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _block_tree(tree: Mapping[str, Any], i: int, cfg: LlamaConfig,
                scanned: bool) -> Mapping[str, Any]:
    if not scanned:
        return tree[f'layer_{i}']

    def take(node):
        if isinstance(node, Mapping):
            return {k: take(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f'scanned leaf has leading axis {arr.shape[0]}'
                             f', expected n_layers={cfg.n_layers}')
        return arr[i]
    return take(tree['layers'])


def params_from_jax(tree: Mapping[str, Any],
                    cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX LlamaModel param tree (numpy leaves; with or without the
    top-level 'params' collection; scanned or unscanned) -> LlamaModel
    state_dict (CPU tensors in the leaves' own dtypes; load_state_dict
    copies them to the model's device and param_dtype)."""
    if 'params' in tree:
        tree = tree['params']
    scanned = 'layers' in tree
    sd: Dict[str, torch.Tensor] = {'tok_embed': to_tensor(tree['tok_embed'])}
    for i in range(cfg.n_layers):
        blk = _block_tree(tree, i, cfg, scanned)
        pre = f'layers.{i}.'
        for name in _ATTN:
            sd.update(_projection(f'{pre}attn.{name}.', blk['attn'][name]))
        if 'moe_mlp' in blk:
            sd.update(_moe_mlp(f'{pre}moe_mlp.', blk['moe_mlp']))
        else:
            for name in _MLP:
                sd.update(_projection(f'{pre}mlp.{name}.',
                                      blk['mlp'][name]))
        for name in ('q_norm', 'k_norm'):
            if cfg.qk_norm:
                sd[f'{pre}attn.{name}.weight'] = to_tensor(
                    blk['attn'][name]['weight'])
        norms = ('attn_norm', 'mlp_norm') + (
            ('attn_post_norm', 'mlp_post_norm') if cfg.sandwich_norms
            else ())
        for name in norms:
            sd[f'{pre}{name}.weight'] = to_tensor(blk[name]['weight'])
    sd['final_norm.weight'] = to_tensor(tree['final_norm']['weight'])
    if not cfg.tie_embeddings:
        sd.update(_projection('lm_head.', tree['lm_head']))
    return sd


def _projection(prefix: str, node: Mapping[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """A JAX Dense / QuantDense / QuantDense4 scope ({'kernel': [in,
    out]} plus 'scale' when quantized, 'bias' where the projection has
    one) -> the port's '<prefix>weight' [out, in] (and '<prefix>scale',
    '<prefix>bias'). int4 kernels (ml_dtypes int4) are read through a
    numpy int8 cast and packed two a byte."""
    kernel = np.asarray(node['kernel'])
    out = {}
    if 'bias' in node:
        out[prefix + 'bias'] = to_tensor(node['bias'])
    if 'scale' not in node:
        out[prefix + 'weight'] = to_tensor(kernel.T)
        return out
    out[prefix + 'scale'] = to_tensor(np.asarray(node['scale'], np.float32))
    if kernel.dtype.name == 'int4':
        codes = torch.from_numpy(np.ascontiguousarray(
            kernel.astype(np.int8).T))
        out[prefix + 'weight'] = quant_lib.pack_int4(codes)
    else:
        out[prefix + 'weight'] = to_tensor(kernel.T)
    return out


def _moe_mlp(prefix: str, node: Mapping[str, Any]
             ) -> Dict[str, torch.Tensor]:
    """A JAX MoeMLP scope (router [dim, E]; experts [E, in, out], or
    int8 with '<name>_scale' [E, out]) -> the port's router [E, dim] and
    experts [E, out, in] (and their scales)."""
    out = {prefix + 'router': to_tensor(np.asarray(node['router']).T)}
    for name in quant_lib.MOE_EXPERT_KEYS:
        out[prefix + name] = to_tensor(np.swapaxes(np.asarray(node[name]),
                                                   -1, -2))
        if name + '_scale' in node:
            out[prefix + name + '_scale'] = to_tensor(
                np.asarray(node[name + '_scale'], np.float32))
    return out


def lora_stack_from_jax(stack: Mapping[str, Any],
                        cfg: LlamaConfig) -> Dict[str, Any]:
    """JAX multi-LoRA stack (skypilot_tpu/infer/lora.py build_stack or
    build_stack_assigned, numpy leaves; scanned {'layers': {'attn':
    {'wq_ab': {'a': [L, N, in, r], 'b': [L, N, r, out]}}}} or unscanned
    {'layer_3': {...: {'a': [N, in, r], ...}}}, plus 'scaling' [N]) ->
    the port's stack (infer/lora.py): {'layers.3.attn.wq': (a [N, in, r],
    b [N, r, out]), ..., 'scaling': [N] f32}, CPU tensors in the leaves'
    dtype (the engine places them on its device)."""
    from skypilot_tpu_torch.infer import lora as lora_lib
    out: Dict[str, Any] = {}

    def walk(node, path):
        for k, v in node.items():
            if path == () and k == 'scaling':
                continue
            if 'a' in v and 'b' in v and not isinstance(v['a'], Mapping):
                a, b = np.asarray(v['a']), np.asarray(v['b'])
                if path and path[0] == 'layers' and \
                        a.shape[0] != cfg.n_layers:
                    raise ValueError(
                        f'scanned leaf has leading axis {a.shape[0]}, '
                        f'expected n_layers={cfg.n_layers}')
                for key, ak, bk in lora_lib.module_entries(path + (k,), a,
                                                           b):
                    out[key] = (to_tensor(ak), to_tensor(bk))
            else:
                walk(v, path + (k,))
    walk(stack, ())
    out['scaling'] = to_tensor(np.asarray(stack['scaling'], np.float32))
    return out


# ------------------------------------------------------- HF checkpoints
# The port's state_dict keys <-> HF Llama names (the reference's
# _TOP_MAP and _LAYER_MAP; both sides [out, in], no transpose).
_TOP_MAP = {'tok_embed': 'model.embed_tokens.weight',
            'final_norm.weight': 'model.norm.weight',
            'lm_head.weight': 'lm_head.weight'}
_LAYER_MAP = {
    'attn_norm.weight': 'input_layernorm.weight',
    'attn.wq.weight': 'self_attn.q_proj.weight',
    'attn.wk.weight': 'self_attn.k_proj.weight',
    'attn.wv.weight': 'self_attn.v_proj.weight',
    'attn.wo.weight': 'self_attn.o_proj.weight',
    'mlp_norm.weight': 'post_attention_layernorm.weight',
    'mlp.w_gate.weight': 'mlp.gate_proj.weight',
    'mlp.w_up.weight': 'mlp.up_proj.weight',
    'mlp.w_down.weight': 'mlp.down_proj.weight',
}
# Qwen2's q/k/v biases (the reference's _ATTN_BIAS_MAP).
_ATTN_BIAS_MAP = {
    'attn.wq.bias': 'self_attn.q_proj.bias',
    'attn.wk.bias': 'self_attn.k_proj.bias',
    'attn.wv.bias': 'self_attn.v_proj.bias',
}
# Qwen3's per-head q/k norms, [head_dim] (the reference's _QK_NORM_MAP).
_QK_NORM_MAP = {
    'attn.q_norm.weight': 'self_attn.q_norm.weight',
    'attn.k_norm.weight': 'self_attn.k_norm.weight',
}
# Gemma-2's four per-layer norms: HF's post_attention_layernorm is the
# post-attention sandwich norm there (Llama's pre-MLP norm), and the MLP
# has pre/post feedforward norms.
_SANDWICH_MAP = {
    'attn_post_norm.weight': 'post_attention_layernorm.weight',
    'mlp_norm.weight': 'pre_feedforward_layernorm.weight',
    'mlp_post_norm.weight': 'post_feedforward_layernorm.weight',
}
# MoE tensor naming by model_type (the reference's _MOE_SCHEMES):
# mixtral nests its experts under block_sparse_moe as w1/w3/w2, qwen3_moe
# under mlp with llama's names; `<prefix>.gate.weight` is the router.
_MOE_SCHEMES = {
    'mixtral': ('block_sparse_moe', {'w_gate': 'w1', 'w_up': 'w3',
                                     'w_down': 'w2'}),
    'qwen3_moe': ('mlp', {'w_gate': 'gate_proj', 'w_up': 'up_proj',
                          'w_down': 'down_proj'}),
}
MOE_TYPES = tuple(_MOE_SCHEMES)
# ops/rope.py's Llama-3.1 constants.
_LLAMA31_ROPE = {'factor': 8.0, 'low_freq_factor': 1.0,
                 'high_freq_factor': 4.0,
                 'original_max_position_embeddings': 8192}


def _layer_map(cfg: LlamaConfig) -> Dict[str, str]:
    """A layer's state_dict suffixes -> HF suffixes for cfg's family."""
    m = dict(_LAYER_MAP)
    if cfg.attn_bias:
        m.update(_ATTN_BIAS_MAP)
    if cfg.qk_norm:
        m.update(_QK_NORM_MAP)
    if cfg.sandwich_norms:
        m.update(_SANDWICH_MAP)
    return m


def hf_names(cfg: LlamaConfig) -> Iterator[Tuple[str, str]]:
    """(state_dict key, HF name) for every tensor of cfg's model, layer by
    layer in file order; no lm_head when the embeddings are tied. Phi-3's
    q/k/v and gate/up keep Llama's per-projection names here: the reader
    splits the fused tensors (_FusedSplitView), the writer fuses them."""
    yield 'tok_embed', _TOP_MAP['tok_embed']
    layer_map = _layer_map(cfg)
    for i in range(cfg.n_layers):
        for ours, suffix in layer_map.items():
            yield f'layers.{i}.{ours}', f'model.layers.{i}.{suffix}'
    yield 'final_norm.weight', _TOP_MAP['final_norm.weight']
    if not cfg.tie_embeddings:
        yield 'lm_head.weight', _TOP_MAP['lm_head.weight']


class _FusedSplitView:
    """A reader for hf_layout 'phi3': q/k/v_proj are row ranges of
    self_attn.qkv_proj (q, then k, then v) and gate/up_proj the halves of
    mlp.gate_up_proj, read by rows so the unneeded rows never leave the
    map (the reference's _FusedSplitView); every other name passes
    through."""

    _RE = re.compile(r'(model\.layers\.\d+\.)'
                     r'(?:self_attn\.(q|k|v)_proj|mlp\.(gate|up)_proj)'
                     r'\.weight$')

    def __init__(self, reader: safetensors_io.ShardReader,
                 cfg: LlamaConfig) -> None:
        self._r = reader
        self._cfg = cfg

    def _split(self, name: str) -> Optional[Tuple[str, int, int]]:
        m = self._RE.match(name)
        if m is None:
            return None
        cfg = self._cfg
        if m.group(2):
            q_rows = cfg.n_heads * cfg.head_dim
            kv_rows = cfg.n_kv_heads * cfg.head_dim
            lo = {'q': 0, 'k': q_rows, 'v': q_rows + kv_rows}[m.group(2)]
            hi = lo + (q_rows if m.group(2) == 'q' else kv_rows)
            return m.group(1) + 'self_attn.qkv_proj.weight', lo, hi
        lo = 0 if m.group(3) == 'gate' else cfg.mlp_dim
        return m.group(1) + 'mlp.gate_up_proj.weight', lo, lo + cfg.mlp_dim

    def __contains__(self, name: str) -> bool:
        split = self._split(name)
        return (split[0] if split else name) in self._r

    def get(self, name: str) -> torch.Tensor:
        split = self._split(name)
        return self._r.get(name) if split is None else \
            self._r.get_rows(*split)


def _fuse_phi3(tensors: List[Tuple[str, torch.Tensor]],
               cfg: LlamaConfig) -> List[Tuple[str, torch.Tensor]]:
    """Phi-3's checkpoint layout from Llama-named tensors: each layer's
    q/k/v_proj rows concatenated into qkv_proj and gate/up_proj into
    gate_up_proj (HF [out, in]: along the rows), as the reference's save
    fuses them."""
    out = dict(tensors)
    for i in range(cfg.n_layers):
        pre = f'model.layers.{i}.'
        out[pre + 'self_attn.qkv_proj.weight'] = torch.cat(
            [out.pop(pre + f'self_attn.{p}_proj.weight') for p in 'qkv'])
        out[pre + 'mlp.gate_up_proj.weight'] = torch.cat(
            [out.pop(pre + f'mlp.{p}_proj.weight') for p in ('gate', 'up')])
    return list(out.items())


def config_from_hf(hf_config: Mapping[str, Any], **overrides) -> LlamaConfig:
    """HF config.json dict -> LlamaConfig: model_type 'llama' maps 1:1
    (Llama-3.1 rope_scaling checked against ops/rope.py's constants),
    'qwen2' adds the q/k/v biases (and ignores sliding_window), 'qwen3'
    the q/k norms (attention_bias from the config), 'mistral' the sliding
    window, 'phi3' the fused layout and its window, 'gemma' GeGLU,
    zero-centred norms, the sqrt(dim) embedding scale and tied
    embeddings, 'gemma2' those plus the sandwich norms, the soft-caps,
    the 1/sqrt(query_pre_attn_scalar) scale and windows on every other
    layer; a head_dim that is not dim / heads becomes head_dim_override.
    The MoE types map their attention: 'mixtral' as llama, 'qwen3_moe' as
    qwen3 (load_mixtral_config adds the expert sizes)."""
    model_type = hf_config.get('model_type', 'llama')
    rope_scaling = hf_config.get('rope_scaling') or {}
    rs_type = rope_scaling.get('rope_type', rope_scaling.get('type'))
    if rs_type not in (None, 'default', 'llama3'):
        # longrope/yarn/etc. would silently produce wrong positions.
        raise ValueError(
            f'unsupported rope_scaling type {rs_type!r} in checkpoint '
            f'config (supported: llama3); long-context variants using '
            f'longrope/yarn are not implemented')
    if rs_type == 'llama3':
        # A different factor set (Llama-3.2's factor=32) would silently
        # serve wrong long-context positions.
        got = {k: rope_scaling.get(k) for k in _LLAMA31_ROPE}
        if any(got[k] is not None and float(got[k]) != v
               for k, v in _LLAMA31_ROPE.items()):
            raise ValueError(
                f'llama3 rope_scaling with non-3.1 factors is not '
                f'implemented: checkpoint has {got}, ops/rope.py '
                f'implements {_LLAMA31_ROPE}')
    kw = dict(
        vocab_size=hf_config['vocab_size'],
        dim=hf_config['hidden_size'],
        n_layers=hf_config['num_hidden_layers'],
        n_heads=hf_config['num_attention_heads'],
        n_kv_heads=hf_config.get('num_key_value_heads',
                                 hf_config['num_attention_heads']),
        mlp_dim=hf_config['intermediate_size'],
        max_seq_len=hf_config.get('max_position_embeddings', 8192),
        rope_theta=hf_config.get('rope_theta', 500000.0),
        use_llama31_rope=rs_type == 'llama3',
        norm_eps=hf_config.get('rms_norm_eps', 1e-5),
        tie_embeddings=hf_config.get('tie_word_embeddings', False),
    )
    if model_type == 'qwen2':
        # HF Qwen2Attention always has q/k/v biases (no config field).
        kw['attn_bias'] = True
    elif model_type in ('qwen3', 'qwen3_moe'):
        kw['qk_norm'] = True
        kw['attn_bias'] = hf_config.get('attention_bias', False)
    elif model_type == 'mistral':
        # Llama with sliding-window attention on every layer.
        kw['sliding_window'] = hf_config.get('sliding_window') or 0
    elif model_type == 'phi3':
        # Llama math behind fused tensors; the -4k minis carry a window.
        kw['hf_layout'] = 'phi3'
        kw['sliding_window'] = hf_config.get('sliding_window') or 0
    elif model_type in ('gemma', 'gemma2'):
        kw['mlp_act'] = 'gelu_tanh'
        kw['norm_zero_centered'] = True
        kw['embed_scale'] = True
        kw['tie_embeddings'] = hf_config.get('tie_word_embeddings', True)
    if model_type == 'gemma2':
        kw['sandwich_norms'] = True
        kw['sliding_window'] = hf_config.get('sliding_window') or 0
        # HF Gemma2: even layers windowed, odd ones global.
        kw['window_pattern'] = 2
        kw['attn_softcap'] = hf_config.get('attn_logit_softcapping') or 0.0
        kw['final_softcap'] = hf_config.get('final_logit_softcapping') \
            or 0.0
        qpas = hf_config.get('query_pre_attn_scalar')
        if qpas:
            kw['attn_scale'] = float(qpas) ** -0.5
    head_dim = hf_config.get('head_dim') or 0
    if head_dim and head_dim != kw['dim'] // kw['n_heads']:
        kw['head_dim_override'] = head_dim
    kw.update(overrides)
    return LlamaConfig(**kw)


def config_to_hf(cfg: LlamaConfig) -> Dict[str, Any]:
    """LlamaConfig -> HF config.json dict (what save_hf_checkpoint
    writes): sandwich_norms -> gemma2, norm_zero_centered -> gemma,
    qk_norm -> qwen3, attn_bias -> qwen2, hf_layout 'phi3' -> phi3, a
    sliding window -> mistral, else llama — the inverse of
    config_from_hf, equal to the reference's dict."""
    if cfg.sandwich_norms:
        model_type, arch = 'gemma2', 'Gemma2ForCausalLM'
    elif cfg.norm_zero_centered:
        model_type, arch = 'gemma', 'GemmaForCausalLM'
    elif cfg.qk_norm:
        model_type, arch = 'qwen3', 'Qwen3ForCausalLM'
    elif cfg.attn_bias:
        model_type, arch = 'qwen2', 'Qwen2ForCausalLM'
    elif cfg.hf_layout == 'phi3':
        model_type, arch = 'phi3', 'Phi3ForCausalLM'
    elif cfg.sliding_window > 0:
        model_type, arch = 'mistral', 'MistralForCausalLM'
    else:
        model_type, arch = 'llama', 'LlamaForCausalLM'
    out = {
        'architectures': [arch],
        'model_type': model_type,
        'vocab_size': cfg.vocab_size,
        'hidden_size': cfg.dim,
        'num_hidden_layers': cfg.n_layers,
        'num_attention_heads': cfg.n_heads,
        'num_key_value_heads': cfg.n_kv_heads,
        'intermediate_size': cfg.mlp_dim,
        'max_position_embeddings': cfg.max_seq_len,
        'rope_theta': cfg.rope_theta,
        'rms_norm_eps': cfg.norm_eps,
        'tie_word_embeddings': cfg.tie_embeddings,
        'head_dim': cfg.head_dim,
        'hidden_act': ('gelu_pytorch_tanh'
                       if cfg.mlp_act == 'gelu_tanh' else 'silu'),
        'torch_dtype': 'float32',
    }
    if model_type in ('gemma', 'gemma2'):
        # GemmaConfig reads 'hidden_activation' (hidden_act is legacy).
        out['hidden_activation'] = out['hidden_act']
    if model_type == 'qwen3':
        # HF defaults attention_bias to False: written, so a biased qwen3
        # checkpoint keeps its biases on reload.
        out['attention_bias'] = cfg.attn_bias
    if model_type in ('mistral', 'phi3'):
        out['sliding_window'] = cfg.sliding_window or None
    if model_type == 'phi3':
        # Phi3Config's default pad_token_id 32000 breaks smaller vocabs.
        out['pad_token_id'] = None
    if model_type == 'gemma2':
        out['sliding_window'] = cfg.sliding_window
        out['attn_logit_softcapping'] = cfg.attn_softcap or None
        out['final_logit_softcapping'] = cfg.final_softcap or None
        # Always written: HF's default of 256 would change the scale of a
        # model that uses 1/sqrt(head_dim).
        out['query_pre_attn_scalar'] = round(
            (cfg.attn_scale or cfg.head_dim ** -0.5) ** -2)
    if cfg.use_llama31_rope:
        out['rope_scaling'] = {'rope_type': 'llama3', **_LLAMA31_ROPE}
    return out


def _read_config(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, 'config.json'), encoding='utf-8') as f:
        return json.load(f)


def checkpoint_model_type(ckpt_dir: str) -> str:
    """'llama' | 'mistral' | 'gemma' | ... from config.json."""
    return _read_config(ckpt_dir).get('model_type', 'llama')


def load_config(ckpt_dir: str, **overrides) -> LlamaConfig:
    """config.json of a checkpoint dir -> LlamaConfig."""
    return config_from_hf(_read_config(ckpt_dir), **overrides)


def moe_hf_names(cfg: LlamaConfig, num_experts: int, model_type: str
                 ) -> Iterator[Tuple[str, Union[str, Tuple[str, ...]]]]:
    """hf_names for a MixtralModel of model_type 'mixtral' or
    'qwen3_moe': the attention and norms as the dense families', then
    each layer's router ('<prefix>.gate.weight') and its three expert
    weights, each the tuple of its E per-expert HF names (stacked along
    a leading E axis, HF's [out, in] kept)."""
    prefix, experts = _MOE_SCHEMES[model_type]
    dense = {k: v for k, v in _layer_map(cfg).items()
             if not k.startswith('mlp.')}
    yield 'tok_embed', _TOP_MAP['tok_embed']
    for i in range(cfg.n_layers):
        pre, hf = f'layers.{i}.', f'model.layers.{i}.{prefix}'
        for ours, suffix in dense.items():
            yield pre + ours, f'model.layers.{i}.{suffix}'
        yield pre + 'moe_mlp.router', f'{hf}.gate.weight'
        for ours, theirs in experts.items():
            yield pre + 'moe_mlp.' + ours, tuple(
                f'{hf}.experts.{e}.{theirs}.weight'
                for e in range(num_experts))
    yield 'final_norm.weight', _TOP_MAP['final_norm.weight']
    yield 'lm_head.weight', _TOP_MAP['lm_head.weight']


def _iter_params(cfg: LlamaConfig, ckpt_dir: str, names, param_dtype,
                 quantize: str, device
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(state_dict key, tensor on `device`) one tensor at a time, in the
    order of `names` ((key, HF name or a tuple of HF names to stack)):
    floats cast to param_dtype (default cfg.param_dtype); with quantize,
    each projection, lm_head and expert weight quantized on `device` from
    the checkpoint's own values (the reference's host-side stream
    quantizer quantizes the stored array), yielding its codes and then
    its scale; the embedding, biases, norms and routers stay float. The
    reader's maps are closed when the iteration ends."""
    from skypilot_tpu_torch.models import llama
    if quantize not in ('none',) + quant_lib.MODES:
        raise ValueError(f'unknown quantize mode {quantize!r}')
    dtype = llama.torch_dtype(param_dtype or cfg.param_dtype)
    device = torch.device(device)
    with safetensors_io.ShardReader(ckpt_dir) as shards:
        reader = _FusedSplitView(shards, cfg) if cfg.hf_layout == 'phi3' \
            else shards
        for key, hf_name in names:
            if hf_name not in reader and key == 'lm_head.weight':
                # A tied checkpoint loaded into an untied config: the
                # embedding is the head ([vocab, dim] on both sides).
                hf_name = _TOP_MAP['tok_embed']
                logger.info('lm_head tied to embeddings in checkpoint')
            stack = isinstance(hf_name, tuple)
            for name in (hf_name if stack else (hf_name,)):
                if name not in reader:
                    raise KeyError(f'{ckpt_dir}: no tensor {name} '
                                   f'(for {key})')
            raw = _stacked(reader, hf_name, device) if stack \
                else reader.get(hf_name)
            if quantize != 'none' and raw.dim() >= 2 and \
                    key != 'tok_embed' and not key.endswith('.router'):
                codes, scale = quant_lib.quantize_weight(
                    raw.to(device), quantize) if raw.dim() == 2 else \
                    quant_lib.quantize_kernel(raw)
                del raw
                yield key, codes
                yield quant_lib.scale_key(key), scale
            else:
                t = raw.to(device=device, dtype=dtype, copy=not stack)
                del raw
                yield key, t


def _stacked(reader, names: Tuple[str, ...], device) -> torch.Tensor:
    """The tensors `names` (one shape) stacked along a new leading axis,
    straight onto `device` one tensor at a time, in the file's dtype."""
    first = reader.get(names[0])
    out = torch.empty((len(names),) + tuple(first.shape), dtype=first.dtype,
                      device=device)
    for e, name in enumerate(names):
        out[e].copy_(reader.get(name))
    return out


def iter_llama_params(cfg: LlamaConfig, ckpt_dir: str, *,
                      param_dtype: Optional[str] = None,
                      quantize: str = 'none',
                      device: Union[str, torch.device] = 'cpu'
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """A dense checkpoint's state_dict, one tensor at a time in file
    order (_iter_params): each projection and lm_head quantized as it
    leaves the reader when asked."""
    return _iter_params(cfg, ckpt_dir, hf_names(cfg), param_dtype,
                        quantize, device)


def load_llama_params(cfg: LlamaConfig, ckpt_dir: str, *,
                      param_dtype: Optional[str] = None,
                      quantize: str = 'none',
                      device: Union[str, torch.device, None] = None
                      ) -> Dict[str, torch.Tensor]:
    """HF Llama-layout checkpoint dir -> the port's LlamaModel state_dict
    on `device` (None -> 'cuda', raising without CUDA; the CPU only when
    named), floats in param_dtype (default cfg.param_dtype).

    quantize 'int8' | 'int4': each projection and lm_head is quantized
    as it leaves the reader, on the device, so the float weights are
    never whole in memory (the reference's _make_store); the result is
    the state_dict of the model with quant=quantize, equal to
    quant.quantize_params of the float load where the checkpoint's dtype
    is param_dtype. The tensors are the caller's own: load them with
    load_state_dict(sd, assign=True) to keep one copy."""
    from skypilot_tpu_torch.utils import device as device_lib
    dev = device_lib.resolve_device(device)
    sd = dict(iter_llama_params(cfg, ckpt_dir, param_dtype=param_dtype,
                                quantize=quantize, device=dev))
    logger.info('loaded %d-layer llama params from %s (quantize=%s, %s)',
                cfg.n_layers, ckpt_dir, quantize, dev)
    return sd


def load_mixtral_config(ckpt_dir: str, **overrides):
    """config.json of a mixtral or qwen3_moe checkpoint -> (LlamaConfig,
    MoeConfig), with the reference's refusals: a qwen3_moe checkpoint
    must renormalise its top-k gates (norm_topk_prob) and route in every
    layer (no decoder_sparse_step / mlp_only_layers); its experts are
    sized by moe_intermediate_size."""
    from skypilot_tpu_torch.models import moe as moe_lib
    hf = _read_config(ckpt_dir)
    if hf.get('model_type') == 'qwen3_moe':
        if not hf.get('norm_topk_prob', False):
            raise NotImplementedError(
                'qwen3_moe with norm_topk_prob=false is not supported')
        if hf.get('decoder_sparse_step', 1) != 1 or \
                hf.get('mlp_only_layers'):
            raise NotImplementedError(
                'qwen3_moe with dense layers interleaved '
                '(decoder_sparse_step/mlp_only_layers) is not '
                'supported — every layer must be MoE')
        overrides.setdefault('mlp_dim', hf['moe_intermediate_size'])
    cfg = config_from_hf(hf, **overrides)
    moe_cfg = moe_lib.MoeConfig(
        num_experts=hf.get('num_experts', hf.get('num_local_experts', 8)),
        experts_per_token=hf.get('num_experts_per_tok', 2))
    return cfg, moe_cfg


def load_mixtral_params(cfg: LlamaConfig, moe_cfg, ckpt_dir: str, *,
                        param_dtype: Optional[str] = None,
                        quantize: str = 'none',
                        device: Union[str, torch.device, None] = None
                        ) -> Dict[str, torch.Tensor]:
    """A mixtral or qwen3_moe checkpoint dir -> the port's MixtralModel
    state_dict on `device` (None -> 'cuda'), floats in param_dtype.
    quantize 'int8': the attention projections, lm_head and each expert
    weight quantized on the device as it loads (a layer's expert weight
    is the only float one resident), the router float; 'int4' raises, as
    the reference's loader does."""
    from skypilot_tpu_torch.utils import device as device_lib
    if quantize == 'int4':
        raise NotImplementedError(quant_lib.INT4_MOE)
    dev = device_lib.resolve_device(device)
    names = moe_hf_names(cfg, moe_cfg.num_experts,
                         checkpoint_model_type(ckpt_dir))
    sd = dict(_iter_params(cfg, ckpt_dir, names, param_dtype, quantize,
                           dev))
    logger.info('loaded %d-layer %d-expert mixtral params from %s '
                '(quantize=%s, %s)', cfg.n_layers, moe_cfg.num_experts,
                ckpt_dir, quantize, dev)
    return sd


def load_checkpoint(ckpt_dir: str, *, quantize: str = 'none',
                    param_dtype: Optional[str] = None,
                    device: Union[str, torch.device, None] = None,
                    capacity_factor: Optional[float] = None,
                    **config_overrides):
    """Family-dispatching loader -> (cfg, moe_cfg, model): the config
    from config.json (with quant=quantize), and a model on `device`
    holding the checkpoint's weights (built on the meta device, the
    loaded tensors assigned: one copy of the weights): a LlamaModel
    (moe_cfg None), or a MixtralModel for mixtral / qwen3_moe, whose
    MoeConfig takes capacity_factor when given (serving's 8.0)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import moe as moe_lib
    from skypilot_tpu_torch.utils import device as device_lib
    moe_cfg = None
    if checkpoint_model_type(ckpt_dir) in MOE_TYPES:
        cfg, moe_cfg = load_mixtral_config(ckpt_dir, **config_overrides)
        if capacity_factor is not None:
            moe_cfg = dataclasses.replace(moe_cfg,
                                          capacity_factor=capacity_factor)
    else:
        cfg = load_config(ckpt_dir, **config_overrides)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, quant=quantize)
    dev = device_lib.resolve_device(device)
    if moe_cfg is None:
        model = llama.LlamaModel(cfg, device='meta')
        sd = load_llama_params(cfg, ckpt_dir, quantize=quantize, device=dev)
    else:
        model = moe_lib.MixtralModel(cfg, moe_cfg, device='meta')
        sd = load_mixtral_params(cfg, moe_cfg, ckpt_dir, quantize=quantize,
                                 device=dev)
    model.load_state_dict(sd, assign=True)
    return cfg, moe_cfg, model


def save_hf_checkpoint(cfg: LlamaConfig,
                       state_dict: Union[Mapping[str, torch.Tensor],
                                         torch.nn.Module],
                       out_dir: str) -> int:
    """Inverse of load_llama_params: config.json (config_to_hf) and one
    model.safetensors of the float state_dict (or module), each tensor in
    its own dtype, copied to the host one at a time. Returns the bytes
    of model.safetensors.

    A mapped tensor absent from the state_dict is skipped SILENTLY only
    where the config explains it (tie_embeddings: no lm_head); any other
    miss is logged as a loud warning naming the missing HF tensors (the
    checkpoint will not reload). A quantized state_dict raises: its codes
    under HF's float names would be a broken checkpoint."""
    sd = state_dict.state_dict() if isinstance(state_dict,
                                               torch.nn.Module) \
        else state_dict
    os.makedirs(out_dir, exist_ok=True)
    tensors, missing = _named_tensors(sd, hf_names(cfg))
    if missing:
        logger.warning(
            'save_hf_checkpoint: %d mapped tensor(s) missing from the '
            'state_dict and SKIPPED: the checkpoint at %s will not reload '
            'cleanly (config flag / state_dict mismatch?): %s%s',
            len(missing), out_dir, ', '.join(missing[:8]),
            ' ...' if len(missing) > 8 else '')
    if cfg.hf_layout == 'phi3':
        tensors = _fuse_phi3(tensors, cfg)
    return _write(out_dir, tensors, config_to_hf(cfg))


def _named_tensors(sd: Mapping[str, torch.Tensor], names
                   ) -> Tuple[List[Tuple[str, torch.Tensor]], List[str]]:
    """(HF name, tensor) for each (key, HF name or names) of `names` the
    float state_dict holds (a tuple of names: the key's tensor split
    along its leading axis), and the HF names it lacks. A quantized
    state_dict raises: its codes under HF's float names would be a
    broken checkpoint."""
    scales = [k for k in sd if k.endswith('scale')]
    if scales:
        raise ValueError(f'the HF writers write float weights; the '
                         f'state_dict is quantized ({scales[0]}, ...)')
    tensors, missing = [], []
    for key, hf_name in names:
        if key not in sd:
            missing.append(hf_name)
        elif isinstance(hf_name, tuple):
            tensors.extend(zip(hf_name, sd[key].unbind(0)))
        else:
            tensors.append((hf_name, sd[key]))
    return tensors, missing


def _write(out_dir: str, tensors: List[Tuple[str, torch.Tensor]],
           hf_config: Dict[str, Any]) -> int:
    """model.safetensors (each tensor copied to the host on its own) and
    config.json; returns the bytes of model.safetensors."""
    n = safetensors_io.save_file(
        tensors, os.path.join(out_dir, 'model.safetensors'),
        metadata={'format': 'pt'})
    with open(os.path.join(out_dir, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config, f, indent=2)
    return n


def save_hf_mixtral_checkpoint(cfg: LlamaConfig, moe_cfg,
                               state_dict: Union[Mapping[str, torch.Tensor],
                                                 torch.nn.Module],
                               out_dir: str) -> int:
    """Inverse of load_mixtral_params: a MixtralModel's float state_dict
    (or the module) as an HF checkpoint, model_type 'qwen3_moe' when the
    config has q/k norms, else 'mixtral' (the reference's rule), with the
    reference's config.json keys. Returns the bytes of
    model.safetensors."""
    sd = state_dict.state_dict() if isinstance(state_dict,
                                               torch.nn.Module) \
        else state_dict
    moe_type = 'qwen3_moe' if cfg.qk_norm else 'mixtral'
    tensors, missing = _named_tensors(
        sd, moe_hf_names(cfg, moe_cfg.num_experts, moe_type))
    if missing:
        raise KeyError(f'state_dict lacks {len(missing)} mapped tensor(s): '
                       f'{missing[:4]}')
    hf = config_to_hf(cfg)
    if moe_type == 'qwen3_moe':
        hf.update({'architectures': ['Qwen3MoeForCausalLM'],
                   'model_type': 'qwen3_moe',
                   'num_experts': moe_cfg.num_experts,
                   'num_experts_per_tok': moe_cfg.experts_per_token,
                   'moe_intermediate_size': cfg.mlp_dim,
                   'norm_topk_prob': True,
                   'decoder_sparse_step': 1,
                   'mlp_only_layers': []})
    else:
        hf.update({'architectures': ['MixtralForCausalLM'],
                   'model_type': 'mixtral',
                   'num_local_experts': moe_cfg.num_experts,
                   'num_experts_per_tok': moe_cfg.experts_per_token})
    os.makedirs(out_dir, exist_ok=True)
    return _write(out_dir, tensors, hf)
