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
QuantLinear4 layout, int4 codes read through a numpy int8 cast.

HF checkpoints (the counterparts of skypilot_tpu/models/weights.py's
functions of the same names, for the llama, mistral and gemma families):
config_from_hf / config_to_hf / load_config / checkpoint_model_type,
load_llama_params (safetensors -> the port's state_dict on a device;
with quantize, each projection quantized as it leaves the reader, so the
float model is never whole in memory), load_checkpoint (config + model,
the family routing) and save_hf_checkpoint (config.json + one
model.safetensors). The port keeps HF's [out, in] weights: no transpose.
The safetensors format is read and written by models/safetensors_io.py.
"""
import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

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
        for name in _MLP:
            sd.update(_projection(f'{pre}mlp.{name}.', blk['mlp'][name]))
        sd[f'{pre}attn_norm.weight'] = to_tensor(blk['attn_norm']['weight'])
        sd[f'{pre}mlp_norm.weight'] = to_tensor(blk['mlp_norm']['weight'])
    sd['final_norm.weight'] = to_tensor(tree['final_norm']['weight'])
    if not cfg.tie_embeddings:
        sd.update(_projection('lm_head.', tree['lm_head']))
    return sd


def _projection(prefix: str, node: Mapping[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """A JAX Dense / QuantDense / QuantDense4 scope ({'kernel': [in,
    out]} plus 'scale' when quantized) -> the port's '<prefix>weight'
    [out, in] (and '<prefix>scale'). int4 kernels (ml_dtypes int4) are
    read through a numpy int8 cast and packed two a byte."""
    kernel = np.asarray(node['kernel'])
    if 'scale' not in node:
        return {prefix + 'weight': to_tensor(kernel.T)}
    scale = to_tensor(np.asarray(node['scale'], np.float32))
    if kernel.dtype.name == 'int4':
        codes = torch.from_numpy(np.ascontiguousarray(
            kernel.astype(np.int8).T))
        return {prefix + 'weight': quant_lib.pack_int4(codes),
                prefix + 'scale': scale}
    return {prefix + 'weight': to_tensor(kernel.T), prefix + 'scale': scale}


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
# Families whose LlamaConfig knobs the port lacks, and MoE checkpoints:
# the ROADMAP queue 1 item each waits for.
_UNPORTED_FAMILIES = {
    'qwen2': 'item 7 (model family knobs: attn_bias)',
    'qwen3': 'item 7 (model family knobs: qk_norm)',
    'gemma2': 'item 7 (model family knobs: sandwich norms, soft-caps)',
    'phi3': 'item 7 (model family knobs: the fused qkv_proj split)',
    'mixtral': 'item 11 (MoE)',
    'qwen3_moe': 'item 11 (MoE)'}
MOE_TYPES = ('mixtral', 'qwen3_moe')
# ops/rope.py's Llama-3.1 constants.
_LLAMA31_ROPE = {'factor': 8.0, 'low_freq_factor': 1.0,
                 'high_freq_factor': 4.0,
                 'original_max_position_embeddings': 8192}


def hf_names(cfg: LlamaConfig) -> Iterator[Tuple[str, str]]:
    """(state_dict key, HF name) for every tensor of cfg's model, layer by
    layer in file order; no lm_head when the embeddings are tied."""
    yield 'tok_embed', _TOP_MAP['tok_embed']
    for i in range(cfg.n_layers):
        for ours, suffix in _LAYER_MAP.items():
            yield f'layers.{i}.{ours}', f'model.layers.{i}.{suffix}'
    yield 'final_norm.weight', _TOP_MAP['final_norm.weight']
    if not cfg.tie_embeddings:
        yield 'lm_head.weight', _TOP_MAP['lm_head.weight']


def config_from_hf(hf_config: Mapping[str, Any], **overrides) -> LlamaConfig:
    """HF config.json dict -> LlamaConfig: model_type 'llama' maps 1:1
    (Llama-3.1 rope_scaling checked against ops/rope.py's constants),
    'mistral' adds the sliding window, 'gemma' GeGLU, zero-centred norms,
    the sqrt(dim) embedding scale, a decoupled head_dim and tied
    embeddings. Families the port's config cannot express yet raise
    NotImplementedError naming their ROADMAP queue 1 item."""
    model_type = hf_config.get('model_type', 'llama')
    if model_type in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f'model_type {model_type!r} is not ported yet: ROADMAP queue 1 '
            f'{_UNPORTED_FAMILIES[model_type]}')
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
    if model_type == 'mistral':
        # Llama with sliding-window attention on every layer.
        kw['sliding_window'] = hf_config.get('sliding_window') or 0
    elif model_type == 'gemma':
        kw['mlp_act'] = 'gelu_tanh'
        kw['norm_zero_centered'] = True
        kw['embed_scale'] = True
        kw['tie_embeddings'] = hf_config.get('tie_word_embeddings', True)
    head_dim = hf_config.get('head_dim') or 0
    if head_dim and head_dim != kw['dim'] // kw['n_heads']:
        kw['head_dim_override'] = head_dim
    kw.update(overrides)
    return LlamaConfig(**kw)


def config_to_hf(cfg: LlamaConfig) -> Dict[str, Any]:
    """LlamaConfig -> HF config.json dict (what save_hf_checkpoint
    writes): norm_zero_centered -> gemma, a sliding window -> mistral,
    else llama — the inverse of config_from_hf, equal to the reference's
    dict for these families."""
    if cfg.norm_zero_centered:
        model_type, arch = 'gemma', 'GemmaForCausalLM'
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
    if model_type == 'gemma':
        # GemmaConfig reads 'hidden_activation' (hidden_act is legacy).
        out['hidden_activation'] = out['hidden_act']
    if model_type == 'mistral':
        out['sliding_window'] = cfg.sliding_window or None
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


def iter_llama_params(cfg: LlamaConfig, ckpt_dir: str, *,
                      param_dtype: Optional[str] = None,
                      quantize: str = 'none',
                      device: Union[str, torch.device] = 'cpu'
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(state_dict key, tensor on `device`) one tensor at a time, in file
    order: floats cast to param_dtype (default cfg.param_dtype); with
    quantize, each projection and lm_head quantized on `device` from the
    checkpoint's own values (the reference's host-side stream quantizer
    quantizes the stored array), yielding its codes and then its
    '.scale'. The reader's maps are closed when the iteration ends."""
    from skypilot_tpu_torch.models import llama
    if quantize not in ('none',) + quant_lib.MODES:
        raise ValueError(f'unknown quantize mode {quantize!r}')
    dtype = llama.torch_dtype(param_dtype or cfg.param_dtype)
    device = torch.device(device)
    with safetensors_io.ShardReader(ckpt_dir) as reader:
        for key, hf_name in hf_names(cfg):
            if hf_name not in reader and key == 'lm_head.weight':
                # A tied checkpoint loaded into an untied config: the
                # embedding is the head ([vocab, dim] on both sides).
                hf_name = _TOP_MAP['tok_embed']
                logger.info('lm_head tied to embeddings in checkpoint')
            if hf_name not in reader:
                raise KeyError(f'{ckpt_dir}: no tensor {hf_name} '
                               f'(for {key})')
            raw = reader.get(hf_name)
            if quantize != 'none' and key != 'tok_embed' and raw.dim() == 2:
                codes, scale = quant_lib.quantize_weight(
                    raw.to(device), quantize)
                del raw
                yield key, codes
                yield key[:-len('weight')] + 'scale', scale
            else:
                t = raw.to(device=device, dtype=dtype, copy=True)
                del raw
                yield key, t


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


def load_checkpoint(ckpt_dir: str, *, quantize: str = 'none',
                    param_dtype: Optional[str] = None,
                    device: Union[str, torch.device, None] = None,
                    **config_overrides):
    """Family-dispatching loader -> (cfg, None, model): the config from
    config.json (with quant=quantize), and a LlamaModel on `device`
    holding the checkpoint's weights (built on the meta device, the
    loaded tensors assigned: one copy of the weights). The None is the
    reference's MoE config slot: MoE checkpoints raise until ROADMAP
    queue 1 item 11."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.utils import device as device_lib
    model_type = checkpoint_model_type(ckpt_dir)
    if model_type in MOE_TYPES:
        raise NotImplementedError(
            f'{ckpt_dir} is a {model_type!r} (MoE) checkpoint: MoE is not '
            f'ported yet: ROADMAP queue 1 {_UNPORTED_FAMILIES[model_type]}')
    cfg = load_config(ckpt_dir, **config_overrides)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, quant=quantize)
    dev = device_lib.resolve_device(device)
    model = llama.LlamaModel(cfg, device='meta')
    model.load_state_dict(load_llama_params(
        cfg, ckpt_dir, quantize=quantize, device=dev), assign=True)
    return cfg, None, model


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
    scales = [k for k in sd if k.endswith('.scale')]
    if scales:
        raise ValueError(f'save_hf_checkpoint writes float weights; the '
                         f'state_dict is quantized ({scales[0]}, ...)')
    os.makedirs(out_dir, exist_ok=True)
    tensors, missing = [], []
    for key, hf_name in hf_names(cfg):
        if key in sd:
            tensors.append((hf_name, sd[key]))
        else:
            missing.append(hf_name)
    if missing:
        logger.warning(
            'save_hf_checkpoint: %d mapped tensor(s) missing from the '
            'state_dict and SKIPPED: the checkpoint at %s will not reload '
            'cleanly (config flag / state_dict mismatch?): %s%s',
            len(missing), out_dir, ', '.join(missing[:8]),
            ' ...' if len(missing) > 8 else '')
    n = safetensors_io.save_file(
        tensors, os.path.join(out_dir, 'model.safetensors'),
        metadata={'format': 'pt'})
    with open(os.path.join(out_dir, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(config_to_hf(cfg), f, indent=2)
    return n
