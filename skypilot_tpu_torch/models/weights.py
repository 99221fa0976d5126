"""Weights for the port's Llama model.

params_from_jax is the one place that knows the JAX package's parameter
layout: it maps the tree skypilot_tpu's LlamaModel.init returns (with
its leaves already converted to numpy arrays by the caller) to this
package's LlamaModel state_dict. Dense kernels are [in, out] there and
[out, in] here; the scanned layer stack carries a leading L axis
(params['layers'][...]), the unscanned one names each block layer_{i}.
"""
from typing import Any, Dict, Mapping

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import LlamaConfig

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
    top-level 'params' collection) -> LlamaModel state_dict (CPU
    tensors; load_state_dict copies them to the model's device and
    dtype)."""
    if 'params' in tree:
        tree = tree['params']
    scanned = 'layers' in tree
    sd: Dict[str, torch.Tensor] = {'tok_embed': to_tensor(tree['tok_embed'])}
    for i in range(cfg.n_layers):
        blk = _block_tree(tree, i, cfg, scanned)
        pre = f'layers.{i}.'
        for name in _ATTN:
            sd[f'{pre}attn.{name}.weight'] = to_tensor(
                np.asarray(blk['attn'][name]['kernel']).T)
        for name in _MLP:
            sd[f'{pre}mlp.{name}.weight'] = to_tensor(
                np.asarray(blk['mlp'][name]['kernel']).T)
        sd[f'{pre}attn_norm.weight'] = to_tensor(blk['attn_norm']['weight'])
        sd[f'{pre}mlp_norm.weight'] = to_tensor(blk['mlp_norm']['weight'])
    sd['final_norm.weight'] = to_tensor(tree['final_norm']['weight'])
    if not cfg.tie_embeddings:
        sd['lm_head.weight'] = to_tensor(
            np.asarray(tree['lm_head']['kernel']).T)
    return sd


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
