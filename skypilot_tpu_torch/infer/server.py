"""Engine factory (counterpart of skypilot_tpu/infer/server.py
build_engine). The HTTP routes are not ported yet.
"""
import dataclasses
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.utils import device as device_lib


def build_engine(model_name: str = 'llama3-8b',
                 num_slots: int = 8,
                 max_seq_len: int = 2048,
                 decode_chunk: int = 16,
                 page_size: int = 64,
                 pool_tokens: Optional[int] = None,
                 dtype: str = 'bfloat16',
                 device=None,
                 seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 prefix_caching: bool = True,
                 spec_decode: int = 0,
                 kv_dtype: str = 'auto',
                 prefill_chunk: int = 0,
                 draft_model_name: Optional[str] = None,
                 lora_stack: Optional[Dict[str, Any]] = None
                 ) -> engine_lib.InferenceEngine:
    """Paged-cache engine serving preset `model_name` on `device`
    (None -> 'cuda'; raises without CUDA unless device='cpu'), weights
    and activations in `dtype`. params: a state_dict to load (for example
    models.weights.params_from_jax of a JAX tree); otherwise random
    weights drawn from a torch.Generator seeded with `seed` on the
    device. pool_tokens / prefix_caching / prefill_chunk / spec_decode /
    kv_dtype / lora_stack pass through to the engine (the page pool's
    size, prefix caching (on by default, as the JAX package's), chunked
    prefill, n-gram speculative decoding, int8 KV, a multi-LoRA stack
    from infer/lora.py, served by SamplingParams.lora_id). A draft model
    (draft_model_name) is not ported and raises."""
    if draft_model_name:
        raise NotImplementedError('the draft-model proposer is not ported; '
                                  'spec_decode uses the n-gram proposer')
    dev = device_lib.resolve_device(device)
    if model_name not in llama.CONFIGS:
        raise ValueError(f'unknown model {model_name!r}; presets: '
                         f'{sorted(llama.CONFIGS)}')
    preset = llama.CONFIGS[model_name]
    cfg = dataclasses.replace(
        preset, dtype=dtype, remat=False,
        max_seq_len=min(preset.max_seq_len, max_seq_len))
    if cfg.param_dtype == 'float32' and cfg.dtype == 'bfloat16':
        # Serving keeps the weights in the compute dtype: an f32 master
        # copy would double the weight bytes every decode step reads.
        cfg = dataclasses.replace(cfg, param_dtype='bfloat16')
    # Built on the meta device, then materialized once on the target:
    # no host copy of the weights and no default init to overwrite.
    model = llama.LlamaModel(cfg, device='meta').to_empty(device=dev)
    if params is not None:
        model.load_state_dict(params)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.init_weights(gen)
    return engine_lib.InferenceEngine(
        model, num_slots=num_slots, max_seq_len=model.cfg.max_seq_len,
        decode_chunk=decode_chunk, page_size=page_size,
        pool_tokens=pool_tokens, prefix_caching=prefix_caching,
        prefill_chunk=prefill_chunk, spec_decode=spec_decode,
        kv_dtype=kv_dtype, device=dev, lora_stack=lora_stack)
