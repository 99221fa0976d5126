"""MoE checkpoints in the PyTorch port against the JAX package's, on the
CPU in float32 at debug size: model_type 'mixtral' (debug-moe) and
'qwen3_moe' (q/k norms, a decoupled head_dim, 8 experts top-2), each
written once per module by the reference's save_hf_mixtral_checkpoint.

  * config_from_hf and load_mixtral_config equal to the reference's, and
    load_mixtral_config's refusals (norm_topk_prob false, dense layers
    interleaved) with the reference's messages;
  * the reference's checkpoints loaded by the port's load_checkpoint:
    a MixtralModel whose logits equal the same tree through
    params_from_jax bit for bit; the port's save_hf_mixtral_checkpoint
    read by the reference's load_mixtral_params: logits equal the
    reference model's on its own tree;
  * the int8 stream load equal to quantize_params of the float load
    (router float), int4 refused;
  * build_engine(checkpoint=) serving a MoE checkpoint (the serving
    capacity factor; the greedy stream equal to the in-memory model's
    engine), and refusing a LoRA stack on it.
"""
import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.models import weights as jax_weights
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, moe, quant, weights

MAX_SEQ = 64
_DEBUG, _DEBUG_MOE = jax_moe.MIXTRAL_CONFIGS['debug-moe']
MODELS = {
    'mixtral': (dataclasses.replace(_DEBUG, max_seq_len=MAX_SEQ),
                _DEBUG_MOE),
    'qwen3_moe': (dataclasses.replace(_DEBUG, max_seq_len=MAX_SEQ,
                                      qk_norm=True, norm_eps=1e-6,
                                      rope_theta=1e6, head_dim_override=32),
                  jax_moe.MoeConfig(num_experts=8, experts_per_token=2)),
}
_PORT_KW = dict(device='cpu', dtype='float32', param_dtype='float32',
                remat=False, max_seq_len=MAX_SEQ)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    return llama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(
                                    llama.LlamaConfig)})


def port_moe(jmoe):
    return moe.MoeConfig(**dataclasses.asdict(jmoe))


@pytest.fixture(scope='module')
def trees():
    """{type: (jax model, params)}: the reference model's tree layout
    (jax.eval_shape of its init) drawn with numpy, every norm weight
    1 + N(0, 0.3)."""
    out = {}
    for i, (kind, (jcfg, jmoe)) in enumerate(MODELS.items()):
        jm = jax_moe.MixtralModel(jcfg, jmoe)
        shapes = nn.meta.unbox(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
        rng = np.random.default_rng(20 + i)

        def draw(path, x):
            key = jax.tree_util.keystr(path)
            if 'norm' in key:
                return (1 + rng.normal(0, 0.3, x.shape)).astype(x.dtype)
            std = 0.02 if 'tok_embed' in key else x.shape[-2] ** -0.5
            return rng.normal(0, std, x.shape).astype(x.dtype)
        out[kind] = (jm, {'params': jax.tree_util.tree_map_with_path(
            draw, shapes['params'])})
    return out


@pytest.fixture(scope='module')
def ref_ckpts(trees, tmp_path_factory):
    """{type: dir} written by the reference's save_hf_mixtral_checkpoint."""
    out = {}
    for kind, (jm, jp) in trees.items():
        d = str(tmp_path_factory.mktemp(f'ref_{kind}'))
        jax_weights.save_hf_mixtral_checkpoint(jm.cfg, jm.moe, jp, d)
        out[kind] = d
    return out


def port_model(jp, jm):
    pcfg = port_cfg(jm.cfg)
    model = moe.MixtralModel(pcfg, port_moe(jm.moe))
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), pcfg))
    return model.eval()


def _tokens():
    return np.random.default_rng(2).integers(0, 256, (2, 12))


# -------------------------------------------------------------- config
@pytest.mark.parametrize('kind', list(MODELS))
def test_configs_match_the_reference(ref_ckpts, kind):
    d = ref_ckpts[kind]
    hf = json.load(open(f'{d}/config.json'))
    assert hf['model_type'] == kind
    assert weights.config_from_hf(hf) == port_cfg(
        jax_weights.config_from_hf(hf))
    cfg, moe_cfg = weights.load_mixtral_config(d)
    jcfg, jmoe = jax_weights.load_mixtral_config(d)
    assert cfg == port_cfg(jcfg)
    assert dataclasses.asdict(moe_cfg) == dataclasses.asdict(jmoe)
    assert cfg.mlp_dim == MODELS[kind][0].mlp_dim


@pytest.mark.parametrize('bad', [{'norm_topk_prob': False},
                                 {'decoder_sparse_step': 2},
                                 {'mlp_only_layers': [1]}],
                         ids=['norm_topk_prob', 'sparse_step', 'mlp_only'])
def test_load_mixtral_config_refusals(ref_ckpts, bad, tmp_path):
    hf = json.load(open(f'{ref_ckpts["qwen3_moe"]}/config.json'))
    with open(tmp_path / 'config.json', 'w') as f:
        json.dump({**hf, **bad}, f)
    with pytest.raises(NotImplementedError) as ref:
        jax_weights.load_mixtral_config(str(tmp_path))
    with pytest.raises(NotImplementedError) as got:
        weights.load_mixtral_config(str(tmp_path))
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------- round trips
@pytest.mark.parametrize('kind', list(MODELS))
def test_reference_checkpoint_loads_in_the_port(trees, ref_ckpts, kind):
    jm, jp = trees[kind]
    cfg, moe_cfg, model = weights.load_checkpoint(ref_ckpts[kind],
                                                  **_PORT_KW)
    assert isinstance(model, moe.MixtralModel)
    assert cfg == port_cfg(jm.cfg)
    assert moe_cfg == port_moe(jm.moe)
    toks = torch.as_tensor(_tokens())
    with torch.no_grad():
        assert torch.equal(model(toks), port_model(jp, jm)(toks))


@pytest.mark.parametrize('kind', list(MODELS))
def test_port_checkpoint_loads_in_the_reference(trees, kind, tmp_path):
    jm, jp = trees[kind]
    weights.save_hf_mixtral_checkpoint(port_cfg(jm.cfg), port_moe(jm.moe),
                                       port_model(jp, jm), str(tmp_path))
    assert weights.checkpoint_model_type(str(tmp_path)) == kind
    jcfg, jmoe = jax_weights.load_mixtral_config(
        str(tmp_path), max_seq_len=MAX_SEQ, dtype='float32',
        param_dtype='float32', remat=False)
    assert (jcfg, jmoe) == (jm.cfg, jm.moe)   # so jm's apply serves both
    loaded = jax_weights.load_mixtral_params(jcfg, jmoe, str(tmp_path))
    toks = jnp.asarray(_tokens(), jnp.int32)
    apply = jax.jit(jm.apply)
    np.testing.assert_array_equal(np.asarray(apply(loaded, toks)),
                                  np.asarray(apply(jp, toks)))


@pytest.mark.parametrize('kind', list(MODELS))
def test_int8_load_equals_quantize_params(trees, ref_ckpts, kind):
    jm, _ = trees[kind]
    cfg, moe_cfg = port_cfg(jm.cfg), port_moe(jm.moe)
    want = quant.quantize_params(weights.load_mixtral_params(
        cfg, moe_cfg, ref_ckpts[kind], device='cpu'), 'int8')
    got = weights.load_mixtral_params(cfg, moe_cfg, ref_ckpts[kind],
                                      quantize='int8', device='cpu')
    assert set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert got['layers.1.moe_mlp.router'].dtype == torch.float32
    assert got['layers.1.moe_mlp.w_gate'].dtype == torch.int8
    with pytest.raises(NotImplementedError, match='MoE expert weights'):
        weights.load_mixtral_params(cfg, moe_cfg, ref_ckpts[kind],
                                    quantize='int4', device='cpu')


def test_quantized_state_dict_is_not_written(trees, tmp_path):
    jm, jp = trees['mixtral']
    sd = quant.quantize_params(port_model(jp, jm).state_dict(), 'int8')
    with pytest.raises(ValueError, match='quantized'):
        weights.save_hf_mixtral_checkpoint(port_cfg(jm.cfg),
                                           port_moe(jm.moe), sd,
                                           str(tmp_path))


# --------------------------------------------------------- build_engine
@pytest.mark.parametrize('kind', list(MODELS))
def test_build_engine_serves_a_moe_checkpoint(trees, ref_ckpts, kind):
    jm, jp = trees[kind]
    eng = torch_server.build_engine(checkpoint=ref_ckpts[kind],
                                    num_slots=2, max_seq_len=MAX_SEQ,
                                    dtype='float32', device='cpu',
                                    page_size=16)
    assert eng.model.moe.capacity_factor == torch_server.MOE_SERVE_CAPACITY
    model = moe.MixtralModel(port_cfg(jm.cfg), dataclasses.replace(
        port_moe(jm.moe), capacity_factor=torch_server.MOE_SERVE_CAPACITY))
    model.load_state_dict(port_model(jp, jm).state_dict())
    ref = torch_engine.InferenceEngine(model.eval(), num_slots=2,
                                       max_seq_len=MAX_SEQ, page_size=16,
                                       device='cpu')
    prompt = _tokens()[0].tolist()
    sp = torch_engine.SamplingParams(max_new_tokens=6)
    outs = []
    for e in (eng, ref):
        e.start()
        try:
            outs.append(e.generate(prompt, sp))
        finally:
            e.stop()
    assert outs[0] == outs[1] and len(outs[0]) == 6
    with pytest.raises(ValueError, match='LoRA'):
        torch_server.build_engine(checkpoint=ref_ckpts[kind], device='cpu',
                                  dtype='float32', lora_stack={})
