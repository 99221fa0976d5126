"""The PyTorch port's Mixture-of-Experts model (skypilot_tpu_torch/models/
moe.py) against the JAX package's, on the CPU in float32 at debug size,
the reference run jitted:

  * the three presets equal the reference's MIXTRAL_CONFIGS;
  * MoeMLP against the reference's on the same weights: capacity factor
    1.25 (assignments dropped) and 8.0, top-1 and top-2, and a tiny
    128-expert top-8 layer at factor 8 on rows padded with one repeated
    token, where the reference drops assignments (counted from its
    dispatch tensor; the port keeps the same ones);
  * the layer builds nothing of the reference's [B, S, E, C] size (a
    dispatch mode records every op's output);
  * MixtralModel logits (debug-moe, and a qwen3-moe-like config with q/k
    norms and a decoupled head_dim) through params_from_jax of a scanned
    and an unscanned tree, and on a packed row with segment ids;
  * the paged engine's greedy streams against the JAX engine's on
    debug-moe (prefix caching on: a prefix hit; a ragged burst; n-gram
    speculation);
  * int8 experts: codes and scales bit-equal to the reference's
    quantize_params, int8 logits within 1e-3 of the reference int8
    model's and within the reference's own int8-vs-float bound
    (tests/test_quant.py); int4 raises the reference's error;
  * build_engine on the MoE presets: the serving capacity factor,
    lora_stack refused.

Tolerances: logits 1e-4 (tests/test_torch_model.py), the layer 1e-5,
quantized logits 1e-3 (tests/test_torch_quant.py); streams equal.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _python_dispatch
from torch.utils import _pytree as pytree

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.models import quant as jax_quant
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, moe, quant, weights

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_TOL = dict(atol=1e-3, rtol=1e-3)
MAX_SEQ = 64
_DEBUG, _DEBUG_MOE = jax_moe.MIXTRAL_CONFIGS['debug-moe']
# Qwen3-MoE's knobs at debug size: q/k norms, head_dim 32 (not 64 / 4),
# 8 experts top-2.
_QWEN3_MOE = (dataclasses.replace(_DEBUG, qk_norm=True, norm_eps=1e-6,
                                  rope_theta=1e6, head_dim_override=32),
              jax_moe.MoeConfig(num_experts=8, experts_per_token=2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg, **over):
    return dataclasses.replace(llama.LlamaConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(llama.LlamaConfig)}), **over)


def port_moe(jmoe):
    return moe.MoeConfig(**dataclasses.asdict(jmoe))


def jax_params(model, seed):
    """A parameter tree of the reference model's layout (jax.eval_shape
    of its init: nothing is compiled) drawn with numpy: the embedding
    N(0, 0.02), each kernel, router and expert weight N(0, 1/fan_in),
    every norm weight 1 + N(0, 0.3) (an init's ones would hide a dropped
    leaf)."""
    shapes = nn.meta.unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if 'norm' in key:
            return (1 + rng.normal(0, 0.3, x.shape)).astype(x.dtype)
        std = 0.02 if 'tok_embed' in key else x.shape[-2] ** -0.5
        return rng.normal(0, std, x.shape).astype(x.dtype)
    return {'params': jax.tree_util.tree_map_with_path(
        draw, shapes['params'])}


def port_model(jp, pcfg, pmoe):
    model = moe.MixtralModel(pcfg, pmoe)
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), pcfg))
    return model.eval()


def _tokens(seed=2, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _close(ref, got, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


@pytest.fixture(scope='module')
def debug_moe():
    """(jax model, params, port cfg, port MoeConfig) at debug-moe with
    the serving capacity factor."""
    jmoe = dataclasses.replace(_DEBUG_MOE, capacity_factor=8.0)
    jcfg = dataclasses.replace(_DEBUG, max_seq_len=MAX_SEQ)
    jm = jax_moe.MixtralModel(jcfg, jmoe)
    return jm, jax_params(jm, 3), port_cfg(jcfg), port_moe(jmoe)


# ------------------------------------------------------------- presets
@pytest.mark.parametrize('name', list(jax_moe.MIXTRAL_CONFIGS))
def test_presets_match_the_reference(name):
    jcfg, jmoe = jax_moe.MIXTRAL_CONFIGS[name]
    pcfg, pmoe = moe.MIXTRAL_CONFIGS[name]
    assert pcfg == port_cfg(jcfg)
    assert dataclasses.asdict(pmoe) == dataclasses.asdict(jmoe)


# --------------------------------------------------------------- layer
def _layer_pair(cf, k, e, seed):
    """The port's MoeMLP with its random init, and the reference's with
    the same weights (router transposed, experts [E, out, in] -> [E, in,
    out]), the inverse of weights._moe_mlp's layout map."""
    jmoe = jax_moe.MoeConfig(num_experts=e, experts_per_token=k,
                             capacity_factor=cf)
    pl = moe.MoeMLP(port_cfg(_DEBUG), port_moe(jmoe))
    pl.init_weights(torch.Generator().manual_seed(seed))
    p = {'router': pl.router.detach().numpy().T}
    for name in quant.MOE_EXPERT_KEYS:
        p[name] = np.swapaxes(getattr(pl, name).detach().numpy(), 1, 2)
    return jax_moe.MoeMLP(_DEBUG, jmoe), p, pl


@pytest.mark.parametrize('cf,k,e,pad', [
    (1.25, 2, 4, False), (8.0, 2, 4, False), (8.0, 1, 4, False),
    (1.25, 1, 4, False), (8.0, 8, 128, True)],
    ids=['cf1.25_k2', 'cf8_k2', 'cf8_k1', 'cf1.25_k1', 'e128_k8_padded'])
def test_moe_mlp_matches_the_reference(cf, k, e, pad):
    """Rows of 12 tokens; 'padded': each row's last 8 tokens one repeated
    vector (a bucket-padded prompt), which all route to the same k
    experts: at factor 8 the capacity is 6, so the reference drops
    assignments there."""
    jl, p, pl = _layer_pair(cf, k, e, seed=5)
    x = np.random.default_rng(7).normal(size=(2, 12, 64)).astype(np.float32)
    if pad:
        x[:, 4:] = x[:, 4:5]
    (ref, _), state = jax.jit(lambda p, x: jl.apply(
        {'params': p}, x, mutable=['intermediates']))(p, jnp.asarray(x))
    ref_kept = int(np.asarray(state['intermediates']['dispatch'][0]).sum())
    with torch.no_grad():
        got = pl(torch.as_tensor(x))
        logits = torch.nn.functional.linear(torch.as_tensor(x),
                                            pl.router.float())
        _, _, keep, _ = moe.route(logits, k, moe.capacity(pl.moe, 12))
    _close(ref, got, LAYER_TOL)
    assert int(keep.sum()) == ref_kept
    if cf == 1.25 or pad:
        assert ref_kept < 2 * 12 * k      # the reference dropped some


def test_no_dense_dispatch_tensor():
    """A row of 64 tokens at factor 8, top-2 of 4 experts: the reference's
    dispatch and combine are [B, S, E, C] = [2, 64, 4, 256]; every tensor
    the port's layer makes stays within B * S * k * max(E, dim, mlp_dim)
    (the assignments' rows), 4x smaller."""
    cfg, _ = moe.MIXTRAL_CONFIGS['debug-moe']
    pl = moe.MoeMLP(cfg, moe.MoeConfig(num_experts=4, experts_per_token=2,
                                       capacity_factor=8.0))
    pl.init_weights(torch.Generator().manual_seed(5))
    sizes = []

    class Record(_python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            sizes.extend(t.numel() for t in pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            return out
    x = torch.randn(2, 64, 64)
    with torch.no_grad(), Record():
        pl(x)
    b, s, k, e = 2, 64, 2, 4
    dense = b * s * e * moe.capacity(pl.moe, s)
    assert max(sizes) <= b * s * k * max(e, 64, 128) < dense


# --------------------------------------------------------------- model
@pytest.mark.parametrize('which', ['debug-moe', 'qwen3-moe'])
@pytest.mark.parametrize('scan', [True, False], ids=['scanned', 'unscanned'])
def test_params_from_jax_logits_match_jax(which, scan):
    jcfg, jmoe = (_DEBUG, _DEBUG_MOE) if which == 'debug-moe' \
        else _QWEN3_MOE
    jcfg = dataclasses.replace(jcfg, scan_layers=scan)
    jm = jax_moe.MixtralModel(jcfg, jmoe)
    jp = jax_params(jm, 4)
    pm = port_model(jp, port_cfg(jcfg), port_moe(jmoe))
    toks = _tokens()
    with torch.no_grad():
        got = pm(torch.as_tensor(toks))
    apply = jax.jit(jm.apply)
    _close(apply(jp, jnp.asarray(toks, jnp.int32)), got, LOGIT_TOL)
    if scan:   # the packed row's segments (the layout is not involved)
        seg = np.asarray([[1] * 5 + [2] * 4 + [0] * 3] * 2, np.int32)
        with torch.no_grad():
            got_seg = pm(torch.as_tensor(toks),
                         segment_ids=torch.as_tensor(seg))
        _close(apply(jp, jnp.asarray(toks, jnp.int32),
                     segment_ids=jnp.asarray(seg)), got_seg, LOGIT_TOL)


def test_model_refuses_lora_and_int4(debug_moe):
    _, jp, pcfg, pmoe = debug_moe
    pm = port_model(jp, pcfg, pmoe)
    with pytest.raises(ValueError, match='LoRA'):
        pm(torch.as_tensor(_tokens()), lora={}, lora_ids=torch.zeros(2))
    with pytest.raises(NotImplementedError) as got:
        moe.MixtralModel(dataclasses.replace(pcfg, quant='int4'), pmoe)
    with pytest.raises(NotImplementedError) as ref:   # its MoE branch
        jax_quant.quantize_params(
            {'moe_mlp': jp['params']['layers']['moe_mlp']}, mode='int4')
    assert str(got.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match='MoE expert weights'):
        quant.quantize_params(pm.state_dict(), 'int4')


# -------------------------------------------------------------- engine
def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _run(eng, make_params, prompts):
    burst = [eng.submit(p, make_params(max_new_tokens=m))[1]
             for p, m in prompts[:-1]]
    eng.start()
    try:
        outs = [_drain(q) for q in burst]
        p, m = prompts[-1]
        outs.append(eng.generate(p, make_params(max_new_tokens=m)))
        return outs
    finally:
        eng.stop()


@pytest.mark.parametrize('spec', [0, 2], ids=['plain', 'spec2'])
def test_engine_greedy_streams_equal_jax(debug_moe, spec):
    """A burst of three (ragged prefill, one prompt repeating itself for
    the n-gram proposer) and a lone prompt sharing the first's opening
    page (a prefix hit in both engines)."""
    jm, jp, pcfg, pmoe = debug_moe
    rng = np.random.default_rng(0)
    loop = rng.integers(1, 256, 6).tolist() * 4
    prompts = [(rng.integers(1, 256, 21).tolist(), 6), (loop, 9),
               (rng.integers(1, 256, 40).tolist(), 7)]
    prompts.append((prompts[0][0][:16] + rng.integers(1, 256, 14).tolist(),
                    8))
    opts = dict(num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
                page_size=16, spec_decode=spec)
    ref = _run(jax_engine.InferenceEngine(jm, jp, cache_mode='paged',
                                          **opts),
               jax_engine.SamplingParams, prompts)
    teng = torch_engine.InferenceEngine(port_model(jp, pcfg, pmoe),
                                        device='cpu', **opts)
    got = _run(teng, torch_engine.SamplingParams, prompts)
    assert got == ref
    assert [len(g) for g in got] == [m for _, m in prompts]
    assert teng.perf_stats()['prefix_cache']['hit_pages'] == 1


# ---------------------------------------------------------------- int8
def test_int8_experts_match_the_reference(debug_moe):
    """quantize_params of the port's state_dict against the reference's of
    the same tree: every code and scale bit-equal (experts, attention,
    lm_head), the router float; the int8 model's logits within 1e-3 of
    the reference int8 model's, and within the reference's own bound of
    its float logits (median per-token error < 3%, <= 1/8 of tokens past
    5%: a flipped near-tie routes through another expert)."""
    jm, jp, pcfg, pmoe = debug_moe
    pm = port_model(jp, pcfg, pmoe)
    got = quant.quantize_params(pm.state_dict(), 'int8')
    # Not jitted: XLA's jit rewrites amax / 127 as a reciprocal product.
    qtree = jax_quant.quantize_params(jp, mode='int8')
    qcfg = dataclasses.replace(pcfg, quant='int8')
    want = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, qtree),
                                   qcfg)
    assert set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert got['layers.0.moe_mlp.router'].dtype == torch.float32
    assert got['layers.1.moe_mlp.w_down'].dtype == torch.int8
    assert tuple(got['layers.1.moe_mlp.w_down_scale'].shape) == (4, 64)
    qm = moe.MixtralModel(qcfg, pmoe)
    qm.load_state_dict(got)
    toks = np.random.default_rng(2).integers(1, 256, (2, 16))
    with torch.no_grad():
        lq = qm(torch.as_tensor(toks)).numpy()
        lf = pm(torch.as_tensor(toks)).numpy()
    jq = jax_moe.MixtralModel(dataclasses.replace(jm.cfg, quant='int8'),
                              jm.moe)
    _close(jax.jit(jq.apply)(qtree, jnp.asarray(toks, jnp.int32)), lq,
           QUANT_TOL)
    tok_rel = np.abs(lq - lf).max(-1) / max(np.abs(lf).max(), 1e-6)
    assert np.median(tok_rel) < 0.03
    assert (tok_rel > 0.05).mean() <= 0.125


def test_int8_random_init_quantizes_the_float_init():
    """init_weights in int8 mode draws each expert weight as the float
    model does (same generator, same order), then quantizes it."""
    cfg, pmoe = moe.MIXTRAL_CONFIGS['debug-moe']
    fm, qm = moe.MixtralModel(cfg, pmoe), moe.MixtralModel(
        dataclasses.replace(cfg, quant='int8'), pmoe)
    for m in (fm, qm):
        m.init_weights(torch.Generator().manual_seed(0))
    want = quant.quantize_params(fm.state_dict(), 'int8')
    for key, t in qm.state_dict().items():
        assert torch.equal(t, want[key]), key


# ------------------------------------------------------- build_engine
def test_build_engine_moe_presets():
    eng = torch_server.build_engine('debug-moe', num_slots=2,
                                    max_seq_len=MAX_SEQ, dtype='float32',
                                    device='cpu', page_size=16,
                                    quantize='int8', spec_decode=2,
                                    draft_model_name='self')
    assert isinstance(eng.model, moe.MixtralModel)
    assert eng.model.moe.capacity_factor == torch_server.MOE_SERVE_CAPACITY
    assert eng.model.layers[0].moe_mlp.w_up.dtype == torch.int8
    assert eng.draft_model is eng.model
    eng.start()
    try:
        out = eng.generate(list(range(1, 12)),
                           torch_engine.SamplingParams(max_new_tokens=5))
    finally:
        eng.stop()
    assert len(out) == 5
    with pytest.raises(ValueError, match='LoRA'):
        torch_server.build_engine('debug-moe', device='cpu',
                                  dtype='float32', lora_stack={})
    with pytest.raises(NotImplementedError, match='MoE expert weights'):
        torch_server.build_engine('debug-moe', device='cpu',
                                  dtype='float32', quantize='int4')
    with pytest.raises(ValueError, match='qwen3-30b-a3b'):
        torch_server.build_engine('no-such-model', device='cpu')
