"""The Qwen2.5, Qwen3, Gemma-2 and Phi-3 families in the PyTorch port
against the JAX package, on the CPU in float32 at debug size (the shapes
of the reference's own family test, tests/test_infer_weights.py
_family_debug_cfg, with qwen2 at 6 query heads on 2 kv heads, G = 3):

  * the seven presets and their parameter counts equal the reference's;
  * params_from_jax logits (no cache, and a packed row with segment ids)
    against the JAX LlamaModel, every bias and norm leaf randomised
    first (the reference's init leaves biases 0 and norms 1, which would
    hide a dropped leaf);
  * the paged engine's greedy streams against the JAX engine's (prefix
    caching on in both): qwen2 on int8 pools, gemma2 on float pools —
    gemma2's window-0 layers too take the gather view and the plain
    attention (the kernels compute neither its soft-cap nor its scale);
  * one paged decode step against a no-cache forward of the same tokens
    (gemma2, phi3), with the paged kernels' wrappers made to raise;
  * config_from_hf / config_to_hf against the reference's dicts;
  * HF checkpoints across the two packages: the reference's
    save_hf_checkpoint read by the port's load_checkpoint and the port's
    save read by the reference's load_llama_params, logits equal both
    ways (bit-equal within a package, 1e-4 across);
  * qwen2's int8 and int4 forwards against the reference's
    quantize_params trees, its stream-quantized load against
    quantize_params of the float load (biases stay float);
  * build_engine(checkpoint=) for each family, and sft's
    --base-checkpoint on a qwen2 checkpoint (and its refusal of a
    checkpoint whose knobs differ from --model's).

Tolerances: logits 1e-4 (tests/test_torch_model.py), quantized logits
1e-3 (tests/test_torch_quant.py); streams and same-package logits equal.
"""
import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quant as jax_quant
from skypilot_tpu.models import weights as jax_weights
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, quant, weights
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.train import sft

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
QUANT_TOL = dict(atol=1e-3, rtol=1e-3)
MAX_SEQ = 64
_BASE = dataclasses.replace(jax_llama.CONFIGS['debug'], max_seq_len=MAX_SEQ)
FAMILIES = {
    # G = 3 (6 query heads on 2 kv heads), head_dim 16, q/k/v biases.
    'qwen2': dataclasses.replace(_BASE, dim=96, n_heads=6, n_kv_heads=2,
                                 attn_bias=True, norm_eps=1e-6,
                                 rope_theta=1e6),
    # Decoupled head_dim (32, not 64 / 4), q/k norms, tied.
    'qwen3': dataclasses.replace(_BASE, qk_norm=True, norm_eps=1e-6,
                                 rope_theta=1e6, head_dim_override=32,
                                 tie_embeddings=True),
    # Window 8 below the prompts, pattern 2, both caps, a scale that is
    # not head_dim ** -0.5, sandwich norms.
    'gemma2': dataclasses.replace(
        _BASE, n_layers=4, mlp_act='gelu_tanh', norm_zero_centered=True,
        embed_scale=True, tie_embeddings=True, head_dim_override=16,
        norm_eps=1e-6, rope_theta=10000.0, sliding_window=8,
        window_pattern=2, attn_softcap=30.0, final_softcap=20.0,
        attn_scale=32.0 ** -0.5, sandwich_norms=True),
    # Fused HF layout, head_dim 16 (not a multiple of 64), window 8.
    'phi3': dataclasses.replace(_BASE, hf_layout='phi3', sliding_window=8,
                                rope_theta=10000.0),
}
PRESETS = ('qwen2-1.5b', 'qwen2-7b', 'qwen3-0.6b', 'qwen3-8b', 'phi3-mini',
           'gemma2-2b', 'gemma2-9b')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg, **over):
    """The port's LlamaConfig with the JAX config's values."""
    return dataclasses.replace(llama.LlamaConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(llama.LlamaConfig)}), **over)


def randomised_params(jcfg, seed):
    """JAX init, then every bias and norm leaf moved off its init."""
    jm = jax_llama.LlamaModel(jcfg)
    jp = nn.meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def bump(path, x):
        key = jax.tree_util.keystr(path)
        if 'bias' in key or 'norm' in key:
            return x + rng.normal(0, 0.3, x.shape).astype(x.dtype)
        return x
    return jm, jax.tree_util.tree_map_with_path(bump, jp)


def port_model(jp, pcfg):
    model = llama.LlamaModel(pcfg)
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), pcfg))
    return model.eval()


@pytest.fixture(scope='module')
def fams():
    """{family: (jax model, randomised params, port cfg)}."""
    out = {}
    for i, (fam, jcfg) in enumerate(FAMILIES.items()):
        jm, jp = randomised_params(jcfg, 10 + i)
        out[fam] = (jm, jp, port_cfg(jcfg))
    return out


def _tokens(seed=2, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _close(ref, got, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


# ------------------------------------------------------------- presets
@pytest.mark.parametrize('name', PRESETS)
def test_presets_match_the_reference(name):
    for f in dataclasses.fields(llama.LlamaConfig):
        assert getattr(llama.CONFIGS[name], f.name) == \
            getattr(jax_llama.CONFIGS[name], f.name), (name, f.name)
    assert llama.CONFIGS[name].num_params() == \
        jax_llama.CONFIGS[name].num_params()
    assert llama.CONFIGS[name].needs_xla_attention == \
        jax_llama.CONFIGS[name].needs_xla_attention


# --------------------------------------------------------------- model
@pytest.mark.parametrize('fam', list(FAMILIES))
def test_params_from_jax_logits_match_jax(fams, fam):
    """No cache, and a packed row with segment ids (the ragged prefill's
    attention): the port against the JAX LlamaModel on the same tree."""
    jm, jp, pcfg = fams[fam]
    pm = port_model(jp, pcfg)
    sd = pm.state_dict()
    if pcfg.attn_bias:
        assert 'layers.0.attn.wq.bias' in sd
    if pcfg.qk_norm:
        assert tuple(sd['layers.0.attn.q_norm.weight'].shape) == (32,)
    if pcfg.sandwich_norms:
        assert 'layers.3.mlp_post_norm.weight' in sd
    toks = _tokens()
    seg = np.asarray([[1] * 5 + [2] * 4 + [0] * 3] * 2, np.int32)
    with torch.no_grad():
        got = pm(torch.as_tensor(toks))
        got_seg = pm(torch.as_tensor(toks),
                     segment_ids=torch.as_tensor(seg))
    apply = jax.jit(jm.apply)
    _close(apply(jp, jnp.asarray(toks, jnp.int32)), got, LOGIT_TOL)
    _close(apply(jp, jnp.asarray(toks, jnp.int32),
                 segment_ids=jnp.asarray(seg)), got_seg, LOGIT_TOL)


@pytest.mark.parametrize('fam', ['gemma2', 'phi3'])
def test_paged_step_takes_the_gather_view(fams, fam, monkeypatch):
    """A model that needs_xla_attention attends through the gather view on
    every layer (gemma2's window-0 layers included): with the paged
    kernels' wrappers raising, a prefill into pages and one decode step
    run, and the step's logits equal a no-cache forward's last ones."""
    _, jp, pcfg = fams[fam]
    pm = port_model(jp, pcfg)

    def refuse(*args, **kwargs):
        raise AssertionError('a paged kernel wrapper was called')
    for name in ('paged_decode_attention', 'paged_decode_attention_q',
                 'paged_decode_attention_mq', 'paged_decode_attention_mq_q'):
        monkeypatch.setattr(paged_attention, name, refuse)
    toks = torch.as_tensor(_tokens(s=14))
    page, n_pages = 8, 9
    shape = (pcfg.n_layers, n_pages, pcfg.n_kv_heads, page, pcfg.head_dim)
    cache = {'k': torch.zeros(shape), 'v': torch.zeros(shape),
             'tables': torch.as_tensor([[1, 2, 3, 4], [5, 6, 7, 8]],
                                       dtype=torch.int32)}
    with torch.no_grad():
        pos = torch.arange(13)[None].expand(2, 13)
        pm(toks[:, :13], positions=pos, cache=cache)
        step, _ = pm(toks[:, 13:], positions=torch.full((2, 1), 13),
                     cache=cache)
        full = pm(toks)
    _close(full[:, -1], step[:, 0], LOGIT_TOL)


def test_final_softcap_bounds_the_logits(fams):
    _, jp, pcfg = fams['gemma2']
    with torch.no_grad():
        logits = port_model(jp, pcfg)(torch.as_tensor(_tokens()))
    assert float(logits.abs().max()) < pcfg.final_softcap


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


@pytest.mark.parametrize('fam,opts', [('qwen2', {'kv_dtype': 'int8'}),
                                      ('gemma2', {})],
                         ids=['qwen2_int8', 'gemma2_float'])
def test_engine_greedy_streams_equal_jax(fams, fam, opts):
    """A burst of three (ragged prefill) and a lone prompt, the lone one
    sharing the first's opening pages (a prefix hit in both engines)."""
    jm, jp, pcfg = fams[fam]
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(1, 256, n).tolist(), m)
               for n, m in ((21, 6), (9, 5), (40, 7))]
    prompts.append((prompts[0][0][:16] + rng.integers(1, 256, 14).tolist(),
                    8))
    jeng = jax_engine.InferenceEngine(
        jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        cache_mode='paged', page_size=16, **opts)
    ref = _run(jeng, jax_engine.SamplingParams, prompts)
    teng = torch_engine.InferenceEngine(
        port_model(jp, pcfg), num_slots=4, max_seq_len=MAX_SEQ,
        decode_chunk=4, page_size=16, device='cpu', **opts)
    got = _run(teng, torch_engine.SamplingParams, prompts)
    assert got == ref
    assert [len(g) for g in got] == [m for _, m in prompts]
    assert teng.perf_stats()['prefix_cache']['hit_pages'] == 1


# ------------------------------------------------------ HF checkpoints
@pytest.mark.parametrize('fam', list(FAMILIES))
def test_config_dicts_match_the_reference(fams, fam):
    _, _, pcfg = fams[fam]
    hf = weights.config_to_hf(pcfg)
    assert hf == jax_weights.config_to_hf(FAMILIES[fam])
    assert hf['model_type'] == fam
    got = weights.config_from_hf(hf)
    want = jax_weights.config_from_hf(hf)
    for f in dataclasses.fields(llama.LlamaConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_qwen2_ignores_its_sliding_window():
    hf = dict(jax_weights.config_to_hf(FAMILIES['qwen2']),
              sliding_window=4096, use_sliding_window=False)
    assert weights.config_from_hf(hf).sliding_window == 0
    assert jax_weights.config_from_hf(hf).sliding_window == 0


@pytest.fixture(scope='module')
def ref_ckpts(fams, tmp_path_factory):
    """{family: dir} written by the reference's save_hf_checkpoint."""
    out = {}
    for fam, (_, jp, _) in fams.items():
        d = str(tmp_path_factory.mktemp(f'ref_{fam}'))
        jax_weights.save_hf_checkpoint(FAMILIES[fam], jp, d)
        out[fam] = d
    return out


@pytest.mark.parametrize('fam', list(FAMILIES))
def test_reference_checkpoint_loads_in_the_port(fams, ref_ckpts, fam):
    _, jp, pcfg = fams[fam]
    if fam == 'phi3':
        names = json.load(open(f'{ref_ckpts[fam]}/config.json'))
        assert names['model_type'] == 'phi3'
    cfg, _, model = weights.load_checkpoint(
        ref_ckpts[fam], device='cpu', dtype='float32',
        param_dtype='float32', remat=False, max_seq_len=MAX_SEQ)
    # The same model; a head_dim override equal to dim / heads is not
    # written back (gemma2 here), as in the reference.
    assert cfg.head_dim == pcfg.head_dim
    assert dataclasses.replace(cfg, head_dim_override=0) == \
        dataclasses.replace(pcfg, head_dim_override=0)
    toks = torch.as_tensor(_tokens())
    with torch.no_grad():
        got = model(toks)
        want = port_model(jp, pcfg)(toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize('fam', list(FAMILIES))
def test_port_checkpoint_loads_in_the_reference(fams, fam, tmp_path):
    jm, jp, pcfg = fams[fam]
    weights.save_hf_checkpoint(pcfg, port_model(jp, pcfg), str(tmp_path))
    if fam == 'phi3':
        from safetensors import safe_open
        with safe_open(str(tmp_path / 'model.safetensors'), 'np') as f:
            keys = set(f.keys())
        assert 'model.layers.0.self_attn.qkv_proj.weight' in keys
        assert 'model.layers.0.self_attn.q_proj.weight' not in keys
    jcfg = jax_weights.load_config(str(tmp_path), max_seq_len=MAX_SEQ,
                                   dtype='float32', param_dtype='float32')
    loaded = jax_weights.load_llama_params(jcfg, str(tmp_path))
    toks = jnp.asarray(_tokens(), jnp.int32)
    got = np.asarray(jax.jit(jax_llama.LlamaModel(jcfg).apply)(loaded,
                                                               toks))
    want = np.asarray(jax.jit(jm.apply)(jp, toks))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('mode', quant.MODES)
def test_qwen2_quantized_logits_match_the_reference(fams, mode):
    """The reference's quantize_params tree (int8 or int4 kernels, float
    biases) through params_from_jax into the quant-mode model."""
    jm, jp, pcfg = fams['qwen2']
    qtree = jax.jit(jax_quant.quantize_params,
                    static_argnames='mode')(jp, mode=mode)
    jq = jax_llama.LlamaModel(dataclasses.replace(FAMILIES['qwen2'],
                                                  quant=mode))
    qcfg = dataclasses.replace(pcfg, quant=mode)
    pm = llama.LlamaModel(qcfg)
    pm.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, qtree), qcfg))
    assert pm.layers[0].attn.wq.bias.dtype == torch.float32
    toks = _tokens()
    with torch.no_grad():
        got = pm(torch.as_tensor(toks))
    _close(jax.jit(jq.apply)(qtree, jnp.asarray(toks, jnp.int32)), got,
           QUANT_TOL)


def test_qwen2_int8_load_equals_quantize_params(fams, ref_ckpts):
    """Stream-quantized load == quantize_params of the float load: the
    projections' codes and scales, the biases float and unchanged."""
    _, jp, pcfg = fams['qwen2']
    want = quant.quantize_params(weights.load_llama_params(
        pcfg, ref_ckpts['qwen2'], device='cpu'), 'int8')
    got = weights.load_llama_params(pcfg, ref_ckpts['qwen2'],
                                    quantize='int8', device='cpu')
    assert set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert got['layers.1.attn.wv.bias'].dtype == torch.float32
    assert got['layers.1.attn.wv.weight'].dtype == torch.int8


@pytest.mark.parametrize('fam', list(FAMILIES))
def test_build_engine_serves_a_family_checkpoint(fams, ref_ckpts, fam):
    """build_engine(checkpoint=) routes the family (int8 weights on
    qwen2) and the engine's greedy stream equals the same weights built
    from params_from_jax."""
    _, jp, pcfg = fams[fam]
    quantize = 'int8' if fam == 'qwen2' else 'none'
    eng = torch_server.build_engine(checkpoint=ref_ckpts[fam], num_slots=2,
                                    max_seq_len=MAX_SEQ, dtype='float32',
                                    device='cpu', page_size=16,
                                    quantize=quantize)
    assert eng.cfg.hf_layout == pcfg.hf_layout
    prompt = _tokens(s=10)[0].tolist()
    sp = torch_engine.SamplingParams(max_new_tokens=6)
    eng.start()
    try:
        got = eng.generate(prompt, sp)
    finally:
        eng.stop()
    sd = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 pcfg)
    if quantize != 'none':
        sd = quant.quantize_params(sd, quantize)
    model = llama.LlamaModel(dataclasses.replace(pcfg, quant=quantize))
    model.load_state_dict(sd)
    ref = torch_engine.InferenceEngine(model.eval(), num_slots=2,
                                       max_seq_len=MAX_SEQ, page_size=16,
                                       device='cpu')
    ref.start()
    try:
        assert got == ref.generate(prompt, sp)
    finally:
        ref.stop()


# ----------------------------------------------------------------- sft
def test_sft_base_checkpoint_takes_qwen2(fams, ref_ckpts, monkeypatch):
    """sft.main --base-checkpoint on a qwen2 checkpoint (its preset cut
    to the checkpoint's debug sizes): the masters hold its weights,
    biases included, before the first step."""
    _, jp, pcfg = fams['qwen2']
    monkeypatch.setitem(llama.CONFIGS, 'qwen2-debug', dataclasses.replace(
        pcfg, remat=False))
    seen = {}
    real = sft.load_base_checkpoint

    def spy(model, path, device):
        real(model, path, device)
        seen.update({k: v.detach().clone()
                     for k, v in model.state_dict().items()})
    monkeypatch.setattr(sft, 'load_base_checkpoint', spy)
    out = sft.main(['--device', 'cpu', '--model', 'qwen2-debug', '--steps',
                    '1', '--batch', '2', '--seq', '16', '--log-every', '1',
                    '--base-checkpoint', ref_ckpts['qwen2']])
    assert out['steps'] == 1
    want = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   pcfg)
    for key in ('layers.0.attn.wk.bias', 'layers.1.mlp.w_up.weight'):
        assert torch.equal(seen[key], want[key]), key


def test_sft_refuses_a_checkpoint_of_another_family(ref_ckpts,
                                                     monkeypatch):
    """A qwen2 checkpoint under a preset of its sizes without biases
    exits before a weight is read."""
    monkeypatch.setitem(llama.CONFIGS, 'llama-96', port_cfg(
        dataclasses.replace(FAMILIES['qwen2'], attn_bias=False)))
    with pytest.raises(SystemExit, match='attn_bias=True does not match'):
        sft.main(['--device', 'cpu', '--model', 'llama-96', '--steps', '1',
                  '--base-checkpoint', ref_ckpts['qwen2']])
