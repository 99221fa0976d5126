"""Gemma in the PyTorch port against the JAX package, on the CPU in
float32: the 'debug' preset with the Gemma knobs (GeGLU, zero-centred
RMSNorm, the sqrt(dim) embedding scale, tied embeddings) and
head_dim_override=256, with 2 kv heads and with 1 (MQA, G = 4), as
tests/test_infer_weights.py builds the Gemma family. Held:

  * the plain flash forward at head_dim 256 (causal, with segment ids,
    windowed and not) against skypilot_tpu/ops/flash_attention.py's
    Pallas _fwd_kernel in interpret mode;
  * the four plain paged-decode versions at head_dim 256, T*G = 32
    (G = 8, T = 4) included, against the Pallas paged kernels in
    interpret mode;
  * the zero-centred RMSNorm, the GeGLU MLP and the embedding scale
    (rounded to the compute dtype) against the reference's;
  * params_from_jax on a Gemma tree: logits against the JAX LlamaModel;
  * greedy token streams of the port's engine against the JAX engine's
    (both with prefix caching on, their default): float pools,
    kv_dtype='int8', spec_decode=3 and both;
  * attention's dispatch by head dim (the reference's _flash_ok rule),
    the CUDA wrappers' refusals of head dims they do not build, and
    build_engine on a Gemma preset.

Tolerances: attention 2e-5 (tests/test_torch_ops.py), logits 1e-4
(tests/test_torch_model.py); token streams equal.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu.ops import norms as jax_norms
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.ops import attention, flash_attention
from skypilot_tpu_torch.ops import paged_attention

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
D = 256
MAX_SEQ = 128
GEMMA = dict(mlp_act='gelu_tanh', norm_zero_centered=True,
             embed_scale=True, tie_embeddings=True, head_dim_override=D,
             norm_eps=1e-6, rope_theta=10000.0, max_seq_len=MAX_SEQ)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(ref, got, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


# ------------------------------------------------------------------ ops
def _segments(s):
    seg = np.zeros((1, s), np.int32)
    for j, (lo, hi) in enumerate(((0, 50), (50, 57), (57, 110))):
        seg[0, lo:hi] = j + 1
    return seg


@pytest.mark.parametrize('hkv,with_seg,window', [
    (2, False, 0), (2, True, 40), (1, True, 0), (1, False, 40)])
def test_flash_d256_matches_pallas_interpret(hkv, with_seg, window):
    """out and lse of the plain forward at head_dim 256 against
    _flash_fwd_impl (the Pallas _fwd_kernel in interpret mode), causal,
    S = 128 on 64-row blocks, 4 query heads."""
    rng = np.random.default_rng(hkv * 10 + window)
    q = rng.normal(size=(1, 128, 4, D)).astype(np.float32)
    k, v = (rng.normal(size=(1, 128, hkv, D)).astype(np.float32)
            for _ in range(2))
    seg = _segments(128) if with_seg else None
    jout, jlse = jax_flash._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _j(seg), True, 64,
        64, window)
    out, lse = flash_attention.flash_attention_fwd_lse(
        _t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg),
        window=window)
    _close(jout, out, ATTN_TOL)
    _close(np.asarray(jlse)[..., 0], lse, ATTN_TOL)


def _paged_case(seed, t, hq, hkv, quant):
    """q [4, T, Hq, 256]; pools [12, Hkv, 16, 256] (int8 codes with f32
    scales when quant); varied lengths, a length-0 slot, a released slot
    (all-zero row, stale length) and an unreserved gap."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(4, t, hq, D)).astype(np.float32)
    if quant:
        pools = [rng.integers(-127, 128, (12, hkv, 16, D)).astype(np.int8)
                 for _ in range(2)]
        pools += [(rng.random((12, hkv, 16)) * 0.05).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.normal(size=(12, hkv, 16, D)).astype(np.float32)
                 for _ in range(2)]
    tables = np.asarray([[1, 2, 3, 0], [0, 0, 0, 0], [6, 7, 8, 9],
                         [10, 0, 4, 0]], np.int32)
    lengths = np.asarray([40, 9999, 60 - t, 0], np.int32)
    return [q] + pools + [tables, lengths]


# (kernel, T, Hq, Hkv): T*G rows a kv head of 8, 2 and 32 (gemma-2b's
# verify step: G = 8, T = 4).
PAGED_CASES = [
    ('paged_decode_attention', 1, 8, 1),
    ('paged_decode_attention', 1, 4, 2),
    ('paged_decode_attention_mq', 4, 8, 1),
    ('paged_decode_attention_mq', 2, 4, 2),
    ('paged_decode_attention_q', 1, 8, 1),
    ('paged_decode_attention_mq_q', 4, 8, 1),
]


@pytest.mark.parametrize('fn,t,hq,hkv', PAGED_CASES)
def test_paged_d256_matches_pallas_interpret(fn, t, hq, hkv):
    args = _paged_case(hq * t + hkv, t, hq, hkv, fn.endswith('_q'))
    if t == 1 and '_mq' not in fn:
        args[0] = args[0][:, 0]
    ref = getattr(jax_paged, fn)(*(jnp.asarray(a) for a in args))
    out = getattr(paged_attention, fn)(*(_t(a) for a in args))
    assert out.shape == args[0].shape
    assert np.isfinite(out.numpy()).all()
    _close(ref, out, ATTN_TOL)


def test_zero_centred_rms_norm_module():
    """The port's RMSNorm module on a Gemma config applies 1 + w, as the
    reference's rms_norm(zero_centered=True); init_weights sets w to 0
    (the identity)."""
    cfg = dataclasses.replace(llama.CONFIGS['debug'], **GEMMA)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    mod = llama.RMSNorm(64, cfg)
    with torch.no_grad():
        mod.weight.copy_(_t(w))
        got = mod(_t(x))
    _close(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                              zero_centered=True), got, dict(atol=1e-5,
                                                             rtol=1e-5))
    model = llama.LlamaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    assert not model.final_norm.weight.any()
    assert not model.layers[1].mlp_norm.weight.any()


def test_geglu_mlp_matches_jax():
    """LlamaMLP with mlp_act='gelu_tanh' against the JAX LlamaMLP (flax
    nn.gelu(approximate=True) * up) on the same weights."""
    jcfg = dataclasses.replace(jax_llama.CONFIGS['debug'], **GEMMA)
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], **GEMMA)
    x = np.random.default_rng(4).normal(size=(2, 7, 64)).astype(np.float32)
    jm = jax_llama.LlamaMLP(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        jm.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    mlp = llama.LlamaMLP(pcfg)
    with torch.no_grad():
        for name in ('w_gate', 'w_up', 'w_down'):
            getattr(mlp, name).weight.copy_(
                _t(np.asarray(jp['params'][name]['kernel']).T))
        got = mlp(_t(x))
    _close(jm.apply(jp, jnp.asarray(x)), got, dict(atol=1e-5, rtol=1e-5))


def test_embed_scale_rounds_the_normalizer_to_the_compute_dtype():
    """bf16 at gemma-7b's width (dim 3072): the first block's input is
    embed.astype(bf16)[tokens] * bf16(sqrt(3072)) — the reference's
    expression (skypilot_tpu/models/llama.py), 55.5 not 55.43 — exactly."""
    cfg = dataclasses.replace(
        llama.CONFIGS['debug'], **GEMMA, dim=3072, n_layers=1,
        dtype='bfloat16', param_dtype='bfloat16')
    model = llama.LlamaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    seen = {}

    def keep_input(mod, args):
        seen['x'] = args[0]
    model.layers[0].register_forward_pre_hook(keep_input)
    tokens = np.random.default_rng(5).integers(0, 256, (1, 6))
    with torch.no_grad():
        model(_t(tokens))
        table = model.tok_embed.float().numpy()
        unrounded = (model.tok_embed[_t(tokens)].float() *
                     3072 ** 0.5).to(torch.bfloat16)
    ref = jnp.asarray(table).astype(jnp.bfloat16)[jnp.asarray(tokens)] * \
        jnp.asarray(3072 ** 0.5, jnp.bfloat16)
    np.testing.assert_array_equal(seen['x'].float().numpy(),
                                  np.asarray(ref, np.float32))
    assert not torch.equal(seen['x'], unrounded)


# ---------------------------------------------------------------- model
def _models(hkv):
    jcfg = dataclasses.replace(jax_llama.CONFIGS['debug'], **GEMMA,
                               n_kv_heads=hkv)
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], **GEMMA,
                               n_kv_heads=hkv)
    jm = jax_llama.LlamaModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    # The zero-centred norms init to 0: give them values, so the (1 + w)
    # convention is held too.
    rng = np.random.default_rng(hkv)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.3, x.shape).astype(x.dtype)
        if 'norm' in jax.tree_util.keystr(path) else x,
        nn.meta.unbox(jp))
    return jm, jp, pcfg


def _port(jp, pcfg):
    model = llama.LlamaModel(pcfg)
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), pcfg))
    return model.eval()


@pytest.mark.parametrize('hkv', [2, 1])
def test_params_from_jax_logits_match_jax(hkv):
    """No cache, and a packed row with segment ids: the port's logits
    against the JAX LlamaModel's on the same Gemma tree (tied: no
    lm_head; wq [64 -> 1024], wk/wv [64 -> hkv*256], wo [1024 -> 64])."""
    jm, jp, pcfg = _models(hkv)
    pm = _port(jp, pcfg)
    assert pm.lm_head is None
    assert tuple(pm.layers[0].attn.wq.weight.shape) == (4 * D, 64)
    assert tuple(pm.layers[0].attn.wo.weight.shape) == (64, 4 * D)
    assert tuple(pm.layers[0].attn.wk.weight.shape) == (hkv * D, 64)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    seg = np.asarray([[1] * 10 + [2] * 9 + [0] * 5] * 2, np.int32)
    with torch.no_grad():
        got = pm(_t(tokens))
        got_seg = pm(_t(tokens), segment_ids=_t(seg))
    _close(jm.apply(jp, jnp.asarray(tokens, jnp.int32)), got, LOGIT_TOL)
    _close(jm.apply(jp, jnp.asarray(tokens, jnp.int32),
                    segment_ids=jnp.asarray(seg)), got_seg, LOGIT_TOL)


def test_presets_match_the_reference():
    for name in ('gemma-2b', 'gemma-7b'):
        for f in dataclasses.fields(llama.LlamaConfig):
            assert getattr(llama.CONFIGS[name], f.name) == \
                getattr(jax_llama.CONFIGS[name], f.name), (name, f.name)
        assert llama.CONFIGS[name].num_params() == \
            jax_llama.CONFIGS[name].num_params()
    assert llama.CONFIGS['gemma-7b'].head_dim == 256
    assert round(llama.CONFIGS['gemma-7b'].num_params() / 1e9, 2) == 8.54


# --------------------------------------------------------------- engine
BURST = [(21, 6), (9, 5), (40, 7)]   # (prompt length, max_new)
LONE = (30, 8)


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


@pytest.fixture(scope='module')
def engine_setup():
    jm, jp, pcfg = _models(1)
    rng = np.random.default_rng(0)
    seq = rng.integers(1, 256, 6).tolist()
    prompts = [(rng.integers(1, 256, n).tolist(), m) for n, m in BURST]
    # A looping prompt, so the n-gram proposer finds drafts.
    prompts[0] = ((seq * 4)[:BURST[0][0]], BURST[0][1])
    prompts.append((rng.integers(1, 256, LONE[0]).tolist(), LONE[1]))
    return jm, jp, pcfg, prompts


@pytest.mark.parametrize('opts', [
    {}, {'kv_dtype': 'int8'}, {'spec_decode': 3},
    {'kv_dtype': 'int8', 'spec_decode': 3}],
    ids=['float', 'int8', 'spec', 'int8_spec'])
def test_engine_greedy_streams_equal_jax(engine_setup, opts):
    """MQA (4 query heads on 1 kv head) at head_dim 256: the burst
    (ragged prefill) and the lone prompt, decoded through the paged
    plain versions (verify steps of 4 tokens with spec: 16 rows)."""
    jm, jp, pcfg, prompts = engine_setup
    jeng = jax_engine.InferenceEngine(
        jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        cache_mode='paged', page_size=16, **opts)
    ref = _run(jeng, jax_engine.SamplingParams, prompts)
    teng = torch_engine.InferenceEngine(
        _port(jp, pcfg), num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        page_size=16, device='cpu', **opts)
    got = _run(teng, torch_engine.SamplingParams, prompts)
    assert got == ref
    assert [len(g) for g in got] == [m for _, m in prompts]
    assert teng.cache['k'].shape[-1] == D
    if opts.get('spec_decode'):
        assert teng.perf['spec_verify_steps'] > 0


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize('d,path', [(96, 'reference'), (128, 'flash'),
                                    (256, 'flash')])
def test_attention_dispatch_by_head_dim(monkeypatch, d, path):
    """impl 'auto' follows the reference's _flash_ok head-dim rule (d % 64
    == 0 and d <= 512): Phi-3's 96 takes mha_reference, 128 and 256 the
    flash entry; 'xla' takes the reference at any head dim."""
    taken = []
    real_flash = flash_attention.flash_attention
    real_ref = attention.mha_reference
    monkeypatch.setattr(flash_attention, 'flash_attention',
                        lambda *a, **k: taken.append('flash') or
                        real_flash(*a, **k))
    monkeypatch.setattr(attention, 'mha_reference',
                        lambda *a, **k: taken.append('reference') or
                        real_ref(*a, **k))
    rng = np.random.default_rng(d)
    q = _t(rng.normal(size=(1, 16, 4, d)).astype(np.float32))
    k = _t(rng.normal(size=(1, 16, 2, d)).astype(np.float32))
    out = attention.attention(q, k, k, causal=True)
    assert taken[0] == path
    torch.testing.assert_close(out, real_ref(q, k, k, causal=True),
                               atol=2e-5, rtol=2e-5)
    taken.clear()
    attention.attention(q, k, k, causal=True, impl='xla')
    assert taken == ['reference']


def test_cuda_wrappers_refuse_unbuilt_head_dims():
    """Before any launch: the flash forward and backward build head_dim
    64, 128 and 256 (a head dim the reference admits but no
    instantiation builds, 192 or 320, names ROADMAP.md; the backward's
    operand check passes at 256); the paged kernels take 64, 128 and
    256."""
    lse = torch.zeros((1, 2, 64))
    for d in (192, 320):
        q = torch.zeros((1, 64, 2, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match='ROADMAP.md'):
            flash_attention._flash_cuda(q, q, q, None, True)
        with pytest.raises(ValueError, match='ROADMAP.md'):
            flash_attention.flash_bwd_cuda(q, q, q, q, lse, lse)
    q = torch.zeros((1, 64, 2, D), dtype=torch.bfloat16)
    ins, rest = flash_attention._bwd_operands(q, q, q, q, lse, lse, None,
                                              True)
    assert rest[12:17] == (1, 64, 2, 2, D)   # b, s, hq, hkv, d
    pool = torch.zeros((3, 1, 16, 320), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='ROADMAP.md'):
        paged_attention._paged_cuda(
            'paged_decode', torch.zeros((1, 1, 2, 320), dtype=torch.bfloat16),
            pool, pool, None, None, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize('name', ['gemma-7b', 'llama3-8b'])
def test_build_engine_gemma_preset(monkeypatch, name):
    """build_engine resolves the Gemma presets as it does llama3-8b:
    without CUDA both refuse the default device alike; on device='cpu'
    (presets cut to 1 layer, dim 64 and vocab 256 here: never built at
    full width in a test) both serve a request, and the pool takes
    cfg.head_dim (256 for Gemma), not dim // n_heads."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        torch_server.build_engine(name)
    preset = llama.CONFIGS[name]
    cut = dataclasses.replace(preset, n_layers=1, dim=64, n_heads=4,
                              n_kv_heads=min(preset.n_kv_heads, 4),
                              mlp_dim=128, vocab_size=256)
    monkeypatch.setitem(llama.CONFIGS, name, cut)
    eng = torch_server.build_engine(name, device='cpu', dtype='float32',
                                    num_slots=2, max_seq_len=64,
                                    page_size=16)
    assert eng.cache['k'].shape[-1] == cut.head_dim == \
        (256 if name == 'gemma-7b' else 64 // 4)
    assert eng.model.cfg.embed_scale == preset.embed_scale
    eng.start()
    try:
        toks = eng.generate(list(range(1, 9)),
                            torch_engine.SamplingParams(max_new_tokens=3))
    finally:
        eng.stop()
    assert len(toks) == 3
