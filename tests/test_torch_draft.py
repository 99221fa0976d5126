"""Draft-model speculative decoding in the PyTorch port against the JAX
engine's (tests/test_spec_decode.py's cases), on the CPU in float32: a
'debug' target and a one-layer debug draft of its own seed (the same
vocab), paged pools of 16-token pages, spec_decode=3.

  * the greedy draft-spec streams equal the JAX engine's draft-spec
    streams and the port's plain greedy streams, with the same accepted
    drafts and verify steps as the JAX engine;
  * 'self' (the target drafting for itself) accepts k drafts every step;
  * a sampled run completes, and a rerun with the same seeds repeats it;
  * a draft of another vocab raises, in the engine and in build_engine;
  * every admission route prefills the whole prompt into the draft: a
    prefix hit, a chunked prefill and a host-tier promotion keep the
    self-draft at k accepted a step and the plain stream, and a slot
    reused after a cancel gives a fresh engine's stream;
  * build_engine's three draft routes ('self', a preset, a checkpoint)
    and the server's --draft-model / --draft-checkpoint flags.

Streams and counts are compared exactly.
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
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, weights

MAX_SEQ = 64
PAGE = 16
K = 3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(seed, n_layers=2):
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'], n_layers=n_layers,
                              max_seq_len=MAX_SEQ)
    model = jax_llama.LlamaModel(cfg)
    params = nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port(jp, n_layers=2):
    cfg = dataclasses.replace(llama.CONFIGS['debug'], n_layers=n_layers,
                              max_seq_len=MAX_SEQ)
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return model.eval()


@pytest.fixture(scope='module')
def models():
    """The JAX target (seed 0) and draft (seed 1, one layer), and the
    port's copies of both."""
    jm, jp = _jax_model(0)
    dm, dp = _jax_model(1, n_layers=1)
    return {'jax': (jm, jp, dm, dp), 'target': _port(jp),
            'draft': _port(dp, n_layers=1)}


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lens]


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _run(eng, make_params, prompts, max_new=12, **kw):
    """All prompts submitted before start (one ragged admission), then
    each prompt again alone (single admissions)."""
    qs = [eng.submit(p, make_params(max_new_tokens=max_new, **kw))[1]
          for p in prompts]
    eng.start()
    try:
        outs = [_drain(q) for q in qs]
        outs += [eng.generate(p, make_params(max_new_tokens=max_new, **kw))
                 for p in prompts[:1]]
        return outs
    finally:
        eng.stop()


def _engine(model, draft=None, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('max_seq_len', MAX_SEQ)
    return torch_engine.InferenceEngine(
        model, decode_chunk=4, page_size=PAGE, device='cpu',
        spec_decode=K if draft is not None else 0, draft_model=draft, **kw)


def test_draft_streams_equal_jax_and_plain(models):
    jm, jp, dm, dp = models['jax']
    prompts = _prompts([7, 19, 33])
    jeng = jax_engine.InferenceEngine(
        jm, jp, num_slots=2, max_seq_len=MAX_SEQ, decode_chunk=4,
        cache_mode='paged', page_size=PAGE, spec_decode=K, draft_model=dm,
        draft_params=dp)
    ref = _run(jeng, jax_engine.SamplingParams, prompts)
    teng = _engine(models['target'], models['draft'])
    got = _run(teng, torch_engine.SamplingParams, prompts)
    plain = _run(_engine(models['target']), torch_engine.SamplingParams,
                 prompts)
    assert got == ref == plain
    assert all(len(o) == 12 for o in got)
    assert teng._dev_hist is None
    assert teng.perf['spec_verify_steps'] > 0
    assert (teng.perf['spec_verify_steps'], teng.perf['spec_accepted']) == \
        (jeng.perf['spec_verify_steps'], jeng.perf['spec_accepted'])


def test_self_draft_accepts_k_every_step(models):
    target = models['target']
    prompts = _prompts([9, 21], seed=1)
    eng = _engine(target, target)
    out = _run(eng, torch_engine.SamplingParams, prompts)
    assert out == _run(_engine(target), torch_engine.SamplingParams,
                       prompts)
    assert eng.perf['spec_verify_steps'] > 0
    assert eng.perf['spec_accepted'] == K * eng.perf['spec_verify_steps']
    assert eng.perf_stats()['spec_accept_per_step'] == K


def test_sampled_draft_run_completes(models):
    prompts = _prompts([11, 5], seed=2)
    runs = [_run(_engine(models['target'], models['draft']),
                 torch_engine.SamplingParams, prompts, temperature=0.9,
                 top_k=20, seed=5) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(o) == 12 for o in runs[0])
    assert all(0 <= t < 256 for o in runs[0] for t in o)


def test_draft_of_another_vocab_raises(models, monkeypatch):
    cfg = dataclasses.replace(llama.CONFIGS['debug'], vocab_size=128)
    with pytest.raises(ValueError, match='vocab mismatch'):
        _engine(models['target'], llama.LlamaModel(cfg).eval())
    monkeypatch.setitem(llama.CONFIGS, 'debug-v128', cfg)
    with pytest.raises(ValueError, match='vocab mismatch'):
        torch_server.build_engine('debug', device='cpu', spec_decode=2,
                                  draft_model_name='debug-v128')


def _self_draft_route(target, route, monkeypatch):
    """(engine options, requests in order) for one admission route; the
    last request is the one that takes the route."""
    rng = np.random.default_rng(3)
    if route == 'prefix_hit':
        a = rng.integers(1, 256, 40).tolist()
        return {}, [a, a[:32] + rng.integers(1, 256, 9).tolist()]
    if route == 'chunked':
        return {'prefill_chunk': 16}, [rng.integers(1, 256, 45).tolist()]
    # host tier: a 50-token prompt (3 reusable pages) in an 8-page pool,
    # evicted by five fillers, then promoted on the rerun.
    monkeypatch.setenv('SKYT_KV_TIER', 'host')
    a = rng.integers(1, 256, 50).tolist()
    fillers = [rng.integers(1, 256, 17).tolist() for _ in range(5)]
    return {'max_seq_len': 128, 'pool_tokens': 128}, [a] + fillers + [a]


@pytest.mark.parametrize('route', ['prefix_hit', 'chunked', 'host_tier'])
def test_every_admission_route_prefills_the_draft(models, route,
                                                  monkeypatch):
    """The self-draft accepts k a step only if its cache holds the whole
    prompt: on a prefix hit, after a chunked prefill and after a host-tier
    promotion it does, and the streams equal the plain engine's."""
    target = models['target']
    opts, reqs = _self_draft_route(target, route, monkeypatch)
    max_new = 47 if route == 'host_tier' else 12
    outs = []
    for draft in (target, None):
        eng = _engine(target, draft, **opts)
        eng.start()
        try:
            outs.append([eng.generate(p, torch_engine.SamplingParams(
                max_new_tokens=max_new if 0 < i < len(reqs) - 1 else 8))
                for i, p in enumerate(reqs)])
        finally:
            eng.stop()
        if draft is not None:
            spec = eng
    assert outs[0] == outs[1]
    assert spec.perf['spec_accepted'] == \
        K * spec.perf['spec_verify_steps'] > 0
    stats = spec.perf_stats()
    if route == 'prefix_hit':
        assert stats['prefix_cache']['hit_pages'] == 2
    elif route == 'chunked':
        assert spec.perf['prefill_chunks'] >= 2
    else:
        assert stats['kv_tier']['promoted_pages'] == 3


def test_slot_reused_after_a_cancel(models):
    """A request cancelled mid-decode frees its slot; the next request
    there streams as on a fresh engine (its draft row rewritten whole)."""
    target, draft = models['target'], models['draft']
    first, second = _prompts([30, 12], seed=4)
    eng = _engine(target, draft, num_slots=1)
    sp = torch_engine.SamplingParams(max_new_tokens=40)
    rid, q = eng.submit(first, sp)
    eng.start()
    try:
        assert q.get(timeout=60) is not None
        assert eng.cancel(rid)
        _drain(q)
        got = eng.generate(second, torch_engine.SamplingParams(
            max_new_tokens=12))
    finally:
        eng.stop()
    fresh = _engine(target, draft, num_slots=1)
    fresh.start()
    try:
        assert got == fresh.generate(second, torch_engine.SamplingParams(
            max_new_tokens=12))
    finally:
        fresh.stop()


@pytest.mark.parametrize('route', ['self', 'preset', 'checkpoint'])
def test_build_engine_draft_routes(models, route, tmp_path):
    kw = {'draft_model_name': 'self'} if route == 'self' else \
        {'draft_model_name': 'debug'} if route == 'preset' else {}
    if route == 'checkpoint':
        weights.save_hf_checkpoint(models['draft'].cfg, models['draft'],
                                   str(tmp_path))
        kw = {'draft_checkpoint': str(tmp_path)}
    eng = torch_server.build_engine('debug', device='cpu', dtype='float32',
                                    max_seq_len=MAX_SEQ, page_size=PAGE,
                                    num_slots=2, spec_decode=K, **kw)
    if route == 'self':
        assert eng.draft_model is eng.model
    elif route == 'checkpoint':
        assert eng.draft_model.cfg.n_layers == 1
        for key, t in models['draft'].state_dict().items():
            assert torch.equal(eng.draft_model.state_dict()[key], t), key
    else:
        assert eng.draft_model is not eng.model
    prompt = _prompts([13], seed=6)[0]
    eng.start()
    try:
        out = eng.generate(prompt, torch_engine.SamplingParams(
            max_new_tokens=10))
    finally:
        eng.stop()
    assert len(out) == 10 and eng.perf['spec_verify_steps'] > 0
    if route == 'self':
        assert eng.perf['spec_accepted'] == K * eng.perf['spec_verify_steps']


def test_server_passes_the_draft_flags(monkeypatch):
    """--draft-model and --draft-checkpoint are taken and reach
    build_engine."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(*args, **kwargs):
        seen.update(kwargs)
        raise Stop
    monkeypatch.setattr(torch_server, 'build_engine', fake)
    with pytest.raises(Stop):
        torch_server.main(['--model', 'debug', '--device', 'cpu',
                           '--spec-decode', '4', '--draft-model', 'self',
                           '--draft-checkpoint', '/nowhere'])
    assert seen['spec_decode'] == 4
    assert seen['draft_model_name'] == 'self'
    assert seen['draft_checkpoint'] == '/nowhere'
