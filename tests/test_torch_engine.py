"""The PyTorch port's serving engine against the JAX package's, on the CPU
at the 'debug' preset in float32: the same weights (params_from_jax), the
same prompts, the paged cache with page size 16, and greedy token
streams that must be EQUAL — for a burst submitted before start() (the
ragged packed-prefill admission), a lone request (the single prefill),
the max_new_tokens cut-off and an EOS cut-off.

Also here: the port's device sampling with top_k=1 reproduces its greedy
stream, and the isolation checks — the port imports neither jax nor
anything of skypilot_tpu (nor aiohttp, safetensors or ml_dtypes), and
its entry points refuse to run without CUDA unless the caller names the
CPU.
"""
import ast
import dataclasses
import os
import subprocess
import sys

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'skypilot_tpu_torch')

MAX_SEQ = 128
PAGE = 16
BURST = [(5, 8), (17, 3), (33, 12), (9, 6)]   # (prompt length, max_new)
LONE = (11, 10)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _run(eng, make_params, prompts):
    """Burst submitted BEFORE start(), drained; then the lone request."""
    burst = [eng.submit(p, make_params(max_new_tokens=m))[1]
             for p, m in prompts[:-1]]
    eng.start()
    try:
        outs = [_drain(q) for q in burst]
        p, m = prompts[-1]
        outs.append(eng.generate(p, make_params(max_new_tokens=m)))
        return outs, eng
    finally:
        eng.stop()


@pytest.fixture(scope='module')
def engines():
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
               for n, m in BURST + [LONE]]

    def jax_eng():
        return jax_engine.InferenceEngine(
            jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
            cache_mode='paged', page_size=PAGE)

    def torch_eng():
        model = llama.LlamaModel(pcfg)
        model.load_state_dict(weights.params_from_jax(tree, pcfg))
        return torch_engine.InferenceEngine(
            model, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
            page_size=PAGE, device='cpu')

    ref, jeng = _run(jax_eng(), jax_engine.SamplingParams, prompts)
    got, teng = _run(torch_eng(), torch_engine.SamplingParams, prompts)
    return {'prompts': prompts, 'ref': ref, 'got': got, 'jeng': jeng,
            'teng': teng, 'jax_eng': jax_eng, 'torch_eng': torch_eng}


def test_burst_takes_ragged_admission_on_both(engines):
    assert engines['jeng'].perf['ragged_dispatches'] == 1
    assert engines['teng'].perf['ragged_dispatches'] == 1
    # The lone request took the single bucket-padded prefill.
    assert engines['teng'].perf['prefill_dispatches'] == 2


@pytest.mark.parametrize('idx', range(len(BURST)))
def test_burst_greedy_streams_equal(engines, idx):
    ref, got = engines['ref'][idx], engines['got'][idx]
    assert got == ref
    assert len(got) == BURST[idx][1]     # the max_new_tokens cut-off


def test_lone_request_stream_equal(engines):
    assert engines['got'][-1] == engines['ref'][-1]
    assert len(engines['got'][-1]) == LONE[1]


def test_eos_cutoff_matches(engines):
    """EOS = the first token of the lone stream whose first occurrence
    is at index >= 1, so the stream must end right after it."""
    ref = engines['ref'][-1]
    cut = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    eos = ref[cut]
    prompt = engines['prompts'][-1][0]
    outs = []
    for make, mod in ((engines['jax_eng'], jax_engine),
                      (engines['torch_eng'], torch_engine)):
        eng = make()
        eng.start()
        try:
            outs.append(eng.generate(prompt, mod.SamplingParams(
                max_new_tokens=LONE[1], eos_token=eos)))
        finally:
            eng.stop()
    assert outs[0] == ref[:cut + 1]
    assert outs[1] == outs[0]


def test_top_k_one_sampling_is_greedy(engines):
    """Temperature sampling through the device filter + per-request
    generator: with top_k=1 only the argmax survives, so the sampled
    stream must equal the greedy one; with top_k=40 it stays in vocab."""
    eng = engines['torch_eng']()
    prompt = engines['prompts'][-1][0]
    eng.start()
    try:
        one = eng.generate(prompt, torch_engine.SamplingParams(
            max_new_tokens=LONE[1], temperature=0.8, top_k=1))
        wide = eng.generate(prompt, torch_engine.SamplingParams(
            max_new_tokens=LONE[1], temperature=0.8, top_k=40, seed=3))
    finally:
        eng.stop()
    assert one == engines['ref'][-1]
    assert len(wide) == LONE[1] and all(0 <= t < 256 for t in wide)


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(root, f), REPO)
                mod = rel[:-3].replace(os.sep, '.')
                mods.append(mod[:-len('.__init__')]
                            if mod.endswith('.__init__') else mod)
    return sorted(mods)


def test_port_module_list_covers_every_slice():
    """The two checks below walk every module of the port; the modules
    of each slice are among them (multi-LoRA: infer/lora.py, ops/lora.py;
    training: train/ and utils/metrics.py, utils/profiling.py; the host
    KV tier: infer/kv_tier.py; the HTTP front door: infer/server.py,
    infer/tokenizer.py, serve/qos.py; HF checkpoints and weight
    quantization: models/safetensors_io.py, models/quant.py)."""
    mods = _port_modules()
    for mod in ('skypilot_tpu_torch.infer.engine',
                'skypilot_tpu_torch.infer.kv_tier',
                'skypilot_tpu_torch.infer.lora',
                'skypilot_tpu_torch.infer.server',
                'skypilot_tpu_torch.infer.tokenizer',
                'skypilot_tpu_torch.serve.qos',
                'skypilot_tpu_torch.ops.lora',
                'skypilot_tpu_torch.ops.paged_attention',
                'skypilot_tpu_torch.models.weights',
                'skypilot_tpu_torch.models.safetensors_io',
                'skypilot_tpu_torch.models.quant',
                'skypilot_tpu_torch.train.trainer',
                'skypilot_tpu_torch.train.sft',
                'skypilot_tpu_torch.train.prefetch',
                'skypilot_tpu_torch.train.checkpoint',
                'skypilot_tpu_torch.utils.metrics',
                'skypilot_tpu_torch.utils.profiling'):
        assert mod in mods


def test_port_imports_no_jax_in_subprocess():
    code = ('import importlib, sys\n'
            f'for m in {_port_modules()!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "orbax", "safetensors", '
            '"ml_dtypes") or '
            'm == "skypilot_tpu" or '
            'm.startswith("skypilot_tpu.")]\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_nothing_of_jax():
    """No port source imports JAX, the JAX package, aiohttp, safetensors
    or ml_dtypes (the card's machine has none of them)."""
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split('.')[0]
                    if top in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                               'skypilot_tpu', 'aiohttp', 'safetensors',
                               'ml_dtypes'):
                        bad.append(f'{path}: {n}')
    assert not bad, bad


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        torch_server.build_engine('debug')
    model = llama.LlamaModel(llama.CONFIGS['debug'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        torch_engine.InferenceEngine(model)


@pytest.mark.parametrize('kw,env,exc', [
    ({}, {'SKYT_KV_TIER': 'fleet'}, NotImplementedError),
    ({'kv_dtype': 'fp8'}, {}, ValueError),
    ({'spec_decode': 2, 'draft_model': object()}, {}, NotImplementedError),
    ({'mesh': object()}, {}, NotImplementedError),
    ({'lockstep': object()}, {}, NotImplementedError)])
def test_unported_engine_options_raise(kw, env, exc, monkeypatch):
    """Options the port does not take: the unported ones raise
    NotImplementedError (the fleet KV tier naming the HTTP routes' slice
    it waits for), an unknown explicit kv_dtype ValueError."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    model = llama.LlamaModel(llama.CONFIGS['debug'])
    with pytest.raises(exc, match='HTTP routes' if env else None):
        torch_engine.InferenceEngine(model, device='cpu', **kw)


@pytest.mark.parametrize('kw,attr,want', [
    ({}, 'prefix_caching', True),
    ({'prefix_caching': False}, 'prefix_caching', False),
    ({'prefill_chunk': 40}, 'prefill_chunk', 32)])
def test_prefix_options_construct(kw, attr, want):
    """Prefix caching is on by default, as in the JAX engine, and can be
    turned off; prefill_chunk is rounded down to whole pages."""
    model = llama.LlamaModel(llama.CONFIGS['debug'])
    eng = torch_engine.InferenceEngine(model, device='cpu', page_size=16,
                                       **kw)
    assert getattr(eng, attr) == want
    built = torch_server.build_engine('debug', device='cpu', page_size=16,
                                      **kw)
    assert getattr(built, attr) == want


def test_build_engine_refuses_a_draft_model():
    with pytest.raises(NotImplementedError, match='draft'):
        torch_server.build_engine('debug', device='cpu', spec_decode=2,
                                  draft_model_name='debug')
