"""The int8 KV cache of the PyTorch port against the JAX package, on the
CPU in float32 ('debug' preset, paged cache with page size 16, max_seq_len
128).

  * statics: quantize_kv, insert_prompt_q, gather_view_layer_q,
    append_token_layer_q and append_tokens_layer_q on IDENTICAL inputs:
    codes equal, scales allclose 1e-6 (released slots' writes clip into
    dummy page 0);
  * ops: the int8 single-query and multi-query plain versions against
    the Pallas _kernel_q and _kernel_mq_q (interpret mode) — varied
    lengths, length 0, dummy-page rows, GQA, T in {1, 4} — atol/rtol
    2e-5;
  * engine: greedy streams EQUAL to the JAX engine's with
    kv_dtype='int8' on test_torch_engine.py's burst-plus-lone traffic,
    and SKYT_KV_DTYPE=int8 taking effect under kv_dtype='auto'.
(The model's int8 decode and verify steps are in test_torch_spec.py.)
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import paged_cache as jax_paged_cache
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import paged_cache
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.ops import paged_attention

JaxPagePool = jax_paged_cache.PagePool
PagePool = paged_cache.PagePool
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
SCALE_TOL = dict(atol=0, rtol=1e-6)
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


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _codes_and_scales(jax_pair, torch_pair):
    np.testing.assert_array_equal(torch_pair[0].numpy(),
                                  np.asarray(jax_pair[0]))
    np.testing.assert_allclose(torch_pair[1].numpy(),
                               np.asarray(jax_pair[1]), **SCALE_TOL)


# -------------------------------------------------------------- statics
def test_quantize_kv_matches_jax():
    """Random rows, an all-zero row (scale 1, codes 0), and rows with
    values exactly on half-code boundaries (round half to even)."""
    rng = np.random.default_rng(20)
    x = (rng.normal(size=(3, 5, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    # amax 31.75: scale exactly 0.25, the other codes exactly n + 0.5.
    x[1, 1, 1, 0] = 31.75
    x[1, 1, 1, 1:] = 0.25 * (np.arange(15) - 7 + 0.5)
    q_j, s_j = jax_paged_cache.quantize_kv(jnp.asarray(x))
    q_t, s_t = paged_cache.quantize_kv(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    _codes_and_scales((q_j, s_j), (q_t, s_t))
    assert float(s_t[0, 0, 0]) == 1.0 and not q_t[0, 0, 0].any()
    assert q_t[1, 1, 1, 1:].tolist() == [-6, -6, -4, -4, -2, -2, 0, 0, 2, 2,
                                         4, 4, 6, 6, 8]


def test_int8_statics_match_jax():
    rng = np.random.default_rng(21)
    layers, n_pages, h, p, d = 2, 9, 2, 4, 8
    pool = rng.integers(-127, 128, (layers, n_pages, h, p, d)).astype(np.int8)
    scales = rng.random((layers, n_pages, h, p)).astype(np.float32)
    prompt = rng.normal(size=(layers, 1, 20, h, d)).astype(np.float32)
    ids = np.array([5, 2, 7], np.int32)
    new_j = JaxPagePool.insert_prompt_q(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(prompt),
        jnp.asarray(ids), 4)
    new_t = PagePool.insert_prompt_q(
        torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy()),
        torch.from_numpy(prompt), torch.from_numpy(ids), 4)
    _codes_and_scales(new_j, new_t)

    tables = np.array([[5, 2, 7], [1, 0, 0], [0, 0, 0]], np.int32)
    view_j = JaxPagePool.gather_view_layer_q(
        new_j[0][1], new_j[1][1], jnp.asarray(tables), jnp.float32)
    view_t = PagePool.gather_view_layer_q(
        new_t[0][1], new_t[1][1], torch.from_numpy(tables), torch.float32)
    np.testing.assert_allclose(view_t.numpy(), np.asarray(view_j),
                               **SCALE_TOL)

    # One token per slot; slot 2 is released (dummy row, stale length).
    one = rng.normal(size=(3, h, d)).astype(np.float32)
    lengths = np.array([9, 3, 50], np.int32)
    app_j = JaxPagePool.append_token_layer_q(
        new_j[0][0], new_j[1][0], jnp.asarray(one), jnp.asarray(tables),
        jnp.asarray(lengths))
    app_t = PagePool.append_token_layer_q(
        new_t[0][0].clone(), new_t[1][0].clone(), torch.from_numpy(one),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    _codes_and_scales(app_j, app_t)

    # A 3-token run per slot, one crossing a page boundary.
    run = rng.normal(size=(3, 3, h, d)).astype(np.float32)
    start = np.array([2, 1, 50], np.int32)
    run_j = JaxPagePool.append_tokens_layer_q(
        app_j[0], app_j[1], jnp.asarray(run), jnp.asarray(tables),
        jnp.asarray(start))
    run_t = PagePool.append_tokens_layer_q(
        app_t[0], app_t[1], torch.from_numpy(run),
        torch.from_numpy(tables), torch.from_numpy(start))
    _codes_and_scales(run_j, run_t)


# ------------------------------------------------------------------ ops
def int8_case(case, seed, t, slots=4, hq=4, hkv=2, d=64, n_pages=12, p=16):
    """q [S, T, Hq, d] f32; int8 pools [n_pages, Hkv, P, d] and f32
    scales [n_pages, Hkv, P]; tables and lengths as
    test_torch_spec.paged_case (dummy page 0 holds codes too)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(slots, t, hq, d)).astype(np.float32)
    pools = [rng.integers(-127, 128, (n_pages, hkv, p, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((n_pages, hkv, p)) * 0.05).astype(np.float32)
              for _ in range(2)]
    if case == 'varied':
        tables = [[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9], [10, 0, 0, 0]]
        lengths = [40, 17, 60, 0]
    elif case == 'length_zero':
        tables = [[2, 0, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0], [6, 7, 8, 0]]
        lengths = [0, 0, 12, 33]
    else:
        tables = [[0, 0, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0], [3, 0, 4, 0]]
        lengths = [9999, 20, 37, 40]
    return (q, pools[0], pools[1], scales[0], scales[1],
            np.asarray(tables, np.int32), np.asarray(lengths, np.int32))


@pytest.mark.parametrize('case', ['varied', 'length_zero', 'dummy_rows'])
def test_q_plain_version_matches_pallas_q(case):
    q, *rest = int8_case(case, 22, 1)
    args = [_both(a) for a in [q[:, 0]] + rest]
    ref = jax_paged.paged_decode_attention_q(*(a[0] for a in args))
    out = paged_attention.paged_decode_attention_q(*(a[1] for a in args))
    assert out.shape == (4, 4, 64) and np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize('t', [1, 4])
@pytest.mark.parametrize('case', ['varied', 'length_zero', 'dummy_rows'])
def test_mq_q_plain_version_matches_pallas_mq_q(case, t):
    args = [_both(a) for a in int8_case(case, 23, t)]
    ref = jax_paged.paged_decode_attention_mq_q(*(a[0] for a in args))
    out = paged_attention.paged_decode_attention_mq_q(*(a[1] for a in args))
    assert out.shape == (4, t, 4, 64) and np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


# --------------------------------------------------------------- engine
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
        return outs
    finally:
        eng.stop()


@pytest.fixture(scope='module')
def int8_engines():
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(1, 256, n).tolist(), m)
               for n, m in BURST + [LONE]]

    def torch_eng(**kw):
        model = llama.LlamaModel(pcfg)
        model.load_state_dict(weights.params_from_jax(tree, pcfg))
        return torch_engine.InferenceEngine(
            model, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
            page_size=PAGE, device='cpu', **kw)

    ref = _run(jax_engine.InferenceEngine(
        jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        cache_mode='paged', page_size=PAGE, kv_dtype='int8'),
        jax_engine.SamplingParams, prompts)
    eng = torch_eng(kv_dtype='int8')
    got = _run(eng, torch_engine.SamplingParams, prompts)
    return {'ref': ref, 'got': got, 'eng': eng, 'torch_eng': torch_eng}


def test_int8_engine_greedy_streams_equal_jax(int8_engines):
    assert int8_engines['got'] == int8_engines['ref']
    assert [len(o) for o in int8_engines['got']] == \
        [m for _, m in BURST + [LONE]]
    cache = int8_engines['eng'].cache
    assert cache['k'].dtype == torch.int8
    assert cache['k_scale'].shape == cache['k'].shape[:-1]


def test_kv_dtype_env_applies_under_auto(int8_engines, monkeypatch):
    monkeypatch.setenv('SKYT_KV_DTYPE', 'int8')
    assert int8_engines['torch_eng']().cache['v'].dtype == torch.int8
    monkeypatch.setenv('SKYT_KV_DTYPE', 'fp4')   # bad value: model dtype
    assert int8_engines['torch_eng']().cache['v'].dtype == torch.float32
