"""n-gram speculative decoding in the PyTorch port against the JAX package,
on the CPU at the 'debug' preset in float32, paged cache with page size
16 and max_seq_len 128.

  * ops: the multi-query paged plain version against the Pallas
    _kernel_mq (interpret mode) — varied lengths, length 0, dummy-page
    rows, GQA, T in {1, 4} — and at T = 1 against the single-query
    plain version; append_tokens_layer against the JAX static
    (atol/rtol 2e-5, float32);
  * model: a paged prefill, then one 4-token verify step (s = 4), logits
    against JAX model.apply: atol/rtol 1e-4 on the f32 cache, 1e-3 on the
    int8 cache (and a decode step, s = 1, on the int8 cache);
  * engine: greedy streams EQUAL to the JAX engine's with spec_decode=3,
    alone and with kv_dtype='int8', on test_torch_engine.py's
    burst-plus-lone traffic; and, on the port alone, spec greedy equal
    to plain greedy, a looping prompt that accepts drafts, an EOS inside
    a verify run with the slot reused after it, the max_seq_len tail
    (with the history kept by its plain chunks), and a sampled
    co-tenant forcing sampled verify steps;
  * sampling: speculative_sample_step's greedy rows equal JAX's on the
    same logits; its sampled rows' first token is distributed as
    sequential sampling (the port alone, its own draws).
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer.paged_cache import PagePool as JaxPagePool
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.ops import paged_attention

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
MAX_SEQ = 128
PAGE = 16
BURST = [(5, 8), (17, 3), (33, 12), (9, 6)]   # (prompt length, max_new)
LONE = (11, 10)
LOOP = [5, 9, 2] * 8                          # n-gram friendly prompt


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


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               **tol)


# ------------------------------------------------------------------ ops
def paged_case(case, seed, t, slots=4, hq=4, hkv=2, d=64, n_pages=12,
               p=16):
    """q [S, T, Hq, d] f32, pools [n_pages, Hkv, P, d], tables, lengths:
    'varied' lengths, 'length_zero' slots, and 'dummy_rows' (released
    slots with all-zero rows and stale lengths, a reserved row with an
    unreserved gap). Lengths + T - 1 stay inside each row's pages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(slots, t, hq, d)).astype(np.float32)
    k_pool = rng.normal(size=(n_pages, hkv, p, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, hkv, p, d)).astype(np.float32)
    if case == 'varied':
        tables = [[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9], [10, 0, 0, 0]]
        lengths = [40, 17, 60, 0]
    elif case == 'length_zero':
        tables = [[2, 0, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0], [6, 7, 8, 0]]
        lengths = [0, 0, 12, 33]
    else:
        tables = [[0, 0, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0], [3, 0, 4, 0]]
        lengths = [9999, 20, 37, 40]
    return (q, k_pool, v_pool, np.asarray(tables, np.int32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize('t', [1, 4])
@pytest.mark.parametrize('case', ['varied', 'length_zero', 'dummy_rows'])
def test_mq_plain_version_matches_pallas_mq(case, t):
    q, kp, vp, tables, lengths = paged_case(case, 11, t)
    args = [_both(a) for a in (q, kp, vp, tables, lengths)]
    ref = jax_paged.paged_decode_attention_mq(*(a[0] for a in args))
    out = paged_attention.paged_decode_attention_mq(*(a[1] for a in args))
    assert out.shape == (4, t, 4, 64)
    assert np.isfinite(out.numpy()).all()
    _close(ref, out, ATTN_TOL)


def test_mq_at_one_token_is_the_single_query_plain_version():
    q, kp, vp, tables, lengths = paged_case('dummy_rows', 12, 1)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    mq = paged_attention.paged_decode_attention_mq(*args)[:, 0]
    sq = paged_attention.paged_decode_attention_reference(
        args[0][:, 0], *args[1:])
    torch.testing.assert_close(mq, sq, **ATTN_TOL)


def test_append_tokens_layer_matches_jax():
    """A 4-token run per slot: one run crosses a page boundary, a
    released slot's run (stale length past its row) clips into dummy
    page 0."""
    rng = np.random.default_rng(13)
    n_pages, h, p, d = 9, 2, 4, 8
    pool = rng.normal(size=(n_pages, h, p, d)).astype(np.float32)
    new_kv = rng.normal(size=(3, 4, h, d)).astype(np.float32)
    tables = np.array([[5, 2, 7], [1, 3, 0], [0, 0, 0]], np.int32)
    start = np.array([6, 1, 50], np.int32)
    ref = JaxPagePool.append_tokens_layer(
        jnp.asarray(pool), jnp.asarray(new_kv), jnp.asarray(tables),
        jnp.asarray(start))
    got = PagePool.append_tokens_layer(
        torch.from_numpy(pool.copy()), torch.from_numpy(new_kv),
        torch.from_numpy(tables), torch.from_numpy(start))
    # Page 0 takes the released slot's clipped writes (one run, no
    # duplicate cells), every other page the live runs'.
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- model
def jax_debug(max_seq=MAX_SEQ):
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=max_seq)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jm, jp


def port_model(jp):
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    cfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(tree, cfg))
    return model.eval()


@pytest.fixture(scope='module')
def debug_models():
    jm, jp = jax_debug()
    return jm, jp, port_model(jp)


def prefill_then_step(jm, jp, pm, quantized, s):
    """Two slots' prompts prefilled and scattered into pages (int8 pools
    when `quantized`), a released third slot, then one step of s tokens
    per slot at positions lens + 0..s-1 (s = 4: the verify step; s = 1: a
    decode step). Returns (JAX logits, port logits)."""
    cfg = pm.cfg
    apply = jax.jit(jm.apply)   # traced once a shape, not op by op
    rng = np.random.default_rng(3)
    page, n_pages, bucket = 8, 10, 16
    lens = [13, 6]
    shape = (cfg.n_layers, 1, bucket, cfg.n_kv_heads, cfg.head_dim)
    pshape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    pool_dt = (jnp.int8, torch.int8) if quantized else \
        (jnp.float32, torch.float32)
    jc_all = {'k': jnp.zeros(pshape, pool_dt[0]),
              'v': jnp.zeros(pshape, pool_dt[0])}
    tc_all = {'k': torch.zeros(pshape, dtype=pool_dt[1]),
              'v': torch.zeros(pshape, dtype=pool_dt[1])}
    if quantized:
        for n in ('k_scale', 'v_scale'):
            jc_all[n] = jnp.zeros(pshape[:-1], jnp.float32)
            tc_all[n] = torch.zeros(pshape[:-1])
    tables = np.array([[3, 4, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    last = []
    for slot, n in enumerate(lens):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = rng.integers(1, 256, n)
        lp = np.array([[n - 1]], np.int32)
        jl, jc = apply(
            jp, jnp.asarray(toks), positions=jnp.arange(bucket)[None, :],
            cache={'k': jnp.zeros(shape), 'v': jnp.zeros(shape)},
            logit_positions=jnp.asarray(lp))
        with torch.no_grad():
            _, tc = pm(torch.from_numpy(toks).long(),
                       cache={'k': torch.zeros(shape),
                              'v': torch.zeros(shape)},
                       logit_positions=torch.from_numpy(lp).long())
        ids = tables[slot, :-(-n // page)]
        for name in ('k', 'v'):
            if quantized:
                jc_all[name], jc_all[f'{name}_scale'] = \
                    JaxPagePool.insert_prompt_q(
                        jc_all[name], jc_all[f'{name}_scale'], jc[name],
                        jnp.asarray(ids))
                PagePool.insert_prompt_q(tc_all[name],
                                         tc_all[f'{name}_scale'], tc[name],
                                         torch.from_numpy(ids))
            else:
                jc_all[name] = JaxPagePool.insert_prompt(
                    jc_all[name], jc[name], jnp.asarray(ids))
                PagePool.insert_prompt(tc_all[name], tc[name],
                                       torch.from_numpy(ids))
        last.append(int(np.argmax(np.asarray(jl)[0, 0])))
    toks = np.concatenate(
        [np.array(last + [5], np.int32)[:, None],
         rng.integers(1, 256, (3, s - 1)).astype(np.int32)], 1)
    positions = np.array(lens + [41], np.int32)[:, None] + np.arange(s)
    jl, _ = apply(jp, jnp.asarray(toks), positions=jnp.asarray(positions),
                     cache={**jc_all, 'tables': jnp.asarray(tables)})
    with torch.no_grad():
        tl, _ = pm(torch.from_numpy(toks).long(),
                   positions=torch.from_numpy(positions).long(),
                   cache={**tc_all, 'tables': torch.from_numpy(tables)})
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize('kv,s', [('f32', 4), ('int8', 4), ('int8', 1)])
def test_step_logits_match_jax(debug_models, kv, s):
    """The verify step (s = 4) over the f32 and the int8 cache, and a
    decode step over the int8 cache. Rows 0-1 are live slots, row 2 a
    released one on the dummy page. int8: 1e-3, for codes that flip by
    one where the two frameworks' K/V projections land within ~1e-7 of a
    rounding boundary."""
    jm, jp, pm = debug_models
    ref, got = prefill_then_step(jm, jp, pm, kv == 'int8', s)
    assert got.shape == (3, s, 256)
    _close(ref, got, LOGIT_TOL if kv == 'f32' else INT8_LOGIT_TOL)


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
def setup(debug_models):
    jm, jp, _ = debug_models
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(1, 256, n).tolist(), m)
               for n, m in BURST + [LONE]]
    prompts[1] = (LOOP[:17], BURST[1][1])

    def jax_eng(**kw):
        return jax_engine.InferenceEngine(
            jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
            cache_mode='paged', page_size=PAGE, **kw)

    def torch_eng(num_slots=4, max_seq_len=MAX_SEQ, **kw):
        return torch_engine.InferenceEngine(
            port_model(jp), num_slots=num_slots, max_seq_len=max_seq_len,
            decode_chunk=4, page_size=PAGE, device='cpu', **kw)

    plain = _run(torch_eng(), torch_engine.SamplingParams, prompts)
    return {'prompts': prompts, 'plain': plain, 'jax_eng': jax_eng,
            'torch_eng': torch_eng}


@pytest.mark.parametrize('kv_dtype', ['auto', 'int8'])
def test_spec_greedy_streams_equal_jax(setup, kv_dtype):
    kw = dict(spec_decode=3, kv_dtype=kv_dtype)
    ref = _run(setup['jax_eng'](**kw), jax_engine.SamplingParams,
               setup['prompts'])
    eng = setup['torch_eng'](**kw)
    got = _run(eng, torch_engine.SamplingParams, setup['prompts'])
    assert got == ref
    assert [len(o) for o in got] == [m for _, m in BURST + [LONE]]
    assert eng.perf['spec_verify_steps'] > 0


def test_spec_greedy_equals_plain_greedy(setup):
    eng = setup['torch_eng'](spec_decode=3)
    got = _run(eng, torch_engine.SamplingParams, setup['prompts'])
    assert got == setup['plain']


def _gen(eng, prompts, max_new, **kw):
    eng.start()
    try:
        return [eng.generate(p, torch_engine.SamplingParams(
            max_new_tokens=max_new, **kw)) for p in prompts]
    finally:
        eng.stop()


def test_spec_accepts_on_looping_output(setup):
    """Greedy decode of a random-weight model falls into short loops;
    the proposer turns them into accepted multi-token steps."""
    eng = setup['torch_eng'](num_slots=1, spec_decode=4)
    out = _gen(eng, [LOOP], 64)
    plain = _gen(setup['torch_eng'](num_slots=1), [LOOP], 64)
    assert out == plain and len(out[0]) == 64
    p = eng.perf_stats()
    assert p['spec_accepted'] > 0, p
    assert p['spec_accept_per_step'] > 0.2, p


# A prompt that ends with the model's own greedy continuation of its
# first 7 tokens, so the continuation's next tokens are n-gram hits
# (seed-0 debug weights): greedy emits 212, 99, 246, 173, ... and one
# verify step accepts 99, 246, 173 as drafts.
EOS_PROMPT = [167, 192, 60, 72, 111, 68, 249, 23, 23, 58, 3, 82, 212, 99,
              246, 173, 42]
EOS = 246


def test_spec_eos_inside_a_run_and_slot_reuse(setup):
    """An EOS inside an accepted run ends the stream right after it (the
    run's later tokens are dropped, the step still counts in full), and
    the next requests reuse the slot."""
    prompts = [EOS_PROMPT, setup['prompts'][2][0][:21], LOOP[3:16]]
    plain = _gen(setup['torch_eng'](num_slots=1), prompts, 12,
                 eos_token=EOS)
    assert plain[0] == [212, 99, 246]
    eng = setup['torch_eng'](num_slots=1, spec_decode=3)
    eng.start()
    try:
        first = eng.generate(prompts[0], torch_engine.SamplingParams(
            max_new_tokens=12, eos_token=EOS))
        # The counted steps emitted more tokens than were delivered: the
        # cut-off fell inside a run.
        p = dict(eng.perf)
        assert p['spec_verify_steps'] + p['spec_accepted'] > \
            p['decode_tokens'], p
        rest = [eng.generate(pr, torch_engine.SamplingParams(
            max_new_tokens=12, eos_token=EOS)) for pr in prompts[1:]]
    finally:
        eng.stop()
    assert [first] + rest == plain


def test_spec_max_seq_tail(setup):
    """A request running into max_seq_len: the tail takes plain chunks
    instead of overrunning the cache, and those keep the device history
    current (it holds the prompt and every delivered token in place)."""
    prompt = setup['prompts'][2][0][:40]
    plain = _gen(setup['torch_eng'](num_slots=1, max_seq_len=64), [prompt],
                 64)
    eng = setup['torch_eng'](num_slots=1, max_seq_len=64, spec_decode=3)
    spec = _gen(eng, [prompt], 64)
    assert spec == plain
    assert len(spec[0]) < 64     # cut off by max_seq_len
    n = len(prompt) + len(spec[0])
    assert eng._dev_hist[0, :n].tolist() == prompt + spec[0]


def test_spec_survives_sampled_interlude(setup):
    """A sampled co-tenant makes every verify step a sampled one (the
    rejection rule for it, argmax acceptance for the greedy slot); the
    greedy stream stays the plain one and acceptance stays real."""
    eng = setup['torch_eng'](num_slots=2, spec_decode=4)
    plain = _gen(setup['torch_eng'](num_slots=2), [LOOP], 48)[0]
    eng.start()
    try:
        _, q_g = eng.submit(LOOP, torch_engine.SamplingParams(
            max_new_tokens=48))
        _, q_s = eng.submit(setup['prompts'][0][0], torch_engine.SamplingParams(
            max_new_tokens=4, temperature=0.8, top_k=40))
        sampled = _drain(q_s)
        greedy = _drain(q_g)
    finally:
        eng.stop()
    assert len(sampled) == 4 and all(0 <= t < 256 for t in sampled)
    assert greedy == plain
    assert eng.perf['spec_accepted'] > 0, eng.perf


# ------------------------------------------------------------- sampling
def test_speculative_sample_step_greedy_rows_match_jax():
    """Greedy slots: the emitted rows and accepted counts equal JAX's on
    the same logits, whatever the random numbers; a sampled slot beside
    them does not change them."""
    vocab, k = 16, 3
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, k + 1, vocab)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = np.stack([greedy[0, :k], [0, 0, 0],
                      greedy[2, :k]]).astype(np.int32)
    draft[0, 2] = (draft[0, 2] + 1) % vocab   # reject the last draft
    temps = np.array([0.0, 0.0, 0.7], np.float32)
    topks = np.zeros((3,), np.int32)
    topps = np.ones((3,), np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    out_j, acc_j = jax.jit(jax_engine.speculative_sample_step)(
        *(jnp.asarray(a) for a in (logits, draft, temps, topks, topps)),
        keys)
    u = torch.from_numpy(rng.random((3, k + vocab)).astype(np.float32))
    out_t, acc_t = torch_engine.speculative_sample_step(
        *(torch.from_numpy(a) for a in (logits, draft, temps, topks,
                                        topps)), u[:, :k], u[:, k:])
    np.testing.assert_array_equal(out_t[:2].numpy(), np.asarray(out_j)[:2])
    np.testing.assert_array_equal(acc_t[:2].numpy(), np.asarray(acc_j)[:2])
    assert acc_t[0] == 2 and acc_t[1] == int(greedy[1, 0] == 0)


def test_speculative_sample_step_unbiased():
    """The first emitted token of a sampled slot is distributed exactly
    as sequential sampling from the filtered target distribution (accept
    d w.p. p(d), else the residual), whatever the draft: 20000 trials as
    20000 slots, the port's own draws."""
    vocab, k, trials = 8, 2, 20000
    rng = np.random.default_rng(0)
    row = (rng.normal(size=(k + 1, vocab)) * 2.0).astype(np.float32)
    logits = torch.from_numpy(row)[None].expand(trials, -1, -1)
    temp = 0.7
    temps = torch.full((trials,), temp)
    draft = torch.tensor([[3, 5]], dtype=torch.int32).expand(trials, -1)
    gen = torch.Generator().manual_seed(0)

    def first_tokens(topk, topp=1.0):
        u = torch.rand((trials, k + vocab), generator=gen)
        out, acc = torch_engine.speculative_sample_step(
            logits, draft, temps, torch.full((trials,), topk,
                                             dtype=torch.int32),
            torch.full((trials,), topp), u[:, :k], u[:, k:])
        emp = np.bincount(out[:, 0].numpy(), minlength=vocab) / trials
        return emp, acc.numpy()

    def softmax(lg):
        e = np.exp(lg - lg[np.isfinite(lg)].max())
        return e / e.sum()

    l0 = row[0].astype(np.float64)
    emp, acc = first_tokens(0)
    np.testing.assert_allclose(emp, softmax(l0 / temp), atol=0.015)
    assert 0 < int(np.sum(acc > 0)) < trials     # acceptance happens
    emp3, _ = first_tokens(3)
    np.testing.assert_allclose(
        emp3, softmax(np.where(l0 < np.sort(l0)[-3], -np.inf, l0) / temp),
        atol=0.015)
    empp, _ = first_tokens(0, topp=0.6)
    order = np.argsort(-l0)
    sp = softmax(l0[order] / temp)
    keep = order[(np.cumsum(sp) - sp) < 0.6]
    lp = np.full(vocab, -np.inf)
    lp[keep] = l0[keep] / temp
    np.testing.assert_allclose(empp, softmax(lp), atol=0.015)
