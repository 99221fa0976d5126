"""The PyTorch port's windowed Llama (Mistral's sliding window) against
the JAX package's, on the CPU in float32: the 'debug' preset with
sliding_window=8 (window_pattern 1: every layer, as Mistral; 2: layer 0
windowed, layer 1 not) and prompts longer than the window. The same
weights cross through params_from_jax. Held:

  * logits with no cache, a packed ragged prefill with segment ids, and
    paged decode and verify steps (a windowed layer attends through the
    gather view in both packages; an unwindowed one takes the paged
    kernels, the Pallas ones in interpret mode on the JAX side);
  * greedy token streams of the port's engine against the JAX engine's
    (both with prefix caching on, their default), plain, with
    kv_dtype='int8' and with spec_decode=2;
  * one train step (loss, gradients, updated parameters) against JAX's
    value_and_grad and make_train_step;
  * that the window changes the logits;
  * that sft.main runs its steps with deterministic algorithms on and
    gives the caller's setting back.

Tolerances as for the unwindowed model: logits 1e-4, gradients atol
1e-6 / rtol 1e-4, steps 1e-5 (tests/test_torch_model.py,
tests/test_torch_train.py); token streams equal.
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
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.train import sft, trainer

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
WINDOW = 8
MAX_SEQ = 128


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(pattern, window=WINDOW):
    kw = dict(sliding_window=window, window_pattern=pattern,
              max_seq_len=MAX_SEQ)
    return (dataclasses.replace(jax_llama.CONFIGS['debug'], **kw),
            # 'flash': the debug preset's head_dim 16 takes the reference
            # under 'auto' (the _flash_ok rule); this holds the flash path
            # to JAX.
            dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash',
                                **kw))


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))


def _port(jp, cfg):
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(_tree(jp), cfg))
    return model.eval()


@pytest.fixture(scope='module', params=[1, 2], ids=['every', 'alternate'])
def models(request):
    jcfg, pcfg = _cfgs(request.param)
    jm = jax_llama.LlamaModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jm, jp, _port(jp, pcfg)


def _close(ref, got, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


def test_config_windows_layers_as_the_reference():
    assert [llama.CONFIGS['mistral-7b'].layer_window(i)
            for i in (0, 1, 31)] == [4096] * 3
    _, pcfg = _cfgs(2)
    assert [pcfg.layer_window(i) for i in range(4)] == [8, 0, 8, 0]
    for f in dataclasses.fields(llama.LlamaConfig):
        ref = getattr(jax_llama.CONFIGS['mistral-7b'], f.name)
        assert getattr(llama.CONFIGS['mistral-7b'], f.name) == ref, f.name


@pytest.mark.parametrize('scan', [True, False])
def test_params_from_jax_carries_a_windowed_tree(scan):
    """A windowed config's tree has the unwindowed one's leaves, shapes
    and dtypes and no others, scanned or not, so params_from_jax maps it
    as it maps any (the models fixture loads it strictly)."""
    jcfg, _ = _cfgs(2)
    trees = [jax.eval_shape(
        jax_llama.LlamaModel(dataclasses.replace(
            jcfg, scan_layers=scan, sliding_window=w)).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        for w in (WINDOW, 0)]
    assert jax.tree_util.tree_structure(trees[0]) == \
        jax.tree_util.tree_structure(trees[1])
    assert jax.tree_util.tree_leaves(trees[0]) == \
        jax.tree_util.tree_leaves(trees[1])


def test_logits_no_cache(models):
    jm, jp, pm = models
    tokens = np.random.default_rng(1).integers(0, 256, (2, 40))
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens))
    _close(jax.jit(jm.apply)(jp, jnp.asarray(tokens, jnp.int32)), got)


def test_window_changes_the_logits(models):
    """The same weights without the window give other logits past the
    window (and the same ones inside it)."""
    _, _, pm = models
    plain = llama.LlamaModel(dataclasses.replace(pm.cfg, sliding_window=0))
    plain.load_state_dict(pm.state_dict())
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (1, 40)))
    with torch.no_grad():
        a, b = pm(tokens), plain.eval()(tokens)
    torch.testing.assert_close(a[:, :WINDOW], b[:, :WINDOW], rtol=0,
                               atol=1e-6)
    assert (a[:, WINDOW:] - b[:, WINDOW:]).abs().max() > 1e-2


def test_packed_prefill_with_segments(models):
    """Prompts of 5, 19 and 12 tokens packed at page-aligned offsets with
    id-0 tails, per-segment positions and a zeroed dense cache."""
    jm, jp, pm = models
    rng = np.random.default_rng(2)
    t, page = 64, 8
    tokens = np.zeros((1, t), np.int32)
    segs = np.zeros((1, t), np.int32)
    poss = np.zeros((1, t), np.int32)
    logit_pos = np.zeros((1, 4), np.int32)
    off = 0
    for j, n in enumerate((5, 19, 12)):
        span = -(-n // page) * page
        tokens[0, off:off + n] = rng.integers(1, 256, n)
        segs[0, off:off + n] = j + 1
        poss[0, off:off + span] = np.arange(span)
        logit_pos[0, j] = off + n - 1
        off += span
    cfg = pm.cfg
    shape = (cfg.n_layers, 1, t, cfg.n_kv_heads, cfg.head_dim)
    jl, _ = jax.jit(jm.apply)(
        jp, jnp.asarray(tokens), positions=jnp.asarray(poss),
        segment_ids=jnp.asarray(segs),
        cache={'k': jnp.zeros(shape), 'v': jnp.zeros(shape)},
        logit_positions=jnp.asarray(logit_pos))
    with torch.no_grad():
        tl, _ = pm(torch.from_numpy(tokens).long(),
                   positions=torch.from_numpy(poss).long(),
                   segment_ids=torch.from_numpy(segs),
                   cache={'k': torch.zeros(shape), 'v': torch.zeros(shape)},
                   logit_positions=torch.from_numpy(logit_pos).long())
    _close(jl, tl)


def test_paged_steps(models):
    """Two prompts (13 and 22 tokens) prefilled and scattered into pages,
    a released third slot, then two decode steps and one verify step of 3
    tokens per slot. (The int8 engine stream below holds int8 pools.)"""
    jm, jp, pm = models
    apply = jax.jit(jm.apply)   # traced once a shape, not op by op
    cfg = pm.cfg
    rng = np.random.default_rng(3)
    page, n_pages, bucket = 8, 12, 32
    lens = [13, 22]
    shape = (cfg.n_layers, 1, bucket, cfg.n_kv_heads, cfg.head_dim)
    pshape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    jc_all = {n: jnp.zeros(pshape) for n in ('k', 'v')}
    tc_all = {n: torch.zeros(pshape) for n in ('k', 'v')}
    # Enough pages for every step's writes; the released slot's row is
    # all dummy page 0.
    tables = np.array([[3, 4, 5, 0], [7, 8, 9, 10], [0, 0, 0, 0]],
                      np.int32)
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
            tl, tc = pm(torch.from_numpy(toks).long(),
                        cache={'k': torch.zeros(shape),
                               'v': torch.zeros(shape)},
                        logit_positions=torch.from_numpy(lp).long())
        _close(jl, tl)
        ids = tables[slot, :-(-n // page)]
        for name in ('k', 'v'):
            jc_all[name] = JaxPagePool.insert_prompt(
                jc_all[name], jc[name], jnp.asarray(ids))
            PagePool.insert_prompt(tc_all[name], tc[name],
                                   torch.from_numpy(ids))
        last.append(int(np.argmax(np.asarray(jl)[0, 0])))
    toks = np.array(last + [5], np.int32)[:, None]
    base = np.array(lens + [41], np.int32)[:, None]
    for step, s in enumerate((1, 1, 3)):
        positions = base + np.arange(s)
        jl, jc = apply(jp, jnp.asarray(toks),
                          positions=jnp.asarray(positions),
                          cache={**jc_all, 'tables': jnp.asarray(tables)})
        jc_all.update({n: jc[n] for n in jc_all})
        with torch.no_grad():
            tl, _ = pm(torch.from_numpy(toks).long(),
                       positions=torch.from_numpy(positions).long(),
                       cache={**tc_all, 'tables': torch.from_numpy(tables)})
        _close(jl, tl)
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)
        s_next = (1, 1, 3, 3)[step + 1]
        toks = np.concatenate(
            [nxt[:, None],
             rng.integers(1, 256, (3, s_next - 1)).astype(np.int32)], 1)
        base = base + s


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
    jcfg, pcfg = _cfgs(2)
    jm = jax_llama.LlamaModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(0)
    seq = rng.integers(1, 256, 6).tolist()
    prompts = [(rng.integers(1, 256, n).tolist(), m) for n, m in BURST]
    # A looping prompt, so the n-gram proposer finds drafts.
    prompts[0] = ((seq * 4)[:BURST[0][0]], BURST[0][1])
    prompts.append((rng.integers(1, 256, LONE[0]).tolist(), LONE[1]))
    return jm, jp, pcfg, prompts


@pytest.mark.parametrize('opts', [{}, {'kv_dtype': 'int8'},
                                  {'spec_decode': 2}],
                         ids=['plain', 'int8', 'spec'])
def test_engine_greedy_streams_equal_jax(engine_setup, opts):
    """Window 8 on layer 0 (pattern 2): the burst (ragged prefill) and
    the lone prompt, all longer than the window, decode through the
    gather view on layer 0 and the paged kernels on layer 1."""
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
    assert teng.perf['ragged_dispatches'] == 1
    if opts.get('spec_decode'):
        assert teng.perf['spec_verify_steps'] > 0


# --------------------------------------------------------------- train
def test_train_step_matches_jax():
    """Loss and gradients of one batch (jax.value_and_grad), then one
    make_train_step step: loss, grad_norm and the updated parameters."""
    jcfg, pcfg = _cfgs(2)
    b, s = 2, 24
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (b, s + 1)).astype(np.int32)
    batch = {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    jm = jax_llama.LlamaModel(jcfg)
    tcfg_kw = dict(warmup_steps=1, total_steps=10)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(),
                               devices=jax.devices()[:1])
    jtx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**tcfg_kw))
    jstate, _ = jax_trainer.create_sharded_state(
        jm, jtx, mesh, jnp.zeros((b, s), jnp.int32), jax.random.PRNGKey(0))

    def loss_fn(params):
        logits = jm.apply({'params': params}, jnp.asarray(batch['tokens']))
        return jax_trainer.cross_entropy_loss(
            logits, jnp.asarray(batch['targets']))[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    pm = llama.LlamaModel(pcfg)
    pm.load_state_dict(weights.params_from_jax(
        _tree({'params': jstate.params}), pcfg))
    loss, _ = trainer.cross_entropy_loss(pm(tb['tokens']), tb['targets'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **STEP_TOL)
    ref = weights.params_from_jax(_tree({'params': jgrads}), pcfg)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   **GRAD_TOL, err_msg=name)

    jstep = jax_trainer.make_train_step(jm, jtx, mesh, donate=False)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    pm.zero_grad(set_to_none=True)
    tx = trainer.make_optimizer(trainer.TrainerConfig(**tcfg_kw))
    state, met = trainer.make_train_step(pm, tx)(
        trainer.create_state(pm, tx), tb)
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   **STEP_TOL, err_msg=key)
    ref = weights.params_from_jax(_tree({'params': jstate.params}), pcfg)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), **STEP_TOL,
                                   err_msg=name)


@pytest.mark.parametrize('before', [False, True])
def test_sft_main_runs_deterministic_and_restores(monkeypatch, before):
    """Every step of sft.main runs with deterministic algorithms on (the
    flash backward's ordered dq adds) and without the fill of
    uninitialized memory; the caller's settings are back after main
    returns and after it exits (SystemExit)."""
    det = torch.utils.deterministic
    seen = []
    real = trainer.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def spy(state, batch):
            seen.append((torch.are_deterministic_algorithms_enabled(),
                         det.fill_uninitialized_memory))
            return step(state, batch)
        return spy
    monkeypatch.setattr(trainer, 'make_train_step', make)
    monkeypatch.setattr(det, 'fill_uninitialized_memory', True)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(before)
    try:
        out = sft.main(['--device', 'cpu', '--model', 'debug', '--steps',
                        '2', '--batch', '1', '--seq', '16', '--log-every',
                        '1', '--prefetch', '0'])
        assert out['steps'] == 2 and seen == [(True, False)] * 2
        assert torch.are_deterministic_algorithms_enabled() == before
        with pytest.raises(SystemExit):
            sft.main(['--device', 'cpu', '--model', 'debug-moe',
                      '--lora-rank', '4'])
        assert torch.are_deterministic_algorithms_enabled() == before
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert det.fill_uninitialized_memory
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
