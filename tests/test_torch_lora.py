"""Multi-LoRA serving in the PyTorch port against the JAX package, on the
CPU at the 'debug' preset in float32, paged cache with page size 16 and
max_seq_len 128. Adapters are random trees in the training layout
(train/lora.py init_lora_params, leaves redrawn with numpy), ranks 4 and 2
(the stack pads to 4), alphas 8 and 4.

  * ops: the plain versions lora_gather_reference / lora_grouped_reference
    against the JAX floors _xla_gather / _xla_grouped and the Pallas
    kernels _pallas_gather / _pallas_grouped in interpret mode
    (atol/rtol 1e-5), with id-0 rows exactly 0, random per-token ids and a
    mixed-rank padded stack (ranks 4 and 2, and 160 and 4: above one
    128-column rank tile); the wrappers' CPU dispatch;
  * the kernel's plan (lora_plan, pure Python, at 132 and at 8 SMs) for
    chip_smoke.py's LoRA shapes and odd ones: every token in exactly one
    tile, the column chunks cover `out` once, the rank tiles cover r, the
    cluster divides the column tiles and splits all of `in`, T holds a
    group's passes, shared memory within the card's 232,448 bytes;
  * stacks: build_stack, build_stack_assigned, graft_adapter and zero_slot
    equal the JAX functions' output after lora_stack_from_jax, for
    scanned and unscanned trees; validate_stack rejects another model's
    stack; parse_lora_flag as JAX's;
  * model: logits with a stack and ids [B] and [B, S] within 1e-4 of JAX
    LlamaModel.apply with the 'lora' and 'lora_ids' collections, also for
    a stack of a rank-256 and a rank-4 adapter;
  * engine: a burst with ids [1, 2, 0] (ragged admission, then decode) and
    a lone adapter request give greedy streams EQUAL to the JAX engine's
    on the same stack; spec_decode=3 with adapters equals the port's plain
    LoRA engine, and int8 KV with adapters equals its own spec_decode=3
    run (exact for greedy), keeps the int8 engine's stream for the id-0
    request and changes an adapter request's; an out-of-range id raises
    ValueError; a freed slot's id is reset to 0;
    request_adapter_update applies at a tick boundary (a request on the
    newly grafted id then gets that adapter's tokens; a draining update
    that cannot apply times out with the old stack live); adapter_in_use
    holds only while a request references the id.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import lora as jax_lora
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import lora as jax_ops
from skypilot_tpu.train import lora as jax_train_lora
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import lora as torch_lora
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.ops import lora as lora_ops

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 128
PAGE = 16
ADAPTERS = ((4, 8.0, 1), (2, 4.0, 2))   # (rank, alpha, seed): ids 1, 2
GRAFT = (3, 6.0, 3)                     # a third adapter, grafted later
BURST = [(5, 8, 1), (17, 6, 2), (33, 10, 0)]   # (length, max_new, lora_id)
LONE = (11, 8, 2)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adapter(params, rank, alpha, seed):
    """A trained-looking adapter in the training layout: init_lora_params'
    tree with A and B redrawn N(0, 0.1) (B = 0 would make it vacuous)."""
    tree = jax_train_lora.init_lora_params(
        params, jax_train_lora.LoRAConfig(rank=rank, alpha=alpha),
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), tree), \
        alpha


def _init(cfg):
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))
    return jm, jp, _np_tree(nn.meta.unbox(jp))['params']


@pytest.fixture(scope='module')
def base():
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm, jp, params = _init(cfg)
    adapters = [_adapter(params, *a) for a in ADAPTERS]
    graft = _adapter(params, *GRAFT)
    jstack = jax_lora.build_stack(adapters, dtype='float32')
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    sd = weights.params_from_jax({'params': params}, pcfg)

    def port_model():
        model = llama.LlamaModel(pcfg)
        model.load_state_dict(sd)
        return model

    return {'cfg': cfg, 'jm': jm, 'jp': jp, 'params': params,
            'adapters': adapters, 'graft': graft, 'jstack': jstack,
            'stack': torch_lora.build_stack(adapters, dtype='float32'),
            'port_model': port_model, 'pcfg': pcfg}


def _assert_stacks_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key == 'scaling':
            np.testing.assert_array_equal(got[key].numpy(), val.numpy())
            continue
        for g, w in zip(got[key], val):
            assert g.shape == w.shape and g.dtype == w.dtype, key
            np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------------------------ ops
def op_case(per_token, seed=0, bsz=3, seq=8, din=32, dout=24,
            ranks=(4, 2)):
    """x [3, 8, 32] f32, a stack of 3 (id 0 zeros, ranks 4 and 2 padded
    to 4, or the given ranks padded to the largest); ids [1, 2, 0] per
    sequence, or random 0..2 per token."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, seq, din)).astype(np.float32)
    a = np.zeros((3, din, max(ranks)), np.float32)
    b = np.zeros((3, max(ranks), dout), np.float32)
    for i, r in enumerate(ranks, 1):
        a[i, :, :r] = rng.normal(size=(din, r))
        b[i, :r] = rng.normal(size=(r, dout))
    scaling = np.array([0.0, 2.0, 2.0], np.float32)
    ids = (rng.integers(0, 3, (bsz, seq)) if per_token
           else np.array([1, 2, 0]))[:bsz].astype(np.int32)
    return x, a, b, ids, scaling[ids]


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize('per_token', [False, True],
                         ids=['gather', 'grouped'])
@pytest.mark.parametrize('against', ['xla_floor', 'pallas_interpret',
                                     'xla_floor_r160',
                                     'pallas_interpret_r160'])
def test_plain_versions_match_jax(per_token, against):
    """The _r160 cases: ranks 160 and 4 (padded to 160), more than one
    128-column rank tile of the kernel."""
    ranks = (160, 4) if against.endswith('_r160') else (4, 2)
    args = op_case(per_token, seed=1 + per_token, ranks=ranks)
    jargs = [jnp.asarray(v) for v in args]
    if against.startswith('xla_floor'):
        fn = jax_ops._xla_grouped if per_token else jax_ops._xla_gather
        want = fn(*jargs)
    elif per_token:
        want = jax_ops._pallas_grouped(*jargs, block_t=8, interpret=True)
    else:
        want = jax_ops._pallas_gather(*jargs, block_s=8, interpret=True)
    plain = lora_ops.lora_grouped_reference if per_token else \
        lora_ops.lora_gather_reference
    got = plain(*_torch(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    ids = args[3]
    zero = ids == 0 if per_token else np.broadcast_to(
        (ids == 0)[:, None], ids.shape + (args[0].shape[1],))
    assert zero.any() and (got.numpy()[zero] == 0).all()


@pytest.mark.parametrize('per_token', [False, True],
                         ids=['gather', 'grouped'])
def test_wrappers_dispatch_on_cpu(per_token):
    """CPU tensors take the plain versions: ids [B] the gather one, [B, S]
    the grouped one; add_lora_delta_ adds in place and keeps id-0 rows."""
    lora_ops.reset_launches()
    x, a, b, ids, scale = _torch(*op_case(per_token, seed=3))
    plain = lora_ops.lora_grouped_reference if per_token else \
        lora_ops.lora_gather_reference
    ref = plain(x, a, b, ids, scale)
    torch.testing.assert_close(lora_ops.grouped_lora_delta(
        x, a, b, ids, scale), ref, rtol=0, atol=0)
    y = torch.randn(ref.shape, generator=torch.Generator().manual_seed(0))
    want = y + ref
    out = lora_ops.add_lora_delta_(y, x, a, b, ids, scale)
    assert out is y
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert lora_ops.launches == dict.fromkeys(lora_ops.KERNELS, 0)


# ----------------------------------------------------------------- plan
# (name, tokens, in, r, out, N): chip_smoke.py's LORA_CASES shapes (ids
# [B] or [B, S] alike: tiles follow tokens) and odd ones.
PLAN_CASES = (
    ('gather_decode', 8, 4096, 16, 14336, 4),
    ('gather_decode_down', 8, 14336, 16, 4096, 4),
    ('gather_verify', 32, 4096, 16, 14336, 4),
    ('gather_lone', 512, 4096, 16, 14336, 4),
    ('grouped_burst', 2048, 4096, 16, 14336, 4),
    ('grouped_random', 398, 4096, 16, 1024, 4),
    ('gather_decode_r256', 8, 4096, 256, 14336, 4),
    ('gather_decode_sparse', 8, 4096, 16, 14336, 9),
    ('odd', 15, 64, 4, 32, 4),
    ('ragged', 63, 100, 12, 37, 4),
    ('ragged_r200', 46, 100, 200, 37, 4),
    ('many_adapters', 64, 4096, 16, 14336, 17),
    ('rank_48', 100, 4096, 48, 14336, 9),
    ('rank_512', 2048, 4096, 512, 14336, 4),
    ('one_token', 1, 16, 8, 8, 2),
)


def _plan_cases():
    for case in PLAN_CASES:
        for sms in (132, 8):
            for in_place in (False, True):
                yield pytest.param(case, sms, in_place,
                                   id=f'{case[0]}-{sms}sm-'
                                   f'{"inplace" if in_place else "delta"}')


@pytest.mark.parametrize('case,sms,in_place', list(_plan_cases()))
def test_lora_plan_covers_the_call(case, sms, in_place):
    _, tokens, din, r, dout, n = case
    plan = lora_ops.lora_plan(tokens, din, r, dout, n, in_place, sms)
    tm = plan.tile_rows
    assert tm in (16, 32, 64)
    # Every token lies in exactly one tile: tile i holds [i * tm, ...).
    assert plan.row_tiles == -(-tokens // tm)
    owner = np.repeat(np.arange(plan.row_tiles), tm)[:tokens]
    assert np.array_equal(np.bincount(owner, minlength=plan.row_tiles),
                          [min(tm, tokens - i * tm)
                           for i in range(plan.row_tiles)])
    if tokens <= 64:
        assert plan.row_tiles == 1     # decode and verify: one tile
    # The column chunks cover `out` once.
    covered = np.zeros(dout, np.int64)
    for blk in range(plan.col_tiles):
        for c in range(plan.col_passes):
            lo = (blk * plan.col_passes + c) * lora_ops.PASS_COLS
            covered[lo:lo + lora_ops.PASS_COLS] += 1
    assert (covered == 1).all()
    # The rank tiles cover r, each a multiple of 16 and at most 128.
    wr = plan.rank_width
    assert wr % 16 == 0 and 16 <= wr <= 128
    assert (plan.rank_tiles - 1) * wr < r <= plan.rank_tiles * wr
    assert plan.items_per_pass * wr <= 128
    # The cluster divides the column tiles, and its spans cover `in`.
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.col_tiles % plan.cluster == 0
    assert plan.span % 16 == 0 and plan.span * plan.cluster >= din
    assert (plan.cluster - 1) * plan.span < din or plan.cluster == 1
    # T holds the passes of a group of whole ids.
    wp = plan.items_per_pass * wr
    passes = -(-plan.ids_per_group * plan.rank_tiles // plan.items_per_pass)
    assert plan.ids_per_group >= 1 and passes * wp <= plan.t_cols
    assert plan.t_cols % 64 == 0
    # A chunk is one TMA box of up to 256 rows, or two of 256.
    assert plan.chunk_rows % 16 == 0 and (16 <= plan.chunk_rows <= 256 or
                                          plan.chunk_rows == 512)
    assert plan.s_stages >= 1 and plan.e_stages >= 1
    # Shared memory within the card's limit (and the count the kernel
    # makes, lora_smem_bytes).
    assert plan.smem_bytes == lora_ops.lora_smem_bytes(
        tm, wr, plan.items_per_pass, plan.t_cols, plan.chunk_rows,
        plan.s_stages, plan.e_stages, in_place)
    assert plan.smem_bytes <= 232448
    assert plan.grid == (plan.row_tiles, plan.col_tiles)


def test_lora_plan_is_cached_and_refuses_nonsense():
    args = (8, 4096, 16, 14336, 4, False, 132)
    assert lora_ops.lora_plan(*args) is lora_ops.lora_plan(*args)
    with pytest.raises(ValueError, match='positive'):
        lora_ops.lora_plan(8, 4096, 0, 14336, 4, False, 132)


def test_lora_plan_takes_ranks_above_128():
    """No rank refusal: ranks above 128 go in 128-column rank tiles (the
    kernel held r <= 128 before)."""
    assert not hasattr(lora_ops, 'MAX_RANK')
    for r in (129, 200, 256, 1024):
        plan = lora_ops.lora_plan(8, 4096, r, 14336, 4, True, 132)
        assert plan.rank_width == 128
        assert plan.rank_tiles == -(-r // 128)


# --------------------------------------------------------------- stacks
@pytest.fixture(scope='module')
def unscanned(base):
    cfg = dataclasses.replace(base['cfg'], scan_layers=False)
    _, _, params = _init(cfg)
    return {'adapters': [_adapter(params, *a) for a in ADAPTERS],
            'graft': _adapter(params, *GRAFT), 'cfg': cfg}


def _layout(base, unscanned, layout):
    return base if layout == 'scanned' else unscanned


@pytest.mark.parametrize('layout', ['scanned', 'unscanned'])
def test_build_stack_matches_jax(base, unscanned, layout):
    lay = _layout(base, unscanned, layout)
    want = weights.lora_stack_from_jax(
        _np_tree(jax_lora.build_stack(lay['adapters'], dtype='float32')),
        base['pcfg'])
    got = torch_lora.build_stack(lay['adapters'], dtype='float32')
    _assert_stacks_equal(got, want)
    assert len(got) == 2 * 7 + 1           # 2 layers x 7 projections
    assert got['layers.1.mlp.w_down'][0].shape == (3, 128, 4)
    torch_lora.validate_stack(got, base['port_model']())


@pytest.mark.parametrize('layout', ['scanned', 'unscanned'])
def test_assigned_graft_and_zero_match_jax(base, unscanned, layout):
    lay = _layout(base, unscanned, layout)
    (ta, aa), (tb, ab) = lay['adapters']
    tc, ac = lay['graft']
    pcfg = base['pcfg']

    def conv(js):
        return weights.lora_stack_from_jax(_np_tree(js), pcfg)
    jas = jax_lora.build_stack_assigned({1: (ta, aa), 3: (tb, ab)}, 5,
                                        dtype='float32')
    pas = torch_lora.build_stack_assigned({1: (ta, aa), 3: (tb, ab)}, 5,
                                          dtype='float32')
    _assert_stacks_equal(pas, conv(jas))
    for aid in (2, 5):                       # set in place, append
        _assert_stacks_equal(torch_lora.graft_adapter(pas, aid, tc, ac),
                             conv(jax_lora.graft_adapter(jas, aid, tc, ac)))
    _assert_stacks_equal(torch_lora.zero_slot(pas, 1),
                         conv(jax_lora.zero_slot(jas, 1)))
    # Pure: the input stack is untouched.
    _assert_stacks_equal(pas, conv(jas))
    with pytest.raises(ValueError, match='out of range'):
        torch_lora.graft_adapter(pas, 7, tc, ac)
    with pytest.raises(ValueError, match='exceeds'):
        torch_lora.graft_adapter(torch_lora.build_stack([(tb, ab)]), 1, ta,
                                 aa)


def _tree(layers, din, dout, hidden):
    """A numpy adapter tree (scanned training layout) for a model of the
    given depth and widths."""
    rng = np.random.default_rng(0)
    shapes = {'attn': {'wq': (din, din), 'wk': (din, dout),
                       'wv': (din, dout), 'wo': (din, din)},
              'mlp': {'w_gate': (din, hidden), 'w_up': (din, hidden),
                      'w_down': (hidden, din)}}
    return {'layers': {scope: {name: {'kernel': {
        'a': rng.normal(size=(layers, i, 2)).astype(np.float32),
        'b': rng.normal(size=(layers, 2, o)).astype(np.float32)}}
        for name, (i, o) in projs.items()}
        for scope, projs in shapes.items()}}


@pytest.mark.parametrize('other', ['deeper', 'wider'])
def test_validate_stack_rejects_another_models_stack(base, other):
    model = base['port_model']()
    good = torch_lora.build_stack([(_tree(2, 64, 32, 128), 4.0)],
                                  dtype='float32')
    torch_lora.validate_stack(good, model)
    tree = _tree(3, 64, 32, 128) if other == 'deeper' else \
        _tree(2, 96, 32, 128)
    stack = torch_lora.build_stack([(tree, 4.0)], dtype='float32')
    with pytest.raises(ValueError, match='does not match the serving'):
        torch_lora.validate_stack(stack, model)
    with pytest.raises(ValueError, match='does not match the serving'):
        torch_engine.InferenceEngine(model, device='cpu', lora_stack=stack)


def test_parse_lora_flag_matches_jax():
    flags = ['a=/tmp/x', 'b=gs://bkt/path:32', 'c=/tmp/y:8.5',
             'd=gs://bkt/ckpt']
    got = torch_lora.parse_lora_flag(flags)
    want = jax_lora.parse_lora_flag(flags)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    for bad, match in ((['justapath'], 'name=path'),
                       (['a=/x', 'a=/y'], 'duplicate')):
        with pytest.raises(ValueError, match=match):
            torch_lora.parse_lora_flag(bad)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize('per_token', [False, True],
                         ids=['ids_B', 'ids_BS'])
def test_model_logits_match_jax(base, per_token):
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 256, (3, 12)).astype(np.int32)
    ids = (rng.integers(0, 3, (3, 12)) if per_token
           else np.array([1, 2, 0])).astype(np.int32)
    want = base['jm'].apply(
        {'params': nn.meta.unbox(base['jp'])['params'],
         'lora': base['jstack'],
         'lora_ids': {'ids': jnp.asarray(ids)}}, jnp.asarray(tokens))
    model = base['port_model']()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), lora=base['stack'],
                    lora_ids=torch.from_numpy(ids))
        plain = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # The adapters move the logits; id 0 (a whole sequence) is the base.
    assert not np.allclose(got.numpy()[0], plain.numpy()[0], atol=1e-3)
    if not per_token:
        np.testing.assert_array_equal(got.numpy()[2], plain.numpy()[2])


@pytest.mark.parametrize('per_token', [False, True],
                         ids=['ids_B', 'ids_BS'])
def test_model_logits_match_jax_rank256_stack(base, per_token):
    """A stack of a rank-256 and a rank-4 adapter (padded to 256: two of
    the kernel's rank tiles) through the model, against JAX."""
    adapters = [_adapter(base['params'], 256, 512.0, 5),
                _adapter(base['params'], 4, 8.0, 6)]
    jstack = jax_lora.build_stack(adapters, dtype='float32')
    stack = torch_lora.build_stack(adapters, dtype='float32')
    assert stack['layers.0.attn.wq'][0].shape[-1] == 256
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 256, (3, 12)).astype(np.int32)
    ids = (rng.integers(0, 3, (3, 12)) if per_token
           else np.array([1, 2, 0])).astype(np.int32)
    want = base['jm'].apply(
        {'params': nn.meta.unbox(base['jp'])['params'], 'lora': jstack,
         'lora_ids': {'ids': jnp.asarray(ids)}}, jnp.asarray(tokens))
    model = base['port_model']()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), lora=stack,
                    lora_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# --------------------------------------------------------------- engine
def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _serve(eng, mod, prompts):
    """The burst submitted BEFORE start() (ragged admission), drained;
    then the lone request (single admission)."""
    burst = [eng.submit(p, mod.SamplingParams(max_new_tokens=m,
                                              lora_id=lid))[1]
             for p, m, lid in prompts[:-1]]
    eng.start()
    try:
        outs = [_drain(q) for q in burst]
        p, m, lid = prompts[-1]
        outs.append(eng.generate(p, mod.SamplingParams(max_new_tokens=m,
                                                       lora_id=lid)))
        return outs
    finally:
        eng.stop()


def _port_engine(base, stack='default', **kw):
    return torch_engine.InferenceEngine(
        base['port_model'](), num_slots=4, max_seq_len=MAX_SEQ,
        decode_chunk=4, page_size=PAGE, device='cpu',
        lora_stack=base['stack'] if stack == 'default' else stack, **kw)


@pytest.fixture(scope='module')
def streams(base):
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(1, 256, n).tolist(), m, lid)
               for n, m, lid in BURST + [LONE]]
    jeng = jax_engine.InferenceEngine(
        base['jm'], nn.meta.unbox(base['jp']), num_slots=4,
        max_seq_len=MAX_SEQ, decode_chunk=4, cache_mode='paged',
        page_size=PAGE, lora_stack=base['jstack'])
    ref = _serve(jeng, jax_engine, prompts)
    teng = _port_engine(base)
    got = _serve(teng, torch_engine, prompts)
    return {'prompts': prompts, 'ref': ref, 'got': got, 'jeng': jeng,
            'teng': teng}


def test_mixed_adapter_burst_equals_jax_engine(streams):
    assert streams['jeng'].perf['ragged_dispatches'] == 1
    assert streams['teng'].perf['ragged_dispatches'] == 1
    assert streams['teng'].perf['prefill_dispatches'] == 2
    assert streams['got'] == streams['ref']
    assert [len(s) for s in streams['got']] == \
        [m for _, m, _ in BURST + [LONE]]


@pytest.mark.parametrize('opts', [{'spec_decode': 3}, {'kv_dtype': 'int8'}],
                         ids=['spec', 'int8'])
def test_adapters_compose_with_spec_and_int8(base, streams, opts):
    """spec_decode=3 is exact for greedy: its streams equal the port's
    plain LoRA engine's. int8 KV: its LoRA streams equal the int8 engine
    run with the adapters applied through spec_decode=3 (exact), and
    differ from the int8 engine without the stack."""
    got = _serve(_port_engine(base, **opts), torch_engine,
                 streams['prompts'])
    if 'spec_decode' in opts:
        assert got == streams['got']
        return
    spec = _serve(_port_engine(base, spec_decode=3, **opts), torch_engine,
                  streams['prompts'])
    assert got == spec
    prompts = [(p, m, 0) for p, m, _ in streams['prompts']]
    plain = _serve(_port_engine(base, stack=None, **opts), torch_engine,
                   prompts)
    assert got[2] == plain[2]           # the id-0 request
    assert got[0] != plain[0]           # an adapter request


def test_out_of_range_lora_id_rejected(base):
    eng = _port_engine(base)
    assert eng.num_adapters == 3
    with pytest.raises(ValueError, match='out of range'):
        eng.submit([1, 2, 3], torch_engine.SamplingParams(lora_id=3))
    with pytest.raises(ValueError, match='out of range'):
        _port_engine(base, stack=None).submit(
            [1, 2, 3], torch_engine.SamplingParams(lora_id=1))
    with pytest.raises(ValueError, match='lora_id'):
        torch_engine.SamplingParams(lora_id=-1).validate()


def test_slot_id_set_while_held_and_reset_when_freed(base):
    eng = _port_engine(base)
    _, q = eng.submit([7, 8, 9, 10], torch_engine.SamplingParams(
        max_new_tokens=24, lora_id=2))
    assert eng.adapter_in_use(2) and not eng.adapter_in_use(1)
    eng.start()
    try:
        first = [q.get(timeout=300), q.get(timeout=300)]
        assert None not in first
        slot = int(np.flatnonzero(eng._slot_lora)[0])
        assert eng._slot_lora[slot] == 2
        assert int(eng._d_lora[slot]) == 2
        assert eng.adapter_in_use(2)
        _drain(q)
        assert not eng.adapter_in_use(2)
        assert not eng._slot_lora.any()
        assert not eng._d_lora.any()
    finally:
        eng.stop()


def test_adapter_update_applies_at_a_tick_boundary(base):
    (ta, aa), (tb, ab) = base['adapters']
    one = torch_lora.build_stack([(ta, aa)], dtype='float32')
    eng = _port_engine(base, stack=one)
    prompt = list(range(3, 15))
    params = torch_engine.SamplingParams(max_new_tokens=8, lora_id=2)
    with pytest.raises(ValueError, match='out of range'):
        eng.submit(prompt, params)
    eng.start()
    try:
        # A draining update cannot apply while a long request holds a
        # slot: it times out and the old stack stays live.
        _, q = eng.submit(prompt, torch_engine.SamplingParams(
            max_new_tokens=100, lora_id=1))
        q.get(timeout=300)
        with pytest.raises(TimeoutError):
            eng.request_adapter_update(
                torch_lora.graft_adapter(one, 2, tb, ab), num_adapters=3,
                drain=True, timeout=0.01)
        assert eng.num_adapters == 2
        res = eng.request_adapter_update(
            torch_lora.graft_adapter(one, 2, tb, ab), num_adapters=3)
        assert res['num_adapters'] == 3 and eng.num_adapters == 3
        assert len(_drain(q)) == 99      # the in-flight request finished
        got = eng.generate(prompt, params)
    finally:
        eng.stop()
    full = _port_engine(base)
    full.start()
    try:
        want = full.generate(prompt, params)
    finally:
        full.stop()
    assert got == want
    with pytest.raises(ValueError, match='num_adapters'):
        eng.request_adapter_update(one, num_adapters=3)
