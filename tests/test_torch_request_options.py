"""The port engine's request options against the JAX package's default
(paged) engine, on the CPU at the 'debug' preset in float32 with 16-token
pages and weights through params_from_jax:

  * presence penalty, frequency penalty, both, and logit_bias: greedy
    streams EQUAL, in a burst submitted before start() (one ragged
    admission mixing all four) and on lone requests; greedy requests in
    slots whose last requests were biased or penalized, beside one that
    is both;
  * logprobs: (token, raw logprob) pairs within atol 1e-4 of the
    reference's, on the plain path and the spec_decode=2 path; a
    penalized slot in a spec engine streams as the plain engine does;
  * deadlines: an expired deadline ends a waiting request (no token) and
    a running one, trace status 'deadline', counted in
    skyt_infer_deadline_expired_total, on both engines;
  * QoS (SKYT_QOS=1): the copied FairQueue, ClassedRequestQueue (with a
    requeue at the head after a reorder) and ServerQoS give the
    reference's order and decisions on the same puts, clock and signals;
    the engines' admission rounds (driven on the test's thread: no
    sleeps) seat the same requests with reserved slots holding back a
    batch burst and with a pool too small for the burst (the requeue);
  * validation: SamplingParams.validate raises where the reference's
    does, out-of-vocab logit_bias ids at submit;
  * the greedy path pays nothing: one greedy decode step issues the
    model's ops plus the same seven ops as before the options existed,
    also after penalized, biased and logprob requests ran.
"""
import dataclasses
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.serve import qos as jax_qos
from skypilot_tpu.utils import metrics as jax_metrics
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.serve import qos as torch_qos
from skypilot_tpu_torch.utils import metrics as torch_metrics

MAX_SEQ = 128
PAGE = 16
LP_ATOL = 1e-4
# (name, SamplingParams options): the burst's four requests, in order.
OPTIONS = [('presence', dict(presence_penalty=0.7)),
           ('frequency', dict(frequency_penalty=0.4)),
           ('both', dict(presence_penalty=0.3, frequency_penalty=0.3)),
           ('bias', dict(logit_bias={7: 3.0, 100: 2.5, 200: -100.0}))]
BURST_LENS = (9, 21, 14, 30)
MAX_NEW = 12


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def models():
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    state = weights.params_from_jax(tree, pcfg)

    def jax_eng(**kw):
        kw = {'num_slots': 4, 'decode_chunk': 4, **kw}
        return jax_engine.InferenceEngine(
            jm, jp, max_seq_len=MAX_SEQ, cache_mode='paged',
            page_size=PAGE, metrics_registry=jax_metrics.MetricsRegistry(),
            **kw)

    def torch_eng(**kw):
        kw = {'num_slots': 4, 'decode_chunk': 4, **kw}
        model = llama.LlamaModel(pcfg)
        model.load_state_dict(state)
        return torch_engine.InferenceEngine(
            model, max_seq_len=MAX_SEQ, page_size=PAGE, device='cpu',
            metrics_registry=torch_metrics.MetricsRegistry(), **kw)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in BURST_LENS + (11, 13, 17, 19, 23)]
    return {'jax': jax_eng, 'torch': torch_eng, 'prompts': prompts,
            'vocab': cfg.vocab_size}


def _drain(q):
    out = []
    while True:
        item = q.get(timeout=300)
        if item is None:
            return out
        out.append(item)


def _script(eng, mod, prompts):
    """The burst (one request a option, submitted before start()), then a
    lone request a option, then a lone logprobs request."""
    P = mod.SamplingParams
    burst = [eng.submit(p, P(max_new_tokens=MAX_NEW, **opt))[1]
             for p, (_, opt) in zip(prompts[:4], OPTIONS)]
    eng.start()
    try:
        out = {f'burst_{name}': _drain(q)
               for (name, _), q in zip(OPTIONS, burst)}
        for p, (name, opt) in zip(prompts[4:8], OPTIONS):
            out[f'lone_{name}'] = eng.generate(
                p, P(max_new_tokens=MAX_NEW, **opt))
        out['lone_logprobs'] = eng.generate(
            prompts[8], P(max_new_tokens=MAX_NEW, logprobs=True))
        out['greedy_after'] = eng.generate(
            prompts[4], P(max_new_tokens=MAX_NEW))
    finally:
        eng.stop()
    # Slots 0 and 1 last held a biased and a penalized request: greedy
    # requests there beside a penalized, biased one (one packed
    # admission, slots 0-2) must not see their predecessors' options.
    mixed = [eng.submit(prompts[4], P(max_new_tokens=MAX_NEW))[1],
             eng.submit(prompts[1], P(max_new_tokens=MAX_NEW))[1],
             eng.submit(prompts[6], P(max_new_tokens=MAX_NEW,
                                      presence_penalty=0.7,
                                      logit_bias={7: 3.0}))[1]]
    eng.start()
    try:
        for name, q in zip(('mixed_a', 'mixed_b', 'mixed_c'), mixed):
            out[name] = _drain(q)
        return out
    finally:
        eng.stop()


@pytest.fixture(scope='module')
def runs(models):
    ref = _script(models['jax'](), jax_engine, models['prompts'])
    got = _script(models['torch'](), torch_engine, models['prompts'])
    return ref, got


@pytest.mark.parametrize('key', [f'{w}_{name}' for w in ('burst', 'lone')
                                 for name, _ in OPTIONS] +
                         ['mixed_a', 'mixed_b', 'mixed_c'])
def test_option_streams_equal_jax(runs, key):
    ref, got = runs
    assert got[key] == ref[key]
    assert len(got[key]) == MAX_NEW


def test_options_change_the_stream(runs):
    """The options act: each stream differs from the plain greedy one of
    the same prompt (the lone presence prompt's greedy run is
    greedy_after), and the -100 bias bans its token."""
    ref, got = runs
    assert got['lone_presence'] != got['greedy_after']
    assert got['mixed_a'] == got['greedy_after']
    assert 200 not in got['burst_bias'] + got['lone_bias']


def test_logprobs_pairs_match_jax(runs):
    ref, got = runs
    rt, rl = zip(*ref['lone_logprobs'])
    gt, gl = zip(*got['lone_logprobs'])
    assert gt == rt
    np.testing.assert_allclose(gl, rl, atol=LP_ATOL, rtol=0)
    assert all(v <= 0 for v in gl)


@pytest.fixture(scope='module')
def spec_runs(models):
    """spec_decode=2 engines: a looping prompt with logprobs (drafts
    accepted on the verify path), then a penalized request (the plain
    path)."""
    loop = [5, 9, 2] * 6
    outs = {}
    for name, mod in (('jax', jax_engine), ('torch', torch_engine)):
        eng = models[name](spec_decode=2)
        eng.start()
        try:
            outs[name] = {
                'lp': eng.generate(loop, mod.SamplingParams(
                    max_new_tokens=16, logprobs=True)),
                'pen': eng.generate(models['prompts'][4], mod.SamplingParams(
                    max_new_tokens=MAX_NEW, presence_penalty=0.7)),
                'steps': eng.perf['spec_verify_steps']}
        finally:
            eng.stop()
    return outs


def test_spec_path_logprobs_match_jax(spec_runs):
    ref, got = spec_runs['jax'], spec_runs['torch']
    assert got['steps'] > 0, 'no verify step ran'
    assert [t for t, _ in got['lp']] == [t for t, _ in ref['lp']]
    np.testing.assert_allclose([v for _, v in got['lp']],
                               [v for _, v in ref['lp']], atol=LP_ATOL,
                               rtol=0)


def test_penalized_slot_in_spec_engine_streams_as_plain(spec_runs, runs):
    assert spec_runs['torch']['pen'] == runs[1]['lone_presence']
    assert spec_runs['torch']['pen'] == spec_runs['jax']['pen']


def _trace_wait(eng, rid):
    tr = eng.request_trace(rid)
    assert tr is not None and 'done' in tr, tr
    return tr


@pytest.mark.parametrize('side', ['jax', 'torch'])
def test_deadline_ends_waiting_and_running(models, side):
    mod = jax_engine if side == 'jax' else torch_engine
    eng = models[side]()
    p = models['prompts']
    # Waiting: already past its deadline when the loop first looks.
    rid_w, q_w = eng.submit(p[0], mod.SamplingParams(
        max_new_tokens=8, deadline=time.time() - 1.0))
    params = mod.SamplingParams(max_new_tokens=MAX_SEQ - 40,
                                deadline=time.time() + 3600)
    eng.start()
    try:
        assert _drain(q_w) == []
        rid_r, q_r = eng.submit(p[1], params)
        first = q_r.get(timeout=300)
        assert first is not None
        params.deadline = time.time() - 1.0   # the budget runs out
        rest = _drain(q_r)
    finally:
        eng.stop()
    assert 1 + len(rest) < params.max_new_tokens
    assert _trace_wait(eng, rid_w)['status'] == 'deadline'
    assert _trace_wait(eng, rid_r)['status'] == 'deadline'
    expired = eng.metrics_registry.get('skyt_infer_deadline_expired_total')
    assert expired.value() == 2


# ------------------------------------------------------------------ QoS
def _fair_script(mod):
    clock = {'t': 100.0}
    fq = mod.FairQueue(quantum=64.0, aging_s=5.0,
                       weights={'interactive': 8.0, 'standard': 4.0,
                                'batch': 1.0},
                       model_weights={'m2': 2.0},
                       clock=lambda: clock['t'])
    rng = np.random.default_rng(3)
    classes = ('interactive', 'standard', 'batch')
    for i in range(40):
        fq.push(i, cls=classes[rng.integers(3)],
                tenant=f't{rng.integers(4)}', cost=float(rng.integers(1, 300)),
                t=100.0 - float(rng.integers(0, 20)),
                model=('m1', 'm2')[rng.integers(2)])
    out = [fq.pop(now=101.0) for _ in range(10)]
    return out + fq.drain(now=112.0)


def test_fair_queue_order_equals_reference():
    assert _fair_script(torch_qos) == _fair_script(jax_qos)


@dataclasses.dataclass
class _Req:
    rid: int
    cls: str
    tenant: str
    cost: float
    t: float


def _classed_script(mod):
    q = mod.ClassedRequestQueue(
        meta=lambda r: mod.RequestMeta(cls=r.cls, tenant=r.tenant,
                                       cost=r.cost, seq=r.rid, enq_t=r.t),
        quantum=128.0, aging_s=10.0, debt_halflife_s=20.0,
        clock=lambda: 0.0)
    rng = np.random.default_rng(5)
    reqs = [_Req(i, ('interactive', 'standard', 'batch')[rng.integers(3)],
                 f't{rng.integers(3)}', float(rng.integers(5, 200)),
                 float(rng.integers(0, 30))) for i in range(24)]
    log = []
    for r in reqs[:12]:
        q.put(r)
    log.append(q.reorder(now=31.0)[0])
    popped = [q.get_nowait() for _ in range(4)]
    log.append([r.rid for r in popped])
    # Two of them go back at the head (a reservation failed), in order.
    with q.mutex:
        q.queue.extendleft(reversed(popped[2:]))
    log.append([r.rid for r in q.queue])
    for r in reqs[12:]:
        q.put(r)
    log.append(q.reorder(now=45.0)[0])
    log.append([q.get_nowait().rid for _ in range(6)])
    log.append(q.depths())
    return log


def test_classed_queue_order_and_requeue_equal_reference():
    got, ref = _classed_script(torch_qos), _classed_script(jax_qos)
    assert got == ref
    assert got[2][:2] == got[1][2:]   # the requeue kept scheduled order


def _server_qos_script(mod, monkeypatch):
    monkeypatch.setenv('SKYT_QOS_TENANT_RPS', '2')
    monkeypatch.setenv('SKYT_QOS_TENANT_BURST', '3')
    clock = {'t': 0.0}
    sig = {'queue_depth': 0.0, 'num_slots': 4.0}
    ctl = mod.ServerQoS(lambda: dict(sig), clock=lambda: clock['t'],
                        registry=(jax_metrics if mod is jax_qos
                                  else torch_metrics).MetricsRegistry())
    steps = [(0.0, 0, 0.1, None, 'interactive', 'a'),
             (0.1, 0, 0.1, None, 'batch', 'a'),
             (0.2, 20, 0.2, None, 'batch', 'b'),
             (0.5, 20, 0.5, None, 'standard', 'b'),
             (0.8, 40, 0.95, 0.7, 'batch', 'c'),
             (1.0, 80, 0.99, 1.2, 'standard', 'c'),
             (1.1, 80, 0.99, 1.2, 'interactive', 'c'),
             (1.2, 0, 0.1, None, 'standard', 'd'),
             (1.2, 0, 0.1, None, 'standard', 'd'),
             (1.2, 0, 0.1, None, 'standard', 'd'),
             (1.25, 0, 0.1, None, 'standard', 'd'),
             (2.5, 0, 0.1, None, 'batch', 'e'),
             (4.0, 0, 0.1, None, 'batch', 'e'),
             (6.0, 0, 0.1, 0.01, 'batch', 'f')]
    out = []
    for t, depth, kv, ttft, cls, tenant in steps:
        clock['t'] = t
        sig.update(queue_depth=float(depth), kv_util=kv)
        if ttft is None:
            sig.pop('ttft_p95_s', None)
        else:
            sig['ttft_p95_s'] = ttft
        d = ctl.admit(cls, tenant, max_new_tokens=64, model='base')
        out.append((d.action, d.level, round(d.retry_after, 6),
                    d.max_new_tokens))
    out.append(ctl.snapshot({'batch': 1}))
    return out


def test_server_qos_decisions_equal_reference(monkeypatch):
    got = _server_qos_script(torch_qos, monkeypatch)
    ref = _server_qos_script(jax_qos, monkeypatch)
    assert got == ref
    assert {a for a, *_ in got[:-1]} >= {'admit', 'degrade', 'shed',
                                         'throttle'}


def _admission_round(eng, side):
    """One tick's admissions as the engine loop runs them, on this
    thread (the loop is not started)."""
    if eng._qos_queue is not None and eng._waiting.qsize() > 1:
        eng._qos_queue.reorder(time.time())
    tries = (eng._try_admit_ragged, eng._admit_one) if side == 'torch' \
        else (eng._try_admit_ragged, eng._try_admit_batch, eng._admit_one)
    with torch.inference_mode():
        while None in eng._slots:
            if not any(f() for f in tries):
                break
    return sorted(r.req_id for r in eng._slots if r is not None)


QOS_BURST = [('batch', 't1'), ('batch', 't1'), ('standard', 't2'),
             ('batch', 't2'), ('interactive', 't3'), ('batch', 't1')]


def _qos_engine_script(models, side, monkeypatch, reserve, pool_tokens):
    monkeypatch.setenv('SKYT_QOS', '1')
    monkeypatch.setenv('SKYT_QOS_RESERVE_SLOTS', str(reserve))
    mod = jax_engine if side == 'jax' else torch_engine
    eng = models[side](pool_tokens=pool_tokens)
    prompts = models['prompts']
    subs = [eng.submit(prompts[i], mod.SamplingParams(
        max_new_tokens=6, priority=cls, tenant=tenant))
        for i, (cls, tenant) in enumerate(QOS_BURST)]
    seated = _admission_round(eng, side)
    with eng._waiting.mutex:
        waiting = [r.req_id for r in eng._waiting.queue]
    if eng._deferred is not None:
        waiting.insert(0, eng._deferred.req_id)
    eng.start()
    try:
        streams = [_drain(q) for _, q in subs]
    finally:
        eng.stop()
    return seated, waiting, streams


@pytest.mark.parametrize('reserve,pool_tokens', [(1, None), (0, 6 * PAGE)])
def test_qos_admission_equals_reference(models, monkeypatch, reserve,
                                        pool_tokens):
    """reserve 1: the batch-first burst leaves one slot free while no
    interactive request is at the head. A 6-page pool: the burst's
    reservations fail part-way and the tail goes back to the head of
    the classed queue in its scheduled order."""
    got = _qos_engine_script(models, 'torch', monkeypatch, reserve,
                             pool_tokens)
    ref = _qos_engine_script(models, 'jax', monkeypatch, reserve,
                             pool_tokens)
    assert got == ref
    seated, waiting, streams = got
    assert 4 in seated                       # interactive goes first
    if reserve:
        assert len(seated) == 4 - reserve
    else:
        assert len(seated) < 4 and waiting
    assert all(len(s) == 6 for s in streams)


# ----------------------------------------------------------- validation
@pytest.mark.parametrize('kw', [
    {}, {'priority': 'batch', 'tenant': 'team-a'},
    {'priority': 'vip'}, {'tenant': 7},
    {'logit_bias': {5: 1.0, 9: -100.0}},
    {'logit_bias': {i: 1.0 for i in range(65)}},
    {'logit_bias': {-1: 1.0}}, {'logit_bias': {True: 1.0}},
    {'logit_bias': {'5': 1.0}}, {'logit_bias': {5: 100.5}},
    {'logit_bias': {5: -101.0}},
    {'presence_penalty': 2.0, 'frequency_penalty': -1.0},
    {'logprobs': True, 'deadline': 1.0},
    {'top_k': 65}, {'top_k': 1.5}, {'top_p': 1.5}, {'temperature': -1.0},
    {'max_new_tokens': 0}, {'lora_id': -1}])
def test_validation_raises_where_reference_does(kw):
    def outcome(mod):
        try:
            mod.SamplingParams(**kw).validate()
            return None
        except ValueError as e:
            return str(e).split(',')[0].split(' ')[0]
    assert outcome(torch_engine) == outcome(jax_engine)


def test_out_of_vocab_bias_refused_at_submit(models):
    eng = models['torch']()
    with pytest.raises(ValueError, match='out of vocab'):
        eng.submit([1, 2, 3], torch_engine.SamplingParams(
            logit_bias={models['vocab']: 1.0}))


# --------------------------------------------------- the greedy path's cost
class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# The ops of one greedy decode step around the model call, as the
# engine issued them before the request options existed.
GREEDY_PRE = ['arange']
GREEDY_POST = ['select', 'to', 'argmax', 'to', 'add', 'stack']


def _greedy_step_ops(eng):
    with torch.inference_mode():
        with _OpLog() as model_log:
            eng.model(eng._d_last[:, None], positions=eng._d_lens[:, None],
                      cache=eng.cache)
        with _OpLog() as step_log:
            eng._decode_n_impl(1, False)
    return step_log.ops, model_log.ops


def test_greedy_step_issues_no_option_ops(models):
    eng = models['torch']()
    fresh, model_ops = _greedy_step_ops(eng)
    assert fresh == GREEDY_PRE + model_ops + GREEDY_POST
    # After penalized, biased and logprob requests held every slot.
    prompts = models['prompts']
    subs = [eng.submit(p, torch_engine.SamplingParams(
        max_new_tokens=4, logprobs=True, **opt))[1]
        for p, (_, opt) in zip(prompts, OPTIONS)]
    eng.start()
    try:
        for q in subs:
            _drain(q)
        # A greedy request then reuses a slot: only its clears ran.
        eng.generate(prompts[5], torch_engine.SamplingParams(
            max_new_tokens=2))
    finally:
        eng.stop()
    after, model_ops = _greedy_step_ops(eng)
    assert after == GREEDY_PRE + model_ops + GREEDY_POST
    with torch.inference_mode():
        with _OpLog() as opt_log:
            eng._decode_n_impl(1, False, penalize=True, biased=True,
                               want_lp=True)
    assert len(opt_log.ops) > len(after)
    assert {'scatter_add', 'logsumexp'} <= set(opt_log.ops)
