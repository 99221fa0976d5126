"""The port's in-place weight swap and adapter registry
(infer/weight_swap.py, the engine's swap hooks, the server's /admin
routes), on the CPU at the 'debug' preset in float32, mirroring the
reference's contracts (tests/test_weight_swap.py, all but the reshard
and fault-point cases, and tests/test_lora_fleet.py's registry
lifecycle):

  * validate_tree's reject table (a missing key, an unexpected one, a
    shape, a dtype) and a matching tree accepted;
  * a swap moves the outputs, weight_version (engine, /stats, the
    gauge) and the metric families; swap_back restores the old outputs;
    drain=True finishes an in-flight request on the old weights,
    drain=False swaps under it; the prefix cache is flushed; a timed-out
    swap leaves the old weights; single-flight; a checkpoint swap
    through build_engine's param_loader, and swap_back restaging from the
    path;
  * the registry: a load serves the merged weights' greedy tokens, a
    graft appends, a rank-growing replacement rebuilds, a bad tree is
    refused with the stack intact, an unload of a referenced id is
    refused (AdapterInUse), ids are reused lowest-first, single-flight
    with the swap;
  * /admin/weights and /admin/adapters: 403 without or with a wrong
    token, 400 on malformed bodies and failed loads, 200, 409; /v1/models
    follows the registry; /admin/reshard and /admin/kv_prewarm 501.
"""
import copy
import http.client
import json
import time

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import lora as infer_lora
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.infer import weight_swap
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.train import export_lora
from skypilot_tpu_torch.utils import metrics as metrics_lib

PROMPT = [1, 2, 3]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed):
    model = llama.LlamaModel(llama.CONFIGS['debug'])
    gen = torch.Generator()
    gen.manual_seed(seed)
    model.init_weights(gen)
    return model


@pytest.fixture(scope='module')
def pair():
    """Two weight sets of the debug model (seeds 0 and 7), state_dicts."""
    return _model(0).state_dict(), _model(7).state_dict()


def _engine(pair, reg, **kw):
    model = llama.LlamaModel(llama.CONFIGS['debug'])
    model.load_state_dict(copy.deepcopy(pair[0]))
    defaults = dict(num_slots=2, max_seq_len=64, decode_chunk=2,
                    page_size=8, device='cpu', metrics_registry=reg)
    defaults.update(kw)
    return torch_engine.InferenceEngine(model, **defaults)


def _gen(eng, tokens=PROMPT, n=8, lora_id=0):
    return eng.generate(tokens, torch_engine.SamplingParams(
        max_new_tokens=n, lora_id=lora_id))


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=60)
        if tok is None:
            return out
        out.append(tok)


@pytest.mark.parametrize('mutate,needle', [
    ('drop', 'missing'), ('add', 'unexpected'), ('shape', 'shape'),
    ('dtype', 'dtype')])
def test_validate_reject_table(pair, mutate, needle):
    p0, p1 = pair
    bad = dict(p1)
    if mutate == 'drop':
        del bad['final_norm.weight']
    elif mutate == 'add':
        bad['bogus_layer.weight'] = torch.zeros(1)
    elif mutate == 'shape':
        bad = {k: v[..., :1] for k, v in p1.items()}
    else:
        bad = {k: v.half() for k, v in p1.items()}
    with pytest.raises(weight_swap.WeightSwapError) as ei:
        weight_swap.validate_tree(p0, bad)
    assert needle in str(ei.value)


def test_validate_accepts_matching_tree(pair):
    weight_swap.validate_tree(*pair)


def test_swap_changes_outputs_version_and_metrics(pair):
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg)
    eng.start()
    try:
        golden_old = _gen(eng)
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        res = mgr.swap(params=pair[1])
        assert res['ok'] and res['weight_version'] == 2
        assert eng.weight_version == 2 == eng.stats()['weight_version']
        assert _gen(eng) != golden_old
        text = reg.expose()
        assert 'skyt_infer_weight_version 2' in text
        assert 'skyt_infer_weight_swaps_total{result="ok"} 1' in text
        assert 'skyt_infer_weight_swap_seconds_count 1' in text
        back = mgr.swap_back()
        assert back['weight_version'] == 1 and back['swap_back']
        assert _gen(eng) == golden_old
        assert mgr.info()['swap_back_available']
    finally:
        eng.stop()


def test_drain_true_finishes_inflight_on_old_weights(pair):
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg)
    eng.start()
    try:
        golden_old = _gen(eng, [5, 6, 7], n=24)
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        _, q = eng.submit([5, 6, 7], torch_engine.SamplingParams(
            max_new_tokens=24))
        first = q.get(timeout=60)          # the request is mid-decode
        res = mgr.swap(params=pair[1], drain=True)
        assert [first] + _drain(q) == golden_old
        assert res['weight_version'] == 2
        assert _gen(eng, [5, 6, 7], n=24) != golden_old
    finally:
        eng.stop()


def test_drain_false_swaps_while_inflight(pair):
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg, decode_chunk=1)
    eng.start()
    try:
        golden_old = _gen(eng, [5, 6, 7], n=48)
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        _, q = eng.submit([5, 6, 7], torch_engine.SamplingParams(
            max_new_tokens=48))
        out = [q.get(timeout=60)]
        res = mgr.swap(params=pair[1], drain=False)
        out += _drain(q)
        assert res['weight_version'] == 2
        assert out != golden_old    # the suffix came from the new weights
    finally:
        eng.stop()


def test_prefix_cache_flushed_on_swap(pair):
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg)
    eng.start()
    try:
        prompt = list(range(1, 18))      # 2 full pages and change
        _gen(eng, prompt)
        _gen(eng, prompt)
        assert eng.pool.prefix_stats['hit_pages'] >= 1
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        res = mgr.swap(params=pair[1])
        assert res['flushed_prefix_pages'] >= 1
        assert eng.pool.prefix_cached_pages() == 0
        misses = eng.pool.prefix_stats['miss_pages']
        _gen(eng, prompt)
        assert eng.pool.prefix_stats['miss_pages'] > misses
    finally:
        eng.stop()


def test_swap_timeout_leaves_old_weights_and_single_flight(pair):
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg, decode_chunk=1)
    eng.start()
    try:
        golden = _gen(eng, [9, 9, 9], n=4)
        _, q = eng.submit([9, 9, 9], torch_engine.SamplingParams(
            max_new_tokens=60))
        q.get(timeout=60)                 # slot occupied
        with pytest.raises(TimeoutError):
            eng.request_weight_swap(pair[1], drain=True, timeout=0.001)
        _drain(q)
        time.sleep(0.1)
        assert eng.weight_version == 1 and _gen(eng, [9, 9, 9], n=4) == golden
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        mgr._flight.acquire()   # pylint: disable=protected-access
        try:
            with pytest.raises(weight_swap.SwapInFlight):
                mgr.swap(params=pair[1])
        finally:
            mgr._flight.release()   # pylint: disable=protected-access
        with pytest.raises(weight_swap.WeightSwapError, match='item 13'):
            mgr.reshard(2)
        # An aborted swap retains nothing to roll back to.
        with pytest.raises(weight_swap.WeightSwapError, match='structure'):
            mgr.swap(params={})
        assert not mgr.last['ok'] and eng.weight_version == 1
        with pytest.raises(weight_swap.WeightSwapError, match='nothing'):
            mgr.swap_back()
    finally:
        eng.stop()


@pytest.fixture(scope='module')
def ckpts(pair, tmp_path_factory):
    cfg = llama.CONFIGS['debug']
    dirs = []
    for i, sd in enumerate(pair):
        d = str(tmp_path_factory.mktemp(f'w{i}'))
        weights.save_hf_checkpoint(cfg, sd, d)
        dirs.append(d)
    return dirs


def test_checkpoint_swap_and_swap_back_restage_from_path(ckpts):
    reg = metrics_lib.MetricsRegistry()
    eng = torch_server.build_engine(checkpoint=ckpts[0], num_slots=2,
                                    max_seq_len=64, dtype='float32',
                                    device='cpu', metrics_registry=reg)
    assert eng.checkpoint_path == ckpts[0]
    eng.start()
    try:
        golden = _gen(eng)
        mgr = weight_swap.WeightSwapManager(eng, registry=reg)
        with pytest.raises(weight_swap.WeightSwapError, match='loading'):
            mgr.swap(checkpoint=ckpts[0] + '-missing')
        res = mgr.swap(checkpoint=ckpts[1], version=5)
        assert res['weight_version'] == 5 and mgr.checkpoint == ckpts[1]
        # What was replaced is a path to restage from, not tensors.
        assert mgr._prev == (1, {'checkpoint': ckpts[0]})  # pylint: disable=protected-access
        assert mgr._old_params is None   # pylint: disable=protected-access
        assert _gen(eng) != golden
        mgr.swap_back()
        assert eng.weight_version == 1 and _gen(eng) == golden
    finally:
        eng.stop()


def _adapter(rank, seed):
    """A training-layout tree for the debug model, A and B N(0, 0.1)."""
    cfg = llama.CONFIGS['debug']
    rng = np.random.default_rng(seed)
    dims = {'wq': (64, 64), 'wk': (64, 32), 'wv': (64, 32), 'wo': (64, 64),
            'w_gate': (64, 128), 'w_up': (64, 128), 'w_down': (128, 64)}
    tree = {}
    for proj, (din, dout) in dims.items():
        scope = 'attn' if proj.startswith('w') and len(proj) == 2 else 'mlp'
        tree.setdefault(scope, {})[proj] = {'kernel': {
            'a': rng.normal(0, 0.1, (cfg.n_layers, din, rank)).astype(
                np.float32),
            'b': rng.normal(0, 0.1, (cfg.n_layers, rank, dout)).astype(
                np.float32)}}
    return {'layers': tree}


def _merged_golden(pair, tree, alpha, prompt):
    eng = _engine(pair, metrics_lib.MetricsRegistry())
    export_lora.merge_into(eng.model, infer_lora.module_adapter(tree),
                           alpha / infer_lora.adapter_rank(tree))
    eng.start()
    try:
        return _gen(eng, prompt, n=6)
    finally:
        eng.stop()


def test_adapter_registry_lifecycle(pair):
    t1, t2, t3 = _adapter(4, 1), _adapter(2, 2), _adapter(8, 3)
    prompt = [1, 5, 9, 13]
    reg = metrics_lib.MetricsRegistry()
    eng = _engine(pair, reg, num_slots=3)
    eng.start()
    mgr = weight_swap.WeightSwapManager(eng, registry=reg)
    areg = weight_swap.AdapterRegistry(eng, mgr, dtype='float32',
                                       registry=reg)
    try:
        base_out = _gen(eng, prompt, n=6)
        r = areg.load('fr', params=t1, alpha=8.0)
        assert r['id'] == 1 and r['num_adapters'] == 2
        m1 = _merged_golden(pair, t1, 8.0, prompt)
        assert _gen(eng, prompt, n=6, lora_id=1) == m1 != base_out
        assert _gen(eng, prompt, n=6) == base_out
        # A second load grafts (appends a slot).
        r = areg.load('de', params=t2, alpha=4.0)
        assert r['id'] == 2 and r['num_adapters'] == 3
        # Replacing with a larger rank rebuilds; the sibling survives.
        r = areg.load('fr', params=t3, alpha=16.0)
        assert r['id'] == 1 and r['replaced'] and r['version'] == 2
        m3 = _merged_golden(pair, t3, 16.0, prompt)
        m2 = _merged_golden(pair, t2, 4.0, prompt)
        assert _gen(eng, prompt, n=6, lora_id=1) == m3
        assert _gen(eng, prompt, n=6, lora_id=2) == m2
        # A tree of no projection: refused, the old stack live.
        with pytest.raises(weight_swap.WeightSwapError):
            areg.load('bad', params={'nope': {'kernel': {
                'a': np.zeros((4, 2)), 'b': np.zeros((2, 4))}}})
        assert areg.last['ok'] is False and areg.last['name'] == 'bad'
        assert _gen(eng, prompt, n=6, lora_id=1) == m3

        # Unload refused while a queued request references the id.
        class _P:   # pylint: disable=too-few-public-methods
            lora_id = 2

        class _R:   # pylint: disable=too-few-public-methods
            params = _P()

        eng._waiting.put(_R())   # pylint: disable=protected-access
        with pytest.raises(weight_swap.AdapterInUse):
            areg.unload('de')
        with eng._waiting.mutex:   # pylint: disable=protected-access
            eng._waiting.queue.clear()   # pylint: disable=protected-access
        areg.unload('de')
        assert 'de' not in areg.snapshot()['adapters']
        assert _gen(eng, prompt, n=6, lora_id=1) == m3
        assert _gen(eng, prompt, n=6) == base_out
        # The next load takes the lowest free id (and flushes: reused).
        r = areg.load('de2', params=t2, alpha=4.0)
        assert r['id'] == 2
        assert _gen(eng, prompt, n=6, lora_id=2) == m2
        mgr._flight.acquire()   # pylint: disable=protected-access
        try:
            with pytest.raises(weight_swap.SwapInFlight):
                areg.load('x', params=t2)
        finally:
            mgr._flight.release()   # pylint: disable=protected-access
        snap = areg.snapshot()
        assert snap['count'] == 2 and snap['stack_slots'] == 3
        fams = reg.expose()
        for fam in ('skyt_infer_adapters_loaded 2',
                    'skyt_infer_adapter_loads_total',
                    'skyt_infer_adapter_unloads_total{result="refused"} 1'):
            assert fam in fams, fam
    finally:
        eng.stop()


def _call(port, method, path, body=None, token=None):
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    headers = {'Content-Type': 'application/json'}
    if token:
        headers['Authorization'] = f'Bearer {token}'
    c.request(method, path, None if body is None else json.dumps(body),
              headers)
    r = c.getresponse()
    data = json.loads(r.read() or b'null')
    c.close()
    return r.status, data


@pytest.fixture
def admin(pair, ckpts, tmp_path, monkeypatch):
    """A server over a checkpoint engine with one adapter from an sft-like
    dir, SKYT_ADMIN_TOKEN unset."""
    monkeypatch.delenv('SKYT_ADMIN_TOKEN', raising=False)
    run = tmp_path / 'run'
    (run / '3').mkdir(parents=True)
    tree = {'layers': {scope: {proj: {'kernel': {
        k: torch.from_numpy(v) for k, v in node['kernel'].items()}}
        for proj, node in projs.items()}}
        for scope, projs in _adapter(4, 1)['layers'].items()}
    torch.save({'lora': tree}, str(run / '3' / 'state.pt'))
    specs = infer_lora.parse_lora_flag([f'sql-ft={run}'])
    stack, names = infer_lora.build_stack_from_specs(specs, 'float32')
    eng = torch_server.build_engine(checkpoint=ckpts[0], num_slots=2,
                                    max_seq_len=64, dtype='float32',
                                    device='cpu', lora_stack=stack,
                                    metrics_registry=metrics_lib.
                                    MetricsRegistry())
    eng.start()
    srv = torch_server.InferenceServer(eng, model_id='base',
                                       lora_names=names, lora_specs=specs)
    port = srv.start()
    try:
        yield srv, port, str(run)
    finally:
        srv.stop()
        eng.stop()


def test_admin_weights_route_contract(admin, ckpts, monkeypatch):
    srv, port, _ = admin
    body = {'checkpoint': ckpts[1]}
    assert _call(port, 'POST', '/admin/weights', body)[0] == 403
    monkeypatch.setenv('SKYT_ADMIN_TOKEN', 'sesame')
    assert _call(port, 'POST', '/admin/weights', body)[0] == 403
    assert _call(port, 'POST', '/admin/weights', body, 'wrong')[0] == 403
    for bad in ([1, 2], {'checkpoint': ''}, {'checkpoint': 7},
                {'checkpoint': 'x', 'version': 'seven'},
                {'checkpoint': 'x', 'version': 0},
                {'checkpoint': 'x', 'drain': 'yes'}, {}):
        st, data = _call(port, 'POST', '/admin/weights', bad, 'sesame')
        assert st == 400, (bad, st, data)
    st, data = _call(port, 'POST', '/admin/weights',
                     {'checkpoint': 'missing'}, 'sesame')
    assert st == 400 and data['weight_version'] == 1
    st, data = _call(port, 'POST', '/admin/weights',
                     {'checkpoint': ckpts[1], 'version': 5}, 'sesame')
    assert st == 200 and data['weight_version'] == 5, data
    assert _call(port, 'GET', '/stats')[1]['weight_version'] == 5
    srv._swap_mgr._flight.acquire()   # pylint: disable=protected-access
    try:
        assert _call(port, 'POST', '/admin/weights', body,
                     'sesame')[0] == 409
    finally:
        srv._swap_mgr._flight.release()   # pylint: disable=protected-access
    st, data = _call(port, 'POST', '/admin/weights', {'swap_back': True},
                     'sesame')
    assert st == 200 and data['weight_version'] == 1 and data['swap_back']
    for path in ('/admin/reshard', '/admin/kv_prewarm'):
        st, data = _call(port, 'POST', path, {}, 'sesame')
        assert st == 501 and 'item' in data['error'], (path, data)


def test_admin_adapters_route_contract(admin, monkeypatch):
    srv, port, run = admin
    body = {'op': 'load', 'name': 'chat-ft', 'checkpoint': run,
            'alpha': 32}
    assert _call(port, 'POST', '/admin/adapters', body)[0] == 403
    monkeypatch.setenv('SKYT_ADMIN_TOKEN', 'sesame')
    st, data = _call(port, 'POST', '/admin/adapters', {'op': 'list'},
                     'sesame')
    assert st == 200 and set(data['adapters']) == {'sql-ft'}
    assert data['adapters']['sql-ft']['rank'] == 4
    for bad in ({'op': 'zap'}, {'op': 'load', 'name': ''},
                {'op': 'load', 'name': 'x', 'checkpoint': 3},
                {'op': 'load', 'name': 'x', 'checkpoint': run,
                 'alpha': 'hi'},
                {'op': 'load', 'name': 'x', 'checkpoint': run + '-no'},
                {'op': 'load', 'name': 'base', 'checkpoint': run},
                {'op': 'unload', 'name': 'never-loaded'}):
        st, data = _call(port, 'POST', '/admin/adapters', bad, 'sesame')
        assert st == 400, (bad, st, data)
    st, data = _call(port, 'POST', '/admin/adapters', body, 'sesame')
    assert st == 200 and data['id'] == 2 and data['alpha'] == 32.0, data
    models = {m['id'] for m in _call(port, 'GET', '/v1/models')[1]['data']}
    assert models == {'base', 'sql-ft', 'chat-ft'}
    st, data = _call(port, 'POST', '/v1/completions',
                     {'model': 'chat-ft', 'prompt': [1, 2, 3],
                      'max_tokens': 4})
    assert st == 200, data
    # Referenced: 409; the stack and the routing unchanged.
    _, q = srv.engine.submit([1, 2, 3] * 5, torch_engine.SamplingParams(
        max_new_tokens=40, lora_id=2))
    q.get(timeout=60)
    st, _ = _call(port, 'POST', '/admin/adapters',
                  {'op': 'unload', 'name': 'chat-ft'}, 'sesame')
    assert st == 409
    _drain(q)
    time.sleep(0.1)
    st, data = _call(port, 'POST', '/admin/adapters',
                     {'op': 'unload', 'name': 'chat-ft'}, 'sesame')
    assert st == 200 and data['id'] == 2
    models = {m['id'] for m in _call(port, 'GET', '/v1/models')[1]['data']}
    assert models == {'base', 'sql-ft'}
    assert _call(port, 'POST', '/v1/completions',
                 {'model': 'chat-ft', 'prompt': [1], 'max_tokens': 2})[0] \
        == 404
    stats = _call(port, 'GET', '/stats')[1]
    assert stats['adapters']['count'] == 1
    assert stats['adapters']['stack_slots'] == 3
