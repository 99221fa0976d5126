"""Prefix caching, chunked prefill and the host KV tier of the PyTorch
port against the JAX package, on the CPU at the 'debug' preset in
float32 with 16-token pages.

  * page_hashes: byte-equal to the JAX package's, salts included;
  * PagePool accounting: one reserve / publish / release / evict / flush /
    install script on the port's pool and the JAX pool gives the same
    table rows, shared counts, stats and on_evict calls;
  * the SKV1 codec: the JAX package encodes and the port decodes, and
    the reverse, bf16 and int8 pages with f32 scales, payloads byte-equal;
  * engines: one scripted sequence of waves (a shared system prompt, a
    burst of hits, an exact repeat, chunked prefill with and without a
    prefix reuse while a short request decodes, the suffix-bucket
    overflow fallback) through the port and the DEFAULT JAX engine
    (prefix caching on), on float pools with two adapters and the base
    model (salts keep their pages apart) and on int8 pools: greedy
    streams, prefix stats and chunk counts EQUAL;
  * flush_prefix on request_adapter_update, as the JAX engine's;
  * a cancelled chunked prefill releases its slot and pages;
  * the host tier (SKYT_KV_TIER=host): pages evicted, spilled, promoted
    back bit-equal to the spilled bytes and the stream equal to
    recompute; SKYT_KV_TIER=off leaves the engine without a tier.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import kv_tier as jax_kv_tier
from skypilot_tpu.infer import lora as jax_lora
from skypilot_tpu.infer import paged_cache as jax_paged
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import kv_tier
from skypilot_tpu_torch.infer import lora as torch_lora
from skypilot_tpu_torch.infer import paged_cache
from skypilot_tpu_torch.models import llama, weights

MAX_SEQ = 128
PAGE = 16
CHUNK = 64
ADAPTERS = ((4, 8.0, 1), (2, 4.0, 2))   # (rank, alpha, seed): ids 1, 2


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- hashes
@pytest.mark.parametrize('n,salt', [(0, 0), (15, 0), (16, 0), (50, 0),
                                    (50, 1), (50, 7), (333, 2**40)])
def test_page_hashes_equal_jax(n, salt):
    toks = np.random.default_rng(n).integers(1, 128256, n).tolist()
    got = paged_cache.page_hashes(toks, PAGE, salt=salt)
    assert got == jax_paged.page_hashes(toks, PAGE, salt=salt)
    assert len(got) == n // PAGE and all(len(h) == 16 for h in got)


def test_salt_separates_adapters():
    toks = list(range(1, 49))
    assert not set(paged_cache.page_hashes(toks, PAGE, 1)) & \
        set(paged_cache.page_hashes(toks, PAGE, 2))


# ---------------------------------------------------------- accounting
def _pools(n_pages=9, slots=3, max_seq=64):
    jcfg = jax_paged.PagedConfig(page_size=PAGE, n_pages=n_pages,
                                 max_pages_per_slot=max_seq // PAGE)
    tcfg = paged_cache.PagedConfig(page_size=PAGE, n_pages=n_pages,
                                   max_pages_per_slot=max_seq // PAGE)
    jp = jax_paged.PagePool(jcfg, 1, 1, 4, slots, jnp.float32)
    tp = paged_cache.PagePool(tcfg, 1, 1, 4, slots, torch.float32,
                              torch.device('cpu'))
    return jp, tp


def test_pool_accounting_equals_jax():
    """The same script on both pools: every return value, the free count,
    the stats and the eviction hook's calls agree at every step."""
    jp, tp = _pools()
    seen = {'j': [], 't': []}
    jp.on_evict = lambda page, h: seen['j'].append((page, h))
    tp.on_evict = lambda page, h: seen['t'].append((page, h))
    a = paged_cache.page_hashes(list(range(1, 65)), PAGE)        # 4 pages
    b = paged_cache.page_hashes(list(range(1, 33)) + [9] * 32, PAGE)
    c = paged_cache.page_hashes(list(range(100, 164)), PAGE)
    script = [
        ('try_reserve_prefix', (0, 60, a[:3])),   # miss: 4 private
        ('publish', (0, a[:3])),
        ('try_reserve_prefix', (1, 50, b[:3])),   # hits a[0], a[1]
        ('publish', (1, b[:3])),
        ('release', (0,)),
        ('try_reserve_prefix', (0, 64, a[:3])),   # hits 3 again
        ('release', (0,)),
        ('release', (1,)),
        ('prefix_peek', (a,)),
        ('try_reserve_prefix', (2, 64, c[:3])),   # evicts LRU pages
        ('publish', (2, c[:3])),
        ('try_reserve', (1, 64)),                 # evicts the rest
        ('try_reserve_prefix', (0, 64, c[:3])),   # full: bails, no evict
        ('release', (2,)),
        ('release', (1,)),
        ('install_prefix', (a[:2],)),
        ('install_prefix', (a[:1],)),             # already registered
        ('try_reserve_prefix', (0, 40, a[:2])),
        ('registered_page', (a[0],)),
        ('registered_hashes', ()),
        ('flush_prefix', ()),
        ('release', (0,)),
        ('prefix_peek', (c,)),
    ]
    for name, args in script:
        rj = getattr(jp, name)(*args)
        rt = getattr(tp, name)(*args)
        if isinstance(rj, tuple):
            np.testing.assert_array_equal(rt[0], rj[0])
            assert rt[1] == rj[1], name
        elif isinstance(rj, np.ndarray):
            np.testing.assert_array_equal(rt, rj)
        else:
            assert rt == rj, name
        assert tp.free_pages() == jp.free_pages(), name
        assert tp.prefix_cached_pages() == jp.prefix_cached_pages(), name
        assert tp.prefix_stats == jp.prefix_stats, name
        np.testing.assert_array_equal(tp.tables, jp.tables)
    assert seen['t'] == seen['j'] and len(seen['t']) >= 4
    assert tp.prefix_stats['hit_pages'] > 0


def test_whole_slot_views_match_layer_views():
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.normal(size=(2, 6, 2, PAGE, 4)).astype(
        np.float32))
    tables = torch.tensor([[3, 1, 0], [5, 2, 4]])
    view = paged_cache.PagePool.gather_view(pool, tables)
    q, s = paged_cache.quantize_kv(pool)
    view_q = paged_cache.PagePool.gather_view_q(q, s, tables, torch.float32)
    for i in range(2):
        torch.testing.assert_close(
            view[i], paged_cache.PagePool.gather_view_layer(pool[i], tables),
            rtol=0, atol=0)
        torch.testing.assert_close(
            view_q[i], paged_cache.PagePool.gather_view_layer_q(
                q[i], s[i], tables, torch.float32), rtol=0, atol=0)


# ---------------------------------------------------------------- SKV1
def _codec_pages(quant):
    """The same page contents as JAX-side numpy arrays and port-side
    tensors: [L, H, P, d] (+ scales [L, H, P])."""
    rng = np.random.default_rng(5)
    out_j, out_t = [], []
    for i in range(3):
        h = bytes([i + 1]) * 16
        if quant:
            arr = {n: rng.integers(-127, 128, (2, 2, PAGE, 8)).astype(np.int8)
                   for n in ('k', 'v')}
            arr.update({f'{n}_scale': rng.random((2, 2, PAGE)).astype(
                np.float32) for n in ('k', 'v')})
            ten = {n: torch.from_numpy(a.copy()) for n, a in arr.items()}
        else:
            f = {n: rng.normal(size=(2, 2, PAGE, 8)).astype(np.float32)
                 for n in ('k', 'v')}
            arr = {n: a.astype(ml_dtypes.bfloat16) for n, a in f.items()}
            ten = {n: torch.from_numpy(a).to(torch.bfloat16)
                   for n, a in f.items()}
        out_j.append((h, arr))
        out_t.append((h, ten))
    return out_j, out_t


@pytest.mark.parametrize('quant', [False, True], ids=['bf16', 'int8'])
def test_skv1_crosses_both_ways(quant):
    pages_j, pages_t = _codec_pages(quant)
    blob_j = jax_kv_tier.encode_pages(pages_j, weight_version=3)
    blob_t = kv_tier.encode_pages(pages_t, weight_version=3)
    assert blob_t == blob_j
    # JAX -> port.
    ver, got = kv_tier.decode_pages(blob_j)
    assert ver == 3 and [h for h, _ in got] == [h for h, _ in pages_t]
    for (_, a), (_, b) in zip(got, pages_t):
        assert sorted(a) == sorted(b)
        for n in a:
            assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape
            assert torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
    # Port -> JAX.
    ver, back = jax_kv_tier.decode_pages(blob_t)
    assert ver == 3
    for (_, a), (_, b) in zip(back, pages_j):
        for n in a:
            assert a[n].dtype == b[n].dtype
            assert a[n].tobytes() == b[n].tobytes()
    assert kv_tier.encode_pages(got, 3) == blob_j


def test_skv1_rejects_malformed():
    with pytest.raises(ValueError):
        kv_tier.decode_pages(b'XXXX\0\0\0\0')
    blob = kv_tier.encode_pages(_codec_pages(True)[1], 1)
    with pytest.raises(ValueError):
        kv_tier.decode_pages(blob[:-5])


def test_host_store_lru_and_versions():
    """HostKVStore as the JAX package's: byte budget with LRU eviction
    (a get refreshes), leading runs, the version gate, discard."""
    page = {'k': torch.zeros(100, dtype=torch.int8)}
    store = kv_tier.HostKVStore(250)
    for i in range(2):
        assert store.put(bytes([i]) * 16, 1, page)
    assert store.get(bytes([0]) * 16, 1) is not None   # 0 now most recent
    assert store.put(bytes([2]) * 16, 1, page)          # evicts 1
    assert not store.contains(bytes([1]) * 16, 1)
    assert [h[0] for h, _ in store.run(
        [bytes([i]) * 16 for i in (0, 2, 1)], 1)] == [0, 2]
    assert store.get(bytes([0]) * 16, 2) is None        # other version
    assert not store.put(bytes([3]) * 16, 1, {'k': torch.zeros(300)})
    assert store.set_version(2) == 2 and len(store) == 0
    assert not store.put(bytes([4]) * 16, 1, page)      # stale: gated
    assert store.put(bytes([4]) * 16, 2, page)
    store.discard(bytes([4]) * 16)
    snap = store.snapshot()
    assert snap['entries'] == 0 and snap['bytes'] == 0
    assert snap['evictions'] == 1 and snap['put_drops'] == 2


# ------------------------------------------------------------- engines
def _adapter(params, rank, alpha, seed):
    """An adapter in the training layout on the q, k and v kernels of the
    scanned tree (k and v make the KV, and so the pages, the adapter's):
    A [L, in, r] and B [L, r, out] drawn N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def ab(kernel):
        n, din, dout = kernel.shape
        return {'kernel': {
            'a': rng.normal(0, 0.1, (n, din, rank)).astype(np.float32),
            'b': rng.normal(0, 0.1, (n, rank, dout)).astype(np.float32)}}
    attn = params['layers']['attn']
    return {'layers': {'attn': {name: ab(attn[name]['kernel'])
                                for name in ('wq', 'wk', 'wv')}}}, alpha


@pytest.fixture(scope='module')
def base():
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))['params']
    adapters = [_adapter(params, *a) for a in ADAPTERS]
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    sd = weights.params_from_jax({'params': params}, pcfg)

    def port_model():
        model = llama.LlamaModel(pcfg)
        model.load_state_dict(sd)
        return model

    return {'jm': jm, 'jp': jp, 'adapters': adapters,
            'jstack': jax_lora.build_stack(adapters, dtype='float32'),
            'stack': torch_lora.build_stack(adapters, dtype='float32'),
            'port_model': port_model}


def _waves(lora):
    """(prompt, max_new, lora_id) waves, each submitted together and
    drained before the next. lora: ids 1, 2 and 0 (the system prompt
    misses under id 2 after id 1 published it, and hits under id 1),
    else all 0."""
    rng = np.random.default_rng(7)

    def toks(n):
        return rng.integers(1, 256, n).tolist()
    system, base32, head16 = toks(40), toks(32), toks(16)
    ids = [1, 2, 1, 1, 0, 2, 0] if lora else [0] * 7
    first = system + toks(3)
    return [
        [(first, 6, ids[0])],                           # miss
        [(system + toks(9), 6, ids[1]),                 # hits (and a
         (system + toks(5), 6, ids[2]),                 # salted miss)
         (list(first), 6, ids[3])],                     # exact repeat
        # Chunked (64 + 36) while the short request decodes.
        [(toks(100), 6, ids[4]), (toks(9), 12, ids[4])],
        [(base32 + toks(3), 6, ids[5])],
        [(base32 + toks(70), 6, ids[5])],               # chunked after reuse
        [(head16 + toks(10), 4, ids[6])],
        # One page cached, its 40-token suffix buckets to 128: past the
        # slot's 128-token view, so a full prefill instead.
        [(head16 + toks(40), 4, ids[6])],
    ]


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _serve(eng, mod, waves):
    eng.start()
    try:
        outs = []
        for wave in waves:
            qs = [eng.submit(p, mod.SamplingParams(max_new_tokens=m,
                                                   lora_id=lid))[1]
                  for p, m, lid in wave]
            outs.append([_drain(q) for q in qs])
        return outs
    finally:
        eng.stop()


# Float pools serve the two adapters and the base model; int8 pools the
# base model.
CONFIGS = {'int8': {'kv_dtype': 'int8'}, 'lora': {}}


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def served(request, base):
    label = request.param
    opts = CONFIGS[label]
    lora = label == 'lora'
    waves = _waves(lora)
    jeng = jax_engine.InferenceEngine(
        base['jm'], nn.meta.unbox(base['jp']), num_slots=2,
        max_seq_len=MAX_SEQ, decode_chunk=4, cache_mode='paged',
        page_size=PAGE, prefill_chunk=CHUNK,
        lora_stack=base['jstack'] if lora else None, **opts)
    teng = torch_engine.InferenceEngine(
        base['port_model'](), num_slots=2, max_seq_len=MAX_SEQ,
        decode_chunk=4, page_size=PAGE, prefill_chunk=CHUNK, device='cpu',
        lora_stack=base['stack'] if lora else None, **opts)
    return {'label': label, 'lora': lora, 'jeng': jeng, 'teng': teng,
            'ref': _serve(jeng, jax_engine, waves),
            'got': _serve(teng, torch_engine, waves), 'waves': waves}


def test_engines_default_to_prefix_caching(served):
    assert served['jeng'].prefix_caching and served['teng'].prefix_caching
    assert served['teng'].prefill_chunk == CHUNK


def test_streams_equal_default_jax_engine(served):
    assert served['got'] == served['ref']
    for outs, wave in zip(served['got'], served['waves']):
        assert [len(o) for o in outs] == [m for _, m, _ in wave]


def test_prefix_stats_and_chunks_equal_jax(served):
    jeng, teng = served['jeng'], served['teng']
    assert teng.pool.prefix_stats == jeng.pool.prefix_stats
    assert teng.perf['prefill_chunks'] == jeng.perf['prefill_chunks']
    # Chunks: 100 -> 64 + 36, 102 with 32 cached -> 64 + 6.
    assert teng.perf['prefill_chunks'] == 4
    stats = teng.perf_stats()['prefix_cache']
    assert stats['hit_pages'] > 0 and stats['cached_pages'] > 0
    assert 0 < stats['occupancy'] <= 1


def test_flush_prefix_on_adapter_update(served):
    """The engines are stopped, so an update applies inline: with a stack
    it flushes the registry (as many entries as the JAX engine's), unless
    asked not to; without one the engine's flush_prefix does the same as
    the JAX pool's. Every page is free afterwards."""
    jeng, teng = served['jeng'], served['teng']
    cached = teng.pool.prefix_cached_pages()
    assert cached > 0
    if served['lora']:
        kept = teng.request_adapter_update(teng._lora_stack, num_adapters=3,
                                           flush_prefix=False)
        assert kept['flushed_prefix_pages'] == 0
        assert teng.pool.prefix_cached_pages() == cached
        flushed = teng.request_adapter_update(
            teng._lora_stack, num_adapters=3)['flushed_prefix_pages']
        ref = jeng.request_adapter_update(
            jeng._lora_stack, num_adapters=3)['flushed_prefix_pages']
    else:
        flushed, ref = teng.flush_prefix(), jeng.pool.flush_prefix()
    assert flushed == ref == cached
    assert teng.pool.prefix_cached_pages() == 0
    assert teng.pool.free_pages() == teng.pool.cfg.n_pages - 1


def test_cancelled_chunked_prefill_is_released(base):
    eng = torch_engine.InferenceEngine(
        base['port_model'](), num_slots=2, max_seq_len=MAX_SEQ,
        decode_chunk=4, page_size=PAGE, prefill_chunk=32, device='cpu')
    free = eng.pool.free_pages()
    rid, q = eng.submit(list(range(1, 120)),
                        torch_engine.SamplingParams(max_new_tokens=4))
    with torch.inference_mode():
        assert eng._admit_one()
        assert eng._chunked is not None and eng.pool.free_pages() < free
        assert eng._advance_chunked()
        assert eng.perf['prefill_chunks'] == 1
        assert eng.cancel(rid)
        assert eng._advance_chunked()
    assert eng._chunked is None and eng._slots == [None, None]
    assert eng.pool.free_pages() == free
    assert q.get(timeout=5) is None
    assert not eng.cancel(rid)


# ------------------------------------------------------------ host tier
def _tier_engine(base, monkeypatch, tier, **kw):
    monkeypatch.setenv('SKYT_KV_TIER', tier)
    return torch_engine.InferenceEngine(
        base['port_model'](), num_slots=2, max_seq_len=128, decode_chunk=4,
        page_size=PAGE, pool_tokens=128, device='cpu', **kw)


def _pages_of(eng, hashes):
    """Each published page's bytes in every pool ({name: [L, H, P(, d)]})."""
    out = []
    for h in hashes:
        page = eng.pool.registered_page(h)
        assert page is not None
        out.append({n: eng.cache[n][:, page].clone()
                    for n in eng._kv_pool_keys()})
    return out


def _same_bytes(a, b):
    return sorted(a) == sorted(b) and all(
        a[n].dtype == b[n].dtype and torch.equal(a[n].view(torch.uint8),
                                                 b[n].view(torch.uint8))
        for n in a)


@pytest.mark.parametrize('kv_dtype', ['auto', 'int8'])
def test_host_promotion_equals_recompute(base, monkeypatch, kv_dtype):
    """A 50-token prompt (3 reusable pages) in an 8-page pool; five
    17-token fillers with 47 new tokens each (4 pages, one published)
    evict all three and leave three pages free for the promotion. The
    rerun promotes them from the host store, bit-equal to the bytes
    spilled and to the pages first computed, and its stream equals the
    first run's."""
    eng = _tier_engine(base, monkeypatch, 'host', kv_dtype=kv_dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 256, 50).tolist()
    hashes = paged_cache.page_hashes(prompt, PAGE)[:3]
    eng.start()
    try:
        golden = eng.generate(prompt, torch_engine.SamplingParams(
            max_new_tokens=8))
        first = _pages_of(eng, hashes)
        for _ in range(5):
            eng.generate(rng.integers(1, 256, 17).tolist(),
                         torch_engine.SamplingParams(max_new_tokens=47))
        assert all(eng.pool.registered_page(h) is None for h in hashes)
        assert eng.kv_tier.drain()
        spilled = [eng.kv_tier.host.get(h, eng.kv_version) for h in hashes]
        assert all(s is not None for s in spilled)
        hits = eng.pool.prefix_stats['hit_pages']
        again = eng.generate(prompt, torch_engine.SamplingParams(
            max_new_tokens=8))
        promoted = _pages_of(eng, hashes)
    finally:
        eng.stop()
    assert again == golden
    assert eng.kv_tier.stats['promoted_pages'] == 3
    assert eng.pool.prefix_stats['hit_pages'] - hits == 3
    for f, s, p in zip(first, spilled, promoted):
        assert _same_bytes(s, f) and _same_bytes(p, s)
    snap = eng.perf_stats()['kv_tier']
    assert snap['tier'] == 'host' and snap['spill_stored'] >= 3


def test_kv_tier_off_leaves_engine_untouched(base, monkeypatch):
    eng = _tier_engine(base, monkeypatch, 'off')
    assert eng.kv_tier is None and eng.pool.on_evict is None
    assert 'kv_tier' not in eng.perf_stats()
    # Prefix caching off: a host tier has nothing to spill, so it stays off.
    eng = _tier_engine(base, monkeypatch, 'host', prefix_caching=False)
    assert eng.kv_tier is None and 'prefix_cache' not in eng.perf_stats()


def test_flush_drops_host_pages(base, monkeypatch):
    """A flush moves the tier to a new version: spilled pages (and any
    spill still in flight) never come back after it."""
    eng = _tier_engine(base, monkeypatch, 'host')
    h = bytes(16)
    page = {n: torch.zeros((2, 2, PAGE, 16)) for n in ('k', 'v')}
    assert eng.kv_tier.host.put(h, eng.kv_version, page)
    old = eng.kv_version
    eng.flush_prefix()
    assert len(eng.kv_tier.host) == 0
    assert not eng.kv_tier.host.put(h, old, page)
