"""The port's HTTP server (skypilot_tpu_torch/infer/server.py, the
standard library's ThreadingHTTPServer) against the reference's
(skypilot_tpu/infer/server.py, aiohttp), on the CPU: each over its own
engine at the 'debug' preset in float32, paged with 16-token pages, the
same weights (params_from_jax) and the same adapter ('ad1', id 1), each
on an ephemeral port once per module. The same requests go to both and
must give the same status codes, greedy tokens and texts:

  * /generate: tokens, text, stream (ndjson) and the max_new_tokens
    alias; an adapter by 'lora';
  * /v1/completions: a string, a batch, token-array prompts, n, stop,
    echo, logprobs (within 1e-4) and SSE ending in [DONE];
  * /v1/chat/completions: a template file the test writes (the same
    render), and the generic fallback (a render failure), SSE too;
  * /v1/models, the /stats keys the serve plane reads, request traces;
  * the /metrics families the fleet plane reads (serve/fleet.py);
  * the header contract (X-Request-Id; X-Priority, X-Tenant and
    service_tier 400s; X-Request-Deadline), 400s for malformed params,
    404 for an unknown model, and with SKYT_QOS=1 a 429 with
    Retry-After (a second server pair over the same engines).

Also: a client that disconnects mid-stream cancels its engine request,
and the port's server module imports neither aiohttp nor jax.
"""
import asyncio
import dataclasses
import http.client
import json
import os
import socket
import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import lora as jax_lora
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.infer import tokenizer as jax_tokenizer
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.utils import metrics as jax_metrics
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import lora as torch_lora
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.infer import tokenizer as torch_tokenizer
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.utils import metrics as torch_metrics

MAX_SEQ = 128
PAGE = 16
LP_ATOL = 1e-4
MODEL_ID = 'debug'
# A Llama-3-style template; a 'fail' role makes it raise (the fallback).
TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}"
    "{% if m['role'] == 'fail' %}{{ raise_exception('bad role') }}"
    "{% endif %}"
    "[{{ m['role'] }}]{{ m['content'] }}\n{% endfor %}"
    "{% if add_generation_prompt %}[assistant]{% endif %}")
# The /metrics families serve/fleet.py reads (:406-432, :680-695; the
# kv tier's only exists with SKYT_KV_TIER on).
FLEET_FAMILIES = {
    'skyt_infer_prefix_cache_pages': 'gauge',
    'skyt_infer_prefix_cache_occupancy': 'gauge',
    'skyt_infer_prefix_cache_hit_pages_total': 'counter',
    'skyt_infer_prefix_cache_miss_pages_total': 'counter',
    'skyt_infer_prefix_cache_evictions_total': 'counter',
    'skyt_infer_itl_seconds': 'histogram',
    'skyt_infer_kv_bytes_per_token': 'gauge',
    'skyt_infer_requests_total': 'counter',
    'skyt_infer_prefill_tokens_total': 'counter',
    'skyt_infer_decode_tokens_total': 'counter',
    'skyt_infer_ttft_seconds': 'histogram',
    'skyt_infer_deadline_expired_total': 'counter',
    'skyt_http_requests_total': 'counter'}
# The /stats keys the serve plane reads (replica_managers._STATS_KEYS,
# 'qos' only with SKYT_QOS=1).
STATS_KEYS = ('ttft_ms', 'steady_decode_tok_per_sec', 'active_slots',
              'num_slots', 'waiting', 'prefix_cache', 'adapters')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Aiohttp:
    """The reference app on an ephemeral port, on a loop thread of its
    own (stoppable, unlike web.run_app)."""

    def __init__(self, app):
        from aiohttp import web
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, '127.0.0.1', 0)
        self.loop.run_until_complete(site.start())
        self.port = site._server.sockets[0].getsockname()[1]
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _adapter(params, rank=4, alpha=8.0, seed=1):
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
def servers(tmp_path_factory):
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              max_seq_len=MAX_SEQ)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jp))['params']
    adapters = [_adapter(params)]
    pcfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl='flash')
    model = llama.LlamaModel(pcfg)
    model.load_state_dict(weights.params_from_jax({'params': params}, pcfg))
    jeng = jax_engine.InferenceEngine(
        jm, jp, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        cache_mode='paged', page_size=PAGE,
        lora_stack=jax_lora.build_stack(adapters, dtype='float32'),
        metrics_registry=jax_metrics.MetricsRegistry())
    teng = torch_engine.InferenceEngine(
        model, num_slots=4, max_seq_len=MAX_SEQ, decode_chunk=4,
        page_size=PAGE, device='cpu',
        lora_stack=torch_lora.build_stack(adapters, dtype='float32'),
        metrics_registry=torch_metrics.MetricsRegistry())
    # The template as a checkpoint dir carries it: both loaders agree.
    tok_dir = tmp_path_factory.mktemp('tok')
    with open(tok_dir / 'tokenizer_config.json', 'w') as f:
        json.dump({'chat_template': TEMPLATE, 'bos_token': '<s>'}, f)
    template = torch_tokenizer.load_chat_template(str(tok_dir))
    assert template == jax_tokenizer.load_chat_template(str(tok_dir))
    specials = torch_tokenizer.special_token_strings(str(tok_dir))
    assert specials == jax_tokenizer.special_token_strings(str(tok_dir))
    kw = dict(model_id=MODEL_ID, lora_names={'ad1': 1},
              chat_template=template, special_tokens=specials)
    jeng.start()
    teng.start()
    ref = _Aiohttp(jax_server.InferenceServer(jeng, **kw).make_app())
    port_srv = torch_server.InferenceServer(teng, **kw)
    port = port_srv.start()
    yield {'ref': ref.port, 'port': port, 'jeng': jeng, 'teng': teng,
           'kw': kw}
    port_srv.stop()
    ref.stop()
    jeng.stop()
    teng.stop()


def _call(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
    data = json.dumps(body) if body is not None else None
    hdrs = dict(headers or {})
    if data is not None:
        hdrs['Content-Type'] = 'application/json'
    c.request(method, path, body=data, headers=hdrs)
    r = c.getresponse()
    raw = r.read()
    c.close()
    return r.status, {k.lower(): v for k, v in r.getheaders()}, raw


def _json(raw):
    return json.loads(raw) if raw else None


def _both(servers, method, path, body=None, headers=None):
    return (_call(servers['ref'], method, path, body, headers),
            _call(servers['port'], method, path, body, headers))


def _sse_events(raw):
    events = [line[len('data: '):] for line in raw.decode().split('\n\n')
              if line.startswith('data: ')]
    assert events[-1] == '[DONE]', events[-1:]
    return [json.loads(e) for e in events[:-1]]


def _strip_ids(obj):
    """A response without the request ids (each engine counts its own)."""
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ('id', 'request_id')}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


PROMPT = [11, 200, 37, 5, 99, 140, 23, 64, 180]


# ------------------------------------------------------------- /generate
@pytest.mark.parametrize('body', [
    {'tokens': PROMPT, 'max_tokens': 6},
    {'tokens': PROMPT, 'max_new_tokens': 5},
    {'text': 'Hello, replica!', 'max_tokens': 7},
    {'tokens': PROMPT, 'max_tokens': 6, 'lora': 'ad1'},
    {'tokens': PROMPT, 'max_tokens': 8, 'presence_penalty': 0.6,
     'logit_bias': {'7': 4.0}}],
    ids=['tokens', 'max_new_tokens', 'text', 'lora', 'options'])
def test_generate_equal(servers, body):
    (rs, rh, rb), (ps, ph, pb) = _both(servers, 'POST', '/generate', body)
    assert rs == ps == 200
    assert _strip_ids(_json(pb)) == _strip_ids(_json(rb))
    assert 'x-request-id' in ph and 'x-request-id' in rh
    assert _json(pb)['request_id'] == int(ph['x-request-id'])


def test_generate_stream_equal(servers):
    body = {'tokens': PROMPT, 'max_tokens': 6, 'stream': True}
    (rs, rh, rb), (ps, ph, pb) = _both(servers, 'POST', '/generate', body)
    assert rs == ps == 200
    assert ph['content-type'] == 'application/x-ndjson'
    assert ph['transfer-encoding'] == 'chunked'
    toks = [json.loads(line)['token'] for line in pb.decode().splitlines()]
    assert toks == [json.loads(line)['token']
                    for line in rb.decode().splitlines()]
    whole = _call(servers['port'], 'POST', '/generate',
                  {'tokens': PROMPT, 'max_tokens': 6})
    assert toks == _json(whole[2])['tokens']


# -------------------------------------------------------- /v1/completions
@pytest.mark.parametrize('body', [
    {'prompt': 'The quick brown fox', 'max_tokens': 6},
    {'prompt': ['first prompt', 'a second one'], 'max_tokens': 5},
    {'prompt': PROMPT, 'max_tokens': 5},
    {'prompt': [PROMPT, PROMPT[:4]], 'max_tokens': 4},
    {'prompt': 'n completions', 'max_tokens': 4, 'n': 2},
    {'prompt': 'echo me', 'max_tokens': 4, 'echo': True},
    {'prompt': [PROMPT, PROMPT[2:]], 'max_tokens': 4, 'echo': True},
    {'prompt': PROMPT, 'max_tokens': 6, 'model': 'ad1'},
    {'prompt': PROMPT, 'max_tokens': 5, 'frequency_penalty': 0.5}],
    ids=['string', 'batch', 'tokens', 'token_batch', 'n', 'echo',
         'echo_tokens', 'adapter', 'penalty'])
def test_completions_equal(servers, body):
    (rs, _, rb), (ps, ph, pb) = _both(servers, 'POST', '/v1/completions',
                                      body)
    assert rs == ps == 200
    assert _strip_ids(_json(pb)) == _strip_ids(_json(rb))
    assert 'x-request-id' in ph


def test_completions_stop_equal(servers):
    """A stop string taken from the unstopped text: both cut there."""
    base = {'prompt': PROMPT, 'max_tokens': 16}
    text = _json(_call(servers['port'], 'POST', '/v1/completions',
                       base)[2])['choices'][0]['text']
    stop = next(text[i:i + 2] for i in range(3, len(text) - 1)
                if '\ufffd' not in text[i:i + 2])
    body = dict(base, stop=[stop, 'never-there'])
    (rs, _, rb), (ps, _, pb) = _both(servers, 'POST', '/v1/completions',
                                     body)
    assert rs == ps == 200
    got, ref = _json(pb)['choices'][0], _json(rb)['choices'][0]
    assert got == ref
    assert got['finish_reason'] == 'stop' and stop not in got['text']


def test_completions_logprobs_close(servers):
    body = {'prompt': PROMPT, 'max_tokens': 6, 'logprobs': 0}
    (rs, _, rb), (ps, _, pb) = _both(servers, 'POST', '/v1/completions',
                                     body)
    assert rs == ps == 200
    got = _json(pb)['choices'][0]
    ref = _json(rb)['choices'][0]
    assert got['text'] == ref['text']
    assert got['logprobs']['tokens'] == ref['logprobs']['tokens']
    np.testing.assert_allclose(got['logprobs']['token_logprobs'],
                               ref['logprobs']['token_logprobs'],
                               atol=LP_ATOL, rtol=0)


@pytest.mark.parametrize('path,body', [
    ('/v1/completions', {'prompt': 'stream me', 'max_tokens': 6,
                         'stream': True}),
    ('/v1/completions', {'prompt': PROMPT, 'max_tokens': 12,
                         'stream': True, 'stop': 'zz'}),
    ('/v1/chat/completions', {'messages': [
        {'role': 'user', 'content': 'hi'}], 'max_tokens': 6,
        'stream': True})], ids=['completions', 'stop', 'chat'])
def test_sse_equal(servers, path, body):
    (rs, rh, rb), (ps, ph, pb) = _both(servers, 'POST', path, body)
    assert rs == ps == 200
    assert ph['content-type'].startswith('text/event-stream')
    assert _strip_ids(_sse_events(pb)) == _strip_ids(_sse_events(rb))
    assert 'x-request-id' in ph


# --------------------------------------------------- /v1/chat/completions
@pytest.mark.parametrize('messages', [
    [{'role': 'system', 'content': 'Be brief.'},
     {'role': 'user', 'content': 'Name a color.'}],
    [{'role': 'fail', 'content': 'x'}, {'role': 'user', 'content': 'y'}]],
    ids=['template', 'fallback'])
def test_chat_equal(servers, messages):
    body = {'messages': messages, 'max_tokens': 6, 'n': 2}
    (rs, _, rb), (ps, _, pb) = _both(servers, 'POST',
                                     '/v1/chat/completions', body)
    assert rs == ps == 200
    got = _json(pb)
    assert _strip_ids(got) == _strip_ids(_json(rb))
    n_prompt = got['usage']['prompt_tokens']
    msgs = json.dumps(messages)
    srv = torch_server.InferenceServer(servers['teng'], **servers['kw'])
    rendered = srv._apply_chat_template(json.loads(msgs))
    assert n_prompt == len(rendered.encode())
    assert rendered.startswith('<|fail|>' if messages[0]['role'] == 'fail'
                               else '<s>[system]')


# ------------------------------------------------------ models and stats
def test_models_equal(servers):
    (rs, _, rb), (ps, _, pb) = _both(servers, 'GET', '/v1/models')
    assert rs == ps == 200 and _json(pb) == _json(rb)


def test_stats_keys_the_serve_plane_reads(servers):
    _both(servers, 'POST', '/generate', {'tokens': PROMPT, 'max_tokens': 2})
    (rs, _, rb), (ps, _, pb) = _both(servers, 'GET', '/stats')
    assert rs == ps == 200
    got, ref = _json(pb), _json(rb)
    for key in STATS_KEYS:
        assert key in got and key in ref, key
        assert type(got[key]) is type(ref[key]), key
    assert set(got['ttft_ms']) == set(ref['ttft_ms'])
    assert set(ref['prefix_cache']) <= set(got['prefix_cache'])
    assert got['adapters'] == ref['adapters']
    assert got['num_slots'] == ref['num_slots'] == 4
    assert 'qos' not in got and 'qos' not in ref


def test_request_trace_equal(servers):
    (_, rh, _), (_, ph, _) = _both(servers, 'POST', '/generate',
                                   {'tokens': PROMPT, 'max_tokens': 3})
    ref = _call(servers['ref'], 'GET',
                f'/stats?request_id={rh["x-request-id"]}')
    got = _call(servers['port'], 'GET',
                f'/stats?request_id={ph["x-request-id"]}')
    assert got[0] == ref[0] == 200
    want = {'request_id', 'queued', 'prefill_start', 'first_token', 'done',
            'status', 'generated', 'prompt_tokens'}
    g, r = _json(got[2]), _json(ref[2])
    assert want <= set(g) and want <= set(r)
    assert (g['status'], g['generated'], g['prompt_tokens']) == \
        (r['status'], r['generated'], r['prompt_tokens']) == \
        ('done', 3, len(PROMPT))
    assert g['queued'] <= g['prefill_start'] <= g['first_token'] <= \
        g['done']


def test_metrics_families_the_fleet_plane_reads(servers):
    _both(servers, 'POST', '/generate', {'tokens': PROMPT, 'max_tokens': 2})
    (rs, rh, rb), (ps, ph, pb) = _both(servers, 'GET', '/metrics')
    assert rs == ps == 200
    assert ph['content-type'] == rh['content-type']

    def families(raw):
        out = {}
        for line in raw.decode().splitlines():
            if line.startswith('# TYPE '):
                _, _, name, typ = line.split()
                out[name] = typ
        return out

    def sample(raw, name):
        for line in raw.decode().splitlines():
            if line.startswith(name + ' '):
                return float(line.split()[1])
        return None
    got, ref = families(pb), families(rb)
    for name, typ in FLEET_FAMILIES.items():
        assert got.get(name) == typ and ref.get(name) == typ, name
    assert sample(pb, 'skyt_infer_kv_bytes_per_token') == \
        sample(rb, 'skyt_infer_kv_bytes_per_token')
    assert sample(pb, 'skyt_infer_requests_total') >= 1


# -------------------------------------------------- headers and refusals
ERROR_CASES = [
    ('/generate', {'tokens': PROMPT}, {'X-Priority': 'vip'}, 400),
    ('/generate', {'tokens': PROMPT}, {'X-Tenant': 'bad tenant!'}, 400),
    ('/generate', {'tokens': PROMPT}, {'X-Request-Deadline': 'soon'}, 400),
    ('/generate', {'tokens': PROMPT}, {'X-Request-Deadline': '-1'}, 400),
    ('/generate', {'nothing': 1}, {}, 400),
    ('/generate', {'tokens': []}, {}, 400),
    ('/generate', {'tokens': PROMPT, 'max_tokens': 'x'}, {}, 400),
    ('/generate', {'tokens': PROMPT, 'top_k': 65}, {}, 400),
    ('/generate', {'tokens': PROMPT, 'logit_bias': {'a': 1}}, {}, 400),
    ('/generate', {'tokens': PROMPT, 'logit_bias': {'999': 1}}, {}, 400),
    ('/generate', {'tokens': PROMPT, 'lora': 'nope'}, {}, 404),
    ('/v1/completions', {'max_tokens': 2}, {}, 400),
    ('/v1/completions', {'prompt': []}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'n': 0}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'n': True}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'stop': 5}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'n': 2, 'stream': True}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'echo': True, 'stream': True}, {},
     400),
    ('/v1/completions', {'prompt': 'x', 'logprobs': 1, 'stop': 'a'}, {},
     400),
    ('/v1/completions', {'prompt': 'x', 'echo': True, 'logprobs': 0}, {},
     400),
    ('/v1/completions', {'prompt': 'x', 'suffix': 'y'}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'best_of': 3}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'top_p': 2.0}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'service_tier': 'gold'}, {}, 400),
    ('/v1/completions', {'prompt': 'x', 'model': 'nope'}, {}, 404),
    ('/v1/chat/completions', {'messages': []}, {}, 400),
    ('/v1/chat/completions', {'messages': ['hi']}, {}, 400),
    ('/v1/chat/completions', {'messages': [{'role': 'user'}],
                              'logprobs': True}, {}, 400),
    ('/v1/chat/completions', {'messages': [{'role': 'user'}], 'n': 2,
                              'stream': True}, {}, 400),
    ('/v1/chat/completions', {'messages': [{'role': 'user'}],
                              'model': 'nope'}, {}, 404),
]


@pytest.mark.parametrize('path,body,headers,status', ERROR_CASES)
def test_refusals_equal(servers, path, body, headers, status):
    (rs, _, rb), (ps, _, pb) = _both(servers, 'POST', path, body, headers)
    assert rs == ps == status
    if status == 404:
        assert _json(pb) == _json(rb)


@pytest.mark.parametrize('path,body', [
    ('/generate', {'tokens': PROMPT, 'max_tokens': 4}),
    ('/v1/completions', {'prompt': 'x', 'max_tokens': 4,
                         'service_tier': 'flex'})])
def test_qos_headers_accepted_equal(servers, path, body):
    hdrs = {'X-Priority': 'interactive', 'X-Tenant': 'team-a.1'}
    (rs, _, rb), (ps, _, pb) = _both(servers, 'POST', path, body, hdrs)
    assert rs == ps == 200
    assert _strip_ids(_json(pb)) == _strip_ids(_json(rb))


def test_deadline_header_ends_a_request(servers):
    body = {'tokens': PROMPT, 'max_tokens': MAX_SEQ - len(PROMPT) - 1}
    hdrs = {'X-Request-Deadline': '0.000001'}
    (rs, _, rb), (ps, ph, pb) = _both(servers, 'POST', '/generate', body,
                                      hdrs)
    assert rs == ps == 200
    assert len(_json(pb)['tokens']) < body['max_tokens']
    assert len(_json(rb)['tokens']) < body['max_tokens']
    trace = _json(_call(servers['port'], 'GET',
                        f'/stats?request_id={ph["x-request-id"]}')[2])
    assert trace['status'] == 'deadline'


def test_qos_throttle_429_equal(servers, monkeypatch):
    """SKYT_QOS=1 with a one-request tenant bucket: a second request of
    the tenant is throttled, 429 with Retry-After, on both; /stats
    carries the qos block."""
    monkeypatch.setenv('SKYT_QOS', '1')
    # No TTFT signal: the reference engine's TTFTs include its compiles.
    monkeypatch.setenv('SKYT_QOS_TTFT_SLO_MS', '0')
    monkeypatch.setenv('SKYT_QOS_TENANT_RPS', '0.01')
    monkeypatch.setenv('SKYT_QOS_TENANT_BURST', '1')
    ref = _Aiohttp(jax_server.InferenceServer(servers['jeng'],
                                              **servers['kw']).make_app())
    port_srv = torch_server.InferenceServer(servers['teng'],
                                            **servers['kw'])
    port = port_srv.start()
    try:
        out = {}
        for name, p in (('ref', ref.port), ('port', port)):
            hdrs = {'X-Tenant': 'greedy-tenant'}
            first = _call(p, 'POST', '/generate',
                          {'tokens': PROMPT, 'max_tokens': 2}, hdrs)
            second = _call(p, 'POST', '/v1/completions',
                           {'prompt': 'x', 'max_tokens': 2}, hdrs)
            stats = _json(_call(p, 'GET', '/stats')[2])
            out[name] = (first[0], second[0],
                         second[1].get('retry-after'),
                         _json(second[2])['qos'], sorted(stats['qos']))
    finally:
        port_srv.stop()
        ref.stop()
    assert out['port'] == out['ref']
    assert out['port'][:2] == (200, 429)
    assert int(out['port'][2]) >= 1


def test_disconnect_cancels_the_engine_request(servers):
    """A stream whose client leaves: the engine request is cancelled
    (its trace ends 'cancelled' long before max_tokens) and counted."""
    teng = servers['teng']
    sock = socket.create_connection(('127.0.0.1', servers['port']))
    body = json.dumps({'tokens': PROMPT, 'stream': True,
                       'max_tokens': MAX_SEQ - len(PROMPT) - 1}).encode()
    sock.sendall(b'POST /generate HTTP/1.1\r\nHost: x\r\n'
                 b'Content-Type: application/json\r\n'
                 b'Content-Length: %d\r\n\r\n%s' % (len(body), body))
    head = b''
    while b'\r\n\r\n' not in head:
        head += sock.recv(4096)
    rid = int(next(line.split(b':')[1] for line in head.split(b'\r\n')
                   if line.lower().startswith(b'x-request-id')))
    sock.close()
    deadline = time.time() + 120
    while time.time() < deadline:
        tr = teng.request_trace(rid)
        if tr and 'done' in tr:
            break
        time.sleep(0.05)
    assert tr['status'] == 'cancelled', tr
    assert tr['generated'] < MAX_SEQ - len(PROMPT) - 1
    gone = teng.metrics_registry.get('skyt_server_client_disconnects_total')
    assert gone.value() >= 1


def test_server_module_imports_no_aiohttp_or_jax():
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys\n'
            'import skypilot_tpu_torch.infer.server\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("aiohttp", "jax", "flax") or m == "skypilot_tpu" or '
            'm.startswith("skypilot_tpu.")]\n'
            'print(bad)\nsys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
