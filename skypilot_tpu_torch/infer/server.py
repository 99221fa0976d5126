"""HTTP front end of a replica, and the engine factory (counterpart of
skypilot_tpu/infer/server.py), on the standard library: a
ThreadingHTTPServer speaking HTTP/1.1, Content-Length on whole responses
and chunked transfer encoding on streams. Endpoints:

  GET  /health            200 {"status": "ok"} while the engine loop
                          runs, else 503 (the readiness probe).
  GET  /stats             engine stats (the keys the serve plane reads:
                          ttft_ms, steady_decode_tok_per_sec,
                          active_slots, num_slots, waiting, prefix_cache,
                          adapters, and qos under SKYT_QOS=1);
                          ?request_id=N: that request's phase trace.
  GET  /metrics           Prometheus text exposition (utils/metrics.py).
  POST /generate          {"tokens": [...]} or {"text": "..."}, with
                          max_tokens (or max_new_tokens), temperature,
                          top_k, top_p, penalties, logit_bias, lora,
                          eos_token, stream (one JSON line a token).
  GET  /v1/models         the served model and its adapters.
  POST /v1/completions    OpenAI completions: prompt as a string, a list
                          of strings, [int] or [[int]]; n, stop, echo,
                          logprobs (the chosen token's), stream (SSE
                          ending in [DONE]).
  POST /v1/chat/completions  OpenAI chat: the messages rendered through
                          the checkpoint's jinja chat template (jinja2's
                          sandbox), else a generic role-tag format.
  POST /admin/weights     {"checkpoint": dir, "version"?, "drain"?} or
                          {"swap_back": true}: the in-place weight swap
                          (infer/weight_swap.py WeightSwapManager).
  POST /admin/adapters    {"op": "load", "name", "checkpoint": dir,
                          "alpha"?, "drain"?} | {"op": "unload", "name"}
                          | {"op": "list"}: adapter hot-load
                          (AdapterRegistry); /v1/models, the 'model'
                          routing and the QoS labels follow it.
  The admin routes need SKYT_ADMIN_TOKEN set and presented as a bearer
  (403 otherwise); 400 on a malformed body or a failed load, 409 while
  another swap or update is in flight or an unloaded adapter is still
  referenced. /admin/reshard and /admin/kv_prewarm answer 501 naming
  what they wait for.

Headers: X-Request-Id on every generation response; X-Priority,
X-Tenant (and the OpenAI body's service_tier) name the QoS class and
tenant (400 when malformed, QoS on or off); X-Request-Deadline (seconds)
becomes the request's deadline; with SKYT_QOS=1 a shed or throttle
decision is a 429 with Retry-After. A client that disconnects cancels
its engine requests. Handler threads never touch the device: they see
Python ints and floats from the engine's queues.

Weights: an HF checkpoint dir (--checkpoint, or SKYT_WEIGHTS_CHECKPOINT
over it; the llama, mistral, gemma, qwen2, qwen3, gemma2 and phi3
families and the MoE types mixtral and qwen3_moe, streamed in by
models/weights.py) with its tokenizer.json (--tokenizer, default the
checkpoint dir; the byte tokenizer with a warning when there is none),
or a preset's random weights from a seed (llama.CONFIGS, or
moe.MIXTRAL_CONFIGS: debug-moe, mixtral-8x7b, qwen3-30b-a3b).
--quantize int8 | int4 serves weight-only quantized projections,
quantized as they load (a MoE model: int8 only, its experts too).
--spec-decode k with --draft-checkpoint (an HF checkpoint of a small
model of the same vocab) or --draft-model (a preset, random weights; or
'self', the served model drafting for itself) drafts with a model
instead of the n-gram lookup. --lora name=dir[:alpha] (repeatable)
serves the adapters of port sft --lora-rank runs (infer/lora.py
build_stack_from_specs; ids from 1 in flag order) by name.

Not ported yet (ROADMAP queue 1): the fleet KV tier's /kv/prefix and
/kv/index and /admin/kv_prewarm (item 6.1), /admin/reshard (item 13),
/debug/* with the tracing plane, the SLO goodput and capacity counters,
tensor parallelism and multi-host replicas (item 13): their flags exit
naming the queue item.

Run:
  python -m skypilot_tpu_torch.infer.server --checkpoint /ckpt/llama3-8b \
      --quantize int8 --port 8000
  python -m skypilot_tpu_torch.infer.server --model llama3-8b --port 8000
      (random weights from a seed, the byte tokenizer)
  python -m skypilot_tpu_torch.infer.server --model qwen3-30b-a3b --port 8000
  python -m skypilot_tpu_torch.infer.server --checkpoint /ckpt/mixtral-8x7b \
      --quantize int8 --port 8000
  python -m skypilot_tpu_torch.infer.server --checkpoint /ckpt/qwen3-8b \
      --spec-decode 4 --draft-checkpoint /ckpt/qwen3-0.6b --port 8000
"""
import argparse
import concurrent.futures
import dataclasses
import datetime
import functools
import hmac
import http.server
import json
import os
import queue as queue_lib
import select
import signal
import socket
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import lora as lora_lib
from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib
from skypilot_tpu_torch.infer import weight_swap as weight_swap_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.models import quant as quant_lib
from skypilot_tpu_torch.models import weights as weights_lib
from skypilot_tpu_torch.serve import qos as qos_lib
from skypilot_tpu_torch.utils import device as device_lib
from skypilot_tpu_torch.utils import env as env_lib
from skypilot_tpu_torch.utils import log_utils
from skypilot_tpu_torch.utils import metrics as metrics_lib

logger = log_utils.init_logger(__name__)

# An engine queue that yields nothing this long fails the request.
_ENGINE_SILENCE_S = 300.0
# Between two looks at the client's socket while waiting on the engine.
_POLL_S = 0.5
# A MoE model's capacity factor when serving (the reference's): finite
# capacity drops assignments as a function of the batch's shape.
MOE_SERVE_CAPACITY = 8.0


def build_engine(model_name: str = 'llama3-8b',
                 num_slots: int = 8,
                 max_seq_len: int = 2048,
                 decode_chunk: int = 16,
                 page_size: int = 64,
                 pool_tokens: Optional[int] = None,
                 dtype: str = 'bfloat16',
                 device=None,
                 seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 prefix_caching: bool = True,
                 spec_decode: int = 0,
                 kv_dtype: str = 'auto',
                 prefill_chunk: int = 0,
                 draft_model_name: Optional[str] = None,
                 draft_checkpoint: Optional[str] = None,
                 lora_stack: Optional[Dict[str, Any]] = None,
                 metrics_registry: Optional[
                     metrics_lib.MetricsRegistry] = None,
                 checkpoint: Optional[str] = None,
                 quantize: str = 'none'
                 ) -> engine_lib.InferenceEngine:
    """Paged-cache engine on `device` (None -> 'cuda'; raises without
    CUDA unless device='cpu'), weights and activations in `dtype`.

    checkpoint: an HF checkpoint dir (config.json + *.safetensors): its
    config (max_seq_len capped) and its weights, streamed in
    (model_name is then unused). Otherwise preset `model_name` (of
    llama.CONFIGS or moe.MIXTRAL_CONFIGS) with
    params, a state_dict to load (for example
    models.weights.params_from_jax of a JAX tree), or random weights
    drawn from a torch.Generator seeded with `seed` on the device.
    quantize 'int8' | 'int4': weight-only quantized projections and
    lm_head — quantized as each tensor loads, after the load of params,
    or as the random init draws them (the float init's weights,
    quantized). pool_tokens / prefix_caching / prefill_chunk / spec_decode /
    kv_dtype / lora_stack / metrics_registry pass through to the engine
    (the page pool's size, prefix caching (on by default, as the JAX
    package's), chunked prefill, n-gram speculative decoding, int8 KV, a
    multi-LoRA stack from infer/lora.py, served by
    SamplingParams.lora_id, where its metrics live).

    draft_model_name / draft_checkpoint (with spec_decode > 0): a draft
    model replaces the n-gram proposer: an HF checkpoint's (its own
    config, in `dtype`), a preset's with random weights from seed + 1
    (chance-level acceptance: a mechanism check, slower than no
    speculation), or 'self', the served model itself (every greedy draft
    the target's own argmax: the mechanism's upper bound, no speed-up).
    Not quantized, but for 'self'. The engine refuses a draft whose
    vocab is not the target's.

    A MoE model (a MIXTRAL_CONFIGS preset, a mixtral or qwen3_moe
    checkpoint) routes at capacity factor MOE_SERVE_CAPACITY, as the
    reference serves it; quantize 'int8' covers its experts, 'int4'
    raises, and so does lora_stack (the reference model takes no
    adapters)."""
    if quantize not in ('none',) + quant_lib.MODES:
        raise ValueError(f'unknown quantize mode {quantize!r}')
    if checkpoint and params is not None:
        raise ValueError('pass checkpoint or params, not both')
    moe_cfg = None
    if not checkpoint:
        if model_name in moe_lib.MIXTRAL_CONFIGS:
            preset, moe_cfg = moe_lib.MIXTRAL_CONFIGS[model_name]
            moe_cfg = dataclasses.replace(
                moe_cfg, capacity_factor=MOE_SERVE_CAPACITY)
        elif model_name in llama.CONFIGS:
            preset = llama.CONFIGS[model_name]
        else:
            raise ValueError(f'unknown model {model_name!r}; presets: '
                             f'{sorted(llama.CONFIGS)} and '
                             f'{sorted(moe_lib.MIXTRAL_CONFIGS)}')
    is_moe = moe_cfg is not None or bool(checkpoint) and (
        weights_lib.checkpoint_model_type(checkpoint) in
        weights_lib.MOE_TYPES)
    if lora_stack is not None and is_moe:
        raise ValueError('a MoE model takes no LoRA stack')
    dev = device_lib.resolve_device(device)
    if checkpoint:
        # The checkpoint's weights in the compute dtype, each projection
        # (and expert) quantized as it leaves the reader when asked.
        ckpt_len = weights_lib.load_config(checkpoint).max_seq_len
        _, _, model = weights_lib.load_checkpoint(
            checkpoint, quantize=quantize, device=dev, remat=False,
            dtype=dtype, param_dtype=dtype,
            max_seq_len=min(ckpt_len, max_seq_len),
            capacity_factor=MOE_SERVE_CAPACITY)
    else:
        cfg = dataclasses.replace(
            preset, dtype=dtype, remat=False, quant=quantize,
            max_seq_len=min(preset.max_seq_len, max_seq_len))
        if cfg.param_dtype == 'float32' and cfg.dtype == 'bfloat16':
            # Serving keeps the weights in the compute dtype: an f32
            # master copy would double the weight bytes every decode step
            # reads.
            cfg = dataclasses.replace(cfg, param_dtype='bfloat16')
        # Built on the meta device, then materialized once on the target:
        # no host copy of the weights and no default init to overwrite.
        model = (llama.LlamaModel(cfg, device='meta') if moe_cfg is None
                 else moe_lib.MixtralModel(cfg, moe_cfg, device='meta')
                 ).to_empty(device=dev)
        if params is not None:
            if quantize != 'none':
                # Float projections quantized; quantized ones kept.
                params = quant_lib.quantize_params(params, quantize)
            model.load_state_dict(params)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            model.init_weights(gen)
    draft = None
    if spec_decode > 0 and (draft_model_name or draft_checkpoint):
        draft = _build_draft(model, draft_model_name, draft_checkpoint,
                             dtype, dev, seed, model.cfg.max_seq_len)
    engine = engine_lib.InferenceEngine(
        model, num_slots=num_slots, max_seq_len=model.cfg.max_seq_len,
        decode_chunk=decode_chunk, page_size=page_size,
        pool_tokens=pool_tokens, prefix_caching=prefix_caching,
        prefill_chunk=prefill_chunk, spec_decode=spec_decode,
        kv_dtype=kv_dtype, device=dev, draft_model=draft,
        lora_stack=lora_stack, metrics_registry=metrics_registry)
    # The weight swap's loader (infer/weight_swap.py): a checkpoint of
    # this config read in this engine's weight mode (dtype, quantize)
    # straight onto the device, so the swap validates like with like.
    engine.checkpoint_path = checkpoint
    cfg, moe = model.cfg, getattr(model, 'moe', None)

    def param_loader(path: str) -> Dict[str, torch.Tensor]:
        if moe is not None:
            return weights_lib.load_mixtral_params(
                cfg, moe, path, quantize=quantize, device=dev)
        return weights_lib.load_llama_params(cfg, path, quantize=quantize,
                                             device=dev)
    engine.param_loader = param_loader
    return engine


def _build_draft(model, name: Optional[str], checkpoint: Optional[str],
                 dtype: str, dev, seed: int, max_seq_len: int):
    """build_engine's draft model: 'self', a checkpoint's, or a preset's
    random weights (the reference's three routes)."""
    if name == 'self':
        return model
    if checkpoint:
        ckpt_len = weights_lib.load_config(checkpoint).max_seq_len
        _, _, draft = weights_lib.load_checkpoint(
            checkpoint, device=dev, remat=False, dtype=dtype,
            param_dtype=dtype, max_seq_len=min(ckpt_len, max_seq_len),
            capacity_factor=MOE_SERVE_CAPACITY)
        return draft
    if name not in llama.CONFIGS:
        raise ValueError(f'unknown draft model {name!r}; presets: '
                         f'{sorted(llama.CONFIGS)}')
    dcfg = dataclasses.replace(llama.CONFIGS[name], dtype=dtype,
                               param_dtype=dtype, remat=False,
                               max_seq_len=max_seq_len)
    draft = llama.LlamaModel(dcfg, device='meta').to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    draft.init_weights(gen)
    logger.warning(
        'draft model %r has RANDOM weights (no draft checkpoint): its '
        'drafts are accepted at chance, so decoding is slower than with '
        'spec_decode 0; point --draft-checkpoint at a small model of the '
        "same vocab for a speed-up", name)
    return draft


class _StopScanner:
    """Windowed incremental stop-sequence matcher, shared by the SSE
    and drain paths. A new match can only END inside the newest piece,
    so each feed() searches max(len(stop))-1 chars of history plus the
    piece."""

    def __init__(self, stops: List[str]) -> None:
        self.stops = stops
        self.max_len = max((len(s) for s in stops), default=0)
        self.acc = ''
        self.cut: Optional[int] = None   # absolute earliest-match index

    def feed(self, piece: str) -> bool:
        """Append new text; True once a stop has matched."""
        if self.cut is not None:
            return True
        lo = max(0, len(self.acc) - (self.max_len - 1)) \
            if self.max_len else len(self.acc)
        self.acc += piece
        if not self.stops:
            return False
        window = self.acc[lo:]
        best = None
        for s in self.stops:
            i = window.find(s)
            if i != -1 and (best is None or i < best):
                best = i
        if best is not None:
            self.cut = lo + best
        return self.cut is not None

    @property
    def text(self) -> str:
        """Full text, truncated before the earliest stop match."""
        return self.acc if self.cut is None else self.acc[:self.cut]

    def safe_len(self, final: bool = False) -> int:
        """Chars emittable now: everything up to the match, else all
        but the max(len(stop))-1 holdback (a partial stop prefix can
        span pieces); `final` flushes the holdback."""
        if self.cut is not None:
            return self.cut
        if final or not self.max_len:
            return len(self.acc)
        return max(0, len(self.acc) - (self.max_len - 1))


class _Disconnected(Exception):
    """The client went away mid-request."""


@dataclasses.dataclass
class _Reply:
    """A whole response: JSON (payload a dict) or text (a str)."""
    status: int
    payload: Any
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    content_type: str = 'application/json; charset=utf-8'


def _error(status: int, message: Any, **headers) -> _Reply:
    body = message if isinstance(message, dict) else {'error': message}
    return _Reply(status, body, dict(headers))


class _Exchange:
    """One request on a handler thread: its body and headers, the reply
    (whole or streamed), and the client's presence."""

    def __init__(self, handler: http.server.BaseHTTPRequestHandler,
                 query: Dict[str, str]) -> None:
        self.h = handler
        self.headers = handler.headers
        self.query = query
        self.rids: List[int] = []     # engine requests to cancel on leave
        self.streaming = False

    def json_body(self) -> Dict[str, Any]:
        n = int(self.headers.get('Content-Length') or 0)
        raw = self.h.rfile.read(n) if n > 0 else b''
        try:
            payload = json.loads(raw or b'null')
        except ValueError as e:
            raise _BadRequest(f'invalid JSON body: {e}') from None
        if not isinstance(payload, dict):
            raise _BadRequest('the JSON body must be an object')
        return payload

    def gone(self) -> bool:
        """True when the client closed its side: the socket reads as
        ready and a peek returns no bytes (or fails)."""
        sock = self.h.connection
        try:
            ready, _, _ = select.select([sock], [], [], 0)
            if not ready:
                return False
            return sock.recv(1, socket.MSG_PEEK) == b''
        except (OSError, ValueError):
            return True

    def q_get(self, out_q: 'queue_lib.Queue') -> Any:
        """out_q.get in short slices; between them, a client that left
        cancels this exchange's engine requests (their slots and pages
        free at the next delivery boundary)."""
        deadline = time.monotonic() + _ENGINE_SILENCE_S
        while True:
            try:
                return out_q.get(timeout=_POLL_S)
            except queue_lib.Empty:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f'engine produced nothing for {_ENGINE_SILENCE_S:.0f}s')
            if self.gone():
                raise _Disconnected('client disconnected mid-request')

    def send(self, reply: _Reply) -> None:
        if isinstance(reply.payload, (dict, list)):
            body = json.dumps(reply.payload).encode()
        else:
            body = str(reply.payload).encode()
        h = self.h
        h.send_response(reply.status)
        h.send_header('Content-Type', reply.content_type)
        h.send_header('Content-Length', str(len(body)))
        for k, v in reply.headers.items():
            h.send_header(k, v)
        h.end_headers()
        self._write(body)

    def start_stream(self, content_type: str,
                     headers: Dict[str, str]) -> None:
        h = self.h
        h.send_response(200)
        h.send_header('Content-Type', content_type)
        h.send_header('Transfer-Encoding', 'chunked')
        for k, v in headers.items():
            h.send_header(k, v)
        h.end_headers()
        self.streaming = True

    def write_chunk(self, data: bytes) -> None:
        if data:
            self._write(b'%x\r\n%s\r\n' % (len(data), data))

    def end_stream(self) -> None:
        self._write(b'0\r\n\r\n')

    def _write(self, data: bytes) -> None:
        try:
            self.h.wfile.write(data)
            self.h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError) as e:
            raise _Disconnected(str(e)) from None


class _BadRequest(Exception):
    """A malformed body: a 400 naming the problem."""


class InferenceServer:
    """The replica's HTTP server over one engine. lora_names: {adapter
    name: stack id} of the engine's boot stack (a request's 'model', or
    /generate's 'lora', names one); lora_specs: the --lora specs that
    built it (their host trees are then retained, so a rank-growing
    hot-load can rebuild the stack). POST /admin/adapters changes the
    map at run time."""

    ROUTES = {('GET', '/health'): '_health',
              ('GET', '/stats'): '_stats',
              ('GET', '/metrics'): '_metrics',
              ('GET', '/v1/models'): '_models',
              ('POST', '/generate'): '_generate',
              ('POST', '/v1/completions'): '_completions',
              ('POST', '/v1/chat/completions'): '_chat_completions',
              ('POST', '/admin/weights'): '_admin_weights',
              ('POST', '/admin/adapters'): '_admin_adapters',
              ('POST', '/admin/reshard'): '_admin_reshard',
              ('POST', '/admin/kv_prewarm'): '_admin_kv_prewarm'}

    def __init__(self, engine: engine_lib.InferenceEngine,
                 tokenizer=None, model_id: str = 'skypilot-tpu',
                 lora_names: Optional[Dict[str, int]] = None,
                 chat_template: Optional[str] = None,
                 special_tokens: Optional[Dict[str, str]] = None,
                 lora_specs=None) -> None:
        self.engine = engine
        self.tokenizer = tokenizer or tokenizer_lib.ByteTokenizer(
            engine.cfg.vocab_size)
        self.model_id = model_id
        self.lora_names = dict(lora_names or {})
        if model_id in self.lora_names:
            # The base id resolves first: a colliding adapter would be
            # unreachable.
            raise ValueError(f'adapter name {model_id!r} collides with the '
                             'served model id; rename the adapter')
        # The in-place weight swap and the adapter registry (one
        # single-flight lock); every adapter change resyncs the routing
        # map and the engine's model labels.
        self._swap_mgr = weight_swap_lib.WeightSwapManager(engine)
        self._adapters = weight_swap_lib.AdapterRegistry(
            engine, self._swap_mgr, reserved_names={model_id},
            on_change=self._adapters_changed)
        if lora_specs:
            self._adapters.seed(lora_specs)
        elif self.lora_names:
            self._adapters.seed_names(self.lora_names)
        self._adapters_changed()
        self._special_tokens = dict(special_tokens or {})
        self._chat_template = self._compile_template(chat_template) \
            if chat_template else None
        reg = engine.metrics_registry
        # None with SKYT_QOS=0; header parsing (400 on malformed input)
        # stays on either way.
        self._qos = qos_lib.ServerQoS(engine.qos_signals, registry=reg) \
            if qos_lib.enabled() else None
        self._m_disconnects = reg.counter(
            'skyt_server_client_disconnects_total',
            'Requests whose client disconnected mid-flight (engine '
            'request cancelled)')
        self._m_http = reg.counter('skyt_http_requests_total',
                                   'HTTP requests served', ('path', 'code'))
        self._m_lat = reg.histogram(
            'skyt_http_request_seconds',
            'HTTP request wall latency by route (streaming routes count '
            'the full stream)', ('path',))
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _adapters_changed(self) -> None:
        """The registry's change hook: the routing map and the engine's
        model labels (QoS flows, bounded by the adapters) follow it."""
        self.lora_names = self._adapters.name_ids()
        self.engine.model_labels = {0: self.model_id, **{
            lid: name for name, lid in self.lora_names.items()}}

    @staticmethod
    def _compile_template(source: str):
        """The chat template in jinja2's immutable sandbox (the helpers
        HF templates call: raise_exception, strftime_now); None (the
        generic format) when jinja2 is missing or the template does not
        compile."""
        try:
            import jinja2
            import jinja2.sandbox
        except ImportError:
            logger.warning('jinja2 not installed; chat requests use the '
                           'generic role-tag format')
            return None

        def raise_exception(msg):
            raise jinja2.TemplateError(msg)
        env = jinja2.sandbox.ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True)
        env.globals['raise_exception'] = raise_exception
        env.globals['strftime_now'] = (
            lambda fmt: datetime.datetime.now().strftime(fmt))
        try:
            return env.from_string(source)
        except jinja2.TemplateError as e:
            logger.warning('chat template failed to compile (%s); using '
                           'the generic format', e)
            return None

    # ------------------------------------------------------------ serving
    def start(self, host: str = '127.0.0.1', port: int = 0) -> int:
        """Serve on a thread of its own; returns the bound port (port 0:
        an ephemeral one)."""
        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={'poll_interval': 0.2},
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

    def dispatch(self, handler, method: str) -> None:
        """Route one request, count it (skyt_http_requests_total by the
        route's path, never the raw one; 499 for a client that left),
        and time it."""
        parts = urllib.parse.urlsplit(handler.path)
        query = dict(urllib.parse.parse_qsl(parts.query))
        name = self.ROUTES.get((method, parts.path))
        known = any(p == parts.path for _, p in self.ROUTES)
        path = parts.path if known else 'unmatched'
        ex = _Exchange(handler, query)
        code = '500'
        t0 = time.perf_counter()
        try:
            if name is None:
                reply = _error(405, f'method {method} not allowed') \
                    if known else _error(404, 'not found')
            else:
                try:
                    reply = getattr(self, name)(ex)
                except _BadRequest as e:
                    reply = _error(400, str(e))
            if reply is not None:
                ex.send(reply)
                code = str(reply.status)
            else:
                code = '200'    # a stream that ran to its end
        except _Disconnected:
            code = '499'
            self._m_disconnects.inc()
            for rid in ex.rids:
                self.engine.cancel(rid)
            handler.close_connection = True
        except Exception as e:  # pylint: disable=broad-except
            logger.exception('%s %s failed', method, parts.path)
            for rid in ex.rids:
                self.engine.cancel(rid)
            handler.close_connection = True
            if not ex.streaming:
                try:
                    ex.send(_error(500, f'internal error: {e}'))
                except _Disconnected:
                    pass
        finally:
            self._m_http.labels(path, code).inc()
            self._m_lat.labels(path).observe(time.perf_counter() - t0)

    # ------------------------------------------------------------- parsing
    def _resolve_lora(self, payload) -> Tuple[int, Optional[_Reply]]:
        """'model' -> (stack id, None): the base id (or no 'model') is
        0, a served adapter's name its id; any other name is the OpenAI
        model_not_found error (404)."""
        name = payload.get('model')
        if name is None or name == self.model_id:
            return 0, None
        lid = self.lora_names.get(name)
        if lid is None:
            return 0, _error(404, {'error': {
                'message': f'model {name!r} not found',
                'type': 'invalid_request_error',
                'code': 'model_not_found'}})
        return lid, None

    def _deadline_from(self, ex: _Exchange):
        """X-Request-Deadline (a relative budget in seconds) ->
        (absolute time.time() deadline or None, error reply or None)."""
        hdr = ex.headers.get('X-Request-Deadline')
        if hdr is None:
            return None, None
        try:
            budget = float(hdr)
            if budget <= 0:
                raise ValueError
        except ValueError:
            return None, _error(400, f'X-Request-Deadline must be a '
                                     f'positive number of seconds, got '
                                     f'{hdr!r}')
        return time.time() + budget, None

    def _qos_admit(self, ex: _Exchange, payload=None, openai: bool = False,
                   max_new: Optional[int] = None):
        """The QoS header contract and admission gate -> (class, tenant,
        decision or None, error reply or None). Malformed X-Priority /
        X-Tenant (or an unknown service_tier) is a 400; with QoS on, a
        shed or throttle decision is a 429 with Retry-After. An explicit
        X-Priority wins over the body's service_tier; a 'degrade'
        decision goes back to the caller, which clamps max_tokens."""
        try:
            cls = qos_lib.parse_priority(ex.headers.get('X-Priority'))
            tenant = qos_lib.parse_tenant(ex.headers.get('X-Tenant'))
            if openai and payload is not None and \
                    'X-Priority' not in ex.headers:
                tier_cls = qos_lib.map_service_tier(
                    payload.get('service_tier'))
                if tier_cls is not None:
                    cls = tier_cls
        except ValueError as e:
            return None, None, None, _error(400, str(e))
        if self._qos is None:
            return cls, tenant, None, None
        # Only a served adapter's name keys a bucket or a label: the
        # label set stays bounded by the adapters.
        model = self.model_id
        named = (payload or {}).get('model')
        if isinstance(named, str) and named in self.lora_names:
            model = named
        dec = self._qos.admit(cls, tenant, max_new_tokens=max_new,
                              model=model)
        if dec.action in ('shed', 'throttle'):
            verb = ('shed by overload control' if dec.action == 'shed'
                    else 'throttled by the per-tenant rate limit')
            return cls, tenant, dec, _error(
                429, {'error': f'request {verb} (class={cls}, '
                               f'tenant={tenant}, overload level '
                               f'{dec.level}); retry after the '
                               f'Retry-After header',
                      'qos': {'class': cls, 'tenant': tenant,
                              'action': dec.action, 'level': dec.level}},
                **{'Retry-After': qos_lib.retry_after_header(
                    dec.retry_after)})
        return cls, tenant, dec, None

    @staticmethod
    def _parse_logit_bias(payload):
        """OpenAI logit_bias arrives with string token-id keys; a
        malformed entry raises ValueError naming it."""
        raw = payload.get('logit_bias')
        if not isinstance(raw, dict) or not raw:
            return None
        out = {}
        for k, v in raw.items():
            try:
                out[int(k)] = float(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f'logit_bias entries must map integer token ids to '
                    f'numbers, got {k!r}: {v!r}') from None
        return out

    def _sampling_from_openai(self, payload, lora_id: int = 0,
                              deadline: Optional[float] = None
                              ) -> engine_lib.SamplingParams:
        return engine_lib.SamplingParams(
            lora_id=lora_id,
            deadline=deadline,
            logit_bias=self._parse_logit_bias(payload),
            max_new_tokens=int(payload.get('max_tokens', 128)),
            temperature=float(payload.get('temperature', 0.0)),
            top_k=int(payload.get('top_k', 0)),
            top_p=float(payload.get('top_p', 1.0)),
            eos_token=self.tokenizer.eos_id,
            seed=int(payload.get('seed', 0)),
            presence_penalty=float(payload.get('presence_penalty', 0.0)),
            frequency_penalty=float(payload.get('frequency_penalty',
                                                0.0)),
            # completions' logprobs is int|null (0 is on: the chosen
            # token only), chat's a bool; only the chosen token's are
            # computed.
            logprobs=(payload.get('logprobs') is not None and
                      payload.get('logprobs') is not False))

    def _params_error(self, params) -> Optional[str]:
        """The engine's refusal of `params` (validate(), out-of-vocab
        logit_bias ids) as a message: a 400 before anything is
        submitted."""
        try:
            params.validate()
        except ValueError as e:
            return str(e)
        bad = [t for t in (params.logit_bias or {})
               if t >= self.engine.cfg.vocab_size]
        if bad:
            return (f'logit_bias token ids out of vocab '
                    f'(V={self.engine.cfg.vocab_size}): {bad[:5]}')
        return None

    @staticmethod
    def _parse_n(payload) -> Optional[int]:
        """OpenAI 'n': an int in [1, 128]; None when malformed."""
        n = payload.get('n', 1)
        if isinstance(n, bool) or not isinstance(n, int):
            return None
        return n if 1 <= n <= 128 else None

    @staticmethod
    def _stops_from_openai(payload) -> Optional[List[str]]:
        """OpenAI 'stop': a string or a list of strings; None when
        malformed."""
        stop = payload.get('stop')
        if stop is None:
            return []
        if isinstance(stop, str):
            return [stop] if stop else []
        if isinstance(stop, list) and all(isinstance(s, str)
                                          for s in stop):
            return [s for s in stop if s]
        return None

    def _prompt_token_lists(self, prompt):
        """OpenAI prompt forms: str | [str] | [int] | [[int]] -> a list
        of token lists (None when malformed)."""
        if isinstance(prompt, str):
            return [self.tokenizer.encode(prompt)]
        if isinstance(prompt, list) and prompt:
            if all(isinstance(x, int) for x in prompt):
                return [list(prompt)]
            if all(isinstance(x, str) for x in prompt):
                return [self.tokenizer.encode(x) for x in prompt]
            if all(isinstance(x, list) and
                   all(isinstance(t, int) for t in x) for x in prompt):
                return [list(x) for x in prompt]
        return None

    def _apply_chat_template(self, messages) -> str:
        """The chat template (add_generation_prompt=True), or the
        generic role-tag format without one or when it fails to render
        (templates are third-party code)."""
        if self._chat_template is not None:
            try:
                return self._chat_template.render(
                    messages=messages, add_generation_prompt=True,
                    **self._special_tokens)
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('chat template render failed (%s); using '
                               'the generic format', e)
        parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
                 for m in messages]
        parts.append('<|assistant|>\n')
        return '\n'.join(parts)

    def _submit(self, ex: _Exchange, tokens: List[int],
                params: engine_lib.SamplingParams):
        rid, out_q = self.engine.submit(tokens, params)
        ex.rids.append(rid)
        return rid, out_q

    # ------------------------------------------------------------ draining
    def _incremental_decoder(self) -> Callable[[Optional[int]],
                                               Optional[str]]:
        """Decode a token stream piece by piece, holding tokens whose
        decode ends in U+FFFD (an incomplete UTF-8 sequence; pass None
        to flush)."""
        held: List[int] = []

        def decode_incremental(tok: Optional[int]) -> Optional[str]:
            if tok is not None:
                held.append(tok)
            if not held:
                return None
            text = self.tokenizer.decode(list(held))
            if tok is not None and text.endswith('\ufffd') and \
                    len(held) < 4:
                return None
            held.clear()
            return text or None
        return decode_incremental

    @staticmethod
    def _drain(ex: _Exchange, out_q):
        """-> (tokens, logprobs or None): the queue yields ints, or
        (token, logprob) pairs when params.logprobs is set."""
        out: List[int] = []
        lps: List[float] = []
        saw_pairs = False
        while True:
            item = ex.q_get(out_q)
            if item is None:
                return out, (lps if saw_pairs else None)
            if isinstance(item, tuple):
                saw_pairs = True
                out.append(item[0])
                lps.append(item[1])
            else:
                out.append(item)

    @staticmethod
    def _finish(out: List[int], params: engine_lib.SamplingParams):
        """(visible tokens, finish_reason): 'stop' only for an eos (which
        is not shown), else 'length'."""
        if params.eos_token is not None and out and \
                out[-1] == params.eos_token:
            return out[:-1], 'stop'
        return out, 'length'

    def _drain_stopping(self, ex: _Exchange, rid: int, out_q, params,
                        stops: List[str]):
        """Drain one request; with stop sequences, cancel it in the
        engine at the first match. Returns (text, finish_reason,
        generated token count, logprobs object or None)."""
        if not stops:
            out, lps = self._drain(ex, out_q)
            visible, reason = self._finish(out, params)
            lp_obj = None
            if lps is not None:
                # Per-token text through the incremental decoder: the
                # pieces concatenate exactly to the response text.
                dec = self._incremental_decoder()
                pieces = [dec(t) or '' for t in visible]
                tail = dec(None)
                if tail and pieces:
                    pieces[-1] += tail
                lp_obj = {'tokens': pieces,
                          'token_logprobs': lps[:len(visible)]}
            return (self.tokenizer.decode(visible), reason, len(out),
                    lp_obj)

        def drain_terminal():
            while ex.q_get(out_q) is not None:
                pass

        decode_incremental = self._incremental_decoder()
        scan = _StopScanner(stops)
        generated = 0
        while True:
            tok = ex.q_get(out_q)
            if tok is None:
                tail = decode_incremental(None)
                if tail and scan.feed(tail):
                    return scan.text, 'stop', generated, None
                return scan.text, 'length', generated, None
            generated += 1
            if params.eos_token is not None and tok == params.eos_token:
                drain_terminal()
                tail = decode_incremental(None)
                if tail:
                    scan.feed(tail)
                return scan.text, 'stop', generated, None
            piece = decode_incremental(tok)
            if piece is None:
                continue
            if scan.feed(piece):
                self.engine.cancel(rid)
                drain_terminal()
                return scan.text, 'stop', generated, None

    def _drain_all(self, ex: _Exchange, subs, params, stops):
        """_drain_stopping over every (rid, queue), concurrently: a stop
        match in any completion frees its slot at once."""
        if len(subs) == 1:
            rid, q = subs[0]
            return [self._drain_stopping(ex, rid, q, params, stops)]
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(len(subs), 32)) as pool:
            futs = [pool.submit(self._drain_stopping, ex, rid, q, params,
                                stops) for rid, q in subs]
            return [f.result() for f in futs]

    def _sse(self, ex: _Exchange, make_chunk, out_q, params,
             stops: List[str], rid: int) -> None:
        """Stream tokens as OpenAI SSE chunks; a final chunk carries the
        finish_reason, then [DONE]. With stop sequences, emission halts
        at the earliest match (the stop text is never sent) and the
        engine request is cancelled."""
        ex.start_stream('text/event-stream', {'Cache-Control': 'no-cache',
                                              'X-Request-Id': str(rid)})
        state = {'sent': 0, 'stopped': False, 'ended': False}
        decode_incremental = self._incremental_decoder()
        scan = _StopScanner(stops)

        def send(obj) -> None:
            ex.write_chunk(b'data: ' + json.dumps(obj).encode() + b'\n\n')

        def emit(piece: str, final: bool = False) -> bool:
            matched = scan.feed(piece)
            out = scan.text[state['sent']:scan.safe_len(final or matched)]
            if out:
                send(make_chunk(out))
                state['sent'] += len(out)
            if matched:
                state['stopped'] = True
                if not state['ended']:
                    self.engine.cancel(rid)
                    while ex.q_get(out_q) is not None:
                        pass
            return matched

        saw_eos = False
        while True:
            tok = ex.q_get(out_q)
            if tok is None:
                state['ended'] = True
                break
            if params.eos_token is not None and tok == params.eos_token:
                saw_eos = True
                continue
            piece = decode_incremental(tok)
            if piece is not None and emit(piece):
                break
        if not state['stopped']:
            emit(decode_incremental(None) or '', final=True)
        reason = 'stop' if (saw_eos or state['stopped']) else 'length'
        send(make_chunk(None, reason))
        ex.write_chunk(b'data: [DONE]\n\n')
        ex.end_stream()

    # -------------------------------------------------------------- routes
    def _health(self, ex: _Exchange) -> _Reply:
        del ex
        if self.engine.ready.is_set():
            return _Reply(200, {'status': 'ok'})
        return _Reply(503, {'status': 'starting'})

    def _stats(self, ex: _Exchange) -> _Reply:
        rid = ex.query.get('request_id')
        if rid is not None:
            try:
                rid_int = int(rid)
            except ValueError:
                return _error(400, f'request_id must be an integer, got '
                                   f'{rid!r}')
            trace = self.engine.request_trace(rid_int)
            if trace is None:
                return _error(404, {
                    'error': f'no phase trace for request {rid_int} '
                             f'(unknown or evicted)',
                    'hint': 'phase traces are a bounded FIFO keyed by the '
                            'X-Request-Id response header'})
            return _Reply(200, trace)
        data = self.engine.stats()
        data['adapters'] = self._adapters.snapshot()
        if self._qos is not None:
            data['qos'] = self._qos.snapshot(self.engine.qos_depths())
        return _Reply(200, data)

    def _metrics(self, ex: _Exchange) -> _Reply:
        del ex
        return _Reply(200, self.engine.metrics_registry.expose(),
                      content_type=metrics_lib.CONTENT_TYPE)

    def _models(self, ex: _Exchange) -> _Reply:
        del ex
        return _Reply(200, {
            'object': 'list',
            'data': [{'id': self.model_id, 'object': 'model',
                      'owned_by': 'skypilot-tpu'}] +
                    [{'id': name, 'object': 'model',
                      'owned_by': 'skypilot-tpu', 'parent': self.model_id}
                     for name in sorted(self.lora_names)]})

    def _generate(self, ex: _Exchange) -> Optional[_Reply]:
        payload = ex.json_body()
        if 'tokens' in payload:
            try:
                tokens = [int(t) for t in payload['tokens']]
            except (TypeError, ValueError):
                return _error(400, '"tokens" must be a list of integers')
        elif 'text' in payload:
            tokens = self.tokenizer.encode(payload['text'])
        else:
            return _error(400, 'need "tokens" or "text"')
        if not tokens:
            return _error(400, 'empty prompt')
        eos = payload.get('eos_token', self.tokenizer.eos_id)
        # 'max_tokens' (OpenAI's name) or the engine's 'max_new_tokens'.
        max_new = payload.get('max_tokens',
                              payload.get('max_new_tokens', 128))
        lora_id, err = self._resolve_lora(
            {'model': payload['lora']} if payload.get('lora') else {})
        if err is not None:
            return err
        try:
            bias = self._parse_logit_bias(payload)
        except ValueError as e:
            return _error(400, str(e))
        deadline, err = self._deadline_from(ex)
        if err is not None:
            return err
        try:
            max_new = int(max_new)
        except (TypeError, ValueError):
            return _error(400, f'max_tokens must be an integer, got '
                               f'{max_new!r}')
        qcls, qtenant, qdec, err = self._qos_admit(ex, payload,
                                                   max_new=max_new)
        if err is not None:
            return err
        if qdec is not None and qdec.max_new_tokens is not None:
            max_new = min(max_new, qdec.max_new_tokens)
        try:
            params = engine_lib.SamplingParams(
                lora_id=lora_id, logit_bias=bias, deadline=deadline,
                priority=qcls, tenant=qtenant, max_new_tokens=max_new,
                temperature=float(payload.get('temperature', 0.0)),
                top_k=int(payload.get('top_k', 0)),
                top_p=float(payload.get('top_p', 1.0)),
                presence_penalty=float(payload.get('presence_penalty',
                                                   0.0)),
                frequency_penalty=float(payload.get('frequency_penalty',
                                                    0.0)),
                eos_token=eos)
        except (TypeError, ValueError) as e:
            return _error(400, str(e))
        err = self._params_error(params)
        if err is not None:
            return _error(400, err)
        try:
            rid, out_q = self._submit(ex, tokens, params)
        except ValueError as e:
            return _error(400, str(e))
        if payload.get('stream'):
            ex.start_stream('application/x-ndjson',
                            {'X-Request-Id': str(rid)})
            while True:
                item = ex.q_get(out_q)
                if item is None:
                    break
                ex.write_chunk(json.dumps({'token': item}).encode() + b'\n')
            ex.end_stream()
            return None
        out, _ = self._drain(ex, out_q)
        visible, _ = self._finish(out, params)
        return _Reply(200, {'request_id': rid, 'tokens': out,
                            'text': self.tokenizer.decode(visible)},
                      {'X-Request-Id': str(rid)})

    def _openai_params(self, ex: _Exchange, payload):
        """The OpenAI routes' shared checks -> (params, model name, stops,
        None) or (None, None, None, error reply)."""
        lora_id, err = self._resolve_lora(payload)
        if err is not None:
            return None, None, None, err
        deadline, err = self._deadline_from(ex)
        if err is not None:
            return None, None, None, err
        try:
            params = self._sampling_from_openai(payload, lora_id, deadline)
        except (TypeError, ValueError) as e:
            return None, None, None, _error(400, str(e))
        # Echo the requested name (an adapter's for multi-LoRA requests).
        model_name = payload.get('model') or self.model_id
        err = self._params_error(params)
        if err is not None:
            return None, None, None, _error(400, err)
        qcls, qtenant, qdec, err = self._qos_admit(
            ex, payload, openai=True, max_new=params.max_new_tokens)
        if err is not None:
            return None, None, None, err
        params.priority = qcls
        params.tenant = qtenant
        if qdec is not None and qdec.max_new_tokens is not None:
            params.max_new_tokens = min(params.max_new_tokens,
                                        qdec.max_new_tokens)
        stops = self._stops_from_openai(payload)
        if stops is None:
            return None, None, None, _error(
                400, 'stop must be a string or list of strings')
        return params, model_name, stops, None

    def _completions(self, ex: _Exchange) -> Optional[_Reply]:
        payload = ex.json_body()
        prompt = payload.get('prompt')
        if prompt is None:
            return _error(400, 'prompt required')
        token_lists = self._prompt_token_lists(prompt)
        if token_lists is None or any(not t for t in token_lists):
            return _error(400, 'prompt must be a non-empty string, token '
                               'array, or list of either')
        n = self._parse_n(payload)
        if n is None:
            return _error(400, 'n must be an integer in [1, 128]')
        stream = bool(payload.get('stream'))
        if stream and (len(token_lists) != 1 or n != 1):
            return _error(400, 'stream supports a single prompt with n=1')
        # Parameters that are not implemented are refused, never ignored.
        if payload.get('suffix'):
            return _error(400, 'suffix (insertion) is not supported')
        best_of = payload.get('best_of')
        if best_of not in (None, 1, n):
            return _error(400, f'best_of={best_of!r} is not supported '
                               f'(only best_of == n == {n}, i.e. plain '
                               'n-sampling, is implemented)')
        echo = bool(payload.get('echo'))
        if echo and stream:
            return _error(400, 'echo cannot combine with stream')
        params, model_name, stops, err = self._openai_params(ex, payload)
        if err is not None:
            return err
        if params.logprobs and (stops or stream):
            return _error(400, 'logprobs cannot combine with stop or '
                               'stream')
        echo_texts = None
        if echo:
            if params.logprobs:
                return _error(400, 'echo cannot combine with logprobs '
                                   '(prompt logprobs are not computed)')
            # The literal prompt strings; token-array prompts decoded.
            items = prompt if isinstance(prompt, list) and \
                not isinstance(prompt[0], int) else [prompt]
            echo_texts = [item if isinstance(item, str)
                          else self.tokenizer.decode(toks)
                          for item, toks in zip(items, token_lists)]
        try:
            # n completions a prompt, prompt-major (OpenAI's layout).
            subs = [self._submit(ex, t, params)
                    for t in token_lists for _ in range(n)]
        except ValueError as e:
            return _error(400, str(e))
        if stream:
            rid, out_q = subs[0]

            def chunk(piece, reason=None):
                return {'id': f'cmpl-{rid}', 'object': 'text_completion',
                        'model': model_name,
                        'choices': [{'index': 0, 'text': piece or '',
                                     'finish_reason': reason}]}
            self._sse(ex, chunk, out_q, params, stops, rid)
            return None
        results = self._drain_all(ex, subs, params, stops)
        choices = []
        total_out = 0
        for i, (text, reason, n_gen, lp_obj) in enumerate(results):
            total_out += n_gen
            if echo_texts is not None:
                text = echo_texts[i // n] + text
            choice = {'index': i, 'text': text, 'finish_reason': reason}
            if lp_obj is not None:
                choice['logprobs'] = lp_obj
            choices.append(choice)
        n_in = sum(len(t) for t in token_lists)
        return _Reply(200, {
            'id': f'cmpl-{subs[0][0]}', 'object': 'text_completion',
            'model': model_name, 'choices': choices,
            'usage': {'prompt_tokens': n_in,
                      'completion_tokens': total_out,
                      'total_tokens': n_in + total_out}},
            {'X-Request-Id': str(subs[0][0])})

    def _chat_completions(self, ex: _Exchange) -> Optional[_Reply]:
        payload = ex.json_body()
        messages = payload.get('messages')
        if not messages or not isinstance(messages, list) or \
                not all(isinstance(m, dict) for m in messages):
            return _error(400, 'messages must be a non-empty list of '
                               '{role, content} objects')
        n = self._parse_n(payload)
        if n is None:
            return _error(400, 'n must be an integer in [1, 128]')
        stream = bool(payload.get('stream'))
        if stream and n != 1:
            return _error(400, 'stream supports n=1')
        params, model_name, stops, err = self._openai_params(ex, payload)
        if err is not None:
            return err
        if params.logprobs:
            # Chat logprobs have another response schema (content arrays).
            return _error(400, 'logprobs is not supported on chat '
                               'completions')
        tokens = self.tokenizer.encode(self._apply_chat_template(messages))
        try:
            subs = [self._submit(ex, tokens, params) for _ in range(n)]
        except ValueError as e:
            return _error(400, str(e))
        rid = subs[0][0]
        if stream:
            first = {'sent': False}

            def chunk(piece, reason=None):
                delta = {}
                if not first['sent']:
                    delta['role'] = 'assistant'   # the first delta's
                    first['sent'] = True
                if piece is not None:
                    delta['content'] = piece
                return {'id': f'chatcmpl-{rid}',
                        'object': 'chat.completion.chunk',
                        'model': model_name,
                        'choices': [{'index': 0, 'delta': delta,
                                     'finish_reason': reason}]}
            self._sse(ex, chunk, subs[0][1], params, stops, rid)
            return None
        results = self._drain_all(ex, subs, params, stops)
        choices = [{'index': i,
                    'message': {'role': 'assistant', 'content': text},
                    'finish_reason': reason}
                   for i, (text, reason, _, _) in enumerate(results)]
        total_out = sum(r[2] for r in results)
        return _Reply(200, {
            'id': f'chatcmpl-{rid}', 'object': 'chat.completion',
            'model': model_name, 'choices': choices,
            'usage': {'prompt_tokens': len(tokens),
                      'completion_tokens': total_out,
                      'total_tokens': len(tokens) + total_out}},
            {'X-Request-Id': str(rid)})

    # ---------------------------------------------------------- admin
    @staticmethod
    def _require_admin(ex: _Exchange) -> Optional[_Reply]:
        """The admin routes' bearer gate: SKYT_ADMIN_TOKEN must be set
        and presented (403 otherwise: reachability is never enough). A
        refused request's body is left unread, so its connection
        closes."""
        token = env_lib.get('SKYT_ADMIN_TOKEN')
        if not token:
            ex.h.close_connection = True
            return _error(403, 'admin API disabled: start the replica with '
                               'SKYT_ADMIN_TOKEN set')
        got = ex.headers.get('Authorization', '')
        if not hmac.compare_digest(
                got.encode('utf-8', 'surrogateescape'),
                f'Bearer {token}'.encode('utf-8')):
            ex.h.close_connection = True
            return _error(403, 'unauthorized: missing or bad Authorization '
                               'bearer token')
        return None

    @staticmethod
    def _drain_flag(payload) -> Optional[bool]:
        drain = payload.get('drain')
        if drain is not None and not isinstance(drain, bool):
            raise _BadRequest(f'drain must be a boolean, got {drain!r}')
        return drain

    def _admin_weights(self, ex: _Exchange) -> _Reply:
        """POST /admin/weights: {"checkpoint": dir, "version": N?,
        "drain": bool?} or {"swap_back": true}. 400 on a malformed body or
        a failed swap (weight_version beside the error), 409 while a swap
        or adapter update is in flight; the old weights stay live in every
        error case."""
        denied = self._require_admin(ex)
        if denied is not None:
            return denied
        payload = ex.json_body()
        drain = self._drain_flag(payload)
        version = payload.get('version')
        if version is not None and (isinstance(version, bool) or
                                    not isinstance(version, int) or
                                    version < 1):
            return _error(400, f'version must be an integer >= 1, got '
                               f'{version!r}')
        if payload.get('swap_back'):
            op = functools.partial(self._swap_mgr.swap_back, drain=drain)
        else:
            ckpt = payload.get('checkpoint')
            if not isinstance(ckpt, str) or not ckpt:
                return _error(400, 'checkpoint must be a non-empty path (or '
                                   'pass swap_back: true)')
            op = functools.partial(self._swap_mgr.swap, checkpoint=ckpt,
                                   version=version, drain=drain)
        try:
            return _Reply(200, op())
        except weight_swap_lib.SwapInFlight as e:
            return _error(409, str(e))
        except weight_swap_lib.WeightSwapError as e:
            return _error(400, {'error': str(e),
                                'weight_version': self.engine.weight_version})

    def _admin_adapters(self, ex: _Exchange) -> _Reply:
        """POST /admin/adapters: {"op": "load", "name", "checkpoint":
        dir, "alpha": f?, "drain": bool?} | {"op": "unload", "name",
        "drain": bool?} | {"op": "list"}. 400 on a malformed body or a
        failed load, 409 while any swap or update is in flight or while
        an unloaded adapter's id is still referenced; the old stack stays
        live in every error case."""
        denied = self._require_admin(ex)
        if denied is not None:
            return denied
        payload = ex.json_body()
        op_name = payload.get('op', 'load')
        if op_name == 'list':
            snap = self._adapters.snapshot()
            snap['last'] = self._adapters.last
            return _Reply(200, snap)
        if op_name not in ('load', 'unload'):
            return _error(400, f"op must be 'load', 'unload', or 'list', "
                               f'got {op_name!r}')
        name = payload.get('name')
        if not isinstance(name, str) or not name:
            return _error(400, f'name must be a non-empty string, got '
                               f'{name!r}')
        drain = self._drain_flag(payload)
        if op_name == 'load':
            ckpt = payload.get('checkpoint')
            if not isinstance(ckpt, str) or not ckpt:
                return _error(400, f'checkpoint must be a non-empty string '
                                   f'(an adapter dir an `sft --lora-rank` '
                                   f'run wrote), got {ckpt!r}')
            alpha = payload.get('alpha', 16.0)
            if isinstance(alpha, bool) or not isinstance(alpha,
                                                         (int, float)):
                return _error(400, f'alpha must be a number, got {alpha!r}')
            op = functools.partial(self._adapters.load, name,
                                   checkpoint=ckpt, alpha=float(alpha),
                                   drain=drain)
        else:
            op = functools.partial(self._adapters.unload, name, drain=drain)
        try:
            return _Reply(200, op())
        except (weight_swap_lib.AdapterInUse,
                weight_swap_lib.SwapInFlight) as e:
            return _error(409, str(e))
        except weight_swap_lib.WeightSwapError as e:
            return _error(400, str(e))

    def _admin_reshard(self, ex: _Exchange) -> _Reply:
        denied = self._require_admin(ex)
        return denied or _error(501, weight_swap_lib.RESHARD_UNPORTED)

    def _admin_kv_prewarm(self, ex: _Exchange) -> _Reply:
        denied = self._require_admin(ex)
        return denied or _error(
            501, 'kv_prewarm is not ported yet: it pulls from the fleet KV '
                 'tier (ROADMAP queue 1 item 6.1)')


def _make_handler(server: InferenceServer):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'
        server_version = 'skypilot-tpu-torch'

        def do_GET(self):  # noqa: N802
            server.dispatch(self, 'GET')

        def do_POST(self):  # noqa: N802
            server.dispatch(self, 'POST')

        def log_message(self, fmt, *args):  # quiet: metrics count them
            del fmt, args
    return Handler


# The reference's flags the port does not take yet: the ROADMAP queue 1
# item each waits for, and the values that ask for nothing unported.
_UNPORTED_FLAGS = {
    'tp': ('item 13 (parallelism, multi-host and comms)', (None, 1)),
    'multihost': ('item 13 (parallelism, multi-host and comms)',
                  (None, 'auto', 'off'))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Serve a model of the PyTorch port over HTTP: an HF '
                    'checkpoint, or a preset with random weights from '
                    'seed 0 and the byte tokenizer.')
    parser.add_argument('--model', default='llama3-8b',
                        help='config preset (without --checkpoint): '
                             'llama.CONFIGS or moe.MIXTRAL_CONFIGS')
    parser.add_argument('--checkpoint', default=None,
                        help='HF checkpoint dir (config.json + '
                             '*.safetensors); SKYT_WEIGHTS_CHECKPOINT '
                             'overrides it')
    parser.add_argument('--tokenizer', default=None,
                        help='tokenizer.json or its dir (default: the '
                             'checkpoint dir)')
    parser.add_argument('--quantize', default='none',
                        choices=('none',) + quant_lib.MODES,
                        help='weight-only quantization of the '
                             'projections (and MoE experts: int8 only), '
                             'applied as they load')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--num-slots', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=2048)
    parser.add_argument('--dtype', default='bfloat16',
                        help='weight and compute dtype (bfloat16|float32)')
    parser.add_argument('--device', default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--no-prefix-caching', action='store_true',
                        help='disable KV prefix caching')
    parser.add_argument('--spec-decode', type=int, default=0,
                        help='speculative decoding draft length k (0 = '
                             'off): n-gram lookup, or a draft model (see '
                             '--draft-checkpoint, --draft-model)')
    parser.add_argument('--draft-checkpoint', default=None,
                        help='HF checkpoint dir of a small draft model of '
                             'the same vocab (with --spec-decode)')
    parser.add_argument('--draft-model', default=None,
                        help="draft preset with random weights, or 'self' "
                             'to draft with the served model (mechanism '
                             'checks; with --spec-decode)')
    parser.add_argument('--kv-dtype', default='auto',
                        choices=['auto', 'int8'],
                        help='KV-cache dtype; auto defers to SKYT_KV_DTYPE, '
                             'then the model dtype')
    parser.add_argument('--prefill-chunk', type=int, default=0,
                        help='chunked prefill: long prompts prefill in '
                             'chunks of this many tokens (0 = off)')
    parser.add_argument('--chat-template', default=None,
                        help='path to a jinja chat template file (a '
                             'missing file fails start-up)')
    parser.add_argument('--lora', action='append', default=None,
                        help='name=dir[:alpha] (repeatable): serve the '
                             'adapters of an sft --lora-rank run\'s '
                             'checkpoint dir under this model name')
    for flag in _UNPORTED_FLAGS:
        parser.add_argument('--' + flag.replace('_', '-'),
                            type=int if flag == 'tp' else str,
                            help='not ported yet')
    args = parser.parse_args(argv)
    for flag, (item, harmless) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) not in harmless:
            parser.exit(2, f'--{flag.replace("_", "-")} is not ported '
                           f'yet: ROADMAP queue 1 {item}\n')
    # Rolling updates: the serve controller exports the service spec's
    # current `weights:` checkpoint, so a replica launched mid- or
    # post-rollout boots on the weights the fleet is serving.
    env_ckpt = env_lib.get('SKYT_WEIGHTS_CHECKPOINT')
    if env_ckpt:
        logger.info('SKYT_WEIGHTS_CHECKPOINT overrides the startup '
                    'checkpoint: %s', env_ckpt)
        args.checkpoint = env_ckpt
    chat_template = None
    if args.chat_template:
        try:
            with open(args.chat_template, encoding='utf-8') as f:
                chat_template = f.read()
        except OSError as e:
            parser.exit(2, f'--chat-template {args.chat_template}: {e}\n')
    tok_path = args.tokenizer or args.checkpoint
    tokenizer, special_tokens = None, {}
    if tok_path:
        try:
            tokenizer = tokenizer_lib.load_tokenizer(tok_path)
        except FileNotFoundError:
            logger.warning('no tokenizer.json at %s; using byte fallback',
                           tok_path)
        if chat_template is None:
            chat_template = tokenizer_lib.load_chat_template(tok_path)
        special_tokens = tokenizer_lib.special_token_strings(tok_path)
    lora_stack, lora_names, lora_specs = None, {}, None
    if args.lora:
        try:
            lora_specs = lora_lib.parse_lora_flag(args.lora)
            lora_stack, lora_names = lora_lib.build_stack_from_specs(
                lora_specs, dtype=args.dtype)
        except (OSError, ValueError) as e:
            parser.exit(2, f'--lora: {e}\n')
    engine = build_engine(args.model, args.num_slots, args.max_seq_len,
                          dtype=args.dtype, device=args.device,
                          lora_stack=lora_stack,
                          prefix_caching=not args.no_prefix_caching,
                          spec_decode=args.spec_decode,
                          draft_model_name=args.draft_model,
                          draft_checkpoint=args.draft_checkpoint,
                          kv_dtype=args.kv_dtype,
                          prefill_chunk=args.prefill_chunk,
                          checkpoint=args.checkpoint,
                          quantize=args.quantize)
    engine.start()
    # One short request first: the process's first device calls pay
    # one-time set-up that is not serving time.
    engine.generate([1] * 8, engine_lib.SamplingParams(max_new_tokens=2))
    engine.reset_perf()
    model_id = (os.path.basename(args.checkpoint.rstrip('/'))
                if args.checkpoint else args.model)
    server = InferenceServer(engine, tokenizer, model_id=model_id,
                             lora_names=lora_names, lora_specs=lora_specs,
                             chat_template=chat_template,
                             special_tokens=special_tokens)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    port = server.start('0.0.0.0', args.port)
    logger.info('inference server: model=%s ckpt=%s quantize=%s device=%s '
                'port=%d slots=%d', model_id, args.checkpoint, args.quantize,
                engine.device, port, args.num_slots)
    stop.wait()
    server.stop()
    engine.stop()
    logger.info('inference server stopped')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
