"""Continuous-batching inference engine, paged KV cache (counterpart of
skypilot_tpu/infer/engine.py in paged mode).

  * Admission: a burst of waiting requests is packed into ONE [1, T]
    prefill row separated by segment ids (ragged prefill); a lone request
    takes the bucket-padded prefill. Either way the prompt KV is then
    scattered into the request's reserved pages.
  * Prefix caching (prefix_caching=True, the default): each prompt's full
    pages are published under chained content hashes (salted by the
    adapter id) once written. A prompt that agrees with a published run
    leaves the ragged path, shares those pages read-only (at most
    (n - 1) // P of them, so one token still runs) and prefills only its
    suffix, at positions start.., over the slot's gathered view through
    the dense continuation path (mha_reference with query positions, as
    the JAX engine); only the suffix pages are written.
  * Chunked prefill (prefill_chunk > 0, rounded to pages): a prompt whose
    uncached part exceeds the chunk is prefilled one chunk per loop
    iteration through the same suffix path, with a decode chunk of the
    running requests in between; its slot stays out of the decode batch
    (table row on the dummy page) until the final chunk installs it. One
    chunked prefill at a time; a second long prompt waits.
  * Host KV tier (SKYT_KV_TIER=host, infer/kv_tier.py): published pages
    that eviction reclaims are cloned on the stream and copied to a
    host-RAM LRU by a writer thread; a later prompt whose run continues
    there gets the pages installed back (a byte copy) and shares them.
  * Decode: every slot steps together, `decode_chunk` steps per dispatch
    (a Python loop of model calls — the JAX engine scans them), and the
    host pulls the chunk's [chunk, slots] tokens once. Decode is
    pipelined: chunk k+1 is enqueued before chunk k's tokens are pulled.
  * Sampling: greedy, or temperature with top-k / top-p. A request's
    first token is sampled on the host from its logits row (numpy rng
    seeded with seed + req_id, as the JAX engine); later tokens on the
    device with the request's own torch.Generator (Gumbel-max over the
    filtered logits).
  * Cut-offs: EOS (delivered, then the stream ends), max_new_tokens and
    max_seq_len.
  * int8 KV (kv_dtype='int8', or SKYT_KV_DTYPE=int8 under 'auto'): the
    pools hold int8 codes with per-token, per-head f32 scales, quantized
    at the prompt scatter and at every append; ~2x the pages per byte.
  * n-gram speculative decoding (spec_decode=k): each slot proposes k
    draft tokens by matching its trailing bigram against its own token
    history (kept on the device), one s = k+1 forward verifies them, and
    the longest prefix the model agrees with is accepted (greedy slots:
    token-identical to plain greedy); sampled slots take the rejection
    rule of speculative_sample_step. Near max_seq_len, where a verify
    run no longer fits, chunks take the plain path, which keeps the
    history current.
  * Multi-LoRA (lora_stack=, infer/lora.py): every request names its
    adapter by SamplingParams.lora_id (0: the base model). A ragged pack
    carries per-token ids (each segment its request's id, padding 0: the
    grouped kernel); a single admission the id [lora_id], and decode and
    verify steps the per-slot ids (the gather kernel). The slot's id is
    set at admission and reset to 0 at release. request_adapter_update
    installs a new stack at a tick boundary (ids stable: in-flight
    requests stay on their adapter) and flushes the prefix cache;
    adapter_in_use backs the unload refusal. int8 KV and spec_decode
    compose with it.
  * cancel(req_id): a waiting request ends at admission, a running or
    chunk-prefilling one is released at the next loop boundary.
  * Request options (SamplingParams): presence and frequency penalties
    over output-token counts ([slots, V] int32 on the device, vLLM's
    convention, on the raw logits before temperature / top-k / top-p),
    logit_bias (a [slots, 64] (idx, val) scatter-add after them; the
    first token takes it on a host copy of its row), logprobs (the out
    queue yields (token, raw logprob) pairs: the log-softmax of the
    unpenalized, unbiased logits), deadlines (an expired request ends
    like a cancel, its trace status 'deadline'), and with SKYT_QOS=1
    priority classes and tenants (serve/qos.py's ClassedRequestQueue
    as the waiting queue, reordered once a tick; SKYT_QOS_RESERVE_SLOTS
    slots kept for 'interactive' admissions). A decode chunk runs the
    penalty, bias and logprob ops only when an active slot asks for
    them, so a chunk without them issues the launches it always did;
    a chunk with a penalized or biased slot takes the plain path under
    spec_decode.
  * Observability: stats() (the reference's /stats keys), request
    traces (queued, prefill_start, first_token, done; a bounded FIFO),
    and the reference's engine metric families in metrics_registry.

Not ported (raise): the draft model proposer, the fleet KV tier
(SKYT_KV_TIER=fleet: it needs the /kv/prefix and /kv/index routes),
meshes and multi-host lockstep. Not ported (absent): the dense
(non-paged) cache mode, the padded batched admission, the capacity
ledger and the tick plane (and their metric families, with the weight
version's, the virtual nodes' and the host-finish counter), tracing
spans, warmup(), and the weight swap and reshard (only the adapter
stack hot-loads).
"""
import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.infer import kv_tier as kv_tier_lib
from skypilot_tpu_torch.infer import lora as lora_lib
from skypilot_tpu_torch.infer import paged_cache
from skypilot_tpu_torch.utils import device as device_lib
from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils
from skypilot_tpu_torch.utils import metrics as metrics_lib

logger = log_utils.init_logger(__name__)

# Device-side top-k sampling supports k up to this (one shared top-k
# sort serves every slot's k and its top-p nucleus).
_TOPK_BUCKET = 64
# QoS priority classes (serve/qos.py's PRIORITIES; repeated here so
# validate() needs no import of the QoS module).
_QOS_PRIORITIES = ('interactive', 'standard', 'batch')
# Max logit_bias entries a request: each slot's (idx, val) pairs are a
# fixed [slots, _BIAS_BUCKET] scatter-add.
_BIAS_BUCKET = 64
# Finished request traces kept for request_trace (a bounded FIFO).
_TRACE_KEEP = 2048


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 128
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => off; at most 64
    top_p: float = 1.0                # >= 1 (or <= 0) => off
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    eos_token: Optional[int] = None
    seed: int = 0
    logprobs: bool = False
    logit_bias: Optional[Dict[int, float]] = None
    lora_id: int = 0
    deadline: Optional[float] = None
    priority: str = 'standard'
    tenant: str = ''

    def validate(self) -> None:
        """Reject parameters the engine cannot honor exactly (the JAX
        engine's rules)."""
        if not isinstance(self.top_k, int) or isinstance(self.top_k, bool):
            raise ValueError(f'top_k must be an int, got {self.top_k!r}')
        if self.top_k < 0:
            raise ValueError(f'top_k must be >= 0, got {self.top_k}')
        if self.top_k > _TOPK_BUCKET:
            raise ValueError(
                f'top_k={self.top_k} exceeds the device sampling bucket '
                f'({_TOPK_BUCKET})')
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f'top_p must be in [0, 1], got {self.top_p}')
        if self.temperature < 0.0:
            raise ValueError(f'temperature must be >= 0, got '
                             f'{self.temperature}')
        if self.max_new_tokens < 1:
            raise ValueError(f'max_new_tokens must be >= 1, got '
                             f'{self.max_new_tokens}')
        if not isinstance(self.lora_id, int) or self.lora_id < 0:
            raise ValueError(f'lora_id must be an int >= 0, got '
                             f'{self.lora_id!r}')
        if self.priority not in _QOS_PRIORITIES:
            raise ValueError(
                f'priority must be one of {_QOS_PRIORITIES}, got '
                f'{self.priority!r}')
        if not isinstance(self.tenant, str):
            raise ValueError(f'tenant must be a string, got '
                             f'{self.tenant!r}')
        if self.logit_bias:
            if len(self.logit_bias) > _BIAS_BUCKET:
                raise ValueError(
                    f'logit_bias supports at most {_BIAS_BUCKET} '
                    f'entries, got {len(self.logit_bias)}')
            for t, b in self.logit_bias.items():
                if not isinstance(t, int) or isinstance(t, bool) or t < 0:
                    raise ValueError(
                        f'logit_bias keys must be token ids >= 0, got '
                        f'{t!r}')
                if not -100.0 <= float(b) <= 100.0:
                    raise ValueError(
                        f'logit_bias values must be in [-100, 100], got '
                        f'{b!r} for token {t}')

    @property
    def penalized(self) -> bool:
        return self.presence_penalty != 0.0 or \
            self.frequency_penalty != 0.0


@dataclasses.dataclass
class _Request:
    req_id: int
    tokens: List[int]
    params: SamplingParams
    out_queue: 'queue.Queue[Any]'
    submitted_at: float = dataclasses.field(default_factory=time.time)
    prefill_start_at: Optional[float] = None   # first admission try
    first_token_at: Optional[float] = None
    slot: Optional[int] = None
    generated: int = 0
    rng: Any = None                   # numpy Generator: first token
    # Device sampling (temperature > 0): made on the engine loop at
    # insert, seeded with seed + req_id.
    gen: Optional[torch.Generator] = None
    page_hashes: Optional[List[bytes]] = None   # prefix-cache keys
    cancelled: bool = False
    expired: bool = False             # cancelled by its deadline


def _round_up_pow2(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _fresh_perf() -> Dict[str, float]:
    return {'decode_tokens': 0, 'steady_tokens': 0, 'steady_time_s': 0.0,
            'prefill_dispatches': 0, 'ragged_dispatches': 0,
            'prefill_chunks': 0, 'spec_verify_steps': 0,
            'spec_accepted': 0}


def _put_many(q, items) -> None:
    """Deliver a run of tokens to a request's queue in one lock hold."""
    if not items:
        return
    with q.mutex:
        q.queue.extend(items)
        q.unfinished_tasks += len(items)
        q.not_empty.notify(len(items))


def _np_raw_lp(logits_row: np.ndarray, tok: int) -> float:
    """Raw model logprob of one token from a host logits row."""
    row = logits_row.astype(np.float64)
    m = row.max()
    return float(row[tok] - m - np.log(np.exp(row - m).sum()))


def _bias_arrays(params: SamplingParams):
    """(idx [_BIAS_BUCKET] int64, val [_BIAS_BUCKET] f32) for a
    request's logit_bias; the zero padding adds 0.0 to token 0."""
    idx = np.zeros(_BIAS_BUCKET, np.int64)
    val = np.zeros(_BIAS_BUCKET, np.float32)
    for j, (t, b) in enumerate((params.logit_bias or {}).items()):
        idx[j] = int(t)
        val[j] = float(b)
    return idx, val


def raw_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """The chosen tokens' raw logprobs: log-softmax of `logits` [..., V]
    at `toks` [...]."""
    picked = torch.gather(logits, -1, toks.long()[..., None])[..., 0]
    return picked - torch.logsumexp(logits, dim=-1)


def sampling_filter(scaled: torch.Tensor, topks: torch.Tensor,
                    topps: torch.Tensor) -> torch.Tensor:
    """Per-slot top-k AND top-p filter over [..., V] temperature-scaled
    logits (counterpart of engine._sampling_filter): entries outside the
    filter become -inf. topks: k == 0 disables. topps: p >= 1 or <= 0
    disables; the nucleus is the smallest prefix of descending-probability
    tokens whose mass reaches p (the first token always survives), taken
    over the top-k-renormalized distribution within one shared top-64
    sort. topks/topps broadcast over leading axes after the slot axis."""
    kvals = torch.topk(scaled, min(_TOPK_BUCKET, scaled.shape[-1]),
                       dim=-1).values
    extra = (1,) * (scaled.dim() - topks.dim())
    tk = topks.reshape(topks.shape + extra)
    k_idx = (topks.long() - 1).clamp(0, kvals.shape[-1] - 1)
    kth = torch.gather(kvals, -1,
                       k_idx.reshape(k_idx.shape + extra).expand(
                           *kvals.shape[:-1], 1))
    kmask = tk > 0
    neg = torch.full((), float('-inf'), dtype=scaled.dtype,
                     device=scaled.device)
    out = torch.where(kmask & (scaled < kth), neg, scaled)
    pos = torch.arange(kvals.shape[-1], device=scaled.device)
    pos = pos.reshape((1,) * (kvals.dim() - 1) + pos.shape)
    kvals_f = torch.where(kmask & (pos >= tk), neg, kvals)
    p = torch.softmax(kvals_f, dim=-1)
    before = torch.cumsum(p, dim=-1) - p
    pp = topps.reshape(topps.shape + extra)
    inside = (before < pp.clamp(0.0, 1.0)) & torch.isfinite(kvals_f)
    inf = torch.full((), float('inf'), dtype=scaled.dtype,
                     device=scaled.device)
    thresh = torch.where(inside, kvals, inf).amin(dim=-1, keepdim=True)
    pmask = (pp > 0.0) & (pp < 1.0)
    return torch.where(pmask & (out < thresh), neg, out)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1): the argmax of log-weights
    plus this noise is a categorical draw."""
    return -torch.log(-torch.log(u))


def speculative_sample_step(logits: torch.Tensor, draft: torch.Tensor,
                            temps: torch.Tensor, topks: torch.Tensor,
                            topps: torch.Tensor, u_accept: torch.Tensor,
                            u_resid: torch.Tensor):
    """One slot-batched speculative-sampling verify step (counterpart of
    engine.speculative_sample_step; the random numbers come in as
    uniforms, drawn by the caller from each request's generator).

    logits [S, k+1, V] f32 — target logits at the k draft positions plus
    the bonus position; draft [S, k] int — point-mass draft tokens;
    temps/topks/topps [S]; u_accept [S, k] and u_resid [S, V] uniforms in
    [0, 1).

    Greedy slots (temp == 0): accept while draft == argmax, emit the
    argmax rows. Sampled slots: accept d_i with probability p_i(d_i)
    (p = softmax of the top-k/top-p filtered logits / temp); at the first
    rejection draw from the residual (p_i with d_i zeroed,
    renormalized), after k accepts draw the bonus token from p_k. The
    emitted stream is distributed exactly as sequential sampling from p.

    Returns (out [S, k+1] emitted tokens — the first acc+1 valid —, acc
    [S] accepted-draft counts)."""
    slots, k1, vocab = logits.shape
    k = k1 - 1
    draft = draft.long()
    greedy = logits.argmax(dim=-1)                          # [S, k+1]
    g_match = draft == greedy[:, :k]
    scaled = logits / temps.clamp_min(1e-6)[:, None, None]
    probs = torch.softmax(sampling_filter(scaled, topks, topps), dim=-1)
    p_draft = torch.gather(probs[:, :k], 2, draft[:, :, None])[:, :, 0]
    sampled = temps[:, None] > 0
    accept = torch.where(sampled, u_accept < p_draft, g_match)
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)     # 0..k
    # Distribution at the emission position acc: the residual with the
    # rejected draft zeroed when acc < k, the bonus p_k otherwise.
    p_at = torch.gather(probs, 1,
                        acc[:, None, None].expand(-1, 1, vocab))[:, 0]
    d_pad = torch.cat([draft, draft.new_zeros((slots, 1))], dim=1)
    d_at = torch.gather(d_pad, 1, acc[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(d_at, vocab).to(probs.dtype)
    resid = torch.where((acc < k)[:, None], p_at * (1.0 - onehot), p_at)
    # Float dust: a rejected draft that held all the mass.
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_at)
    repl = (torch.log(resid) + gumbel(u_resid)).argmax(dim=-1)
    idx = torch.arange(k + 1, device=logits.device)[None, :]
    s_out = torch.where(idx < acc[:, None], d_pad,
                        torch.where(idx == acc[:, None], repl[:, None],
                                    torch.zeros_like(d_pad)))
    out = torch.where(sampled, s_out, greedy)
    return out.to(torch.int32), acc.to(torch.int32)


def propose_ngram(hist: torch.Tensor, lens: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Prompt-lookup drafts [S, k]: the k tokens after the most recent
    earlier occurrence of each slot's trailing bigram (hist[L-1],
    hist[L]) in its own history [S, W]; with no match, the tokens after
    L (a junk draft that verification rejects)."""
    _, w = hist.shape
    length = lens.long()
    b0 = torch.gather(hist, 1, (length - 1).clamp(0, w - 1)[:, None])
    b1 = torch.gather(hist, 1, length.clamp(0, w - 1)[:, None])
    idx = torch.arange(w - 1, device=hist.device)[None, :]
    ok = (hist[:, :-1] == b0) & (hist[:, 1:] == b1) & \
        (idx + 1 < length[:, None])
    i = torch.where(ok.any(dim=1),
                    torch.where(ok, idx, torch.full_like(idx, -1)).amax(1),
                    length - 1)
    start = (i + 2).clamp(0, w - k)
    return torch.gather(hist, 1, start[:, None] +
                        torch.arange(k, device=hist.device)[None, :])


def kv_bytes_per_token(cfg, kv_dtype: str = 'auto') -> int:
    """KV pool bytes one token costs across all layers (k + v), as
    skypilot_tpu/infer/memory_plan.py counts them: head_dim values at
    the model dtype's width, or for int8 head_dim bytes plus one f32
    scale a head."""
    if kv_dtype == 'int8':
        per_head = cfg.head_dim + 4
    else:
        per_head = cfg.head_dim * (2 if cfg.dtype == 'bfloat16' else 4)
    return cfg.n_layers * 2 * cfg.n_kv_heads * per_head


class InferenceEngine:
    """Slot-based continuous batching over the paged KV cache."""

    def __init__(self, model, *, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 decode_chunk: int = 16,
                 page_size: int = 64,
                 pool_tokens: Optional[int] = None,
                 prefix_caching: bool = True,
                 spec_decode: int = 0,
                 prefill_chunk: int = 0,
                 kv_dtype: str = 'auto',
                 mesh=None, lockstep=None,
                 draft_model=None, device=None,
                 lora_stack=None,
                 metrics_registry: Optional[
                     metrics_lib.MetricsRegistry] = None) -> None:
        """model: a models.llama.LlamaModel holding its weights on
        `device` (None -> 'cuda'; raises without CUDA unless 'cpu').
        pool_tokens: the page pool's size in tokens (default num_slots *
        max_seq_len). prefix_caching: share published prompt pages (see
        the module docstring); SKYT_KV_TIER=host adds the host tier to
        it. prefill_chunk: chunked prefill's chunk in tokens, rounded
        down to pages (at least one; 0: off). spec_decode: draft length
        k of n-gram speculative decoding (0: off). kv_dtype: 'int8'
        quantizes the paged pools; 'auto' defers to SKYT_KV_DTYPE, then
        to the model dtype; anything else explicit raises ValueError.
        lora_stack: a multi-LoRA stack (infer/lora.py), validated against
        the model and placed on the engine's device in the model dtype
        once. metrics_registry: where the engine's metric families live
        (default: metrics.REGISTRY). mesh, lockstep and a draft model
        exist in the JAX engine and are not ported yet: anything but
        their defaults raises, as does SKYT_KV_TIER=fleet."""
        unported = {'mesh': mesh is not None,
                    'lockstep': lockstep is not None,
                    'draft_model': draft_model is not None}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f'engine options not ported yet: {", ".join(bad)}')
        explicit_kv = kv_dtype not in (None, '', 'auto')
        kv_req = kv_dtype if explicit_kv else env.get('SKYT_KV_DTYPE', 'auto')
        if kv_req in (None, ''):
            kv_req = 'auto'
        if kv_req not in paged_cache.KV_DTYPES:
            if explicit_kv:
                raise ValueError(
                    f"kv_dtype must be 'auto' or 'int8', got {kv_req!r}")
            # A bad environment value degrades instead of failing the
            # replica, as the JAX engine does.
            logger.warning("SKYT_KV_DTYPE=%r is not 'auto' or 'int8'; "
                           'serving at the model dtype', kv_req)
            kv_req = 'auto'
        self.kv_dtype = kv_req
        self.spec_decode = max(0, int(spec_decode))
        self.prefix_caching = bool(prefix_caching)
        self.prefill_chunk = max(0, int(prefill_chunk))
        if self.prefill_chunk:
            # Page-aligned, so chunk boundaries land on page boundaries.
            self.prefill_chunk = max(
                page_size, self.prefill_chunk // page_size * page_size)
        tier = kv_tier_lib.tier_from_env()
        if tier == 'fleet':
            raise NotImplementedError(kv_tier_lib.FLEET_UNPORTED)
        if tier != 'off' and not self.prefix_caching:
            logger.warning('SKYT_KV_TIER=%s needs prefix caching; tiering '
                           'stays off', tier)
            tier = 'off'
        self.device = device_lib.resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev != self.device:
            raise ValueError(f'model weights are on {model_dev}, the '
                             f'engine runs on {self.device}')
        self.model = model.eval()
        self.cfg = model.cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or self.cfg.max_seq_len
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_buckets = [b for b in (32, 128, 512, 2048, 8192)
                                if b <= self.max_seq_len] or \
            [self.max_seq_len]
        self.dtype = model.dtype
        pcfg = paged_cache.PagedConfig.for_engine(
            self.max_seq_len, num_slots, page_size, pool_tokens)
        self.pool = paged_cache.PagePool(
            pcfg, self.cfg.n_layers, self.cfg.n_kv_heads,
            self.cfg.head_dim, num_slots, self.dtype, self.device,
            kv_dtype=self.kv_dtype)
        # k, v (and k_scale, v_scale for int8 pools), plus the block table.
        self.cache = dict(self.pool.pools)
        self.cache['tables'] = torch.zeros(
            (num_slots, pcfg.max_pages_per_slot), dtype=torch.int32,
            device=self.device)
        self.pool.pools = None   # tensors live in self.cache now
        # Device token history per slot (prompt + generated), the n-gram
        # proposer's haystack; invariant: hist[slot, lens[slot]] is the
        # last token fed. The k+2 tail keeps a verify run's k+1-token
        # write in bounds.
        self._dev_hist = torch.zeros(
            (num_slots, self.max_seq_len + self.spec_decode + 2),
            dtype=torch.int32, device=self.device) \
            if self.spec_decode > 0 else None
        self._deferred: Optional[_Request] = None
        # The one chunked prefill in progress: {req, slot, row, hashes,
        # start, n}. Its slot holds the reservation but stays out of the
        # decode batch until the final chunk.
        self._chunked: Optional[Dict[str, Any]] = None
        # Host slot table. _lengths is an upper-bound estimate for chunk
        # sizing; _conf_lengths the confirmed length, advanced at pulls.
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._lengths = np.zeros((num_slots,), np.int32)
        self._conf_lengths = np.zeros((num_slots,), np.int32)
        self._temps = np.zeros((num_slots,), np.float32)
        self._slot_gens: List[Optional[torch.Generator]] = \
            [None] * num_slots
        # Waiting queue: a FIFO, or with SKYT_QOS=1 the classed queue
        # (a queue.Queue whose deque is kept in scheduled order, so the
        # head snapshots, pops and requeues below work unchanged).
        # Decided here: the queue's type never changes under a live
        # engine. Adapter ids name their flows through model_labels
        # (the server writes it).
        self.model_labels: Dict[int, str] = {0: 'base'}
        self._qos_queue = None
        self._qos_reserved = 0
        if env.get_bool('SKYT_QOS'):
            from skypilot_tpu_torch.serve import qos as qos_lib
            self._qos_queue = qos_lib.ClassedRequestQueue(
                meta=lambda r: qos_lib.RequestMeta(
                    cls=r.params.priority,
                    tenant=r.params.tenant or 'default',
                    cost=float(len(r.tokens) + r.params.max_new_tokens),
                    seq=r.req_id, enq_t=r.submitted_at,
                    model=str(self.model_labels.get(
                        r.params.lora_id, r.params.lora_id))))
            self._qos_reserved = max(0, min(
                num_slots - 1, env.get_int('SKYT_QOS_RESERVE_SLOTS', 0)))
        self._waiting: 'queue.Queue[_Request]' = \
            self._qos_queue if self._qos_queue is not None \
            else queue.Queue()
        # Requests popped but not yet in _slots (failed on a loop crash).
        self._admitting: List[_Request] = []
        # Packed-token cap per ragged prefill (bounds its shape the way
        # the prefill buckets bound the padded one).
        self._ragged_max = max(self.prefill_buckets)
        # Device decode args (last token, length, temperature, top-k,
        # top-p per slot): written in place at insert, advanced by the
        # decode chunks, never re-uploaded from the host while slots are
        # live (an in-flight chunk may already have advanced them).
        n, dev = num_slots, self.device
        self._d_last = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._d_lens = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._d_temps = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._d_topks = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._d_topps = torch.ones((n,), dtype=torch.float32, device=dev)
        # Request options: presence / frequency penalties and each
        # slot's output-token counts [slots, V]; the logit_bias pairs.
        # Written at insert only for a request that sets them, or to
        # clear what a slot's earlier request left (_slot_pen /
        # _slot_bias: the slot's device values are nonzero), so an
        # engine serving neither issues no extra work.
        self._d_press = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._d_freqs = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._d_counts = torch.zeros((n, self.cfg.vocab_size),
                                     dtype=torch.int32, device=dev)
        self._d_bidx = torch.zeros((n, _BIAS_BUCKET), dtype=torch.long,
                                   device=dev)
        self._d_bval = torch.zeros((n, _BIAS_BUCKET), dtype=torch.float32,
                                   device=dev)
        self._slot_pen = np.zeros((n,), bool)
        self._slot_bias = np.zeros((n,), bool)
        # Multi-LoRA: the live stack (None: no adapters), its entry count
        # (id 0 included), and each slot's adapter id, on the host and as
        # the device copy the decode steps read.
        self._lora_stack = None
        self.num_adapters = 0
        if lora_stack is not None:
            self._lora_stack = self._place_stack(lora_stack)
            self.num_adapters = int(lora_stack['scaling'].shape[0])
        self._slot_lora = np.zeros((n,), np.int32)
        self._d_lora = torch.zeros((n,), dtype=torch.int32, device=dev)
        # The one pending adapter update (applied at a tick boundary).
        self._swap_req: Optional[Dict[str, Any]] = None
        self._next_id = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.perf = _fresh_perf()
        self._last_pull_t: Optional[float] = None
        self._had_admission = False
        self._ttfts: 'collections.deque[float]' = collections.deque(
            maxlen=512)
        # Set while the loop runs (/health); cleared by a crash.
        self.ready = threading.Event()
        # Request traces: req_id -> phase timestamps (queued,
        # prefill_start, first_token, done) and status.
        self._traces: 'collections.OrderedDict[int, Dict[str, Any]]' = \
            collections.OrderedDict()
        self._traces_lock = threading.Lock()
        self._last_gauge_t = 0.0
        self._last_deadline_scan = 0.0
        self.metrics_registry = metrics_registry or metrics_lib.REGISTRY
        self._init_metrics()
        # Version stamped on host-tier pages; every prefix flush bumps it,
        # so pages spilled before the flush are never promoted after it.
        self.kv_version = 1
        self.kv_tier: Optional[kv_tier_lib.KVTierManager] = None
        if tier != 'off':
            self.kv_tier = kv_tier_lib.KVTierManager()
            self.kv_tier.host.set_version(self.kv_version)
            self.pool.on_evict = self._kv_spill
            # One page of each pool: [L, H, P(, d)] at pool dtype.
            self.kv_tier.set_page_layout({
                name: (self.cache[name].dtype,
                       tuple(self.cache[name].shape[:1]
                             + self.cache[name].shape[2:]))
                for name in self._kv_pool_keys()})
            self._m_kv_tier_hits = self.metrics_registry.counter(
                'skyt_infer_kv_tier_hit_pages_total',
                'Prefix pages served per cache tier: hbm = registry '
                'hits, host = pages promoted host->device, fleet = '
                'pages landed by cross-replica fetch', ('tier',))
            self._prefix_seen['tier_hbm'] = 0
            self._kv_tier_seen = {'promoted_pages': 0}

    def _init_metrics(self) -> None:
        """The JAX engine's metric families (same names, help, labels and
        buckets), each counted at the same event; the QoS ones only with
        SKYT_QOS=1."""
        reg = self.metrics_registry
        self._m_requests = reg.counter(
            'skyt_infer_requests_total', 'Requests submitted')
        self._m_prefill_tokens = reg.counter(
            'skyt_infer_prefill_tokens_total',
            'Prompt tokens admitted through prefill')
        self._m_decode_tokens = reg.counter(
            'skyt_infer_decode_tokens_total',
            'Tokens generated by decode')
        self._m_queue_depth = reg.gauge(
            'skyt_infer_queue_depth',
            'Requests queued but not yet admitted to a slot')
        self._m_running = reg.gauge(
            'skyt_infer_running_requests',
            'Requests occupying a decode slot')
        reg.gauge('skyt_infer_slots_total',
                  'Configured decode slots').set(self.num_slots)
        self._m_ttft = reg.histogram(
            'skyt_infer_ttft_seconds',
            'Time to first token (queue wait + prefill)')
        self._m_itl = reg.histogram(
            'skyt_infer_itl_seconds',
            'Inter-token latency (per-chunk mean across active slots)')
        self._m_prefill_dispatches = reg.counter(
            'skyt_infer_prefill_dispatches_total',
            'Target-model prefill device dispatches (batched admission '
            'amortizes these across same-bucket requests)')
        self._m_admission_batch = reg.histogram(
            'skyt_infer_admission_batch_size',
            'Requests admitted per prefill dispatch',
            buckets=(1, 2, 4, 8, 16, 32))
        self._m_prefill_disp_tokens = reg.counter(
            'skyt_infer_prefill_dispatch_tokens_total',
            'Token positions prefill dispatches actually computed '
            '(batch x bucket for padded, packed T for ragged)')
        self._m_prefill_padded = reg.counter(
            'skyt_infer_prefill_padded_tokens_total',
            'Prefill dispatch positions holding no real prompt token '
            '(the wasted-FLOP fraction ragged prefill removes)')
        self._m_kv_util = reg.gauge(
            'skyt_infer_kv_cache_utilization',
            'KV cache occupancy fraction (0-1)')
        self._m_deadline_expired = reg.counter(
            'skyt_infer_deadline_expired_total',
            'Requests expired by their per-request deadline (slot and '
            'KV pages reclaimed)')
        self._m_prefix_hit = reg.counter(
            'skyt_infer_prefix_cache_hit_pages_total',
            'Prompt pages served from the prefix cache')
        self._m_prefix_miss = reg.counter(
            'skyt_infer_prefix_cache_miss_pages_total',
            'Prompt pages that missed the prefix cache')
        self._m_prefix_evictions = reg.counter(
            'skyt_infer_prefix_cache_evictions_total',
            'Published prefix pages reclaimed by allocation pressure '
            '(each one is warm KV dropped from HBM — and spilled to '
            'the host tier when SKYT_KV_TIER is on)')
        self._m_prefix_pages = reg.gauge(
            'skyt_infer_prefix_cache_pages',
            'Pages currently holding published (reusable) prefix KV')
        self._m_prefix_occupancy = reg.gauge(
            'skyt_infer_prefix_cache_occupancy',
            'Published prefix pages / allocatable pool pages (0-1)')
        # Pool running totals already folded into the counters.
        self._prefix_seen = {'hit_pages': 0, 'miss_pages': 0,
                             'evictions': 0}
        self._m_kv_tier_hits = None
        reg.gauge(
            'skyt_infer_kv_bytes_per_token',
            'KV cache bytes per token at the active KV dtype '
            '(memory_plan page math) — the disaggregation '
            'advisor transfer-cost input').set(float(
                kv_bytes_per_token(self.cfg, self.kv_dtype)))
        self._m_qos_depth = self._m_qos_wait = self._m_qos_ttft = None
        if self._qos_queue is not None:
            self._m_qos_depth = reg.gauge(
                'skyt_qos_queue_depth',
                'Waiting requests by QoS class', ('class',))
            self._m_qos_wait = reg.histogram(
                'skyt_qos_queue_wait_seconds',
                'Queue wait (submit -> prefill start) by QoS class',
                ('class',))
            self._m_qos_ttft = reg.histogram(
                'skyt_qos_ttft_seconds',
                'Time to first token by QoS class', ('class',))

    # ------------------------------------------------------- device work
    def _lora_kw(self, lora_ids) -> Dict[str, Any]:
        """The model's adapter arguments (none without a stack): the live
        stack and `lora_ids` ([B] or [B, S] int32, numpy or a device
        tensor)."""
        if self._lora_stack is None:
            return {}
        if not isinstance(lora_ids, torch.Tensor):
            lora_ids = torch.as_tensor(np.asarray(lora_ids, np.int32),
                                       device=self.device)
        return {'lora': self._lora_stack, 'lora_ids': lora_ids}

    def _prefill_impl(self, tokens: torch.Tensor, length: int,
                      lora_id: int = 0):
        """tokens [1, bucket]: (greedy [1], logits [1, V] f32, prefill
        cache {'k','v'} [L, 1, bucket, H, d])."""
        b, s = tokens.shape
        shape = (self.cfg.n_layers, b, s, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        cache = {'k': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device),
                 'v': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device)}
        logit_pos = torch.full((b, 1), length - 1, dtype=torch.long,
                               device=self.device)
        logits, cache = self.model(tokens, cache=cache,
                                   logit_positions=logit_pos,
                                   **self._lora_kw([lora_id]))
        logits = logits[:, 0, :].float()
        return logits.argmax(dim=-1), logits, cache

    def _prefill_ragged_impl(self, tokens, seg_ids, positions, logit_pos,
                             lora_row=None):
        """Packed prefill of several prompts in ONE [1, T] row, separated
        by segment ids (padding carries id 0); lora_row [1, T]: each
        token's adapter id. Returns (greedy [Bp], logits [Bp, V] f32,
        packed dense cache [L, 1, T, H, d])."""
        b, s = tokens.shape
        shape = (self.cfg.n_layers, b, s, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        cache = {'k': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device),
                 'v': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device)}
        logits, cache = self.model(tokens, positions=positions,
                                   segment_ids=seg_ids, cache=cache,
                                   logit_positions=logit_pos,
                                   **self._lora_kw(lora_row))
        logits = logits[0].float()
        return logits.argmax(dim=-1), logits, cache

    def _prefill_suffix_impl(self, tokens: torch.Tensor, start: int,
                             length: int, table_row: np.ndarray,
                             lora_id: int = 0):
        """Prefix-cached (or chunked) prefill: tokens [1, bucket] at
        positions start.. run over the slot's gathered view (int8 pools
        dequantized), so they attend the pages already written through
        the dense continuation path. Returns (greedy [1], logits [1, V]
        f32 at position length - 1, the view {'k','v'}
        [L, 1, max_pages*P, H, d] with the new tokens written at start..,
        which the insert scatters back from src_off)."""
        row = torch.as_tensor(table_row[None], device=self.device)
        if 'k_scale' in self.cache:
            view = {n: paged_cache.PagePool.gather_view_q(
                self.cache[n], self.cache[f'{n}_scale'], row, self.dtype)
                for n in ('k', 'v')}
        else:
            view = {n: paged_cache.PagePool.gather_view(self.cache[n], row)
                    for n in ('k', 'v')}
        positions = start + torch.arange(tokens.shape[1],
                                         device=self.device)[None]
        logit_pos = torch.full((1, 1), length - start - 1,
                               dtype=torch.long, device=self.device)
        logits, view = self.model(tokens, positions=positions, cache=view,
                                  logit_positions=logit_pos,
                                  **self._lora_kw([lora_id]))
        logits = logits[:, 0, :].float()
        return logits.argmax(dim=-1), logits, view

    def _insert_pages_impl(self, prefill_cache, page_ids: np.ndarray,
                           src_off: int) -> None:
        """Scatter positions [src_off, src_off + n*P) of row 0 of a
        prefill cache into pages `page_ids`, in place (int8 pools
        quantize here). Alone, a chunk's write: the slot's table row and
        decode args stay as they are until the final chunk."""
        p = self.pool.cfg.page_size
        need = src_off + len(page_ids) * p
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.device)
        for name in ('k', 'v'):
            pk = prefill_cache[name]
            if pk.shape[2] < need:   # bucket shorter than the page span
                pk = torch.nn.functional.pad(
                    pk, (0, 0, 0, 0, 0, need - pk.shape[2]))
            if 'k_scale' in self.cache:
                paged_cache.PagePool.insert_prompt_q(
                    self.cache[name], self.cache[f'{name}_scale'], pk, ids,
                    src_off)
            else:
                paged_cache.PagePool.insert_prompt(self.cache[name], pk,
                                                   ids, src_off)

    def _insert_paged_impl(self, prefill_cache, slot: int, req: _Request,
                           first: int, temp: float, page_ids: np.ndarray,
                           table_row: np.ndarray, src_off: int) -> None:
        """Scatter the prompt KV (positions [src_off, src_off + n*P) of
        row 0 of the prefill cache) into the pages `page_ids`, install the
        slot's table row and decode args — all in place, ordered after
        any in-flight chunk on the stream. A prefix hit passes only its
        suffix pages: shared pages are never written."""
        self._insert_pages_impl(prefill_cache, page_ids, src_off)
        self.cache['tables'][slot] = torch.as_tensor(
            table_row, dtype=torch.int32, device=self.device)
        self._d_last[slot] = first
        self._d_lens[slot] = len(req.tokens)
        self._d_temps[slot] = temp
        self._d_topks[slot] = min(req.params.top_k, _TOPK_BUCKET)
        self._d_topps[slot] = req.params.top_p
        self._d_lora[slot] = req.params.lora_id
        if temp > 0.0 and req.gen is None:
            req.gen = torch.Generator(device=self.device)
            req.gen.manual_seed(req.params.seed + req.req_id)
        self._slot_gens[slot] = req.gen
        self._insert_options_impl(slot, req.params, first)

    def _insert_options_impl(self, slot: int, p: SamplingParams,
                             first: int) -> None:
        """A slot's penalty and bias state: a penalized request sets its
        penalties and its count row (reset, then the first token
        counted, as the JAX engine's _update_args); a biased one its
        (idx, val) pairs. A request without them only clears what the
        slot's earlier request left, so greedy traffic writes nothing
        here."""
        pen = p.penalized
        if pen or self._slot_pen[slot]:
            self._d_press[slot] = p.presence_penalty
            self._d_freqs[slot] = p.frequency_penalty
            self._slot_pen[slot] = pen
        if pen:
            self._d_counts[slot] = 0
            self._d_counts[slot, first] = 1
        if p.logit_bias or self._slot_bias[slot]:
            idx, val = _bias_arrays(p)
            self._d_bidx[slot] = torch.as_tensor(idx, device=self.device)
            self._d_bval[slot] = torch.as_tensor(val, device=self.device)
            self._slot_bias[slot] = bool(p.logit_bias)

    def _clear_slot_impl(self, slot: int) -> None:
        """Point a released slot's table row at the dummy page so its
        decode writes (an in-flight chunk's included: this write orders
        after it on the stream) can never land in pages a later
        admission re-reserves or shares; its adapter id goes back to 0."""
        self.cache['tables'][slot] = 0
        self._d_lora[slot] = 0

    # ---------------------------------------------------- host KV tier
    def _kv_pool_keys(self) -> List[str]:
        return ['k', 'v', 'k_scale', 'v_scale'] if 'k_scale' in self.cache \
            else ['k', 'v']

    def _kv_spill(self, page: int, h: bytes) -> None:
        """PagePool.on_evict: clone the page being reclaimed on the
        stream (a view would see the insert that reuses it), record an
        event after the clones, and hand both to the tier's writer
        thread, which waits on the event before its copy to host memory.
        Never raises into the pool's accounting."""
        try:
            snap = {name: self.cache[name][:, page].clone()
                    for name in self._kv_pool_keys()}
            ready = None
            if self.device.type == 'cuda':
                ready = torch.cuda.Event()
                ready.record()
            self.kv_tier.enqueue_spill(h, self.kv_version, snap, ready)
        except Exception:  # pylint: disable=broad-except
            logger.exception('kv tier spill enqueue failed')

    def _kv_install_impl(self, page_ids: List[int],
                         datas: List[kv_tier_lib.PageArrays]) -> None:
        """Write host pages ([L, H, P(, d)] at pool dtype each) into pool
        pages `page_ids`, in place: a byte copy, so a promoted page is
        bit-equal to the page that spilled."""
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.device)
        for name in self._kv_pool_keys():
            self.cache[name][:, ids] = torch.stack(
                [d[name] for d in datas], dim=1).to(self.device)

    def _kv_install(self, pages: List[int],
                    datas: List[kv_tier_lib.PageArrays]) -> None:
        """Install promoted pages in chunks of at most 8 (bounds the host
        staging of one copy)."""
        for i in range(0, len(pages), 8):
            self._kv_install_impl(pages[i:i + 8], datas[i:i + 8])

    def _kv_try_promote(self, req: _Request) -> int:
        """If the registry's run for `req` stops short and the host store
        holds its continuation, install those pages (refcount 0, warm)
        so the reservation that follows shares them. Returns the pages
        promoted."""
        if self.kv_tier is None or not req.page_hashes:
            return 0
        psize = self.pool.cfg.page_size
        lookup = req.page_hashes[:(len(req.tokens) - 1) // psize]
        have = self.pool.prefix_peek(lookup)
        if have >= len(lookup):
            return 0
        run = self.kv_tier.host.run(lookup[have:], self.kv_version)
        # A page that does not match the pool's layout ends the run and
        # is dropped from the store.
        for i, (h, arrays) in enumerate(run):
            bad = self.kv_tier.validate_page(arrays)
            if bad is not None:
                logger.warning('kv host page %s rejected: %s', h.hex(), bad)
                self.kv_tier.host.discard(h)
                run = run[:i]
                break
        if not run:
            return 0
        pages = self.pool.install_prefix([h for h, _ in run])
        if pages is None:   # the free list cannot take it: recompute
            return 0
        self._kv_install(pages, [arrays for _, arrays in run])
        self.kv_tier.note_promotion(len(pages))
        return len(pages)

    def _kv_admission_break(self, req: _Request, n: int,
                            psize: int) -> bool:
        """True when the host store holds the head of `req`'s prefix (the
        registry missed it), so it leaves the ragged path for the
        sequential one, where the promotion happens."""
        if self.kv_tier is None:
            return False
        lookup = req.page_hashes[:(n - 1) // psize]
        return bool(lookup) and self.kv_tier.host.contains(
            lookup[0], self.kv_version)

    def _sampled_slots(self, sampling: bool) -> List[int]:
        return [i for i in range(self.num_slots)
                if sampling and self._temps[i] > 0
                and self._slot_gens[i] is not None]

    def _hist_insert_impl(self, slot: int, tokens: List[int],
                          first: int) -> None:
        """Install an admitted prompt and its first token (at index n)
        in the slot's history, zero-padded to the prefill bucket and
        clamped to the buffer (n < max_seq_len < its width)."""
        n = len(tokens)
        width = min(max(self._bucket_for(n), n + 1),
                    self._dev_hist.shape[1])
        row = np.zeros((width,), np.int32)
        row[:n] = tokens
        row[n] = first
        self._dev_hist[slot, :width] = torch.as_tensor(row,
                                                       device=self.device)

    def _decode_n_impl(self, n: int, sampling: bool, penalize: bool = False,
                       biased: bool = False, want_lp: bool = False):
        """Generate n tokens per slot: n model steps with on-device
        sampling (greedy where temps == 0). penalize / biased / want_lp
        (some active slot asks for penalties, logit_bias, logprobs) add
        their ops; without them a step issues exactly the greedy and
        sampling ops. Returns (tokens [n, slots], raw logprobs [n, slots]
        or None) and advances the device args (and the spec history,
        if kept)."""
        last, lens = self._d_last, self._d_lens
        sampled_slots = self._sampled_slots(sampling)
        hist = self._dev_hist
        rows = torch.arange(self.num_slots, device=self.device)
        toks, lps = [], []
        for _ in range(n):
            logits, _ = self.model(last[:, None], positions=lens[:, None],
                                   cache=self.cache,
                                   **self._lora_kw(self._d_lora))
            logits = logits[:, 0, :].float()
            raw = logits          # logprobs report the raw model's
            if penalize:
                # vLLM's convention over output-token counts, on the raw
                # logits before temperature / top-k / top-p (greedy too).
                counts = self._d_counts
                logits = logits - self._d_freqs[:, None] * counts - \
                    self._d_press[:, None] * (counts > 0)
            if biased:
                # Each slot's (idx, val) pairs; padding adds 0 to token 0.
                logits = logits.scatter_add(1, self._d_bidx, self._d_bval)
            tok = logits.argmax(dim=-1).to(torch.int32)
            if sampled_slots:
                scaled = logits / self._d_temps.clamp_min(1e-6)[:, None]
                filtered = sampling_filter(scaled, self._d_topks,
                                           self._d_topps)
                # Gumbel-max with each request's own generator: the
                # argmax of logits + Gumbel noise is a categorical draw.
                noise = torch.zeros_like(filtered)
                for i in sampled_slots:
                    noise[i] = gumbel(torch.rand(
                        filtered.shape[-1], device=self.device,
                        generator=self._slot_gens[i]))
                drawn = (filtered + noise).argmax(dim=-1).to(torch.int32)
                tok = torch.where(self._d_temps > 0, drawn, tok)
            if penalize:
                self._d_counts[rows, tok.long()] += 1
            if want_lp:
                lps.append(raw_logprobs(raw, tok))
            if hist is not None:
                # Released slots' stale lengths may run past the buffer:
                # their writes clamp into its (unread) last column.
                hist[rows, (lens + 1).clamp(max=hist.shape[1] - 1)] = tok
            toks.append(tok)
            last, lens = tok, lens + 1
        self._d_last, self._d_lens = last, lens
        return torch.stack(toks), (torch.stack(lps) if want_lp else None)

    def _decode_spec_impl(self, n: int, k: int, sampling: bool,
                          want_lp: bool = False):
        """n speculative verify steps: per slot, k n-gram drafts, one
        s = k+1 forward over [last, drafts] at lens..lens+k, accept a
        draft prefix, emit accepted+1 tokens. Returns (tokens
        [n, slots, k+1], valid counts [n, slots], the emitted rows' raw
        logprobs [n, slots, k+1] when want_lp, else None) and advances
        the device args and the history."""
        last, lens, hist = self._d_last, self._d_lens, self._dev_hist
        sampled_slots = self._sampled_slots(sampling)
        vocab = self.cfg.vocab_size
        ar = torch.arange(k + 1, device=self.device)
        toks, counts, lps = [], [], []
        for _ in range(n):
            draft = propose_ngram(hist, lens, k)
            logits, _ = self.model(torch.cat([last[:, None], draft], 1),
                                   positions=lens[:, None] + ar,
                                   cache=self.cache,
                                   **self._lora_kw(self._d_lora))
            logits = logits.float()
            if sampled_slots:
                u = torch.zeros((self.num_slots, k + vocab),
                                device=self.device)
                for i in sampled_slots:
                    u[i] = torch.rand(k + vocab, device=self.device,
                                      generator=self._slot_gens[i])
                out, acc = speculative_sample_step(
                    logits, draft, self._d_temps, self._d_topks,
                    self._d_topps, u[:, :k], u[:, k:])
            else:
                out = logits.argmax(dim=-1).to(torch.int32)
                acc = torch.cumprod((draft == out[:, :k]).to(torch.int32),
                                    dim=1).sum(dim=1, dtype=torch.int32)
            if want_lp:
                lps.append(raw_logprobs(logits, out))
            # All k+1 candidates go to the history at lens+1; entries past
            # acc+1 are junk the proposer never matches (its window ends
            # at lens).
            start = (lens + 1).clamp(max=hist.shape[1] - (k + 1))
            hist.scatter_(1, start.long()[:, None] + ar, out)
            toks.append(out)
            counts.append(acc + 1)
            last = torch.gather(out, 1, acc.long()[:, None])[:, 0]
            lens = lens + acc + 1
        self._d_last, self._d_lens = last, lens
        return torch.stack(toks), torch.stack(counts), \
            (torch.stack(lps) if want_lp else None)

    def _sample(self, logits: np.ndarray, req: _Request) -> int:
        """Host-side sampling of a request's FIRST token; the same
        temperature -> top-k -> top-p order as the device path."""
        p = req.params
        if p.temperature <= 0.0:
            return int(np.argmax(logits))
        logits = logits.astype(np.float64) / p.temperature
        if p.top_k > 0:
            kth = np.partition(logits, -p.top_k)[-p.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        if 0.0 < p.top_p < 1.0:
            order = np.argsort(-logits)
            s = logits[order]
            sp = np.exp(s - s.max())
            sp /= sp.sum()
            before = np.cumsum(sp) - sp
            logits[order[before >= p.top_p]] = -np.inf
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        return int(req.rng.choice(len(probs), p=probs))

    # ------------------------------------------------------------ public
    def submit(self, tokens: List[int],
               params: Optional[SamplingParams] = None
               ) -> 'tuple[int, queue.Queue]':
        """Enqueue a request; returns (req_id, token queue). The queue
        yields generated token ids (or (token, raw logprob) pairs when
        params.logprobs), then None when finished."""
        params = params or SamplingParams()
        params.validate()
        if params.lora_id >= max(1, self.num_adapters):
            raise ValueError(
                f'lora_id {params.lora_id} out of range: engine has '
                f'{max(0, self.num_adapters - 1)} adapter(s) loaded')
        if params.logit_bias:
            bad = [t for t in params.logit_bias
                   if t >= self.cfg.vocab_size]
            if bad:
                raise ValueError(
                    f'logit_bias token ids out of vocab '
                    f'(V={self.cfg.vocab_size}): {bad[:5]}')
        if len(tokens) >= self.max_seq_len:
            raise ValueError(f'prompt length {len(tokens)} >= max_seq_len '
                             f'{self.max_seq_len}')
        if self._thread is not None and not self._thread.is_alive() and \
                not self._stop.is_set():
            raise RuntimeError(
                'engine loop is dead (crashed); refusing new requests')
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
        req = _Request(req_id=req_id, tokens=list(tokens), params=params,
                       out_queue=queue.Queue(),
                       rng=np.random.default_rng(params.seed + req_id))
        self._m_requests.inc()
        self._trace_event(req_id, 'queued', ts=req.submitted_at,
                          prompt_tokens=len(tokens), status='waiting')
        self._waiting.put(req)
        return req_id, req.out_queue

    def generate(self, tokens: List[int],
                 params: Optional[SamplingParams] = None) -> List[Any]:
        """Blocking convenience: submit + drain. Items as the queue
        yields them: ints, or (token, logprob) pairs with logprobs."""
        _, q = self.submit(tokens, params)
        out = []
        while True:
            tok = q.get()
            if tok is None:
                return out
            out.append(tok)

    def cancel(self, req_id: int) -> bool:
        """Cancel a submitted request (any thread): a waiting one ends at
        admission without taking a slot, a running or chunk-prefilling
        one is released at the next loop boundary (its queue then yields
        None). Returns True if a live request with req_id was found."""
        found = False
        for req in (*self._slots, *self._admitting, self._deferred):
            if req is not None and req.req_id == req_id:
                req.cancelled = found = True
        with self._waiting.mutex:
            for req in self._waiting.queue:
                if req.req_id == req_id:
                    req.cancelled = found = True
        return found

    def _expire_deadlines(self) -> None:
        """Cancel every request past its params.deadline (engine loop,
        each iteration): a running one is released at the next delivery
        boundary, a waiting one ends at admission without a slot. The
        waiting queue (a scan under its mutex) is read at most 4 times a
        second; the slots every iteration."""
        now = time.time()
        expired: List[_Request] = []
        for req in (*self._slots, self._deferred, *self._admitting):
            if req is not None and not req.cancelled and \
                    req.params.deadline is not None and \
                    now > req.params.deadline:
                expired.append(req)
        if now - self._last_deadline_scan >= 0.25:
            self._last_deadline_scan = now
            with self._waiting.mutex:
                for req in self._waiting.queue:
                    if not req.cancelled and \
                            req.params.deadline is not None and \
                            now > req.params.deadline:
                        expired.append(req)
        for req in expired:
            if not req.expired:
                req.expired = True
                self._m_deadline_expired.inc()
            req.cancelled = True

    def start(self) -> None:
        self._stop.clear()
        if self.kv_tier is not None:
            self.kv_tier.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=60)
        if self.kv_tier is not None:
            self.kv_tier.stop()

    # ------------------------------------------------------------ adapters
    def _place_stack(self, stack):
        lora_lib.validate_stack(stack, self.model)
        return lora_lib.place_stack(stack, self.dtype, self.device)

    def request_adapter_update(self, lora_stack, *, num_adapters: int,
                               flush_prefix: bool = True,
                               drain: bool = False,
                               timeout: Optional[float] = None
                               ) -> Dict[str, Any]:
        """Install a new multi-LoRA stack as the live one at a tick
        boundary (the adapter hot-load apply; counterpart of the JAX
        engine's, adapter branch). The base weights are untouched: only
        the stack reference moves. Adapter ids are stable across updates
        (a registry appends or zero-fills slots, never renumbers), so
        in-flight requests stay on their adapter; drain=True waits until
        no slot is occupied (admissions are held meanwhile), for an
        in-place replacement of a referenced id. flush_prefix (the
        default) unpublishes the prefix cache and the host tier's pages:
        pages are salted by adapter id, and a reused id would otherwise
        hit KV computed under its old values. The stack is validated and
        placed on the caller's thread. Blocks until applied; returns
        {'num_adapters', 'flushed_prefix_pages', 'apply_s'}. Raises
        TimeoutError if no applicable boundary comes within `timeout`
        (SKYT_ADAPTER_TIMEOUT_S); the old stack then stays live."""
        if int(num_adapters) != int(lora_stack['scaling'].shape[0]):
            raise ValueError(
                f'num_adapters={num_adapters} but the stack has '
                f'{int(lora_stack["scaling"].shape[0])} entries')
        if timeout is None:
            timeout = env.get_float('SKYT_ADAPTER_TIMEOUT_S')
        swap: Dict[str, Any] = {'lora_stack': self._place_stack(lora_stack),
                                'num_adapters': int(num_adapters),
                                'flush_prefix': bool(flush_prefix),
                                'drain': bool(drain),
                                'event': threading.Event(),
                                'result': None}
        running = self._thread is not None and self._thread.is_alive()
        with self._lock:
            if self._swap_req is not None:
                raise RuntimeError('an adapter update is already pending')
            self._swap_req = swap
        if not running:
            # No engine loop: every moment is a tick boundary.
            self._maybe_apply_swap()
        if not swap['event'].wait(timeout):
            with self._lock:
                if self._swap_req is swap:
                    self._swap_req = None
                    raise TimeoutError(
                        f'engine did not reach an adapter update boundary '
                        f'within {timeout}s (drain={drain}); the old '
                        'stack stays live')
            # Lost the race: the loop claimed it while we timed out.
            swap['event'].wait(5)
        if swap['result'] is None:
            raise RuntimeError('engine loop died before the adapter update '
                               'applied; the old stack stays live')
        return swap['result']

    def _maybe_apply_swap(self) -> None:
        """Apply a pending adapter update if this tick boundary is
        eligible (a draining update waits for every slot to be free).
        The eligibility check and the claim are one lock hold: once
        claimed, the waiter's timeout can no longer abort it, so a
        replica never serves a stack its caller believes was refused."""
        with self._lock:
            swap = self._swap_req
            if swap is None:
                return
            if swap['drain'] and (self._chunked is not None or any(
                    s is not None for s in self._slots)):
                return
            self._swap_req = None   # claimed: the apply is now inevitable
        t0 = time.perf_counter()
        self._lora_stack = swap['lora_stack']
        self.num_adapters = swap['num_adapters']
        flushed = 0
        if swap['flush_prefix'] and self.prefix_caching:
            flushed = self.flush_prefix()
        swap['result'] = {'num_adapters': self.num_adapters,
                          'flushed_prefix_pages': flushed,
                          'apply_s': time.perf_counter() - t0}
        logger.info('adapter stack applied: %d slot(s) (drain=%s, %d prefix '
                    'pages flushed)', self.num_adapters, swap['drain'],
                    flushed)
        swap['event'].set()

    def flush_prefix(self) -> int:
        """Unpublish every prefix page (PagePool.flush_prefix) and move the
        host tier to a new version, which drops its pages and any spill
        still in flight. Engine-loop only (or with the loop stopped).
        Returns the device entries flushed."""
        flushed = self.pool.flush_prefix()
        self.kv_version += 1
        if self.kv_tier is not None:
            self.kv_tier.host.set_version(self.kv_version)
        return flushed

    def adapter_in_use(self, lora_id: int) -> bool:
        """True while an active, admitting, deferred or waiting request
        references the adapter id (a registry's unload refusal: a freed
        id's slot zeroes, so a surviving reference would serve base-model
        outputs under the adapter's name)."""
        lid = int(lora_id)
        for req in (*self._slots, *self._admitting, self._deferred):
            if req is not None and req.params.lora_id == lid:
                return True
        with self._waiting.mutex:
            return any(r.params.lora_id == lid
                       for r in self._waiting.queue)

    def reset_perf(self) -> None:
        self.perf = _fresh_perf()
        self._last_pull_t = None
        with self._lock:
            self._ttfts.clear()

    def ttfts(self) -> List[float]:
        """Recent TTFTs (submit -> first token delivered), in admission
        order."""
        with self._lock:
            return list(self._ttfts)

    def perf_stats(self) -> Dict[str, Any]:
        """TTFT percentiles over the recent window and the steady-state
        decode rate (pull-to-pull intervals with no admission between)."""
        ttfts = sorted(self.ttfts())
        out: Dict[str, float] = dict(self.perf)
        if ttfts:
            out['ttft_p50_s'] = ttfts[len(ttfts) // 2]
            out['ttft_max_s'] = ttfts[-1]
        if self.perf['steady_time_s'] > 0:
            out['steady_decode_tok_s'] = (self.perf['steady_tokens'] /
                                          self.perf['steady_time_s'])
        if self.spec_decode > 0:
            # Mean accepted drafts per verify step (tokens per step - 1).
            steps = self.perf['spec_verify_steps']
            out['spec_accept_per_step'] = (
                self.perf['spec_accepted'] / steps if steps else 0.0)
        if self.prefix_caching:
            pc = dict(self.pool.prefix_stats)
            cached = self.pool.prefix_cached_pages()
            total = self.pool.cfg.n_pages - 1   # page 0 is the dummy
            pc['cached_pages'] = cached
            if total > 0:
                pc['occupancy'] = round(cached / total, 4)
            out['prefix_cache'] = pc
        if self.kv_tier is not None:
            out['kv_tier'] = self.kv_tier.snapshot()
        return out

    def stats(self) -> Dict[str, Any]:
        """The /stats body: slot and queue occupancy, each op's
        implementation ('cuda': the hand-written kernels; 'plain' on the
        CPU), perf_stats(), and the JAX engine's keys the serve plane
        reads (ttft_ms percentiles, steady_decode_tok_per_sec)."""
        active = sum(1 for r in self._slots if r is not None)
        impl = 'cuda' if self.device.type == 'cuda' else 'plain'
        out: Dict[str, Any] = {
            'active_slots': active, 'num_slots': self.num_slots,
            'waiting': self._waiting.qsize() + (
                1 if self._deferred is not None else 0),
            'ready': self.ready.is_set(),
            'kernel_paths': dict.fromkeys(
                ('flash_attention', 'paged_attention', 'lora'), impl),
            **self.perf_stats()}
        out['steady_decode_tok_per_sec'] = out.get('steady_decode_tok_s',
                                                   0.0)
        ttfts = self.ttfts()
        if ttfts:
            arr = np.asarray(ttfts) * 1000.0
            out['ttft_ms'] = {
                'p50': round(float(np.percentile(arr, 50)), 2),
                'p90': round(float(np.percentile(arr, 90)), 2),
                'p99': round(float(np.percentile(arr, 99)), 2),
                'count': int(arr.size)}
        return out

    def _trace_event(self, req_id: int, phase: str,
                     ts: Optional[float] = None, **extra) -> None:
        """Record one phase timestamp of a request (the first write of a
        phase wins) and any fields in `extra`."""
        now = ts if ts is not None else time.time()
        with self._traces_lock:
            tr = self._traces.get(req_id)
            if tr is None:
                tr = {'request_id': req_id}
                self._traces[req_id] = tr
                while len(self._traces) > _TRACE_KEEP:
                    self._traces.popitem(last=False)
            tr.setdefault(phase, now)
            tr.update(extra)

    def request_trace(self, req_id: int) -> Optional[Dict[str, Any]]:
        """A request's phase timestamps (queued, prefill_start,
        first_token, done) with prompt_tokens, generated and status, or
        None for an unknown or evicted id."""
        with self._traces_lock:
            tr = self._traces.get(req_id)
            return None if tr is None else dict(tr)

    def qos_depths(self) -> Optional[Dict[str, int]]:
        """Waiting requests by QoS class, or None with QoS off."""
        if self._qos_queue is None:
            return None
        return self._qos_queue.depths()

    def qos_signals(self) -> Dict[str, float]:
        """Overload signals for the server's QoS admission controller:
        queue depth, slot count, page occupancy, rolling p95 TTFT."""
        sig: Dict[str, float] = {
            'queue_depth': float(self._waiting.qsize() + (
                1 if self._deferred is not None else 0)),
            'num_slots': float(self.num_slots)}
        total = self.pool.cfg.n_pages - 1
        if total > 0:
            sig['kv_util'] = (total - self.pool.free_pages()) / total
        ttfts = self.ttfts()
        if ttfts:
            sig['ttft_p95_s'] = float(np.percentile(np.asarray(ttfts), 95))
        return sig

    def _update_metric_gauges(self) -> None:
        """Refresh the gauges and fold the pool's running prefix totals
        into their counters; each loop iteration, at most 4 times a
        second."""
        now = time.monotonic()
        if now - self._last_gauge_t < 0.25:
            return
        self._last_gauge_t = now
        self._m_queue_depth.set(self._waiting.qsize() + (
            1 if self._deferred is not None else 0))
        self._m_running.set(sum(1 for r in self._slots if r is not None))
        if self._qos_queue is not None:
            for cls, depth in self._qos_queue.depths().items():
                self._m_qos_depth.labels(cls).set(depth)
        total = self.pool.cfg.n_pages - 1   # page 0 is the dummy
        if total > 0:
            self._m_kv_util.set((total - self.pool.free_pages()) / total)
        if not self.prefix_caching:
            return
        ps = self.pool.prefix_stats
        for key, metric in (('hit_pages', self._m_prefix_hit),
                            ('miss_pages', self._m_prefix_miss),
                            ('evictions', self._m_prefix_evictions)):
            cur = int(ps.get(key, 0))
            if cur > self._prefix_seen[key]:
                metric.inc(cur - self._prefix_seen[key])
                self._prefix_seen[key] = cur
        cached = self.pool.prefix_cached_pages()
        self._m_prefix_pages.set(cached)
        if total > 0:
            self._m_prefix_occupancy.set(cached / total)
        if self._m_kv_tier_hits is not None:
            cur = int(ps.get('hit_pages', 0))
            if cur > self._prefix_seen['tier_hbm']:
                self._m_kv_tier_hits.labels('hbm').inc(
                    cur - self._prefix_seen['tier_hbm'])
                self._prefix_seen['tier_hbm'] = cur
            cur = int(self.kv_tier.stats.get('promoted_pages', 0))
            if cur > self._kv_tier_seen['promoted_pages']:
                self._m_kv_tier_hits.labels('host').inc(
                    cur - self._kv_tier_seen['promoted_pages'])
                self._kv_tier_seen['promoted_pages'] = cur

    # --------------------------------------------------------- admission
    def _count_prefill_dispatch(self, n_requests: int, dispatch_tokens: int,
                                real_tokens: int) -> None:
        """One prefill forward serving n_requests admissions (1 for the
        single and the suffix paths and for each chunk), computing
        dispatch_tokens positions of which real_tokens hold prompt
        tokens."""
        self.perf['prefill_dispatches'] += 1
        self._m_prefill_dispatches.inc()
        self._m_admission_batch.observe(n_requests)
        self._m_prefill_disp_tokens.inc(dispatch_tokens)
        if dispatch_tokens > real_tokens:
            self._m_prefill_padded.inc(dispatch_tokens - real_tokens)

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return _round_up_pow2(n)

    def _ragged_bucket(self, t: int) -> int:
        """Packed-length bucket: t rounded up to a page-aligned 1/8th of
        the enclosing power of two (floor: one page)."""
        psize = self.pool.cfg.page_size
        b = _round_up_pow2(t, lo=max(32, psize))
        step = max(psize, (b // 8) - (b // 8) % psize)
        return -(-t // step) * step

    @staticmethod
    def _needs_row(p: SamplingParams) -> bool:
        """Whether a request's first token needs its logits row on the
        host: sampling, logprobs or logit_bias."""
        return p.temperature > 0.0 or p.logprobs or bool(p.logit_bias)

    def _first_token(self, req: _Request, logits_row, greedy):
        """First token of an admitted prompt, the JAX engine's rule for
        every admission path: logit_bias added to a host copy of the row,
        host sampling for temp > 0, the biased row's argmax, else the
        device argmax (`greedy`, a lazy pull); the raw logprob of the
        unbiased row when asked for. logits_row: the host [V] row, or
        None when _needs_row is False. Returns (first, first_lp)."""
        p = req.params
        row = logits_row
        if p.logit_bias:
            row = logits_row.copy()
            for t, b in p.logit_bias.items():
                row[int(t)] += float(b)
        if p.temperature > 0.0:
            first = self._sample(row, req)
        elif p.logit_bias:
            first = int(np.argmax(row))
        else:
            first = greedy()
        first_lp = _np_raw_lp(logits_row, first) if p.logprobs else None
        return first, first_lp

    def _mark_prefill_start(self, req: _Request) -> None:
        if req.prefill_start_at is None:
            req.prefill_start_at = time.time()
        self._trace_event(req.req_id, 'prefill_start', status='running')

    def _reserve_admission_batch(self, live: List[_Request],
                                 free: List[int]):
        """Page reservations for a popped batch. A first failure
        requeues everything (the sequential path owns the pool-full
        case); a later one shrinks the batch with the tail back at the
        queue head. Returns (the requests kept, their table rows)."""
        rows: List[np.ndarray] = []
        for j, req in enumerate(live):
            total = min(len(req.tokens) + req.params.max_new_tokens,
                        self.max_seq_len)
            row = self.pool.try_reserve(free[j], total)
            if row is None:
                break
            rows.append(row)
        with self._waiting.mutex:
            self._waiting.queue.extendleft(reversed(live[len(rows):]))
        live = live[:len(rows)]
        self._admitting = list(live)
        return live, (rows or None)

    def _hashes(self, req: _Request) -> List[bytes]:
        """The request's full-page hashes (computed once; none without
        prefix caching)."""
        if not self.prefix_caching:
            return []
        if req.page_hashes is None:
            req.page_hashes = paged_cache.page_hashes(
                req.tokens, self.pool.cfg.page_size, salt=req.params.lora_id)
        return req.page_hashes

    def _try_admit_ragged(self) -> bool:
        """Pack a FIFO prefix of waiting requests (>= 2, page-aligned,
        any mix of lengths) into one [1, T] prefill with segment ids.
        The prefix stops at a cancelled request, a prompt for chunked
        prefill, a prefix hit or a host-tier hit: those take the
        sequential path."""
        if self._deferred is not None or self._chunked is not None:
            return False
        free = [i for i, r in enumerate(self._slots) if r is None]
        if len(free) < 2 or self._waiting.qsize() < 2:
            return False
        psize = self.pool.cfg.page_size
        with self._waiting.mutex:
            queued = list(itertools.islice(self._waiting.queue, len(free)))
        cand: List[_Request] = []
        total = 0
        for req in queued:
            n = len(req.tokens)
            if req.cancelled or (self.prefill_chunk and
                                 n > self.prefill_chunk):
                break
            if self._qos_reserved and \
                    req.params.priority != 'interactive' and \
                    len(cand) >= len(free) - self._qos_reserved:
                break
            if self.prefix_caching:
                lookup = self._hashes(req)[:(n - 1) // psize]
                if self.pool.prefix_peek(lookup) > 0 or \
                        self._kv_admission_break(req, n, psize):
                    break
            span = -(-n // psize) * psize
            if cand and total + span > self._ragged_max:
                break
            cand.append(req)
            total += span
        if len(cand) < 2:
            return False
        for _ in cand:
            self._waiting.get_nowait()
        cand, rows = self._reserve_admission_batch(cand, free)
        if rows is None:
            return False
        nb = len(cand)
        spans = [-(-len(r.tokens) // psize) * psize for r in cand]
        offs = list(itertools.accumulate([0] + spans[:-1]))
        t_bucket = self._ragged_bucket(sum(spans))
        tokens = np.zeros((1, t_bucket), np.int32)
        segs = np.zeros((1, t_bucket), np.int32)
        poss = np.zeros((1, t_bucket), np.int32)
        # Per-token adapter ids: each segment's tokens carry their
        # request's lora_id; page tails and bucket padding stay 0.
        lora_row = np.zeros((1, t_bucket), np.int32)
        bp = 1 << (nb - 1).bit_length()
        logit_pos = np.zeros((1, bp), np.int32)
        for j, req in enumerate(cand):
            n = len(req.tokens)
            off = offs[j]
            self._mark_prefill_start(req)
            tokens[0, off:off + n] = req.tokens
            segs[0, off:off + n] = j + 1
            lora_row[0, off:off + n] = req.params.lora_id
            # The page-rounding tail keeps id 0 (masked from real
            # tokens); its positions continue the request's arange.
            poss[0, off:off + spans[j]] = np.arange(spans[j])
            logit_pos[0, j] = off + n - 1
        self.perf['ragged_dispatches'] += 1
        self._count_prefill_dispatch(
            nb, t_bucket, sum(len(r.tokens) for r in cand))
        dev = self.device
        greedy, logits, prefill_cache = self._prefill_ragged_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(segs, device=dev),
            torch.as_tensor(poss, device=dev).long(),
            torch.as_tensor(logit_pos, device=dev).long(), lora_row)
        logits_np = logits.cpu().numpy() if any(
            self._needs_row(r.params) for r in cand) else None
        greedy_np = greedy.cpu().numpy() if any(
            r.params.temperature <= 0.0 and not r.params.logit_bias
            for r in cand) else None
        for j, req in enumerate(cand):
            slot = free[j]
            n = len(req.tokens)
            first, first_lp = self._first_token(
                req, logits_np[j] if self._needs_row(req.params) else None,
                lambda j=j: int(greedy_np[j]))
            row = rows[j]
            n_ins = min(-(-n // psize), int((row > 0).sum()))
            self._insert_paged_impl(prefill_cache, slot, req, first,
                                    max(0.0, req.params.temperature),
                                    row[:n_ins], row, offs[j])
            self.pool.publish(slot, self._hashes(req)[:n // psize])
            self._complete_admission(req, slot, n, first, first_lp)
        return True

    def _admit_one(self) -> bool:
        if self._qos_reserved:
            # A non-interactive head may not take the slots kept for
            # interactive requests (a cancelled one passes: it never
            # takes a slot).
            head = self._deferred
            if head is None:
                with self._waiting.mutex:
                    head = self._waiting.queue[0] \
                        if self._waiting.queue else None
            if head is not None and not head.cancelled and \
                    head.params.priority != 'interactive' and \
                    self._slots.count(None) <= self._qos_reserved:
                return False
        req = self._deferred
        if req is not None:
            self._deferred = None
        else:
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                return False
        if req.cancelled:   # never takes a slot
            self._trace_event(req.req_id, 'done', status='deadline'
                              if req.expired else 'cancelled')
            req.out_queue.put(None)
            return True
        n = len(req.tokens)
        psize = self.pool.cfg.page_size
        if self.prefill_chunk and self._chunked is not None and \
                n > self.prefill_chunk:
            # A long prompt behind a chunked prefill waits, unreserved.
            self._deferred = req
            return False
        self._admitting = [req]
        slot = self._slots.index(None)
        total = min(n + req.params.max_new_tokens, self.max_seq_len)
        hashes = self._hashes(req)
        if self.kv_tier is not None and hashes:
            try:
                self._kv_try_promote(req)
            except Exception:  # pylint: disable=broad-except
                # The tier never fails an admission: it recomputes.
                logger.exception('kv tier promotion failed; recomputing')
        # At most (n - 1) // P shared pages: one token must run through
        # the model for the next-token logits.
        res = self.pool.try_reserve_prefix(slot, total,
                                           hashes[:(n - 1) // psize])
        if res is None:
            self._deferred = req   # pool full: keep FIFO order
            self._admitting = []
            return False
        row, n_cached = res
        if self.prefill_chunk and n - n_cached * psize > self.prefill_chunk:
            # One chunk per loop iteration from here (_advance_chunked).
            self._mark_prefill_start(req)
            self._slots[slot] = req
            req.slot = slot
            self._slot_lora[slot] = req.params.lora_id
            self._chunked = {'req': req, 'slot': slot, 'row': row,
                             'hashes': hashes, 'start': n_cached * psize,
                             'n': n}
            self._admitting = []   # it lives in _slots now
            return True
        if n_cached > 0 and n_cached * psize + self._bucket_for(
                n - n_cached * psize) > self.pool.cfg.max_pages_per_slot * \
                psize:
            # The suffix bucket would run past the slot's view: a full
            # prefill instead.
            self.pool.release(slot)
            res = self.pool.try_reserve_prefix(slot, total, ())
            if res is None:
                self._deferred = req
                self._admitting = []
                return False
            row, n_cached = res
        temp = max(0.0, req.params.temperature)
        reserved = int((row > 0).sum())
        self._mark_prefill_start(req)
        if n_cached > 0:
            start = n_cached * psize
            suffix = req.tokens[start:]
            padded = np.zeros((1, self._bucket_for(len(suffix))), np.int32)
            padded[0, :len(suffix)] = suffix
            greedy, logits, prefill_cache = self._prefill_suffix_impl(
                torch.as_tensor(padded, device=self.device).long(), start,
                n, row, req.params.lora_id)
            # Only the computed suffix pages; the shared ones hold it.
            ids = row[n_cached:min(-(-n // psize), reserved)]
            self._count_prefill_dispatch(1, padded.shape[1], len(suffix))
        else:
            start = 0
            bucket = self._bucket_for(n)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = req.tokens
            greedy, logits, prefill_cache = self._prefill_impl(
                torch.as_tensor(padded, device=self.device).long(), n,
                req.params.lora_id)
            ids = row[:min(-(-bucket // psize), reserved)]
            self._count_prefill_dispatch(1, bucket, n)
        logits_row = logits.cpu().numpy()[0] \
            if self._needs_row(req.params) else None
        first, first_lp = self._first_token(req, logits_row,
                                            lambda: int(greedy.cpu()[0]))
        self._insert_paged_impl(prefill_cache, slot, req, first, temp, ids,
                                row, start)
        self.pool.publish(slot, hashes[:n // psize])
        self._complete_admission(req, slot, n, first, first_lp)
        return True

    def _advance_chunked(self) -> bool:
        """Run ONE chunk of the chunked prefill in progress, if any,
        through the suffix path: this chunk's tokens over the pages
        written so far, its pages scattered back (the slot's table row
        untouched, so it stays out of the decode batch). The final chunk
        gives the first token and installs the slot. Returns whether
        anything ran."""
        st = self._chunked
        if st is None:
            return False
        req, slot, row = st['req'], st['slot'], st['row']
        if req.cancelled:
            self._release(slot)   # drops its pages and self._chunked
            return True
        start, n, hashes = st['start'], st['n'], st['hashes']
        psize = self.pool.cfg.page_size
        piece = min(self.prefill_chunk, n - start)
        final = start + piece >= n
        sb = self._bucket_for(piece)
        if start + sb > self.pool.cfg.max_pages_per_slot * psize:
            # The padded writes must stay inside the slot's view; the
            # page-rounded piece always fits.
            sb = -(-piece // psize) * psize
        padded = np.zeros((1, sb), np.int32)
        padded[0, :piece] = req.tokens[start:start + piece]
        self.perf['prefill_chunks'] += 1
        self._count_prefill_dispatch(1, sb, piece)
        # Keep this iteration out of the steady decode rate.
        self._had_admission = True
        # An intermediate chunk's logits row (at its own end) goes unused.
        greedy, logits, view = self._prefill_suffix_impl(
            torch.as_tensor(padded, device=self.device).long(), start,
            n if final else start + piece, row, req.params.lora_id)
        first_page = start // psize
        ids = row[first_page:min(-(-(start + piece) // psize),
                                 int((row > 0).sum()))]
        if not final:
            self._insert_pages_impl(view, ids, first_page * psize)
            self.pool.publish(slot, hashes[:(start + piece) // psize])
            st['start'] = start + piece
            return True
        temp = max(0.0, req.params.temperature)
        logits_row = logits.cpu().numpy()[0] \
            if self._needs_row(req.params) else None
        first, first_lp = self._first_token(req, logits_row,
                                            lambda: int(greedy.cpu()[0]))
        self._insert_paged_impl(view, slot, req, first, temp, ids, row,
                                first_page * psize)
        self.pool.publish(slot, hashes[:n // psize])
        self._chunked = None
        self._complete_admission(req, slot, n, first, first_lp)
        return True

    def _complete_admission(self, req: _Request, slot: int, n: int,
                            first: int,
                            first_lp: Optional[float] = None) -> None:
        if self._dev_hist is not None:
            self._hist_insert_impl(slot, req.tokens, first)
        req.first_token_at = time.time()
        ttft = req.first_token_at - req.submitted_at
        with self._lock:
            self._ttfts.append(ttft)
        self._m_ttft.observe(ttft)
        if self._qos_queue is not None:
            cls = req.params.priority
            self._m_qos_ttft.labels(cls).observe(ttft)
            start = req.prefill_start_at or req.first_token_at
            self._m_qos_wait.labels(cls).observe(
                max(0.0, start - req.submitted_at))
        self._m_prefill_tokens.inc(n)
        self._trace_event(req.req_id, 'first_token', ts=req.first_token_at)
        req.slot = slot
        req.generated = 1
        req.out_queue.put((first, first_lp) if req.params.logprobs
                          else first)
        self._slots[slot] = req
        self._slot_lora[slot] = req.params.lora_id
        self._lengths[slot] = n
        self._conf_lengths[slot] = n
        self._temps[slot] = max(0.0, req.params.temperature)
        self._had_admission = True
        if self._req_done(req, first):
            self._release(slot)

    def _req_done(self, req: _Request, token: int) -> bool:
        p = req.params
        if p.eos_token is not None and token == p.eos_token:
            return True
        if req.generated >= p.max_new_tokens:
            return True
        return self._lengths[req.slot] + 1 >= self.max_seq_len

    def _release(self, slot: int, status: Optional[str] = None) -> None:
        """Free a slot; the request's stream ends (None) only after the
        slot no longer holds it. status overrides the trace's outcome
        (the crash handler's 'failed')."""
        req = self._slots[slot]
        if self._chunked is not None and self._chunked['slot'] == slot:
            self._chunked = None   # a chunked prefill abandoned
        self._slots[slot] = None
        self._slot_lora[slot] = 0
        self._lengths[slot] = 0
        self._conf_lengths[slot] = 0
        self._slot_gens[slot] = None
        if req is not None:
            self.pool.release(slot)
            self._clear_slot_impl(slot)
            # The trace before the None: a client reading it right after
            # its response must see the request done.
            self._trace_event(req.req_id, 'done', generated=req.generated,
                              status=status or (
                                  'deadline' if req.expired else
                                  'cancelled' if req.cancelled else 'done'))
            req.out_queue.put(None)

    # -------------------------------------------------------------- loop
    def _loop(self) -> None:
        self.ready.set()
        try:
            with torch.inference_mode():
                self._loop_body()
        except Exception:  # pylint: disable=broad-except
            logger.exception('engine loop crashed; failing open requests')
            self.ready.clear()
            for i, req in enumerate(self._slots):
                if req is not None:
                    self._trace_event(req.req_id, 'done', status='failed')
                    req.out_queue.put(None)
                    self._slots[i] = None
            pending = [r for r in (*self._admitting, self._deferred)
                       if r is not None and r.slot is None]
            while True:
                try:
                    pending.append(self._waiting.get_nowait())
                except queue.Empty:
                    break
            for req in pending:
                self._trace_event(req.req_id, 'done', status='failed')
                req.out_queue.put(None)
        finally:
            # A pending adapter update must not wedge its waiter on a
            # stopped or dead loop: it fails (the old stack stays live).
            with self._lock:
                swap, self._swap_req = self._swap_req, None
            if swap is not None:
                swap['event'].set()

    def _loop_body(self) -> None:
        # Pipelined decode: enqueue chunk k+1 BEFORE pulling chunk k's
        # tokens, so the card computes through the host's delivery work.
        pending = None   # (toks_dev, entries)
        while not self._stop.is_set():
            # A pending adapter update applies at this tick boundary when
            # eligible; while a draining one waits, admissions hold so the
            # drain converges. (A stale lock-free read delays by a tick.)
            if self._swap_req is not None:
                self._maybe_apply_swap()
            swap = self._swap_req
            hold = swap is not None and swap['drain']
            self._expire_deadlines()
            if self._qos_queue is not None and self._waiting.qsize() > 1:
                # The fair schedule (class order, aging, DRR across
                # tenants) over the backlog, before this tick's
                # admissions.
                self._qos_queue.reorder(time.time())
            admitted = False
            while None in self._slots and not hold:
                if self._try_admit_ragged():
                    admitted = True
                    continue
                if not self._admit_one():
                    break
                admitted = True
            self._admitting = []
            # One chunk of a long prompt's prefill, then a decode chunk:
            # running requests keep streaming meanwhile.
            chunked = self._advance_chunked()
            filling = self._chunked['slot'] if self._chunked else None
            active = [i for i, r in enumerate(self._slots)
                      if r is not None and i != filling]
            new_pending = None
            upper = 0
            if active:
                # Power-of-two chunk capped by the remaining cache space;
                # a verify step needs room for k+1 tokens, else the chunk
                # takes the plain path.
                rem_space = self.max_seq_len - 1 - int(
                    max(self._lengths[i] for i in active))
                sampling = any(self._temps[i] > 0 for i in active)
                entries = [(i, self._slots[i]) for i in active]
                opts = [r.params for _, r in entries]
                penalize = any(p.penalized for p in opts)
                biased = any(p.logit_bias for p in opts)
                want_lp = any(p.logprobs for p in opts)
                k = self.spec_decode
                # A penalized or biased slot takes the plain path: its
                # target moves within a draft run (as in vLLM).
                if k > 0 and not penalize and not biased and \
                        rem_space // (k + 1) >= 1:
                    bound = max(1, min(self.decode_chunk,
                                       rem_space // (k + 1)))
                    chunk = 1 << (bound.bit_length() - 1)
                    toks, counts, lps = self._decode_spec_impl(
                        chunk, k, sampling, want_lp)
                    new_pending = (toks, counts, lps, entries)
                    upper = chunk * (k + 1)
                else:
                    bound = max(1, min(self.decode_chunk, rem_space))
                    chunk = 1 << (bound.bit_length() - 1)
                    toks, lps = self._decode_n_impl(
                        chunk, sampling, penalize, biased, want_lp)
                    new_pending = (toks, None, lps, entries)
                    upper = chunk
            self._update_metric_gauges()
            if pending is not None:
                self._finish_chunk(pending)
            elif not active and not admitted and not chunked:
                time.sleep(0.002)
            self._lengths = self._conf_lengths + upper
            pending = new_pending
        if pending is not None:
            self._finish_chunk(pending)

    def _finish_chunk(self, pending) -> None:
        """Pull a dispatched chunk's tokens (the pipeline's sync point),
        deliver each slot's run up to its cut-off, release finished
        slots and advance the confirmed lengths. A spec chunk's tokens
        are [chunk, slots, k+1] with counts [chunk, slots]: the first
        counts[t, i] entries of step t are valid."""
        toks_dev, counts_dev, lps_dev, entries = pending
        toks_np = toks_dev.cpu().numpy()
        counts_np = counts_dev.cpu().numpy() if counts_dev is not None \
            else None
        lps_np = lps_dev.cpu().numpy() if lps_dev is not None else None
        now = time.perf_counter()
        delivered = 0
        base = {i: int(self._conf_lengths[i]) for i, _ in entries}
        for i, req in entries:
            if self._slots[i] is not req:
                continue   # finished earlier / slot re-admitted
            if req.cancelled:
                self._release(i)   # this chunk's tokens are dropped
                continue
            p = req.params
            if counts_np is not None:
                # The valid tokens of every verify step, in step order.
                c = counts_np[:, i]
                valid = np.arange(toks_np.shape[2])[None] < c[:, None]
                flat = toks_np[:, i, :][valid]
                flat_lps = lps_np[:, i, :][valid] if lps_np is not None \
                    else None
            else:
                flat = toks_np[:, i]
                flat_lps = lps_np[:, i] if lps_np is not None else None
            total = int(flat.shape[0])
            # Tokens up to AND including the first EOS; at most
            # max_new_tokens in all; positions below max_seq_len - 1.
            if p.eos_token is not None:
                hits = np.flatnonzero(flat == p.eos_token)
                n_eos = int(hits[0]) + 1 if hits.size else total + 1
            else:
                n_eos = total + 1
            n_raw = min(n_eos, p.max_new_tokens - req.generated,
                        self.max_seq_len - 1 - base[i])
            n_del = min(total, n_raw)
            if n_del > 0:
                items = flat[:n_del].tolist()
                if p.logprobs:
                    items = list(zip(items, flat_lps[:n_del].tolist()))
                _put_many(req.out_queue, items)
                req.generated += n_del
                delivered += n_del
                base[i] += n_del
            if counts_np is not None:
                # A verify step counts in full if its run began before
                # the cut-off (which may land inside the run).
                began = (np.cumsum(c) - c) < max(n_del, 1)
                self.perf['spec_verify_steps'] += int(began.sum())
                self.perf['spec_accepted'] += int((c[began] - 1).sum())
            if n_raw <= total:
                self._release(i)
        for i, req in entries:
            if self._slots[i] is req:
                self._conf_lengths[i] = base[i]
        self.perf['decode_tokens'] += delivered
        self._m_decode_tokens.inc(delivered)
        if self._last_pull_t is not None and not self._had_admission:
            self.perf['steady_tokens'] += delivered
            self.perf['steady_time_s'] += now - self._last_pull_t
            if delivered > 0:
                # Tokens arrive a chunk at a time: the pull interval over
                # the chunk's delivered count.
                self._m_itl.observe((now - self._last_pull_t) / delivered)
        self._last_pull_t = now
        self._had_admission = False
