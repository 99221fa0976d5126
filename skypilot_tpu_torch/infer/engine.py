"""Continuous-batching inference engine, paged KV cache (counterpart of
skypilot_tpu/infer/engine.py in paged mode).

  * Admission: a burst of waiting requests is packed into ONE [1, T]
    prefill row separated by segment ids (ragged prefill); a lone request
    takes the bucket-padded prefill. Either way the prompt KV is then
    scattered into the request's reserved pages.
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

Not ported (raise): presence/frequency penalties, logit_bias, logprobs,
LoRA ids, deadlines, QoS classes and tenants, prefix caching, the draft
model proposer, chunked prefill, meshes and multi-host lockstep. Not
ported (absent): the dense (non-paged) cache mode, the padded batched
admission, cancel, metrics and tracing.
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

from skypilot_tpu_torch.infer import paged_cache
from skypilot_tpu_torch.utils import device as device_lib
from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

# Device-side top-k sampling supports k up to this (one shared top-k
# sort serves every slot's k and its top-p nucleus).
_TOPK_BUCKET = 64


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
        """Reject parameters the engine cannot honor exactly, and the
        features this engine does not implement yet."""
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
        unported = {
            'presence_penalty': self.presence_penalty != 0.0,
            'frequency_penalty': self.frequency_penalty != 0.0,
            'logprobs': bool(self.logprobs),
            'logit_bias': bool(self.logit_bias),
            'lora_id': self.lora_id != 0,
            'deadline': self.deadline is not None,
            'priority': self.priority != 'standard',
            'tenant': self.tenant != '',
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f'sampling parameters not ported yet: {", ".join(bad)}')


@dataclasses.dataclass
class _Request:
    req_id: int
    tokens: List[int]
    params: SamplingParams
    out_queue: 'queue.Queue[Optional[int]]'
    submitted_at: float = dataclasses.field(default_factory=time.time)
    first_token_at: Optional[float] = None
    slot: Optional[int] = None
    generated: int = 0
    rng: Any = None                   # numpy Generator: first token
    gen: Optional[torch.Generator] = None   # device sampling


def _round_up_pow2(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _fresh_perf() -> Dict[str, float]:
    return {'decode_tokens': 0, 'steady_tokens': 0, 'steady_time_s': 0.0,
            'prefill_dispatches': 0, 'ragged_dispatches': 0,
            'spec_verify_steps': 0, 'spec_accepted': 0}


def _put_many(q, items) -> None:
    """Deliver a run of tokens to a request's queue in one lock hold."""
    if not items:
        return
    with q.mutex:
        q.queue.extend(items)
        q.unfinished_tasks += len(items)
        q.not_empty.notify(len(items))


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


class InferenceEngine:
    """Slot-based continuous batching over the paged KV cache."""

    def __init__(self, model, *, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 decode_chunk: int = 16,
                 page_size: int = 64,
                 prefix_caching: bool = False,
                 spec_decode: int = 0,
                 prefill_chunk: int = 0,
                 kv_dtype: str = 'auto',
                 mesh=None, lockstep=None,
                 draft_model=None, device=None) -> None:
        """model: a models.llama.LlamaModel holding its weights on
        `device` (None -> 'cuda'; raises without CUDA unless 'cpu').
        spec_decode: draft length k of n-gram speculative decoding (0:
        off). kv_dtype: 'int8' quantizes the paged pools; 'auto' defers
        to SKYT_KV_DTYPE, then to the model dtype; anything else
        explicit raises ValueError. prefix_caching, prefill_chunk, mesh,
        lockstep and a draft model exist in the JAX engine and are not
        ported yet: anything but their defaults raises."""
        unported = {'prefix_caching': bool(prefix_caching),
                    'prefill_chunk': prefill_chunk > 0,
                    'mesh': mesh is not None,
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
            self.max_seq_len, num_slots, page_size)
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
        # Host slot table. _lengths is an upper-bound estimate for chunk
        # sizing; _conf_lengths the confirmed length, advanced at pulls.
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._lengths = np.zeros((num_slots,), np.int32)
        self._conf_lengths = np.zeros((num_slots,), np.int32)
        self._temps = np.zeros((num_slots,), np.float32)
        self._slot_gens: List[Optional[torch.Generator]] = \
            [None] * num_slots
        self._waiting: 'queue.Queue[_Request]' = queue.Queue()
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
        self._next_id = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.perf = _fresh_perf()
        self._last_pull_t: Optional[float] = None
        self._had_admission = False
        self._ttfts: 'collections.deque[float]' = collections.deque(
            maxlen=512)

    # ------------------------------------------------------- device work
    def _prefill_impl(self, tokens: torch.Tensor, length: int):
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
                                   logit_positions=logit_pos)
        logits = logits[:, 0, :].float()
        return logits.argmax(dim=-1), logits, cache

    def _prefill_ragged_impl(self, tokens, seg_ids, positions, logit_pos):
        """Packed prefill of several prompts in ONE [1, T] row, separated
        by segment ids (padding carries id 0). Returns (greedy [Bp],
        logits [Bp, V] f32, packed dense cache [L, 1, T, H, d])."""
        b, s = tokens.shape
        shape = (self.cfg.n_layers, b, s, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        cache = {'k': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device),
                 'v': torch.zeros(shape, dtype=self.dtype,
                                  device=self.device)}
        logits, cache = self.model(tokens, positions=positions,
                                   segment_ids=seg_ids, cache=cache,
                                   logit_positions=logit_pos)
        logits = logits[0].float()
        return logits.argmax(dim=-1), logits, cache

    def _insert_paged_impl(self, prefill_cache, slot: int, req: _Request,
                           first: int, temp: float, page_ids: np.ndarray,
                           table_row: np.ndarray, src_off: int) -> None:
        """Scatter the prompt KV (positions [src_off, src_off + n*P) of
        row 0 of the prefill cache) into the reserved pages, install the
        slot's table row and decode args — all in place, ordered after
        any in-flight chunk on the stream."""
        p = self.pool.cfg.page_size
        need = src_off + len(page_ids) * p
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.device)
        for name in ('k', 'v'):
            pk = prefill_cache[name]
            if pk.shape[2] < need:   # bucket shorter than the page span
                pk = torch.nn.functional.pad(
                    pk, (0, 0, 0, 0, 0, need - pk.shape[2]))
            if 'k_scale' in self.cache:   # int8 pool: quantize here
                paged_cache.PagePool.insert_prompt_q(
                    self.cache[name], self.cache[f'{name}_scale'], pk, ids,
                    src_off)
            else:
                paged_cache.PagePool.insert_prompt(self.cache[name], pk,
                                                   ids, src_off)
        self.cache['tables'][slot] = torch.as_tensor(
            table_row, dtype=torch.int32, device=self.device)
        self._d_last[slot] = first
        self._d_lens[slot] = len(req.tokens)
        self._d_temps[slot] = temp
        self._d_topks[slot] = min(req.params.top_k, _TOPK_BUCKET)
        self._d_topps[slot] = req.params.top_p
        self._slot_gens[slot] = req.gen

    def _clear_slot_impl(self, slot: int) -> None:
        """Point a released slot's table row at the dummy page so its
        decode writes can never land in pages a later admission
        re-reserves."""
        self.cache['tables'][slot] = 0

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

    def _decode_n_impl(self, n: int, sampling: bool):
        """Generate n tokens per slot: n model steps with on-device
        sampling (greedy where temps == 0). Returns tokens [n, slots]
        and advances the device args (and the spec history, if kept)."""
        last, lens = self._d_last, self._d_lens
        sampled_slots = self._sampled_slots(sampling)
        hist = self._dev_hist
        rows = torch.arange(self.num_slots, device=self.device)
        toks = []
        for _ in range(n):
            logits, _ = self.model(last[:, None], positions=lens[:, None],
                                   cache=self.cache)
            logits = logits[:, 0, :].float()
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
            if hist is not None:
                # Released slots' stale lengths may run past the buffer:
                # their writes clamp into its (unread) last column.
                hist[rows, (lens + 1).clamp(max=hist.shape[1] - 1)] = tok
            toks.append(tok)
            last, lens = tok, lens + 1
        self._d_last, self._d_lens = last, lens
        return torch.stack(toks)

    def _decode_spec_impl(self, n: int, k: int, sampling: bool):
        """n speculative verify steps: per slot, k n-gram drafts, one
        s = k+1 forward over [last, drafts] at lens..lens+k, accept a
        draft prefix, emit accepted+1 tokens. Returns (tokens
        [n, slots, k+1], valid counts [n, slots]) and advances the device
        args and the history."""
        last, lens, hist = self._d_last, self._d_lens, self._dev_hist
        sampled_slots = self._sampled_slots(sampling)
        vocab = self.cfg.vocab_size
        ar = torch.arange(k + 1, device=self.device)
        toks, counts = [], []
        for _ in range(n):
            draft = propose_ngram(hist, lens, k)
            logits, _ = self.model(torch.cat([last[:, None], draft], 1),
                                   positions=lens[:, None] + ar,
                                   cache=self.cache)
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
        return torch.stack(toks), torch.stack(counts)

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
        yields generated token ids, then None when finished."""
        params = params or SamplingParams()
        params.validate()
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
        gen = torch.Generator(device=self.device)
        gen.manual_seed(params.seed + req_id)
        req = _Request(req_id=req_id, tokens=list(tokens), params=params,
                       out_queue=queue.Queue(),
                       rng=np.random.default_rng(params.seed + req_id),
                       gen=gen)
        self._waiting.put(req)
        return req_id, req.out_queue

    def generate(self, tokens: List[int],
                 params: Optional[SamplingParams] = None) -> List[int]:
        """Blocking convenience: submit + drain."""
        _, q = self.submit(tokens, params)
        out = []
        while True:
            tok = q.get()
            if tok is None:
                return out
            out.append(tok)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=60)

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

    def perf_stats(self) -> Dict[str, float]:
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
        return out

    # --------------------------------------------------------- admission
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

    def _first_token(self, req: _Request, logits_row, greedy) -> int:
        """First token: host sampling for temp > 0, else the device
        argmax (a lazy pull)."""
        if req.params.temperature > 0.0:
            return self._sample(logits_row, req)
        return greedy()

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

    def _try_admit_ragged(self) -> bool:
        """Pack a FIFO prefix of waiting requests (>= 2, page-aligned,
        any mix of lengths) into one [1, T] prefill with segment ids."""
        if self._deferred is not None:
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
            span = -(-len(req.tokens) // psize) * psize
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
        bp = 1 << (nb - 1).bit_length()
        logit_pos = np.zeros((1, bp), np.int32)
        for j, req in enumerate(cand):
            n = len(req.tokens)
            off = offs[j]
            tokens[0, off:off + n] = req.tokens
            segs[0, off:off + n] = j + 1
            # The page-rounding tail keeps id 0 (masked from real
            # tokens); its positions continue the request's arange.
            poss[0, off:off + spans[j]] = np.arange(spans[j])
            logit_pos[0, j] = off + n - 1
        self.perf['ragged_dispatches'] += 1
        self.perf['prefill_dispatches'] += 1
        dev = self.device
        greedy, logits, prefill_cache = self._prefill_ragged_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(segs, device=dev),
            torch.as_tensor(poss, device=dev).long(),
            torch.as_tensor(logit_pos, device=dev).long())
        logits_np = logits.cpu().numpy() if any(
            r.params.temperature > 0.0 for r in cand) else None
        greedy_np = greedy.cpu().numpy() if any(
            r.params.temperature <= 0.0 for r in cand) else None
        for j, req in enumerate(cand):
            slot = free[j]
            n = len(req.tokens)
            first = self._first_token(
                req, logits_np[j] if logits_np is not None else None,
                lambda j=j: int(greedy_np[j]))
            row = rows[j]
            n_ins = min(-(-n // psize), int((row > 0).sum()))
            self._insert_paged_impl(prefill_cache, slot, req, first,
                                    max(0.0, req.params.temperature),
                                    row[:n_ins], row, offs[j])
            self._complete_admission(req, slot, n, first)
        return True

    def _admit_one(self) -> bool:
        req = self._deferred
        if req is not None:
            self._deferred = None
        else:
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                return False
        self._admitting = [req]
        slot = self._slots.index(None)
        n = len(req.tokens)
        bucket = self._bucket_for(n)
        total = min(n + req.params.max_new_tokens, self.max_seq_len)
        row = self.pool.try_reserve(slot, total)
        if row is None:
            self._deferred = req   # pool full: keep FIFO order
            self._admitting = []
            return False
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = req.tokens
        greedy, logits, prefill_cache = self._prefill_impl(
            torch.as_tensor(padded, device=self.device).long(), n)
        self.perf['prefill_dispatches'] += 1
        temp = max(0.0, req.params.temperature)
        logits_row = logits.cpu().numpy()[0] if temp > 0.0 else None
        first = self._first_token(req, logits_row,
                                  lambda: int(greedy.cpu()[0]))
        p = self.pool.cfg.page_size
        n_ins = min(-(-bucket // p), int((row > 0).sum()))
        self._insert_paged_impl(prefill_cache, slot, req, first, temp,
                                row[:n_ins], row, 0)
        self._complete_admission(req, slot, n, first)
        return True

    def _complete_admission(self, req: _Request, slot: int, n: int,
                            first: int) -> None:
        if self._dev_hist is not None:
            self._hist_insert_impl(slot, req.tokens, first)
        req.first_token_at = time.time()
        with self._lock:
            self._ttfts.append(req.first_token_at - req.submitted_at)
        req.slot = slot
        req.generated = 1
        req.out_queue.put(first)
        self._slots[slot] = req
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

    def _release(self, slot: int) -> None:
        req = self._slots[slot]
        if req is not None:
            req.out_queue.put(None)
        self._slots[slot] = None
        self._lengths[slot] = 0
        self._conf_lengths[slot] = 0
        self._slot_gens[slot] = None
        if req is not None:
            self.pool.release(slot)
            self._clear_slot_impl(slot)

    # -------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            with torch.inference_mode():
                self._loop_body()
        except Exception:  # pylint: disable=broad-except
            logger.exception('engine loop crashed; failing open requests')
            for i, req in enumerate(self._slots):
                if req is not None:
                    req.out_queue.put(None)
                    self._slots[i] = None
            for req in (*self._admitting, self._deferred):
                if req is not None and req.slot is None:
                    req.out_queue.put(None)
            while True:
                try:
                    self._waiting.get_nowait().out_queue.put(None)
                except queue.Empty:
                    break

    def _loop_body(self) -> None:
        # Pipelined decode: enqueue chunk k+1 BEFORE pulling chunk k's
        # tokens, so the card computes through the host's delivery work.
        pending = None   # (toks_dev, entries)
        while not self._stop.is_set():
            admitted = False
            while None in self._slots:
                if self._try_admit_ragged():
                    admitted = True
                    continue
                if not self._admit_one():
                    break
                admitted = True
            self._admitting = []
            active = [i for i, r in enumerate(self._slots) if r is not None]
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
                k = self.spec_decode
                if k > 0 and rem_space // (k + 1) >= 1:
                    bound = max(1, min(self.decode_chunk,
                                       rem_space // (k + 1)))
                    chunk = 1 << (bound.bit_length() - 1)
                    toks, counts = self._decode_spec_impl(chunk, k,
                                                          sampling)
                    new_pending = (toks, counts, entries)
                    upper = chunk * (k + 1)
                else:
                    bound = max(1, min(self.decode_chunk, rem_space))
                    chunk = 1 << (bound.bit_length() - 1)
                    toks = self._decode_n_impl(chunk, sampling)
                    new_pending = (toks, None, entries)
                    upper = chunk
            if pending is not None:
                self._finish_chunk(pending)
            elif not active and not admitted:
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
        toks_dev, counts_dev, entries = pending
        toks_np = toks_dev.cpu().numpy()
        counts_np = counts_dev.cpu().numpy() if counts_dev is not None \
            else None
        now = time.perf_counter()
        delivered = 0
        base = {i: int(self._conf_lengths[i]) for i, _ in entries}
        for i, req in entries:
            if self._slots[i] is not req:
                continue   # finished earlier / slot re-admitted
            p = req.params
            if counts_np is not None:
                # The valid tokens of every verify step, in step order.
                c = counts_np[:, i]
                flat = toks_np[:, i, :][np.arange(toks_np.shape[2])[None]
                                        < c[:, None]]
            else:
                flat = toks_np[:, i]
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
                _put_many(req.out_queue, flat[:n_del].tolist())
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
        if self._last_pull_t is not None and not self._had_admission:
            self.perf['steady_tokens'] += delivered
            self.perf['steady_time_s'] += now - self._last_pull_t
        self._last_pull_t = now
        self._had_admission = False
