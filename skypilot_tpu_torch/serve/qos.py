"""QoS admission control: priority classes, per-tenant fair queueing
and overload shedding; the port's copy of skypilot_tpu/serve/qos.py.

  * the server (infer/server.py) parses ``X-Priority`` / ``X-Tenant``
    (the OpenAI routes also map ``service_tier``) and gates admission
    through :class:`ServerQoS`: per-tenant token buckets and the overload
    ladder (degrade, then shed with ``429 + Retry-After``);
  * with ``SKYT_QOS=1`` the engine replaces its FIFO with
    :class:`ClassedRequestQueue`: class-ordered with aging credit and
    deficit-round-robin tenant fairness within a class.

Everything is off by default: ``SKYT_QOS=0`` keeps the plain FIFO path.
Every shed/throttle/degrade decision lands in the ``skyt_qos_*``
metrics. Not ported: the reference's fault points (``qos.shed`` /
``qos.throttle``, which force a path for chaos drills) and the trace
span annotations of each decision: both wait for the port's fault and
tracing planes. The LB's and autoscaler's helpers (``rate_by_class``,
``shed_avoid_classes``, ``autoscale_class_weights``) belong to the serve
plane and are not copied.

Priority classes (strict order, aging prevents starvation):

    interactive > standard > batch

Overload ladder (lowest class suffers first; interactive is never shed
by the overload controller):

    level 0  admit everything
    level 1  degrade batch   (clamp max_tokens)
    level 2  shed batch, degrade standard
    level 3  shed batch AND standard
"""
import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils
from skypilot_tpu_torch.utils import metrics as metrics_lib

logger = log_utils.init_logger(__name__)

PRIORITIES = ('interactive', 'standard', 'batch')
CLASS_RANK = {'interactive': 0, 'standard': 1, 'batch': 2}
DEFAULT_CLASS = 'standard'
DEFAULT_TENANT = 'default'

# OpenAI `service_tier` values mapped onto our classes (the OpenAI
# routes' body-level alternative to the X-Priority header).
_SERVICE_TIER_MAP = {
    'priority': 'interactive',
    'auto': 'standard',
    'default': 'standard',
    'flex': 'batch',
    'batch': 'batch',
}

_TENANT_CHARS = frozenset(
    'abcdefghijklmnopqrstuvwxyz'
    'ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-')
_TENANT_MAX_LEN = 64


def enabled() -> bool:
    """Master switch. '0' / unset => the whole subsystem is a no-op
    (the engine keeps its plain FIFO queue, the server never consults
    the admission controller). Read at engine/server CONSTRUCTION —
    the waiting-queue type cannot change under a live engine."""
    return env.get('SKYT_QOS', '0') not in ('', '0', 'false')


# ------------------------------------------------------- header parsing
def parse_priority(value: Optional[str]) -> str:
    """X-Priority header -> class name. Absent/empty => the default
    class; anything not in PRIORITIES raises ValueError (HTTP layers
    turn it into a 400 naming the offender)."""
    if value is None or value == '':
        return DEFAULT_CLASS
    v = value.strip().lower()
    if v not in CLASS_RANK:
        raise ValueError(
            f'X-Priority must be one of {"/".join(PRIORITIES)}, '
            f'got {value!r}')
    return v


def parse_tenant(value: Optional[str]) -> str:
    """X-Tenant header -> tenant id. Absent/empty => the shared
    default tenant. The charset/length bound keeps tenant ids safe as
    metric label values and queue keys (attacker-controlled headers
    must not mint unbounded label cardinality one byte at a time —
    callers should still bound DISTINCT tenants; see
    TenantRateLimiter's eviction)."""
    if value is None or value == '':
        return DEFAULT_TENANT
    v = value.strip()
    if not v or len(v) > _TENANT_MAX_LEN or \
            not all(c in _TENANT_CHARS for c in v):
        raise ValueError(
            f'X-Tenant must be 1-{_TENANT_MAX_LEN} chars of '
            f'[A-Za-z0-9._-], got {value!r}')
    return v


def map_service_tier(tier: Any) -> Optional[str]:
    """OpenAI `service_tier` -> class, or None when the field is
    absent. Unknown tiers raise ValueError (400)."""
    if tier is None:
        return None
    if isinstance(tier, str) and tier.lower() in _SERVICE_TIER_MAP:
        return _SERVICE_TIER_MAP[tier.lower()]
    raise ValueError(
        f'service_tier must be one of '
        f'{sorted(set(_SERVICE_TIER_MAP))}, got {tier!r}')


# --------------------------------------------------- token-bucket limits
class TokenBucket:
    """Deterministic token bucket (injectable clock, float tokens).

    refill rate `rate` tokens/s up to `burst`; try_take returns
    (granted, retry_after_s) where retry_after is the exact time until
    the requested amount would be available — the Retry-After header's
    source of truth."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def _refill(self, now: float) -> None:
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> 'Tuple[bool, float]':
        now = self._clock()
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True, 0.0
        if self.rate <= 0:
            return False, 60.0
        return False, (n - self.tokens) / self.rate


class TenantRateLimiter:
    """Per-tenant token buckets, lazily created and bounded: beyond
    `max_tenants` the least-recently-used bucket is evicted (a fresh
    bucket starts full, so eviction can only ever be LENIENT — it
    never locks a tenant out). rate <= 0 disables limiting entirely."""

    def __init__(self, rate: float, burst: float,
                 max_tenants: int = 4096,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_tenants = max(1, int(max_tenants))
        self._clock = clock
        self._buckets: 'collections.OrderedDict[str, TokenBucket]' = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.rate > 0

    def try_take(self, tenant: str, n: float = 1.0) -> 'Tuple[bool, float]':
        if not self.active:
            return True, 0.0
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst,
                                     clock=self._clock)
                self._buckets[tenant] = bucket
                while len(self._buckets) > self.max_tenants:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(tenant)
            return bucket.try_take(n)


# -------------------------------------------------- DRR weighted fair queue
def _class_weights() -> Dict[str, float]:
    """SKYT_QOS_WEIGHTS='interactive:8,standard:4,batch:1' — the DRR
    quantum multiplier per class (matters only when aging lands two
    classes in the same band). Malformed entries fall back."""
    out = {'interactive': 8.0, 'standard': 4.0, 'batch': 1.0}
    raw = env.get('SKYT_QOS_WEIGHTS', '')
    for part in (p for p in raw.split(',') if p.strip()):
        k, sep, v = part.partition(':')
        try:
            if not sep or k.strip() not in out:
                raise ValueError
            out[k.strip()] = max(float(v), 0.001)
        except ValueError:
            logger.warning('ignoring malformed SKYT_QOS_WEIGHTS '
                           'entry %r', part)
    return out


def _model_weights() -> Dict[str, float]:
    """SKYT_QOS_MODEL_WEIGHTS='summarize:4,translate:1' — the DRR
    quantum multiplier per served model/adapter name (docs/serving.md
    "Adapter fleet"), multiplied with the class weight. Unlisted
    models weigh 1.0; malformed entries are dropped (model names are
    operator-chosen, so unlike class weights any key is legal)."""
    out: Dict[str, float] = {}
    raw = env.get('SKYT_QOS_MODEL_WEIGHTS', '')
    for part in (p for p in raw.split(',') if p.strip()):
        k, sep, v = part.partition(':')
        try:
            if not sep or not k.strip():
                raise ValueError
            out[k.strip()] = max(float(v), 0.001)
        except ValueError:
            logger.warning('ignoring malformed SKYT_QOS_MODEL_WEIGHTS '
                           'entry %r', part)
    return out


class FairQueue:
    """Deficit-round-robin weighted fair queue with strict class
    priority and aging (the scheduling core; ClassedRequestQueue
    adapts it to the engine's queue.Queue contract).

    Items are grouped into FLOWS keyed (class, tenant, model) — the
    model key (docs/serving.md "Adapter fleet") isolates adapters
    within a tenant, so one adapter's burst queues behind its own
    flow instead of starving the tenant's other models. A flow's BAND
    is its class rank minus the aging credit of its oldest item
    (``wait // aging_s``) — unbounded below, so a starved batch flow
    eventually outranks fresh interactive traffic (no starvation).
    pop() serves the lowest band; within a band, classic DRR over the
    flows in first-arrival order: each visit grants
    ``quantum * class_weight * model_weight`` deficit, a flow emits
    while its deficit covers its head's cost, and an emptied flow
    forfeits its deficit. FIFO within a flow, always."""

    def __init__(self, quantum: Optional[float] = None,
                 aging_s: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None,
                 model_weights: Optional[Dict[str, float]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.quantum = (quantum if quantum is not None
                        else env.get_float('SKYT_QOS_QUANTUM', 256.0))
        self.quantum = max(self.quantum, 0.001)
        self.aging_s = (aging_s if aging_s is not None
                        else env.get_float('SKYT_QOS_AGING_S', 30.0))
        self.aging_s = max(self.aging_s, 0.001)
        self.weights = dict(weights or _class_weights())
        self.model_weights = dict(model_weights
                                  if model_weights is not None
                                  else _model_weights())
        self._clock = clock
        # flow key -> deque[(item, cost, seq, enq_t)]
        self._flows: 'collections.OrderedDict[tuple, collections.deque]' \
            = collections.OrderedDict()
        self._deficit: Dict[tuple, float] = {}
        self._n = 0
        self._seq = 0

    def __len__(self) -> int:
        return self._n

    def push(self, item: Any, cls: str = DEFAULT_CLASS,
             tenant: str = DEFAULT_TENANT, cost: float = 1.0,
             seq: Optional[int] = None,
             t: Optional[float] = None,
             model: str = '') -> None:
        if cls not in CLASS_RANK:
            cls = DEFAULT_CLASS
        if seq is None:
            seq = self._seq
            self._seq += 1
        flow = (cls, tenant, model)
        dq = self._flows.get(flow)
        if dq is None:
            dq = collections.deque()
            self._flows[flow] = dq
            self._deficit.setdefault(flow, 0.0)
        dq.append((item, max(float(cost), 0.001), seq,
                   self._clock() if t is None else t))
        self._n += 1

    def seed_debt(self, debt: Dict[tuple, float],
                  cap: Optional[float] = None) -> None:
        """Start flows with NEGATIVE deficit equal to their recent
        service (ClassedRequestQueue's cross-tick fairness memory).
        Capped so an old debt can only delay a flow by a few rounds."""
        if cap is None:
            cap = 4.0 * self.quantum
        for flow, d in debt.items():
            if flow in self._deficit and d > 0:
                self._deficit[flow] -= min(float(d), cap)

    def _band(self, flow: tuple, now: float) -> int:
        dq = self._flows[flow]
        oldest = min(entry[3] for entry in dq)
        credit = int(max(0.0, now - oldest) / self.aging_s)
        return CLASS_RANK[flow[0]] - credit

    def depths(self) -> Dict[str, int]:
        out = {c: 0 for c in PRIORITIES}
        for flow, dq in self._flows.items():
            out[flow[0]] += len(dq)
        return out

    def pop(self, now: Optional[float] = None) -> Optional[Any]:
        if self._n == 0:
            return None
        if now is None:
            now = self._clock()
        bands = {flow: self._band(flow, now) for flow in self._flows}
        target = min(bands.values())
        cand = [flow for flow in self._flows if bands[flow] == target]
        # DRR: serve the first candidate (arrival order) whose deficit
        # covers its head; while nobody can afford, everyone in the
        # band earns a quantum. Bounded: each refill adds
        # quantum*min_weight > 0 and the head cost is finite.
        while True:
            for flow in cand:
                dq = self._flows[flow]
                item, cost, _seq, _t = dq[0]
                if self._deficit[flow] >= cost:
                    dq.popleft()
                    self._n -= 1
                    self._deficit[flow] -= cost
                    if not dq:
                        # An emptied flow forfeits its deficit (DRR).
                        del self._flows[flow]
                        del self._deficit[flow]
                    return item
            for flow in cand:
                self._deficit[flow] += (
                    self.quantum * self.weights.get(flow[0], 1.0) *
                    self.model_weights.get(flow[2], 1.0))

    def drain(self, now: Optional[float] = None) -> List[Any]:
        """Full scheduling order (consumes the queue)."""
        if now is None:
            now = self._clock()
        out = []
        while self._n:
            out.append(self.pop(now))
        return out


@dataclasses.dataclass(frozen=True)
class RequestMeta:
    """What the scheduler needs to know about a queued request. The
    engine supplies a `meta` callable mapping its _Request to this."""
    cls: str
    tenant: str
    cost: float
    seq: int
    enq_t: float
    # Served model/adapter name (docs/serving.md "Adapter fleet") —
    # the third flow key; '' (the default, and pre-adapter callers)
    # collapses to per-(class, tenant) flows as before.
    model: str = ''


class ClassedRequestQueue(queue.Queue):
    """The engine's priority-aware waiting structure: a queue.Queue
    whose backing deque is kept in SCHEDULED order, so every existing
    access pattern — get_nowait() pops, head snapshots under .mutex
    for batched admission, extendleft requeues — keeps working while
    admission order becomes class-ordered with aging + DRR tenant
    fairness.

    put() appends; the engine loop calls reorder() once per tick,
    which recomputes the schedule via FairQueue (seeded with the
    persistent per-flow service debt) and rewrites the deque in place.
    Pops charge the popped flow's debt (decayed exponentially) so a
    tenant that just got a burst served queues behind its peers next
    tick. Multi-host lockstep: only the PRIMARY reorders; the computed
    order rides the tick broadcast and followers apply_order() it, so
    hosts admit identical sequences without trusting follower clocks.

    Batched-admission buckets are preserved within a class: the
    schedule is band-major and stable by arrival within a flow, so a
    same-bucket FIFO prefix never straddles a class boundary."""

    def __init__(self, meta: Callable[[Any], 'RequestMeta'],
                 quantum: Optional[float] = None,
                 aging_s: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None,
                 debt_halflife_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time) -> None:
        super().__init__()
        self._meta = meta
        self._quantum = (quantum if quantum is not None
                         else env.get_float('SKYT_QOS_QUANTUM', 256.0))
        self._aging_s = (aging_s if aging_s is not None
                         else env.get_float('SKYT_QOS_AGING_S', 30.0))
        self._weights = dict(weights or _class_weights())
        self._model_weights = _model_weights()
        self._halflife = (debt_halflife_s if debt_halflife_s is not None
                          else env.get_float('SKYT_QOS_DEBT_HALFLIFE_S',
                                          30.0))
        self._clock = clock
        self._debt: Dict[tuple, float] = {}
        self._debt_t = clock()

    # --------------------------------------------- queue.Queue plumbing
    def _get(self):
        item = self.queue.popleft()
        try:
            m = self._meta(item)
            flow = (m.cls, m.tenant, m.model)
            self._debt[flow] = self._debt.get(flow, 0.0) + m.cost
        except Exception:  # pylint: disable=broad-except
            logger.exception('qos meta extraction failed on pop')
        return item

    # ---------------------------------------------------- scheduling
    def _decay_debt(self, now: float) -> None:
        dt = max(0.0, now - self._debt_t)
        self._debt_t = now
        if not self._debt or dt <= 0:
            return
        factor = 0.5 ** (dt / max(self._halflife, 0.001))
        self._debt = {k: v * factor for k, v in self._debt.items()
                      if v * factor > 1e-3}

    def _schedule(self, items: List[Any], now: float) -> List[Any]:
        fq = FairQueue(quantum=self._quantum, aging_s=self._aging_s,
                       weights=self._weights,
                       model_weights=self._model_weights,
                       clock=lambda: now)
        for item in items:
            m = self._meta(item)
            fq.push(item, m.cls, m.tenant, m.cost, seq=m.seq,
                    t=m.enq_t, model=m.model)
        fq.seed_debt(self._debt)
        return fq.drain(now)

    def reorder(self, now: Optional[float] = None
                ) -> 'Tuple[List[int], bool]':
        """Recompute the schedule and rewrite the deque in place.
        Returns (seq order, changed) — `changed` is False when the
        deque was already in scheduled order (the lockstep primary
        skips the broadcast then)."""
        if now is None:
            now = self._clock()
        with self.mutex:
            self._decay_debt(now)
            items = list(self.queue)
            if len(items) <= 1:
                return [self._meta(i).seq for i in items], False
            ordered = self._schedule(items, now)
            changed = any(a is not b for a, b in zip(items, ordered))
            if changed:
                self.queue.clear()
                self.queue.extend(ordered)
            return [self._meta(i).seq for i in ordered], changed

    def apply_order(self, seqs: List[int]) -> None:
        """Reorder the deque to match a seq permutation computed
        elsewhere (the lockstep primary's broadcast). Items missing
        from `seqs` keep their relative order at the tail — defensive;
        by construction follower queues hold the identical set."""
        pos = {s: i for i, s in enumerate(seqs)}
        sentinel = len(pos)
        with self.mutex:
            items = sorted(
                self.queue,
                key=lambda it: pos.get(self._meta(it).seq, sentinel))
            self.queue.clear()
            self.queue.extend(items)

    def depths(self) -> Dict[str, int]:
        out = {c: 0 for c in PRIORITIES}
        with self.mutex:
            for item in self.queue:
                cls = self._meta(item).cls
                out[cls if cls in out else DEFAULT_CLASS] += 1
        return out


# ------------------------------------------------------ overload control
class OverloadController:
    """Watches live engine signals and maps them to an overload level
    with hysteresis (raise immediately, lower only after the computed
    level has stayed below the current one for SKYT_QOS_HOLD_S).

    `signals` is a zero-arg callable returning a dict with any of
    queue_depth, num_slots, kv_util (0-1), ttft_p95_s; it is sampled
    at most every SKYT_QOS_REFRESH_S so per-request admission stays
    O(1) dict reads."""

    def __init__(self, signals: Callable[[], Dict[str, float]],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._signals = signals
        self._clock = clock
        self.queue_degrade = env.get_float('SKYT_QOS_QUEUE_DEGRADE', 4.0)
        self.queue_shed = env.get_float('SKYT_QOS_QUEUE_SHED', 8.0)
        self.kv_degrade = env.get_float('SKYT_QOS_KV_DEGRADE', 0.90)
        self.kv_shed = env.get_float('SKYT_QOS_KV_SHED', 0.97)
        self.ttft_slo_s = env.get_float('SKYT_QOS_TTFT_SLO_MS', 500.0) / 1e3
        self.hold_s = env.get_float('SKYT_QOS_HOLD_S', 2.0)
        self.refresh_s = env.get_float('SKYT_QOS_REFRESH_S', 0.25)
        self.retry_base_s = env.get_float('SKYT_QOS_RETRY_AFTER_S', 1.0)
        self._lock = threading.Lock()
        self._level = 0
        self._below_since: Optional[float] = None
        self._next_refresh = 0.0
        self._pressure = 0.0

    def _raw_level(self, sig: Dict[str, float]) -> int:  # guarded-by: _lock
        level = 0
        q = float(sig.get('queue_depth', 0) or 0)
        slots = max(1.0, float(sig.get('num_slots', 1) or 1))
        ratio = q / slots
        if ratio >= 2 * self.queue_shed:
            level = 3
        elif ratio >= self.queue_shed:
            level = max(level, 2)
        elif ratio >= self.queue_degrade:
            level = max(level, 1)
        kv = sig.get('kv_util')
        if kv is not None:
            if kv >= self.kv_shed:
                level = max(level, 2)
            elif kv >= self.kv_degrade:
                level = max(level, 1)
        ttft = sig.get('ttft_p95_s')
        if ttft is not None and self.ttft_slo_s > 0:
            if ttft >= 2 * self.ttft_slo_s:
                level = max(level, 2)
            elif ttft >= self.ttft_slo_s:
                level = max(level, 1)
        # Pressure: the dominant signal normalized to its shed point
        # (what the LB consults through the controller sync).
        self._pressure = min(1.0, max(
            ratio / max(self.queue_shed, 0.001),
            (kv or 0.0) / max(self.kv_shed, 0.001),
            (ttft or 0.0) / max(2 * self.ttft_slo_s, 0.001)
            if self.ttft_slo_s > 0 else 0.0))
        return level

    def level(self) -> int:
        now = self._clock()
        with self._lock:
            if now < self._next_refresh:
                return self._level
            self._next_refresh = now + self.refresh_s
            try:
                raw = self._raw_level(self._signals() or {})
            except Exception:  # pylint: disable=broad-except
                logger.exception('qos signal sampling failed')
                return self._level
            if raw > self._level:
                self._level = raw          # escalate immediately
                self._below_since = None
            elif raw < self._level:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.hold_s:
                    self._level = raw      # de-escalate after the hold
                    self._below_since = None
            else:
                self._below_since = None
            return self._level

    @property
    def pressure(self) -> float:
        # Lock-discipline fix (skyanalyze): _pressure is written by
        # level() under _lock from the engine loop while the HTTP
        # handlers read it here — take the lock for a torn-free read.
        with self._lock:
            return self._pressure

    def retry_after(self, level: Optional[int] = None) -> float:
        if level is None:
            # Lock-discipline fix (skyanalyze): the no-arg fallback
            # read raced level()'s writes from other threads.
            with self._lock:
                level = self._level
        return min(30.0, self.retry_base_s * (2 ** max(0, level - 1)))


@dataclasses.dataclass
class Decision:
    """One admission decision (every one also lands in the skyt_qos_*
    counters)."""
    action: str                      # admit | degrade | shed | throttle
    level: int = 0
    retry_after: float = 0.0
    max_new_tokens: Optional[int] = None   # degrade clamp


class ServerQoS:
    """The infer server's admission controller: per-tenant token
    buckets + the overload ladder, with metrics."""

    def __init__(self, signals: Callable[[], Dict[str, float]],
                 registry: Optional['metrics_lib.MetricsRegistry'] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        reg = registry or metrics_lib.REGISTRY
        self.overload = OverloadController(signals, clock=clock)
        rate = env.get_float('SKYT_QOS_TENANT_RPS', 0.0)
        burst = env.get_float('SKYT_QOS_TENANT_BURST',
                           max(10.0, 2 * rate))
        self.limiter = TenantRateLimiter(rate, burst, clock=clock)
        self.degrade_max_tokens = int(
            env.get_float('SKYT_QOS_DEGRADE_MAX_TOKENS', 32))
        self._m_requests = reg.counter(
            'skyt_qos_requests_total',
            'Requests through QoS admission', ('class',))
        # The 'model' label (docs/serving.md "Adapter fleet") is the
        # RESOLVED base-model id or loaded-adapter name — a bounded
        # set (SKYT_ADAPTER_MAX + 1), never the raw request string.
        self._m_shed = reg.counter(
            'skyt_qos_shed_total',
            'Requests shed by the overload controller (429)',
            ('class', 'model'))
        self._m_throttled = reg.counter(
            'skyt_qos_throttled_total',
            'Requests throttled by the per-(tenant, model) token '
            'bucket (429)', ('class', 'model'))
        self._m_degraded = reg.counter(
            'skyt_qos_degraded_total',
            'Requests admitted with degraded limits (max_tokens '
            'clamped)', ('class',))
        self._m_level = reg.gauge(
            'skyt_qos_overload_level',
            'Current overload ladder level (0 ok .. 3 shed standard)')

    def admit(self, cls: str, tenant: str,
              max_new_tokens: Optional[int] = None,
              model: str = '') -> 'Decision':
        """Decide for one request. The caller (HTTP handler) turns
        shed/throttle into 429 + Retry-After and applies the degrade
        clamp before building SamplingParams. `model` MUST be a
        resolved label (base id or loaded-adapter name), never the
        raw request string — it keys a token bucket and two counter
        labels, both cardinality-bounded only if the caller is."""
        self._m_requests.labels(cls).inc()
        level = self.overload.level()
        self._m_level.set(level)
        # Buckets keyed (class, tenant, model): one adapter's burst
        # exhausts ITS bucket, not the tenant's other models'
        # (docs/serving.md "Adapter fleet").
        ok, wait = self.limiter.try_take(f'{cls}|{tenant}|{model}')
        if not ok:
            self._m_throttled.labels(cls, model).inc()
            return Decision('throttle', level, max(wait, 0.1))
        retry = self.overload.retry_after(level)
        shed = (level >= 3 and cls != 'interactive') or \
            (level >= 2 and cls == 'batch')
        if shed:
            self._m_shed.labels(cls, model).inc()
            return Decision('shed', level, max(retry, 0.1))
        degrade = (level >= 1 and cls == 'batch') or \
                  (level >= 2 and cls == 'standard')
        if degrade and max_new_tokens is not None and \
                max_new_tokens > self.degrade_max_tokens:
            self._m_degraded.labels(cls).inc()
            return Decision('degrade', level,
                            max_new_tokens=self.degrade_max_tokens)
        return Decision('admit', level)

    def snapshot(self, depths: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Any]:
        """QoS pressure summary: served in /stats (scraped by the
        controller, forwarded to the LB via the sync response) and
        attached to flight-recorded slow traces."""
        level = self.overload.level()
        out: Dict[str, Any] = {
            'level': level,
            'pressure': round(self.overload.pressure, 4),
            'retry_after_s': round(self.overload.retry_after(level), 3),
        }
        if depths is not None:
            out['classes'] = depths
        return out


def retry_after_header(seconds: float) -> str:
    """Retry-After header value: integral seconds, >= 1 (the header
    is delta-seconds; sub-second advice rounds up)."""
    return str(max(1, int(math.ceil(seconds))))
