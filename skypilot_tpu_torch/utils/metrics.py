"""Dependency-free Prometheus-style metrics registry: the port's own copy
of Counter, Gauge, MetricsRegistry and REGISTRY from
skypilot_tpu/utils/metrics.py (same names, get-or-create semantics,
thread safety, per-family series cap SKYT_METRICS_MAX_SERIES and text
exposition 0.0.4), which train/trainer.py's TrainMetricsPublisher
writes. Histograms are not copied: nothing of the port observes one yet.
"""
import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.utils import env

_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*$')

def _max_series() -> int:
    """Per-family label-set cap (SKYT_METRICS_MAX_SERIES, default
    1000). Read at metric construction; malformed values fall back."""
    return env.get_int('SKYT_METRICS_MAX_SERIES', 1000, minimum=1)


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integers bare, floats via
    repr, infinities as +Inf/-Inf (the exposition spelling)."""
    if v == math.inf:
        return '+Inf'
    if v == -math.inf:
        return '-Inf'
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return str(v).replace('\\', r'\\').replace('\n', r'\n') \
        .replace('"', r'\"')


def _escape_help(v: str) -> str:
    return v.replace('\\', r'\\').replace('\n', r'\n')


def _render_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ''
    inner = ','.join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return '{' + inner + '}'


class _Metric:
    """Base: a named family of children keyed by label values."""

    type: str = ''

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f'invalid metric name {name!r}')
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith('__'):
                raise ValueError(f'invalid label name {ln!r}')
        if len(set(labelnames)) != len(labelnames):
            raise ValueError(f'duplicate label names in {labelnames!r}')
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        # Cardinality guard state: the cap, a drop callback installed
        # by the owning registry (lazy — the dropped-series counter is
        # not minted until something actually drops, so golden
        # exposition output is unchanged in the steady state), and the
        # shared detached child writes land on once over the cap.
        self._series_cap = _max_series()
        self._on_drop: Optional[Callable[[], None]] = None
        self._overflow_child: Any = None

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kwvalues):
        """Child for one label-value combination (created on first
        use). Positional or keyword, not both — the prometheus_client
        convention."""
        if values and kwvalues:
            raise ValueError('pass label values positionally or by '
                             'keyword, not both')
        if kwvalues:
            if set(kwvalues) != set(self.labelnames):
                raise ValueError(
                    f'{self.name} labels are {self.labelnames}, got '
                    f'{tuple(kwvalues)}')
            values = tuple(kwvalues[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f'{self.name} takes {len(self.labelnames)} label '
                f'value(s), got {len(values)}')
        key = tuple(str(v) for v in values)
        dropped = False
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self._series_cap:
                    # Over the cap: the write still works (callers
                    # must not crash) but lands on a shared DETACHED
                    # child that never reaches the exposition —
                    # bounded memory, counted loss.
                    dropped = True
                    if self._overflow_child is None:
                        self._overflow_child = self._make_child()
                    child = self._overflow_child
                else:
                    child = self._make_child()
                    self._children[key] = child
        if dropped and self._on_drop is not None:
            # Outside self._lock: the drop counter is another metric
            # with its own lock (and the registry's); never nest.
            self._on_drop()
        return child

    def label_keys(self) -> List[Tuple[str, ...]]:
        """Label-value tuples of all live children (for eviction
        sweeps by owners whose label domain churns, e.g. replica
        URLs)."""
        with self._lock:
            return list(self._children)

    def remove_labels(self, *values) -> None:
        """Drop one child series (no-op if absent). Standard
        Prometheus churn semantics: the series disappears from the
        exposition; if it ever comes back it restarts from zero (rate()
        handles resets)."""
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    def _default_child(self):
        """The single unlabeled child (labelless metrics only)."""
        if self.labelnames:
            raise ValueError(
                f'{self.name} has labels {self.labelnames}; call '
                f'.labels(...) first')
        return self.labels()

    def _sorted_children(self):
        with self._lock:
            return sorted(self._children.items())

    def expose_lines(self) -> List[str]:
        raise NotImplementedError

    def sample_dicts(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class _CounterChild:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError('counters can only increase')
        with self._lock:
            self.value += amount


class Counter(_Metric):
    type = 'counter'

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def value(self, *labelvalues, **kwvalues) -> float:
        """Current value of one child — READ-ONLY: wrong label arity
        raises (never silently 0), and a combination that was never
        written reads as 0.0 WITHOUT creating a phantom zero-valued
        series in the exposition."""
        if labelvalues and kwvalues:
            raise ValueError('pass label values positionally or by '
                             'keyword, not both')
        if kwvalues:
            if set(kwvalues) != set(self.labelnames):
                raise ValueError(
                    f'{self.name} labels are {self.labelnames}, got '
                    f'{tuple(kwvalues)}')
            labelvalues = tuple(kwvalues[n] for n in self.labelnames)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f'{self.name} takes {len(self.labelnames)} label '
                f'value(s), got {len(labelvalues)}')
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            return child.value if child is not None else 0.0

    def expose_lines(self) -> List[str]:
        lines = [f'# HELP {self.name} {_escape_help(self.help)}',
                 f'# TYPE {self.name} {self.type}']
        for key, child in self._sorted_children():
            lines.append(f'{self.name}'
                         f'{_render_labels(self.labelnames, key)} '
                         f'{_fmt(child.value)}')
        return lines

    def sample_dicts(self) -> List[Dict[str, Any]]:
        return [{'labels': self._labels_dict(key), 'value': child.value}
                for key, child in self._sorted_children()]


class _GaugeChild:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Gauge(_Metric):
    type = 'gauge'

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    expose_lines = Counter.expose_lines
    sample_dicts = Counter.sample_dicts
    value = Counter.value


# The guard's loss counter (one family, 'metric' label = family name).
_DROPPED_SERIES = 'skyt_metrics_dropped_series_total'


class MetricsRegistry:
    """Holds metric families; renders the exposition text / snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: 'Dict[str, _Metric]' = {}

    def _get_or_create(self, cls, name: str, help_text: str,
                       labelnames: Sequence[str]):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f'metric {name!r} already registered as '
                        f'{existing.type} with labels '
                        f'{existing.labelnames}')
                return existing
            metric = cls(name, help_text, labelnames)
            if name != _DROPPED_SERIES:
                # The dropped-series counter itself is exempt: its
                # 'metric' label domain is the (bounded) family set,
                # and wiring it to itself would recurse on overflow.
                metric._on_drop = self._make_drop_cb(name)
            self._metrics[name] = metric
            return metric

    def _make_drop_cb(self, metric_name: str) -> Callable[[], None]:
        """Per-family drop callback. The counter is created LAZILY on
        the first drop so registries that never overflow expose
        byte-identical output to before the guard existed."""
        def _cb() -> None:
            self.counter(
                _DROPPED_SERIES,
                'Label-sets dropped by the per-family series cap '
                '(SKYT_METRICS_MAX_SERIES); each increment is one '
                'write that would have minted a new series',
                ('metric',)).labels(metric_name).inc()
        return _cb

    def counter(self, name: str, help_text: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4. Families render in
        registration order; children in sorted label order — the output
        is deterministic for golden tests."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose_lines())
        return '\n'.join(lines) + ('\n' if lines else '')

    def snapshot(self) -> List[Dict[str, Any]]:
        """JSON-friendly view for the dashboard / /stats consumers."""
        with self._lock:
            metrics = list(self._metrics.values())
        return [{'name': m.name, 'type': m.type, 'help': m.help,
                 'samples': m.sample_dicts()} for m in metrics]


# Content type the exposition endpoint should answer with.
CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

# Process-wide default registry. Long-lived components (engine, server,
# load balancer, autoscaler, trainer) publish here unless handed an
# instance; tests inject their own to stay isolated.
REGISTRY = MetricsRegistry()
