"""SKYT_* environment accessors for the port.

The port's own registry: only the names this package reads are declared
here, with the same read semantics as skypilot_tpu/utils/env.py (get:
raw os.environ.get; get_bool: unset -> default, else true unless one of
'', '0', 'false', 'no', 'off'; get_int / get_float: unset or empty ->
default, an unparsable value (or an int below `minimum`) -> default with
a warning). Reading an undeclared name
raises, so every knob stays listed in one place.
"""
import dataclasses
import logging
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    type: str
    default: Any
    doc: str


_REGISTRY: Dict[str, EnvVar] = {}


def _var(name: str, typ: str, default: Any, doc: str) -> None:
    _REGISTRY[name] = EnvVar(name, typ, default, doc)


_var('SKYT_DEBUG', 'bool', False, 'Debug-level logging.')
_var('SKYT_MINIMIZE_LOGGING', 'bool', False,
     'Warnings and errors only.')
_var('SKYT_KV_DTYPE', 'str', 'auto',
     "Paged KV cache dtype when the engine's kv_dtype is 'auto': 'auto' "
     "(the model dtype) or 'int8' (per-token, per-head scales).")
_var('SKYT_KV_TIER', 'str', 'off',
     'Prefix-KV cache tiering: "off" (device pages only) or "host" '
     '(spill evicted prefix pages to a host-RAM LRU and promote them on '
     'a miss). Needs prefix caching. "fleet" (cross-replica fetch over '
     'GET /kv/prefix) is not ported and raises.')
_var('SKYT_KV_HOST_BYTES', 'int', 256 * 1024 * 1024,
     'Byte budget of the host-RAM prefix-page LRU.')
_var('SKYT_ADAPTER_TIMEOUT_S', 'float', 120.0,
     'How long an adapter hot-load waits for the engine to reach an '
     'applicable decode-tick boundary before aborting (the old adapter '
     'stack stays live).')
_var('SKYT_PROFILE_DIR', 'str', None,
     'Where the sft StepProfiler writes its torch.profiler trace (unset: '
     'no profile).')
_var('SKYT_PROFILE_START_STEP', 'int', 2,
     'First train step the StepProfiler captures.')
_var('SKYT_PROFILE_NUM_STEPS', 'int', 3,
     'How many consecutive steps the StepProfiler captures.')
_var('SKYT_METRICS_MAX_SERIES', 'int', 1000,
     'Per-family label-set cap in the metrics registry.')
_var('SKYT_TRAIN_MFU', 'bool', True,
     'Compute + log model FLOPs utilization in the sft step log.')
_var('SKYT_TORCH_BUILD_DIR', 'str', '',
     'Where the CUDA kernels are built (default: the package\'s '
     '_build/ directory).')
_var('SKYT_WEIGHTS_CHECKPOINT', 'str', None,
     'Weights checkpoint override applied at replica startup '
     '(exported from the service spec\'s `weights:` field, so '
     'replicas launched mid/post-rollout boot on the current '
     'weights instead of the task\'s original --checkpoint).')
# QoS plane (serve/qos.py, the engine's classed queue, the server's
# admission gate); the reference's names and defaults.
_var('SKYT_QOS', 'bool', False,
     'Master switch for the QoS plane (admission, DRR, shedding).')
_var('SKYT_QOS_WEIGHTS', 'str', '',
     'DRR class weights, e.g. "interactive:8,standard:4,batch:1".')
_var('SKYT_QOS_QUANTUM', 'float', 256.0,
     'DRR quantum (token credits per round).')
_var('SKYT_QOS_AGING_S', 'float', 30.0,
     'Anti-starvation aging horizon for queued requests.')
_var('SKYT_QOS_DEBT_HALFLIFE_S', 'float', 30.0,
     'Half-life of accumulated DRR debt.')
_var('SKYT_QOS_RESERVE_SLOTS', 'int', 0,
     'Engine slots reserved for interactive-class admission.')
_var('SKYT_QOS_QUEUE_DEGRADE', 'float', 4.0,
     'Queue-depth-per-slot level that triggers degrade mode.')
_var('SKYT_QOS_QUEUE_SHED', 'float', 8.0,
     'Queue-depth-per-slot level that triggers shedding.')
_var('SKYT_QOS_KV_DEGRADE', 'float', 0.90,
     'KV-cache utilization that triggers degrade mode.')
_var('SKYT_QOS_KV_SHED', 'float', 0.97,
     'KV-cache utilization that triggers shedding.')
_var('SKYT_QOS_TTFT_SLO_MS', 'float', 500.0,
     'Interactive TTFT objective the overload ladder protects.')
_var('SKYT_QOS_HOLD_S', 'float', 2.0,
     'Hysteresis hold before the overload level steps down.')
_var('SKYT_QOS_REFRESH_S', 'float', 0.25,
     'Overload-level recompute cadence.')
_var('SKYT_QOS_RETRY_AFTER_S', 'float', 1.0,
     'Base Retry-After seconds on shed (429) responses.')
_var('SKYT_QOS_DEGRADE_MAX_TOKENS', 'float', 32.0,
     'max_tokens clamp applied to batch requests in degrade mode.')
_var('SKYT_QOS_TENANT_RPS', 'float', 0.0,
     'Per-tenant request-rate limit (0 = off).')
_var('SKYT_QOS_TENANT_BURST', 'float', 0.0,
     'Per-tenant burst allowance (0 = 2x the rate).')
_var('SKYT_QOS_MODEL_WEIGHTS', 'str', '',
     'Per-model DRR quantum multipliers for the fair queue, e.g. '
     '"summarize:4,translate:1" (multiplied with the class weight; '
     'unlisted models weigh 1.0).')

_FALSEY = ('', '0', 'false', 'no', 'off')


def lookup(name: str) -> EnvVar:
    ev = _REGISTRY.get(name)
    if ev is None:
        raise KeyError(f'{name} is not declared in '
                       'skypilot_tpu_torch/utils/env.py')
    return ev


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    lookup(name)
    return os.environ.get(name, default)


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    ev = lookup(name)
    if default is None:
        default = bool(ev.default)
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in _FALSEY


def get_int(name: str, default: Optional[int] = None,
            minimum: Optional[int] = None) -> int:
    ev = lookup(name)
    if default is None:
        default = int(ev.default or 0)
    raw = os.environ.get(name)
    if raw is None or raw == '':
        return default
    try:
        val = int(raw)
    except ValueError:
        logging.getLogger(__name__).warning(
            '%s=%r is not an integer; using default %d', name, raw, default)
        return default
    if minimum is not None and val < minimum:
        logging.getLogger(__name__).warning(
            '%s=%d is below the minimum %d; using default %d', name, val,
            minimum, default)
        return default
    return val


def get_float(name: str, default: Optional[float] = None) -> float:
    ev = lookup(name)
    if default is None:
        default = float(ev.default or 0.0)
    raw = os.environ.get(name)
    if raw is None or raw == '':
        return default
    try:
        return float(raw)
    except ValueError:
        logging.getLogger(__name__).warning(
            '%s=%r is not a number; using default %s', name, raw, default)
        return default
