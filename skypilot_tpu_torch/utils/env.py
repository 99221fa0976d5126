"""SKYT_* environment accessors for the port.

The port's own registry: only the names this package reads are declared
here, with the same read semantics as skypilot_tpu/utils/env.py (get:
raw os.environ.get; get_bool: unset -> default, else true unless one of
'', '0', 'false', 'no', 'off'; get_float: unset or empty -> default, an
unparsable value -> default with a warning). Reading an undeclared name
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
_var('SKYT_ADAPTER_TIMEOUT_S', 'float', 120.0,
     'How long an adapter hot-load waits for the engine to reach an '
     'applicable decode-tick boundary before aborting (the old adapter '
     'stack stays live).')
_var('SKYT_TORCH_BUILD_DIR', 'str', '',
     'Where the CUDA kernels are built (default: the package\'s '
     '_build/ directory).')

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
