"""SKYT_* environment accessors for the port.

The port's own registry: only the names this package reads are declared
here, with the same read semantics as skypilot_tpu/utils/env.py (get:
raw os.environ.get; get_bool: unset -> default, else true unless one of
'', '0', 'false', 'no', 'off'). Reading an undeclared name raises, so
every knob stays listed in one place.
"""
import dataclasses
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
