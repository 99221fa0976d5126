"""Logging setup for the port (same format and SKYT_DEBUG /
SKYT_MINIMIZE_LOGGING controls as skypilot_tpu/utils/log_utils.py, under
its own 'skypilot_tpu_torch' root logger)."""
import logging
import sys

from skypilot_tpu_torch.utils import env

_FORMAT = '%(levelname).1s %(asctime)s %(name)s:%(lineno)d] %(message)s'
_DATE_FORMAT = '%m-%d %H:%M:%S'
_ROOT = 'skypilot_tpu_torch'

_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(_ROOT)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATE_FORMAT))
    root.addHandler(handler)
    if env.get_bool('SKYT_DEBUG'):
        root.setLevel(logging.DEBUG)
    elif env.get_bool('SKYT_MINIMIZE_LOGGING'):
        root.setLevel(logging.WARNING)
    else:
        root.setLevel(logging.INFO)
    root.propagate = False


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f'{_ROOT}.{name}'
    return logging.getLogger(name)
