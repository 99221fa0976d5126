"""Checkpoint/resume and the preemption-safe exit for training
(counterpart of skypilot_tpu/train/checkpoint.py).

PreemptionGuard is the JAX package's, with its own EXIT_CODE_PREEMPTED
(75, skypilot_tpu/runtime/job_lib.py:46): the managed-jobs controller
resumes a job that exits with it instead of counting a failure.

Checkpointer keeps Orbax's CheckpointManager contract on one device:
save every `save_interval_steps` (or when forced), keep the newest
`keep`, restore the latest or a given step. A save copies the train
state to host memory (the step, the model's and the optimizer's
state_dicts, the schedule's position and the accumulator), then writes
<dir>/<step>/state.pt on a background thread through a temporary
directory and a rename, so a step directory is complete or absent. wait()
blocks until the write has landed. Sharded state
(torch.distributed.checkpoint) is the parallelism slice's.
"""
import os
import shutil
import signal
import threading
from typing import Any, Optional

import torch

from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

EXIT_CODE_PREEMPTED = 75
STATE_FILE = 'state.pt'


class PreemptionGuard:
    """Preemption-safe exit for training loops.

    Spot preemption arrives as SIGTERM with a short grace window;
    operators use SIGINT/SIGTERM the same way. The handler only sets a
    flag — the step loop checks `requested` at each step boundary, saves
    a final checkpoint, waits for the write, and exits with
    EXIT_CODE_PREEMPTED.

    `immediate=True` covers the startup phase (building the model, the
    first kernel builds): the handler raises SystemExit(EXIT_CODE) on
    the spot, since nothing is mid-write yet. Call cooperative() when
    the step loop begins so checkpoint writes are never interrupted.

    Installing from a non-main thread is a no-op (signal.signal would
    raise); `requested` then just stays False.
    """

    EXIT_CODE = EXIT_CODE_PREEMPTED

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 immediate: bool = False) -> None:
        self._event = threading.Event()
        self._signum: Optional[int] = None
        self._immediate = immediate
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:   # not the main thread (tests)
                logger.warning(
                    'PreemptionGuard installed off the main thread; '
                    'signal %s will not be caught', sig)

    def restore(self) -> None:
        """Put back the handlers this guard replaced — for callers that
        invoke a training main() in-process (tests) and outlive it."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def cooperative(self) -> None:
        """Leave immediate-exit (startup) mode: from here on the
        handler only sets the flag and the step loop owns the exit."""
        self._immediate = False

    def _handle(self, signum, frame) -> None:
        del frame
        self._signum = signum
        self._event.set()
        if self._immediate:
            raise SystemExit(self.EXIT_CODE)

    @property
    def requested(self) -> bool:
        """True once SIGTERM/SIGINT arrived; the step loop should
        checkpoint and exit(EXIT_CODE)."""
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum


def _to_host(obj: Any) -> Any:
    """A copy of a (nested) state with every tensor in host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    """Step-numbered checkpoints of a train/trainer.py TrainState."""

    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval_steps: int = 100) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ----------------------------------------------------------- save/load
    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Start a save of `state` (a TrainState) as step `step`; returns
        True if one was started. Without force only every
        save_interval_steps-th step is saved; a step already saved is not
        saved again."""
        if not force and step % self.save_interval_steps:
            return False
        self.wait()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        host = _to_host(state.state_dict())
        self._writer = threading.Thread(target=self._write,
                                        args=(step, host),
                                        name='train-checkpoint', daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, host: Any) -> None:
        try:
            tmp = os.path.join(self.directory, f'.tmp-{step}-{os.getpid()}')
            os.makedirs(tmp, exist_ok=True)
            torch.save(host, os.path.join(tmp, STATE_FILE))
            os.rename(tmp, os.path.join(self.directory, str(step)))
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except Exception as e:  # pylint: disable=broad-except
            # Raised again by wait() on the training thread.
            self._error = e

    def restore(self, state: Any, step: Optional[int] = None) -> Optional[Any]:
        """Load step `step` (default: the latest) into `state` in place
        and return it; None if no checkpoint exists."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        sd = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                        map_location='cpu', weights_only=False)
        state.load_state_dict(sd)
        return state

    def all_steps(self):
        steps = [int(n) for n in os.listdir(self.directory) if n.isdigit()]
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the in-flight save has landed (call before exit);
        re-raises a failed write."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('checkpoint write failed') from err

    def close(self) -> None:
        self.wait()
