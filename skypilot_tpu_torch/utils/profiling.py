"""Step profiling and the MFU denominator for the port's trainer
(counterpart of skypilot_tpu/utils/profiling.py).

  * PEAK_FLOPS / peak_flops: dense bf16 peak of one card, keyed by the
    prefix of torch.cuda.get_device_name (the MFU denominator). A device
    not in the table has no peak: MFU is then not computed, never
    reported against a made-up number.
  * StepProfiler: a torch.profiler trace (host and CUDA activity) of
    steps [SKYT_PROFILE_START_STEP, + SKYT_PROFILE_NUM_STEPS) of a
    training loop, written as a Chrome trace under SKYT_PROFILE_DIR; a
    no-op unless SKYT_PROFILE_DIR is set.

FLOPs per step come from sft's analytic count (train/sft.py
analytic_flops: 6 * params + 12 * layers * dim * seq per token), not
from torch.utils.flop_counter: that counter sees aten operators only,
so the attention kernels launched through ctypes (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) would drop out of the count.
"""
import os
import time
from typing import Optional

import torch

from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

# Dense bf16 tensor-core peak per card (NVIDIA's data sheet, SXM part).
PEAK_FLOPS = {
    'NVIDIA H100': 989e12,
}


def peak_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one CUDA device, or None for the CPU and
    for cards not in PEAK_FLOPS."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    name = torch.cuda.get_device_name(dev)
    for prefix, flops in PEAK_FLOPS.items():
        if name.startswith(prefix):
            return flops
    return None


class StepProfiler:
    """Profiles steps [start, start + num) of a training loop."""

    def __init__(self, trace_dir: Optional[str] = None) -> None:
        self.trace_dir = trace_dir or env.get('SKYT_PROFILE_DIR')
        self.start_step = env.get_int('SKYT_PROFILE_START_STEP', 2)
        self.num_steps = env.get_int('SKYT_PROFILE_NUM_STEPS', 3, minimum=1)
        self._prof = None
        self._done = False

    @property
    def enabled(self) -> bool:
        return self.trace_dir is not None

    def on_step(self, step: int) -> None:
        """Call at the top of every step with a 0-based loop index."""
        if not self.enabled or self._done:
            return
        if self._prof is not None and \
                step >= self.start_step + self.num_steps:
            self.stop()
        elif self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                os.makedirs(self.trace_dir, exist_ok=True)
                self._prof = torch.profiler.profile(activities=activities)
                self._prof.__enter__()
            except Exception as e:  # pylint: disable=broad-except
                # An unwritable profile dir costs the profile, not the
                # training job.
                self._prof = None
                self._done = True
                logger.warning('step-window profile failed to start '
                               '(%r); continuing unprofiled', e)
                return
            logger.info('profiling steps %d..%d -> %s', step,
                        step + self.num_steps - 1, self.trace_dir)

    def stop(self) -> None:
        """Idempotent; call after the loop in case it ended mid-trace."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            # The profiled steps' device work belongs in the trace.
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        stamp = int(time.time())
        path = os.path.join(self.trace_dir, f'train_steps_{stamp}.json')
        self._prof.export_chrome_trace(path)
        # Device time by kernel over the window, also as text beside the
        # trace: where a step's device time goes.
        table = self._prof.key_averages().table(
            sort_by='self_device_time_total', row_limit=25)
        with open(os.path.join(self.trace_dir,
                               f'train_steps_{stamp}.txt'), 'w') as f:
            f.write(table)
        self._prof = None
        self._done = True
        logger.info('profile trace written to %s; device time by kernel '
                    'over %d steps:\n%s', path, self.num_steps, table)
