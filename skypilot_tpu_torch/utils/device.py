"""Device resolution for the port's entry points.

The port serves on the card: an entry point given no device runs on
'cuda', and raises where there is none. The CPU is used only when the
caller names it (the CPU parity tests do), never as a silent fallback.
"""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> 'cuda' (raises without a CUDA device); 'cpu' -> the CPU;
    any CUDA device string -> that device (raises without CUDA)."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'on the CPU explicitly')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev
