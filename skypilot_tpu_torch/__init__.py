"""skypilot_tpu_torch: the PyTorch/CUDA port of skypilot_tpu's compute plane.

The JAX package (skypilot_tpu/) is the reference; this package mirrors its
paths (skypilot_tpu_torch/models/llama.py is held against
skypilot_tpu/models/llama.py) and runs on an NVIDIA H100. Plain tensor
code is PyTorch; every kernel the JAX package writes in Pallas is a CUDA
C++ kernel under csrc/, built with nvcc at first use (ops/_build.py).

Entry points run on 'cuda' unless the caller passes device='cpu'; with no
CUDA device and no explicit 'cpu' they raise (utils/device.py).

The package imports torch and numpy only — never jax, flax or anything of
skypilot_tpu.
"""

__version__ = '0.1.0'
