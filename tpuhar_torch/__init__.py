"""tpuhar_torch — the PyTorch/CUDA port of ``tpuhar`` for NVIDIA Hopper (H100).

Serving slice: the flagship bf16 IMU+video fusion forward (``entry.build_forward``).
Plain tensor code is PyTorch; the two kernels on its path are written by hand for
``sm_90a`` in ``csrc/`` (the fused window featurizer and the fused 3x3 conv), each
with its plain PyTorch version beside it. Module names mirror ``tpuhar/``. The port
imports no JAX; from the JAX package it reads only ``tpuhar.config``, which is
stdlib-only.
"""

__version__ = "0.1.0"
