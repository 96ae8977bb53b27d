"""PyTorch + CUDA port of ``visionworkbench_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: each module here keeps
its name and public signatures and is tested against it on the CPU
(``tests/test_torch_*.py``). This package imports ``torch`` and ``numpy``
only, never ``jax`` and nothing of ``visionworkbench_tpu``.

Conventions:

* Compute is fp32 with int32 disparity codes, as in the JAX package.
* TF32 is off for matmuls and cuDNN (set below, at import), so every fp32
  product on the card is a full fp32 product.
* Entry points take ``device=None``, which means ``cuda``; they raise when
  no card is present. Tests pass ``device="cpu"``.
* Each hand-written CUDA kernel (``csrc/``) has a plain PyTorch version in
  the same module. A wrapper runs the plain version only for tensors on the
  CPU; for a CUDA tensor it launches its kernel or raises.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from visionworkbench_torch.version import __version__  # noqa: E402,F401
