"""photon-ml-tpu-torch: the PyTorch/CUDA port of ``photon_ml_tpu``.

The package mirrors the JAX package module by module (``ops/``,
``optim/``, ``data/``, ``models/``, ``evaluation/``), so every file has one
counterpart there, which is the reference it is tested against. It imports
``torch`` only: never ``jax`` and nothing of ``photon_ml_tpu``.

Plain tensor code is PyTorch. The one TPU kernel on the sparse GLM training
path, the tiled bilinear pass, is a CUDA kernel written for Hopper
(``ops/csrc/bilinear_pass.cu``), built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from photon_ml_tpu_torch.task import TaskType

__version__ = "0.1.0"
__all__ = ["TaskType", "__version__"]
