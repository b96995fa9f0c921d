"""Shared set-up of the benchmark's own tests: the harness's directory and
the checkout's root on ``sys.path``, as ``benchmark/run.py`` has them, and
the card fixture (decided inside it, never while a module is imported)."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return "cuda"
