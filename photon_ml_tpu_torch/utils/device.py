"""Device selection and the card's identity.

The port's entry points take an explicit ``device``. ``None`` means the
CUDA card; without one they raise rather than run on the CPU, so a run
that meant to use the card never measures the CPU by accident. Tests and
CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_dir() -> str:
    """Where the port builds its native libraries and kernels: ``build/``
    at the root of the checkout (listed in ``.gitignore``)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", "photon_ml_tpu_torch")


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for card 0, or None when
    nvidia-smi is missing. Every timing is reported beside this line: a
    card set below its maximum power runs slower under load."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None
