"""Model coefficients: means + optional per-coefficient variances.

Port of ``photon_ml_tpu/models/coefficients.py`` (reference: photon-ml
.../model/Coefficients.scala:33).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class Coefficients:
    means: Tensor  # [d]
    variances: Optional[Tensor] = None  # [d] or None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]
