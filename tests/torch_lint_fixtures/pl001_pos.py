"""PL001 (torch) positives: one hidden device->host sync a line, each
outside the counted overlap seam."""

import torch
from torch import Tensor


def raw_copy(t):
    return t.cpu()  # 1: .cpu() wherever it is called


def scalar_of(t: Tensor) -> float:
    return t.sum().item()  # 2: .item() on a tensor method's result


def listed(n):
    z = torch.zeros(n)
    return z.tolist()  # 3: .tolist() on a torch.* result


def as_numpy(x: torch.Tensor):
    y = x * 2
    return y.numpy()  # 4: .numpy() on a tensor derived from a parameter


def cast(x: Tensor):
    return float(x.max())  # 5: float() of a tensor


def branch(x: Tensor) -> bool:
    return bool((x > 0).any())  # 6: bool() of a tensor comparison


def count(x: Tensor) -> int:
    nz = torch.count_nonzero(x)
    return int(nz)  # 7: int() of a torch.* result
