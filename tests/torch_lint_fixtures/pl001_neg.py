"""PL001 (torch) negatives: host values the rule must not flag (numpy,
Python numbers, tensor metadata, torch's host calls) and fetches through
the counted seam."""

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.parallel import overlap


def numpy_lists(a: np.ndarray):
    return a.tolist(), np.asarray(a).sum().item()  # numpy, not torch


def python_numbers(x):
    return float(x), int(len(x)), bool(x)  # nothing says x is a tensor


def metadata(t: torch.Tensor):
    return int(t.shape[0]), int(t.numel()), int(t.size(0)), int(t.dim())


def host_calls(t):
    return (int(torch.cuda.device_count()), int(dist.get_rank()),
            bool(torch.is_tensor(t)), bool(torch.cuda.is_available()))


def through_the_seam(t: torch.Tensor):
    host = overlap.device_get(t)
    return host.tolist(), float(host.sum())


def after_the_fetch(t: torch.Tensor):
    values = overlap.device_get(t)
    return values.numpy() if hasattr(values, "numpy") else values
