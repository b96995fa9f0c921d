"""The yardstick's peaks and the least time of each operation the cells
count, from the inputs' own sizes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores.

A sparse pass over a matrix of ``nnz`` nonzeros (``chip_smoke.py:735``
``pass_bound_ms``, recounted over the data's nonzeros instead of the
schedule's held entries, so a change of layout cannot move it) reads each
nonzero's value, row index and column index once (12 bytes), each of its
``members`` source vectors once and writes each output once, in float32:
``12 nnz + 4 members (n_src + n_out)`` bytes, against ``2 members nnz``
flops. The least time is the larger of bytes over the HBM rate and flops
over the float32 rate; at these shapes it is always the bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def pass_bytes(nnz: int, n_src: int, n_out: int, members: int = 1) -> int:
    return 12 * nnz + 4 * members * (n_src + n_out)


def pass_flops(nnz: int, members: int = 1) -> int:
    return 2 * members * nnz


def least_s(nbytes: float, flops: float) -> float:
    """The least time for work of ``nbytes`` and ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def pass_least_s(nnz: int, n_src: int, n_out: int, members: int = 1) -> float:
    """The least time of one sparse pass (module note)."""
    return least_s(pass_bytes(nnz, n_src, n_out, members), pass_flops(nnz, members))


def evaluation_least_s(nnz: int, rows: int, features: int, members: int = 1) -> float:
    """One value-and-gradient evaluation of a GLM: the margins pass
    (features to rows) and the gradient pass (rows to features)."""
    return pass_least_s(nnz, features, rows, members) + pass_least_s(nnz, rows, features, members)


def share_percent(least: float, took: float):
    """``least`` over ``took`` in percent, or None when nothing ran."""
    if took <= 0:
        return None
    return 100.0 * least / took
