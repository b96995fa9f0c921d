"""K2, the grid-batched bilinear pass: CUDA kernel wrapper and plain version.

Replaces ``photon_ml_tpu/ops/tiled_sparse.py::_grid_bilinear_pass``, which
the ``custom_vmap`` rule of ``_bilinear_pass_auto`` swaps in when the
optimizers run over a ``[G, d]`` coefficient bank (the batched λ-grid). It
is K1's function (``ops/kernels/bilinear_pass.py``) for G source rows at
once, over one shared schedule:

    out[g, step_out[s] * W + out_pos[s, e]] +=
        vals[s, e] * src[g, step_in[s] * W + in_pos[s, e]]

``src`` is a ``[G, num_in_blocks * W]`` bank and the result a
``[G, num_out_blocks * W]`` bank. Only the source carries the member axis:
the schedule and the values are the same for every member. The spill
remainder is not part of it (``_Schedule.apply_spill`` adds it after).

What bounds it on the H100: bytes. The schedule (12 bytes per entry) is
the dominant traffic, and the kernel reads each entry once for a tile of
members (``members_per_cta``), not once per member. At the ads shape with
G = 4 the least traffic is ~222 MB, ~0.066 ms at 3.35 TB/s; that is a
bound, not a measurement (``PERF.md`` has the measured times). Its
gathers and shared atomics are latency-bound, so the launch favours
occupancy over reuse (two CTAs per SM, see ``members_per_cta``).

On a CUDA tensor :func:`grid_bilinear_pass` launches the kernel (built
with ``nvcc`` for ``sm_90a`` at first use) or raises; only a CPU tensor
takes the plain version. ``launches`` counts kernel launches.

Tolerance: float atomics, as K1; against the plain version it agrees to
f32 rounding (checked at 1e-5 of the output's scale).
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops.kernels.bilinear_pass import (
    MAX_SHARED_BYTES,
    check_cuda_operands,
    check_operands,
)
from photon_ml_tpu_torch.ops.kernels.cuda_build import (
    load_kernel_library,
    timed_build,
)

Tensor = torch.Tensor

# Kernel launches on the CUDA path (a run sets it to 0 and reads it).
launches = 0

# Members one CTA serves, at most (kMaxGT in the .cu source).
MAX_MEMBERS_PER_CTA = 8


def members_per_cta(num_members: int, window: int) -> int:
    """GT: as many members as fit in a shared-memory accumulator
    ``[GT, W]`` of half the opt-in (two CTAs per SM; at most 8), balanced
    so the tiles differ by at most one."""
    cap = min(MAX_MEMBERS_PER_CTA, MAX_SHARED_BYTES // 2 // (4 * window))
    if cap < 1:
        raise ValueError(f"grid_bilinear_pass: window {window} exceeds shared memory")
    n_tiles = -(-num_members // cap)
    return -(-num_members // n_tiles)


def grid_bilinear_pass_plain(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None
) -> Tensor:
    """The same function in plain PyTorch, the reference's formula: one
    flat ``index_select`` of the ``[n_in * W, G]`` source times the values,
    then ``index_add_`` over ``step * W + pos``, with G on the trailing
    axis."""
    S = sched.step_out.shape[0]
    v = (sched.vals if vals is None else vals)[:S].reshape(-1)
    flat_in = (sched.step_in[:, None].long() * window + sched.in_pos[:S]).reshape(-1)
    flat_out = (sched.step_out[:, None].long() * window + sched.out_pos[:S]).reshape(-1)
    contrib = v[:, None] * src.T.index_select(0, flat_in)
    out = torch.zeros(
        num_out_blocks * window, src.shape[0], dtype=src.dtype, device=src.device
    )
    return out.index_add_(0, flat_out, contrib).T.contiguous()


def grid_bilinear_pass(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None
) -> Tensor:
    """Apply a schedule to every row of the bank ``src`` [G, n_in * W];
    -> [G, num_out_blocks * W].

    ``sched``, ``vals``, ``num_out_blocks`` and ``window`` as for K1's
    ``bilinear_pass``; the kernel reads and adds unchecked."""
    global launches
    v = check_operands("grid_bilinear_pass", sched, num_out_blocks, window, vals)
    n_in = sched.num_in_blocks * window
    if src.dim() != 2 or src.shape[0] < 1 or src.shape[1] != n_in:
        raise ValueError(
            f"grid_bilinear_pass: src must be a bank [G >= 1, "
            f"{sched.num_in_blocks} * {window}], got {tuple(src.shape)}"
        )
    if src.device.type == "cpu":
        return grid_bilinear_pass_plain(sched, src, num_out_blocks, window, vals)
    if src.device.type != "cuda":
        raise ValueError(f"grid_bilinear_pass: unsupported device {src.device}")
    check_cuda_operands("grid_bilinear_pass", sched, v, src)
    G = src.shape[0]
    n_out = num_out_blocks * window
    out = torch.zeros(G, n_out, dtype=torch.float32, device=src.device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.photon_grid_bilinear_pass(
        sched.segments.data_ptr(), sched.segments.shape[0],
        sched.step_in.data_ptr(), sched.in_pos.data_ptr(),
        sched.out_pos.data_ptr(), v.data_ptr(), sched.in_pos.shape[1],
        src.data_ptr(), n_in, out.data_ptr(), n_out,
        window, G, members_per_cta(G, window), stream,
    )
    if rc != 0:
        msg = lib.photon_grid_cuda_error_string(rc).decode()
        raise RuntimeError(f"grid_bilinear_pass launch failed: {msg} ({rc})")
    launches += 1
    return out


def _declare(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    i64 = ctypes.c_int64
    lib.photon_grid_bilinear_pass.restype = i
    lib.photon_grid_bilinear_pass.argtypes = [
        p, i, p, p, p, p, i, p, i64, p, i64, i, i, i, p,
    ]
    lib.photon_grid_cuda_error_string.restype = ctypes.c_char_p
    lib.photon_grid_cuda_error_string.argtypes = [i]


def _kernel_lib():
    return load_kernel_library("grid_bilinear_pass.cu", _declare)


def build_kernel() -> float:
    """Compile the kernel (if its library is older than its source) and
    load it; -> seconds spent. Raises when ``nvcc`` fails."""
    return timed_build(_kernel_lib)
