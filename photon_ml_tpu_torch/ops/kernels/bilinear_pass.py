"""K1, the tiled bilinear pass: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel ``photon_ml_tpu/ops/tiled_sparse.py``
(``_bilinear_pass_kernel``, launched by ``_run_bilinear_pass``). One
function serves the z-pass ``X . w``, the g-pass ``X^T . c`` and the
Hessian-diagonal g-pass over squared values:

    out[step_out[s] * W + out_pos[s, e]] +=
        vals[s, e] * src[step_in[s] * W + in_pos[s, e]]

over the ``G`` steps of a schedule (entry rows past ``G`` are padding) and
the ``L`` entries of each step, with ``W`` the window. ``src`` and the
result are flat padded vectors. The spill remainder is not part of it
(``_Schedule.apply_spill`` adds it after).

What bounds it on the H100: bytes. Each entry is read once as 12 bytes
(``in_pos``, ``out_pos``, ``val``): ~200 MB per pass at the ads shape
(16.7M entries), so ~60 us at 3.35 TB/s is the least it could take. That
is a bound, not a measurement; ``PERF.md`` has the measured times. The
design keeps the gathered source window and the output window on chip
(L2 and shared memory); ``ops/csrc/bilinear_pass.cu`` says how.

On a CUDA tensor :func:`bilinear_pass` launches the kernel (built with
``nvcc`` for ``sm_90a`` at first use) or raises; only a CPU tensor takes
the plain version. ``launches`` counts kernel launches.

Tolerance: the kernel sums with float atomics, so the order of additions
changes from run to run; against the plain version it agrees to f32
rounding (relative error ~1e-7 of the output's scale, checked at 1e-5).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from photon_ml_tpu_torch.ops.kernels.cuda_build import (
    load_kernel_library,
    timed_build,
)

Tensor = torch.Tensor

# Kernel launches on the CUDA path (a run sets it to 0 and reads it).
launches = 0

# Steps of one output block given to one CTA (see the .cu source note).
STEPS_PER_CTA = 8

MAX_SHARED_BYTES = 227 * 1024  # the H100's opt-in per CTA


def plan_segments(step_out: np.ndarray, steps_per_cta: int = STEPS_PER_CTA) -> np.ndarray:
    """CTA work table [n_seg, 3] int32: (output block, first step, end
    step). Each output block's consecutive run of steps is cut into
    segments of at most ``steps_per_cta`` steps."""
    step_out = np.asarray(step_out)
    G = step_out.shape[0]
    if G == 0:
        return np.zeros((0, 3), np.int32)
    idx = np.arange(G)
    new_block = np.ones(G, bool)
    new_block[1:] = step_out[1:] != step_out[:-1]
    run_start = np.maximum.accumulate(np.where(new_block, idx, 0))
    heads = np.nonzero(new_block | ((idx - run_start) % steps_per_cta == 0))[0]
    ends = np.append(heads[1:], G)
    return np.stack([step_out[heads], heads, ends], axis=1).astype(np.int32)


def bilinear_pass_plain(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None
) -> Tensor:
    """The same function in plain PyTorch: one flat ``index_select`` times
    the values, then ``index_add_`` over ``step * W + pos`` (the reference's
    grid pass with one source column)."""
    G = sched.step_out.shape[0]
    v = (sched.vals if vals is None else vals)[:G].reshape(-1)
    flat_in = (
        sched.step_in[:, None].long() * window + sched.in_pos[:G]
    ).reshape(-1)
    flat_out = (
        sched.step_out[:, None].long() * window + sched.out_pos[:G]
    ).reshape(-1)
    out = torch.zeros(num_out_blocks * window, dtype=src.dtype, device=src.device)
    return out.index_add_(0, flat_out, v * src.index_select(0, flat_in))


def check_operands(kernel: str, sched, num_out_blocks: int, window: int, vals):
    """Checks a pass makes before its kernel reads ``sched`` unchecked:
    ``num_out_blocks`` and ``window`` are those the schedule's indices were
    checked against, and the entry arrays share one shape. -> the values."""
    if window != sched.window or num_out_blocks != sched.num_out_blocks:
        raise ValueError(
            f"{kernel}: window {window} and {num_out_blocks} output "
            f"blocks, but the schedule was checked for window {sched.window} "
            f"and {sched.num_out_blocks} output blocks"
        )
    v = sched.vals if vals is None else vals
    if v.shape != sched.in_pos.shape or sched.out_pos.shape != sched.in_pos.shape:
        raise ValueError(f"{kernel}: entry arrays differ in shape")
    return v


def check_cuda_operands(kernel: str, sched, v: Tensor, src: Tensor) -> None:
    """Device, type and contiguity of what a CUDA pass hands the kernel."""
    tensors = {
        "segments": (sched.segments, torch.int32),
        "step_in": (sched.step_in, torch.int32),
        "in_pos": (sched.in_pos, torch.int32),
        "out_pos": (sched.out_pos, torch.int32),
        "vals": (v, torch.float32),
        "src": (src, torch.float32),
    }
    for name, (t, dtype) in tensors.items():
        if t.device != src.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, src on {src.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if sched.segments.dim() != 2 or sched.segments.shape[1] != 3:
        raise ValueError(f"{kernel}: segments must be [n_seg, 3]")


def bilinear_pass(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None
) -> Tensor:
    """Apply a schedule to the flat ``src``; -> flat [num_out_blocks * W].

    ``sched`` is a ``_Schedule`` of ``ops/tiled_sparse.py``; ``vals``
    overrides its entry values (the Hessian diagonal squares them).
    ``src``, ``num_out_blocks`` and ``window`` must be those the schedule's
    indices were checked against: the kernel reads and adds unchecked."""
    v = check_operands("bilinear_pass", sched, num_out_blocks, window, vals)
    if src.dim() != 1 or src.shape[0] != sched.num_in_blocks * window:
        raise ValueError(
            f"bilinear_pass: src must be flat [{sched.num_in_blocks} * "
            f"{window}], got {tuple(src.shape)}"
        )
    if src.device.type == "cpu":
        return bilinear_pass_plain(sched, src, num_out_blocks, window, vals)
    if src.device.type != "cuda":
        raise ValueError(f"bilinear_pass: unsupported device {src.device}")
    return _launch(sched, src, num_out_blocks, window, v)


def _launch(sched, src: Tensor, num_out_blocks: int, window: int, v: Tensor) -> Tensor:
    global launches
    check_cuda_operands("bilinear_pass", sched, v, src)
    if window * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"bilinear_pass: window {window} exceeds shared memory")
    lib = _kernel_lib()
    out = torch.zeros(num_out_blocks * window, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.photon_bilinear_pass(
        sched.segments.data_ptr(), sched.segments.shape[0],
        sched.step_in.data_ptr(), sched.in_pos.data_ptr(),
        sched.out_pos.data_ptr(), v.data_ptr(), sched.in_pos.shape[1],
        src.data_ptr(), out.data_ptr(), window, stream,
    )
    if rc != 0:
        msg = lib.photon_cuda_error_string(rc).decode()
        raise RuntimeError(f"bilinear_pass launch failed: {msg} ({rc})")
    launches += 1
    return out


def _declare(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.photon_bilinear_pass.restype = i
    lib.photon_bilinear_pass.argtypes = [p, i, p, p, p, p, i, p, p, i, p]
    lib.photon_cuda_error_string.restype = ctypes.c_char_p
    lib.photon_cuda_error_string.argtypes = [i]


def _kernel_lib():
    return load_kernel_library("bilinear_pass.cu", _declare)


def build_kernel() -> float:
    """Compile the kernel (if its library is older than its source) and
    load it; -> seconds spent. Raises when ``nvcc`` fails."""
    return timed_build(_kernel_lib)
