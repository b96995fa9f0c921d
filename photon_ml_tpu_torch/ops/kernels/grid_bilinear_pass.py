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
the schedule and the values are the same for every member. With
``spill=True`` each member's spill remainder is added too, as K1 adds it
(on the card in the same launch, the spill read once for a tile of
members).

What bounds it on the H100: bytes. The schedule (12 bytes per entry) is
the dominant traffic: at the ads shape with G = 4 the least traffic is
~222 MB, ~0.066 ms at 3.35 TB/s; that is a bound, not a measurement
(``PERF.md`` has the measured times). The kernel loads each entry once for
a tile of members; ``members_per_cta`` cuts the bank into as many tiles as
still run in one wave (their walks over the schedule then share it in L2,
and each CTA gathers from fewer source windows), so a bank of 4 is four
tiles of one on the ads shape's z-pass (32 output blocks) and one tile of
4 on its g-pass (128). The CTAs follow K1's work plan
(``bilinear_pass.plan_work``): one per work item and member tile, as many
as the card holds at once.

On a CUDA tensor :func:`grid_bilinear_pass` launches the kernel (built
with ``nvcc`` for ``sm_90a`` at first use) or raises; only a CPU tensor
takes the plain version. ``launches`` counts kernel launches,
``spill_launches`` those that folded a spill remainder in.

Determinism: K1's fixed order of additions (``bilinear_pass``'s note), for
every member: the same schedule and bank give the same bits on every launch
(fixed per card model). Against the plain version it agrees to f32 rounding
(checked at 1e-5 of the output's scale).
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops.kernels.bilinear_pass import (
    GATHERED,
    MAX_SHARED_BYTES,
    LaunchConfig,
    check_cuda_operands,
    check_operands,
    make_plan,
    scratch_for,
    sm_count,
    spill_operands,
    spill_pointers,
    vector_loads,
)
from photon_ml_tpu_torch.ops.kernels.cuda_build import (
    load_kernel_library,
    timed_build,
)

Tensor = torch.Tensor

# Kernel launches on the CUDA path, and those of them that folded a
# spill remainder in (a run sets them to 0 and reads them).
launches = 0
spill_launches = 0

# Members one CTA serves, at most (the kernel's instantiations, 1..7).
MAX_MEMBERS_PER_CTA = 7


def members_per_cta(num_members: int, window: int, num_out_blocks: int, slots: int) -> int:
    """GT, members per CTA. Each member tile is one more CTA per work item
    and one more walk over the schedule (mostly from L2 when the tiles run
    at once), but a smaller tile gathers from fewer source windows, which
    must stay in L1, and adds fewer members per entry. So the bank is cut
    into as many tiles as still run in one wave beside at least one work
    item per output block (``slots // num_out_blocks``, with ``slots`` the
    card's resident CTAs), and into no fewer than its accumulators ``[GT,
    W]`` need to fit a CTA's shared memory (at most 7 members); the tiles
    are balanced (all of GT members but the last)."""
    cap = min(MAX_MEMBERS_PER_CTA, MAX_SHARED_BYTES // (4 * window))
    if cap < 1:
        raise ValueError(f"grid_bilinear_pass: window {window} exceeds shared memory")
    n_tiles = max(-(-num_members // cap), min(num_members, slots // max(num_out_blocks, 1)))
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
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None,
    spill: bool = False, spill_vals: Tensor = None,
) -> Tensor:
    """Apply a schedule to every row of the bank ``src`` [G, n_in * W];
    -> [G, num_out_blocks * W].

    ``sched``, ``vals``, ``spill``, ``spill_vals``, ``num_out_blocks`` and
    ``window`` as for K1's ``bilinear_pass``; the kernel reads and adds
    unchecked."""
    v = check_operands("grid_bilinear_pass", sched, num_out_blocks, window, vals)
    n_in = sched.num_in_blocks * window
    if src.dim() != 2 or src.shape[0] < 1 or src.shape[1] != n_in:
        raise ValueError(
            f"grid_bilinear_pass: src must be a bank [G >= 1, "
            f"{sched.num_in_blocks} * {window}], got {tuple(src.shape)}"
        )
    if src.device.type == "cpu":
        out = grid_bilinear_pass_plain(sched, src, num_out_blocks, window, vals)
        return sched.apply_spill(out, src, vals=spill_vals) if spill else out
    if src.device.type != "cuda":
        raise ValueError(f"grid_bilinear_pass: unsupported device {src.device}")
    return launch(sched, src, num_out_blocks, window, v,
                  spill_operands(sched, spill_vals) if spill else None)


# Threads per CTA of K2 (the kernel's kThreads).
THREADS = 1024

_occupancy: dict = {}  # (gt, window, vec) -> CTAs per SM


def ctas_per_sm(gt: int, window: int, vec: bool) -> int:
    """Resident CTAs of K2 on one SM for ``gt`` members at this window
    (the CUDA occupancy calculator, asked once per configuration)."""
    key = (gt, window, bool(vec))
    if key not in _occupancy:
        n = ctypes.c_int()
        _call(0, 0, None, 0, None, None, None, None, None, None, 0, None, 0,
              None, 0, window, gt, gt, int(vec), *spill_pointers(None), n, None)
        _occupancy[key] = n.value
    return _occupancy[key]


def launch_config(sched, v: Tensor, device: torch.device, num_members: int) -> LaunchConfig:
    """The launch of a pass over a bank of ``num_members`` with values
    ``v``: 16-byte entry loads where the entry arrays allow them, member
    tiles of ``members_per_cta``, windows read through L1 (whatever the
    order of the gathers). Made once per schedule, bank size and load
    width, and cached on the schedule beside its plans."""
    vec = vector_loads(sched, v)
    key = ("k2", num_members, vec)
    cfg = sched.plans.get(key)
    if cfg is None:
        slots = sm_count(device) * ctas_per_sm(1, sched.window, vec)
        gt = members_per_cta(num_members, sched.window, sched.num_out_blocks, slots)
        cfg = sched.plans[key] = tile_config(sched, device, num_members, gt, vec)
    return cfg


def tile_config(
    sched, device: torch.device, num_members: int, gt: int, vec: bool
) -> LaunchConfig:
    """The launch of a bank of ``num_members`` in tiles of ``gt``: each
    work item runs once per tile, so the plan targets the card's resident
    CTA slots over the tiles."""
    n_tiles = -(-num_members // gt)
    per_sm = ctas_per_sm(gt, sched.window, vec)
    plan = make_plan(sched, max(1, sm_count(device) * per_sm // n_tiles))
    return LaunchConfig(plan, per_sm, vec, GATHERED, THREADS, gt, n_tiles)


def launch(
    sched, src: Tensor, num_out_blocks: int, window: int, v: Tensor, spill=None
) -> Tensor:
    """The CUDA launch behind :func:`grid_bilinear_pass`; ``spill`` as for
    K1's ``launch``."""
    check_cuda_operands("grid_bilinear_pass", sched, v, src)
    cfg = launch_config(sched, v, src.device, src.shape[0])
    return launch_with(cfg, sched, src, num_out_blocks, window, v, spill)


def launch_with(
    cfg: LaunchConfig, sched, src: Tensor, num_out_blocks: int, window: int, v: Tensor,
    spill=None,
) -> Tensor:
    """Launch K2 over ``sched`` as ``cfg`` says (:func:`launch` passes
    :func:`launch_config`'s; ``tools/pass_ablation.py`` times others) on
    operands :func:`launch` has checked, the spill remainder folded in
    where ``spill`` is given; -> the output bank."""
    global launches, spill_launches
    G = src.shape[0]
    n_in = sched.num_in_blocks * window
    n_out = num_out_blocks * window
    out = torch.empty(G, n_out, dtype=torch.float32, device=src.device)
    scratch = scratch_for(cfg.plan, G, window, src.device)
    n = ctypes.c_int()
    _call(
        cfg.plan.items.data_ptr(), cfg.plan.num_items,
        cfg.plan.shared.data_ptr(), cfg.plan.num_shared, scratch.data_ptr(),
        sched.step_in.data_ptr(),
        sched.step_sizes.data_ptr(), sched.in_pos.data_ptr(),
        sched.out_pos.data_ptr(), v.data_ptr(), sched.in_pos.shape[1],
        src.data_ptr(), n_in, out.data_ptr(), n_out, window, G,
        cfg.members_per_cta, int(cfg.vec), *spill_pointers(spill), n,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    launches += 1
    spill_launches += spill is not None
    return out


def _call(*args) -> None:
    lib = _kernel_lib()
    rc = lib.photon_grid_bilinear_pass(*args[:-2], ctypes.byref(args[-2]), args[-1])
    if rc != 0:
        msg = lib.photon_grid_cuda_error_string(rc).decode()
        raise RuntimeError(f"grid_bilinear_pass launch failed: {msg} ({rc})")


def _declare(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    i64 = ctypes.c_int64
    lib.photon_grid_bilinear_pass.restype = i
    lib.photon_grid_bilinear_pass.argtypes = [
        p, i, p, i, p, p, p, p, p, p, i, p, i64, p, i64, i, i, i, i,
        p, p, p, p, ctypes.POINTER(i), p,
    ]
    lib.photon_grid_cuda_error_string.restype = ctypes.c_char_p
    lib.photon_grid_cuda_error_string.argtypes = [i]


def _kernel_lib():
    return load_kernel_library("grid_bilinear_pass.cu", _declare)


def build_kernel() -> float:
    """Compile the kernel (if its library is older than its sources) and
    load it; -> seconds spent. Raises when ``nvcc`` fails."""
    return timed_build(_kernel_lib)
