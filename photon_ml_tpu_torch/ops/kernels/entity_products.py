"""K4, the per-entity products in a fixed order of additions: CUDA kernel
wrapper and plain version.

Replaces no Pallas kernel: the JAX package leaves these products to XLA
(the einsums of ``photon_ml_tpu/game/random_effect.py``'s
``solve_dense_newton`` and dense per-entity objective, and the member-wise
sums of its vmapped optimizers). On the card the port ran them on
``torch.bmm`` and ``.sum(dim=-1)``, whose order of additions follows the
whole batch's shape, so an entity rounded otherwise in a bucket than in a
padded shard block of other size. Here every output sums its own row in
``data/batch.py`` ``row_sum``'s order, which depends on the row's length
alone (``csrc/entity_products.cu`` says how):

- :func:`row_dot` ``(a, b)``: ``row_sum(a * b)`` over the last axis (``b``
  may be None: ``row_sum(a)``); the optimizers' member-wise dots, norms and
  sums, the per-entity objective values and margins, the RE scores; with
  :func:`row_norm` (``sqrt`` of ``row_sum(a * a)``, reading ``a`` once) and
  :func:`row_dots` (up to 8 pairs of one shape) by a kernel of its own, one
  launch a call at any row length (:func:`row_plan`);
- :func:`bmv` ``(A, x)``: ``A [E, m, n] @ x [E, n] -> [E, m]`` for any
  strides of ``A`` (``X``, ``X^T`` as a view, ``G``);
- :func:`gram` ``(X)``: ``X X^T`` ``[E, S, S]``, by a kernel of its own
  that stages each entity's ``X`` in shared memory and computes the
  entries ``i <= j`` once (:func:`gram_plan`).

On a CUDA tensor each launches the kernel (built with ``nvcc`` for
``sm_90a`` at first use) or raises; only a CPU tensor takes the plain
version, the same function in PyTorch's own operators (``torch.bmm``,
``.sum(dim=-1)``, ``vector_norm``): on the CPU these already give an
entity the same bits in a batch of any size (``tests/
test_torch_entity_order.py`` holds them to it), and they keep the CPU's
results, and the port's tolerances against the JAX package, as they were.
The kernel's order itself is ``row_sum``'s, written out in plain PyTorch
as the ``*_ordered`` functions: the kernel gives their bits (each product
rounded once, the same tree of adds; ``chip_smoke.py`` holds it to them on
the card, and the tests hold :func:`launch_plan`'s and :func:`row_plan`'s
trees to ``row_sum`` on the CPU). ``launches`` counts kernel launches, and
``launches_by`` the same launches by wrapper (``gram``, ``bmv``,
``row_dot``; :func:`row_norm` and :func:`row_dots` count as ``row_dot``).

What bounds it on the H100: bytes (PERF.md has the measured times beside
the bound).
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.data.batch import row_sum
from photon_ml_tpu_torch.ops.kernels.cuda_build import (
    load_kernel_library,
    timed_build,
)

Tensor = torch.Tensor

# Kernel launches on the CUDA path (a run sets them to 0 with
# reset_launches() and reads them): in all, and by wrapper.
launches = 0
launches_by = {"gram": 0, "bmv": 0, "row_dot": 0}

_LEAVES = 16  # leaves a thread sums serially (the kernel's kLeaves)
_WARP_ROWS = 512  # widest padded row one warp (or less) serves
_GROUP_ROWS = _LEAVES * 1024  # widest padded row one CTA serves
_GRAM_SMEM = 200 * 1024  # most shared memory the Gram kernel stages
_PLAIN_CHUNK = 1 << 22  # products a plain Gram materializes at once
_DTYPES = {torch.float32: 0, torch.float64: 1}
ROW_THREADS = 256  # threads per CTA of the row kernel (its kRowThreads)
ROW_WARPS = ROW_THREADS // 32
ROW_FANIN = ROW_WARPS * _LEAVES  # a long row's items merged per ticket (its kFanin)
MAX_PAIRS = 8  # pairs one row launch takes (its kMaxPairs)
# what a row launch reduces (the kernel's RowMode): a's sum, a * b's, and
# the sqrt of a * a's
SUM, DOT, NORM = 0, 1, 2
_ROW_SCRATCH_SHAPES = 16  # long-row scratch shapes kept on each device


def padded_width(k: int) -> int:
    """``row_sum``'s padded width: the next power of two of ``k`` (1 for 0)."""
    return 1 << max(k - 1, 0).bit_length()


def reset_launches() -> None:
    global launches
    launches = 0
    for kind in launches_by:
        launches_by[kind] = 0


@functools.lru_cache(maxsize=None)
def launch_plan(k: int) -> Tuple[Tuple[int, int, bool], ...]:
    """The launches that reduce a row of ``k``: (threads per output P,
    leaves per thread M, partial) for each, in order. Every plan follows
    the same tree, so the choice changes the time and never the bits."""
    w = padded_width(k)
    plan = []
    while w > _GROUP_ROWS:
        plan.append((w // _LEAVES, _LEAVES, True))
        w //= _LEAVES
    # a row of 16 or fewer is one thread's; a longer one takes w / 16
    # threads, a warp at 512, a CTA of up to 1,024 above
    p = max(1, w // _LEAVES)
    plan.append((p, w // p, False))
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def row_plan(k: int, v: int) -> Tuple[int, int, int]:
    """The row kernel's plan for rows of ``k`` read ``v`` elements at a
    time: (leaves per thread M, log2 of a row's threads lu, log2 of a
    row's CTAs lc). A short row (lc = 0) is ``2^lu <= ROW_THREADS``
    threads' of one CTA: thread u owns positions ``v u + j + v 2^lu m`` (j
    < v, m < M) of the padded width ``W = v 2^lu M``. A long row is ``C =
    2^lc`` CTAs' of ``ROW_WARPS`` warps: CTA c's lane l owns residues ``q
    = 32 v c + v l + j`` of ``P = 32 v C``, warp w their leaves ``q + P (w
    + 8 s)`` (s < M), so ``W = 8 P M``; the tickets merge the CTAs'
    partials. Every plan follows ``row_sum``'s tree, so it changes the
    time and never the bits."""
    leaves = padded_width(k) // v
    m = min(_LEAVES, leaves)
    lu = (leaves // m).bit_length() - 1
    cta = ROW_THREADS.bit_length() - 1
    return (m, lu, 0) if lu <= cta else (m, cta, lu - cta)


def row_vector(k: int, operands: Sequence[Tensor]) -> int:
    """Elements a thread of the row kernel loads at once: 16 bytes (4 in
    float32, 2 in float64) where every operand allows it (each row
    16-byte aligned, its elements adjacent, ``k`` a multiple), else 1."""
    v = 16 // operands[0].element_size()
    if k == 0 or k % v:
        return 1
    for t in operands:
        if t.stride(1) != 1 or t.stride(0) % v or t.data_ptr() % 16:
            return 1
    return v


def gram_plan(s: int, d: int, itemsize: int) -> Optional[Tuple[int, int]]:
    """(P, M) of the Gram kernel for X [E, s, d] (an entity's block staged
    in shared memory), or None when the block does not fit or its rows are
    wider than a warp serves: then the Gram takes the general kernel."""
    w = padded_width(d)
    if w > _WARP_ROWS or s * w * itemsize > _GRAM_SMEM:
        return None
    ((p, m, _),) = launch_plan(d)
    return p, m


# --------------------------------------------------------------------------
# plain versions, and the kernel's order in plain PyTorch
# --------------------------------------------------------------------------


def row_dot_plain(a: Tensor, b: Optional[Tensor] = None) -> Tensor:
    return (a if b is None else a * b).sum(dim=-1)


def row_norm_plain(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def bmv_plain(A: Tensor, x: Tensor) -> Tensor:
    return torch.bmm(A, x[..., None])[..., 0]


def gram_plain(X: Tensor) -> Tensor:
    return torch.bmm(X, X.transpose(1, 2))


def row_dot_ordered(a: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """:func:`row_dot` in the kernel's order of additions, in plain PyTorch
    (``row_sum`` of the products): the kernel gives these bits."""
    return row_sum(a if b is None else a * b)


def bmv_ordered(A: Tensor, x: Tensor) -> Tensor:
    return row_sum(A * x[:, None, :])


def gram_ordered(X: Tensor) -> Tensor:
    E, S, D = X.shape
    step = max(1, _PLAIN_CHUNK // max(S * S * D, 1))
    parts = [
        row_sum(X[s:s + step, :, None, :] * X[s:s + step, None, :, :])
        for s in range(0, E, step)
    ]
    return torch.cat(parts) if parts else X.new_zeros(0, S, S)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------


def row_dot(a: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """``a * b`` summed over the last axis (``a`` and ``b`` broadcast),
    on the card in ``row_sum``'s order; ``b`` None: ``a``'s sum."""
    if a.device.type == "cpu":
        return row_dot_plain(a, b)
    if b is not None and a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    pair = (_rows(a), None if b is None else _rows(b))
    return _row_launch([pair], SUM if b is None else DOT)[0].reshape(a.shape[:-1])


def row_norm(a: Tensor) -> Tensor:
    """Euclidean norm over the last axis: on the card the ``sqrt`` of
    ``row_sum(a * a)``, ``a`` read once."""
    if a.device.type == "cpu":
        return row_norm_plain(a)
    return _row_launch([(_rows(a), None)], NORM)[0].reshape(a.shape[:-1])


def row_dots(pairs: Sequence[Tuple[Tensor, Tensor]]) -> Tensor:
    """:func:`row_dot` of each pair, stacked: ``[len(pairs), ...]``. On
    the card the pairs of one shape share a launch (up to ``MAX_PAIRS`` a
    launch), each member's bits those of its own :func:`row_dot`."""
    shape = pairs[0][0].shape
    if pairs[0][0].device.type == "cpu":
        return torch.stack([row_dot(a, b) for a, b in pairs])
    if any(a.shape != shape or b.shape != shape for a, b in pairs):
        return torch.stack([row_dot(a, b) for a, b in pairs])
    rows = [(_rows(a), _rows(b)) for a, b in pairs]
    parts = [_row_launch(rows[i:i + MAX_PAIRS], DOT) for i in range(0, len(rows), MAX_PAIRS)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out.reshape((len(pairs),) + shape[:-1])


def bmv(A: Tensor, x: Tensor) -> Tensor:
    """``A [E, m, n] @ x [E, n] -> [E, m]``, on the card each output in
    ``row_sum``'s order; ``A`` may be any strided view (``X.transpose(1,
    2)``)."""
    if A.dim() != 3 or x.dim() != 2 or x.shape != (A.shape[0], A.shape[2]):
        raise ValueError(f"bmv: A [E, m, n] and x [E, n], got {tuple(A.shape)}, {tuple(x.shape)}")
    if A.device.type == "cpu":
        return bmv_plain(A, x)
    return _launch("bmv", A, x, *bmv_args(A, x)).reshape(A.shape[:2])


def gram(X: Tensor) -> Tensor:
    """``X [E, S, D] -> X X^T [E, S, S]``, on the card each entry in
    ``row_sum``'s order."""
    if X.dim() != 3:
        raise ValueError(f"gram: X [E, S, D], got {tuple(X.shape)}")
    if X.device.type == "cpu":
        return gram_plain(X)
    E, S, D = X.shape
    plan = gram_plan(S, D, X.element_size())
    if plan is None:
        return _launch("gram", X, X, *gram_args(X)).reshape(E, S, S)
    return _launch_gram(X, *plan)


# The kernel's operands for each function: (E, I, J, K, a's strides, b's
# strides), a's and b's strides over (e, i, j, k) in elements.


def bmv_args(A: Tensor, x: Tensor):
    E, m, n = A.shape
    return (E, m, 1, n, (A.stride(0), A.stride(1), 0, A.stride(2)),
            (x.stride(0), 0, 0, x.stride(1)))


def gram_args(X: Tensor):
    E, S, D = X.shape
    st = X.stride()
    return E, S, S, D, (st[0], st[1], 0, st[2]), (st[0], 0, st[1], st[2])


def _rows(t: Tensor) -> Tensor:
    """``t`` as ``[n, k]`` rows (a view where the strides allow it)."""
    if t.dim() == 2:
        return t
    if t.dim() == 1:
        return t[None]
    return t.reshape(-1, t.shape[-1])


def _check(a, b) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"entity_products: unsupported device {a.device}")
    if a.dtype not in _DTYPES or (b is not None and b.dtype != a.dtype):
        raise ValueError(
            f"entity_products: float32 or float64 operands of one dtype, got "
            f"{a.dtype}{'' if b is None else ', ' + str(b.dtype)}"
        )
    if b is not None and b.device != a.device:
        raise ValueError("entity_products: operands on two devices")


def _raise_on(lib, rc) -> None:
    if rc != 0:
        msg = lib.photon_entity_products_error_string(rc).decode()
        raise RuntimeError(f"entity_products launch failed: {msg} ({rc})")


def _launch_gram(X: Tensor, p: int, m: int) -> Tensor:
    """The Gram kernel on the card, one CTA per entity; -> ``[E, S, S]``."""
    global launches
    _check(X, None)
    lib = _kernel_lib()
    E, S, D = X.shape
    out = torch.empty(E, S, S, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    _raise_on(lib, lib.photon_entity_gram(
        _DTYPES[X.dtype], X.data_ptr(), out.data_ptr(), E, S, D, *X.stride(), p, m,
        torch.cuda.current_stream(X.device).cuda_stream,
    ))
    launches += 1
    launches_by["gram"] += 1
    return out


def _row_launch(pairs, mode: int) -> Tensor:
    """The row kernel over ``pairs`` of ``[R, K]`` rows on the card; ->
    ``[len(pairs), R]``."""
    for a, b in pairs:
        _check(a, b)
    return run_rows(_row_call, pairs, mode)


def run_rows(call, pairs, mode: int) -> Tensor:
    """One launch of the row kernel over ``pairs`` (at most ``MAX_PAIRS``
    of one ``[R, K]`` shape) through ``call`` (the kernel's C entry point,
    or a test's emulation of it): ``call(pairs, out, mode, v, plan)`` with
    ``v`` from :func:`row_vector` and ``plan`` from :func:`row_plan`,
    counted under ``row_dot``. -> ``[len(pairs), R]``."""
    global launches
    a0 = pairs[0][0]
    R, K = a0.shape
    out = torch.empty(len(pairs), R, dtype=a0.dtype, device=a0.device)
    if R == 0:
        return out
    operands = [t for pair in pairs for t in pair if t is not None]
    v = row_vector(K, operands)
    call(pairs, out, mode, v, row_plan(K, v))
    launches += 1
    launches_by["row_dot"] += 1
    return out


_row_scratch: "OrderedDict" = OrderedDict()


def row_scratch(device, dtype, rows: int, partials: int, ctas: int) -> Tuple[Tensor, Tensor]:
    """A long row's partials ``[rows, partials]`` and tickets ``[rows,
    ctas]`` (int32, zero: the kernel's last CTA of each group resets its
    ticket), made once per shape and kept (the last few shapes a
    device), so a launch allocates nothing."""
    key = (str(device), dtype, rows, partials, ctas)
    hit = _row_scratch.get(key)
    if hit is None:
        hit = (torch.empty(rows * partials, dtype=dtype, device=device),
               torch.zeros(rows * ctas, dtype=torch.int32, device=device))
        _row_scratch[key] = hit
        while len(_row_scratch) > _ROW_SCRATCH_SHAPES:
            _row_scratch.popitem(last=False)
    else:
        _row_scratch.move_to_end(key)
    return hit


def _row_call(pairs, out, mode, v, plan) -> None:
    """The row kernel's C entry point for :func:`run_rows`."""
    lib = _kernel_lib()
    m, lu, lc = plan
    R, K = pairs[0][0].shape
    scratch = tickets = None
    if lc:
        scratch, tickets = row_scratch(
            out.device, out.dtype, len(pairs) * R, (32 * v) << lc, 1 << lc)
    table = []
    for a, b in pairs:
        bb = a if b is None else b
        table += [a.data_ptr(), bb.data_ptr(), a.stride(0), a.stride(1), bb.stride(0),
                  bb.stride(1)]
    _raise_on(lib, lib.photon_row_dots(
        _DTYPES[out.dtype], v, len(pairs), (ctypes.c_int64 * len(table))(*table),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(), R, K, mode, m, lu, lc,
        torch.cuda.current_stream(out.device).cuda_stream,
    ))


def _launch(kind, a, b, E, I, J, K, sa, sb) -> Tensor:
    """The general kernel over the ``E * I * J`` outputs on the card, its
    launches counted under ``kind``; -> ``[E * I * J]``."""
    _check(a, b)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream

    def call(src, src_b, dst, E, I, J, K, sa, sb, p, m, partial):
        rc = lib.photon_entity_products(
            _DTYPES[src.dtype], src.data_ptr(),
            None if src_b is None else src_b.data_ptr(), dst.data_ptr(),
            E, I, J, K, *sa, *(sb or (0, 0, 0, 0)), p, m, int(partial), stream,
        )
        _raise_on(lib, rc)

    return run_plan(kind, call, a, b, E, I, J, K, sa, sb)


def run_plan(kind, call, a, b, E, I, J, K, sa, sb) -> Tensor:
    """Every launch of ``launch_plan(K)`` through ``call`` (the kernel's
    C entry point, or a test's emulation of it), each counted under
    ``kind``: a partial launch writes ``[E * I * J, P]`` partials, whose
    rows the next launch reduces. -> ``[E * I * J]``."""
    global launches
    n_out = E * I * J
    out = torch.empty(n_out, dtype=a.dtype, device=a.device)
    if n_out == 0:
        return out
    src, src_b = a, b
    for p, m, partial in launch_plan(K):
        dst = torch.empty(n_out * p, dtype=a.dtype, device=a.device) if partial else out
        call(src, src_b, dst, E, I, J, K, sa, sb, p, m, partial)
        launches += 1
        launches_by[kind] += 1
        if partial:
            # the partials' rows continue the same tree
            src, src_b = dst, None
            E, I, J, K = n_out, 1, 1, p
            sa, sb = (p, 0, 0, 1), None
    return out


def _declare(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    i64 = ctypes.c_int64
    lib.photon_entity_products.restype = i
    lib.photon_entity_products.argtypes = [i, p, p, p] + [i64] * 12 + [i, i, i, p]
    lib.photon_entity_gram.restype = i
    lib.photon_entity_gram.argtypes = [i, p, p] + [i64] * 6 + [i, i, p]
    lib.photon_row_dots.restype = i
    lib.photon_row_dots.argtypes = [i, i, i, p, p, p, p, i64, i64, i, i, i, i, p]
    lib.photon_entity_products_error_string.restype = ctypes.c_char_p
    lib.photon_entity_products_error_string.argtypes = [i]


def _kernel_lib():
    return load_kernel_library("entity_products.cu", _declare)


def build_kernel() -> float:
    """Compile the kernel (if its library is older than its sources) and
    load it; -> seconds spent. Raises when ``nvcc`` fails."""
    return timed_build(_kernel_lib)
