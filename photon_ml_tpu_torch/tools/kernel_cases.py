"""Inputs at K1's and K2's edge cases, and what the kernels must return on
them, for the card checks (``chip_smoke.py`` phase 2 and
``tests/test_torch_cuda_kernels.py``). Data comes from numpy seeds; the
module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def edge_case_batches(device, seed=0):
    """Small tiled batches at the kernels' edge cases: -> [(name, batch)].

    - split_steps: the default window with fewer steps than the card's CTA
      slots, so the work plan splits steps across CTAs;
    - one_step_block: an output block (rows 192..255) whose entries fit
      one step;
    - odd_chunk: chunk 30, not a multiple of 4 (one entry per load);
    - heavy_row: row 5 holds a tenth of the entries, all in one feature
      block (same-address adds in the z-pass)."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    rng = np.random.default_rng([seed, 3])
    out = []
    for name, n, d, nnz, params in (
        ("split_steps", 20000, 30000, 240000, ts.TileParams()),
        ("one_step_block", 700, 900, 8400, ts.TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8)),
        ("odd_chunk", 700, 900, 8400, ts.TileParams(s_hi=8, s_lo=8, chunk=30, spill_cap=0)),
        ("heavy_row", 700, 900, 8400, ts.TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=4)),
    ):
        rows = rng.integers(0, n, nnz)
        feats = rng.integers(0, d, nnz)
        if name == "one_step_block":
            in_block = np.flatnonzero((rows >= 192) & (rows < 256))
            rows[in_block[20:]] = rng.integers(0, 192, len(in_block) - 20)
        if name == "heavy_row":
            rows[: nnz // 10] = 5
            feats[: nnz // 10] = rng.integers(0, params.window, nnz // 10)
        tb = ts.build_tiled_batch(
            rows, feats, rng.normal(size=nnz).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32),
            np.ones(n, np.float32), d, params=params, device=device,
        )
        out.append((name, tb))
    return out


def real_entries_pass(sched, src: Tensor, num_out_blocks: int, window: int, vals=None) -> Tensor:
    """The pass over the steps' real entries only (slot < ``step_sizes``),
    for a flat ``src`` or a bank ``[G, n]``: what the kernels compute. It
    equals the plain version (``bilinear_pass_plain``, which also adds
    every padding slot's ``0 * src[window start]``) wherever the source is
    finite."""
    S = sched.num_steps
    L = sched.in_pos.shape[1]
    real = torch.arange(L, device=src.device)[None, :] < sched.step_sizes[:, None].long()
    v = (sched.vals if vals is None else vals)[:S][real]
    flat_in = (sched.step_in[:, None].long() * window + sched.in_pos[:S])[real]
    flat_out = (sched.step_out[:, None].long() * window + sched.out_pos[:S])[real]
    bank = src.reshape(-1, src.shape[-1])
    out = torch.zeros(bank.shape[0], num_out_blocks * window, dtype=src.dtype, device=src.device)
    out.index_add_(1, flat_out, v * bank.index_select(1, flat_in))
    return out.reshape(src.shape[:-1] + (num_out_blocks * window,))


def nan_source(sched, src: Tensor) -> Tensor:
    """A copy of ``src`` [..., n] with a NaN where a nonzero entry of
    ``sched`` reads, off a window's first slot (where the plain version's
    padding slots also read: ``nan_at_window_start`` covers that)."""
    W = sched.window
    sizes = sched.step_sizes.cpu().numpy()
    in_pos = sched.in_pos.cpu().numpy()
    for s in np.flatnonzero(sizes > 1):
        hits = np.flatnonzero(in_pos[s, : sizes[s]] != 0)
        if len(hits):
            at = int(sched.step_in[s]) * W + int(in_pos[s, hits[0]])
            out = src.clone()
            out[..., at] = float("nan")
            return out
    raise ValueError("no entry reads off a window's first slot")


def nan_at_window_start(sched, src: Tensor, num_out_blocks: int, window: int, vals=None):
    """A copy of ``src`` with a NaN at the first slot of an input window
    that a padded step reads, where the plain version and the real entries
    differ: the plain version's padding slots (``in_pos`` 0, value 0) carry
    ``0 * NaN`` into slot 0 of their output block, which no real entry
    reaches with the NaN. -> (source, the plain version's output, the real
    entries' output)."""
    from photon_ml_tpu_torch.ops.kernels.bilinear_pass import bilinear_pass_plain

    L = sched.in_pos.shape[1]
    sizes = sched.step_sizes.cpu().numpy()
    for s in np.flatnonzero(sizes < L)[:64]:
        out = src.clone()
        out[..., int(sched.step_in[s]) * window] = float("nan")
        plain = torch.stack([
            bilinear_pass_plain(sched, row, num_out_blocks, window, vals)
            for row in out.reshape(-1, out.shape[-1])
        ]).reshape(out.shape[:-1] + (num_out_blocks * window,))
        real = real_entries_pass(sched, out, num_out_blocks, window, vals)
        if int(torch.isnan(plain).sum()) > int(torch.isnan(real).sum()):
            return out, plain, real
    raise ValueError("no padded step where the plain version's NaN differs")


def schedule_without_block(sched, block: int):
    """``sched`` with every step of output block ``block`` taken out: a
    schedule neither builder makes (both give a block without entries a
    step of none), whose block the kernels must still write as zeros."""
    from photon_ml_tpu_torch.ops.tiled_sparse import _Schedule

    S = sched.num_steps
    keep = (sched.step_out != block).cpu().numpy()
    step_out = sched.step_out.cpu().numpy()[keep]
    step_init = np.ones(step_out.shape[0], np.int32)
    step_init[1:] = step_out[1:] != step_out[:-1]
    arrays = (
        step_out, sched.step_in.cpu().numpy()[keep], step_init,
        sched.out_pos.cpu().numpy()[:S][keep], sched.in_pos.cpu().numpy()[:S][keep],
        sched.vals.cpu().numpy()[:S][keep], sched.spill_out.cpu().numpy(),
        sched.spill_in.cpu().numpy(), sched.spill_vals.cpu().numpy(),
    )
    return _Schedule.from_numpy(
        arrays, window=sched.window, num_out_blocks=sched.num_out_blocks,
        num_in_blocks=sched.num_in_blocks, device=sched.step_out.device,
    )
