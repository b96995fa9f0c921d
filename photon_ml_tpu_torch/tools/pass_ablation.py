"""What each part of K1's and K2's design buys, on one NVIDIA card.

    python3 -m photon_ml_tpu_torch.tools.pass_ablation [--seed 0] [--reps 50] [--json PATH]
    PYTHONPATH=<checkout> python3 photon_ml_tpu_torch/tools/pass_ablation.py --design-only

Builds planted-model data at the ads shape (2^18 rows x 64 nnz x 2^20
features, ``time_sequential_grid``'s) and rank 0's cell of a 2 x 2 (data,
model) mesh of the same data (2^17 rows x 2^19 features), then times the
z-pass and the g-pass of K1 and of K2 over a bank of 4 with the design as
built and with one part changed at a time (each variant is a launch
configuration handed to the wrappers' ``launch_with``):

- the source windows: K1's ``staged``, copied into shared memory with
  cp.async, or ``gathered``, read through L1 (the design stages a pass
  whose gathers fall at random in the window and gathers one whose
  gathers come in order: ``default_mode``; K2 always gathers);
- ``plan_8_steps``: the earlier plan, 8 whole steps per CTA;
- ``no_vec``: one entry per thread and trip instead of 4 (16-byte loads);
- ``no_sole``: items alone on their block store into a scratch row that
  the second launch sums, instead of storing into the output;
- ``no_padding_skip``: every step walks all L slots (sizes = L);
- K2: one tile of 4 members (each entry loaded once for the bank), tiles
  of 2 and of 1, instead of the wave rule (``members_per_cta``).

``design`` is timed first and last (``design_again``), which shows the
spread. With ``--design-only`` it times the design alone, through the
public ``bilinear_pass`` and ``grid_bilinear_pass``: that runs on any
checkout of the port since its mesh slice, so run it as a file with an
older checkout first on ``PYTHONPATH``, in turns with the current one, to
compare the two on one card with one timer (this file's
``device_timing``). Where the checkout's wrappers take ``spill=`` it
also times each pass with the schedule's spill remainder folded in
(``design_spill``; its bound is the pass's). Times are CUDA events over ``--reps`` launches queued
behind a sleep, so they are the card's and not the wrappers'; cell passes
are also timed with the 50 MB L2 flushed before each launch. Each line
prints the ms per pass, the bytes bound and (without ``--design-only``)
the plan: CTAs, entries per CTA, resident CTAs per SM. Then the card's
name and power limit; ``--json`` also writes the rows and the ptxas
report of a fresh build to a file. It needs a CUDA card; it imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import re
import sys

import numpy as np
import torch

N_ROWS, NNZ_PER_ROW, DIM = 1 << 18, 64, 1 << 20
HBM_BYTES_PER_S = 3.35e12
G = 4


def _device_timing():
    """``device_timing`` beside this file (an older checkout first on the
    path has none of its own)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "device_timing.py")
    spec = importlib.util.spec_from_file_location("_pass_ablation_device_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bound_ms(sched, n_src, n_out, members=1):
    """Bytes bound: each held entry's 12 bytes, each source and output
    element once, over the HBM rate (chip_smoke.pass_bound_ms's rule)."""
    entries = int(torch.count_nonzero(sched.vals[: sched.num_steps]))
    return (12 * entries + 4 * members * (n_src + n_out)) / HBM_BYTES_PER_S * 1e3


def k1_variant(k1, sched, dev, *, mode=None, vec=None, target=None, sole=True):
    """K1's launch over ``sched`` with one part of the design changed."""
    base = k1.launch_config(sched, sched.vals, dev)
    mode = base.mode if mode is None else mode
    vec = base.vec if vec is None else vec
    per_sm = k1.ctas_per_sm(sched.window, vec, mode)
    plan = k1.make_plan(sched, target or k1.sm_count(dev) * per_sm)
    return k1.LaunchConfig(plan if sole else no_sole(k1, plan), per_sm, vec, mode, k1.THREADS)


def k2_variant(k1, k2, sched, dev, *, gt=None, vec=None, target=None, sole=True):
    """K2's launch over ``sched`` for a bank of G, one part changed."""
    base = k2.launch_config(sched, sched.vals, dev, G)
    gt = base.members_per_cta if gt is None else gt
    cfg = k2.tile_config(sched, dev, G, gt, base.vec if vec is None else vec)
    plan = k1.make_plan(sched, target) if target else cfg.plan
    return dataclasses.replace(cfg, plan=plan if sole else no_sole(k1, plan))


def no_sole(k1, plan):
    """``plan`` with every item storing its window in a scratch row, each
    block summed by the second launch (no item writes the output itself)."""
    items = plan.items[:, : k1.ITEM_COLUMNS].cpu().numpy().copy()
    items[:, 5] = 0
    return k1.work_plan(items, plan.items.device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--design-only", action="store_true",
                    help="time the design alone, through the public wrappers")
    ap.add_argument("--json", help="write the rows and the ptxas report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pass_ablation: needs an NVIDIA card", file=sys.stderr)
        return 2

    import photon_ml_tpu_torch
    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.kernels import cuda_build
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    timing = _device_timing()
    smi = gpu_name_and_power_limit()
    print(f"pass_ablation package={photon_ml_tpu_torch.__file__}", flush=True)
    k1.build_kernel()
    k2.build_kernel()
    logs = {} if args.design_only else cuda_build.build_logs
    for name, log in logs.items():
        spills = re.findall(r"\b[1-9]\d* bytes spill stores", log)
        print(f"ptxas {name}: {len(spills)} kernels spill registers", flush=True)
    rng = np.random.default_rng(args.seed)
    idx = rng.integers(0, DIM, size=(N_ROWS, NNZ_PER_ROW), dtype=np.int64)
    vals = rng.normal(size=(N_ROWS, NNZ_PER_ROW)).astype(np.float32)
    ones, zeros = np.ones(N_ROWS, np.float32), np.zeros(N_ROWS, np.float32)
    full = ts.build_tiled_batch(
        np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW),
        idx.reshape(-1), vals.reshape(-1), zeros, zeros, ones, DIM, device="cuda",
    )
    batch = sparse_batch_from_arrays(idx, vals, zeros, zeros, ones, device="cpu")
    cell = ts.feature_shard_tiled_batch(batch, DIM, 2, 2, 0, 0, device="cuda")[0].cell
    flush = timing.l2_flush_buffer()
    dev = torch.device("cuda")
    rows = []

    def record(shape, kernel, pass_name, variant, fn, sched, n_src, n_out, members, cfg):
        warm = timing.device_ms(fn, args.reps)
        cold = timing.device_ms(fn, args.reps, flush=flush) if shape == "cell" else None
        bound = bound_ms(sched, n_src, n_out, members)
        row = dict(shape=shape, kernel=kernel, pass_name=pass_name, variant=variant,
                   ms=warm, ms_l2_flushed=cold, bound_ms=bound, share_of_bound=bound / warm)
        if cfg is not None:
            row.update(
                ctas=cfg.ctas, entries_per_item=int(sched.step_sizes.sum()) / max(cfg.plan.num_items, 1),
                ctas_per_sm=cfg.ctas_per_sm, mode=cfg.mode, members_per_cta=cfg.members_per_cta,
                threads=cfg.threads, ordered_gathers=sched.ordered_gathers,
            )
        rows.append(row)
        print("pass_ablation " + " ".join(f"{k}={v!r}" for k, v in row.items()), flush=True)

    for shape, tb in (("full", full), ("cell", cell)):
        win = tb.params.window
        w = torch.randn(tb.dim, device="cuda")
        c = torch.randn(tb.num_rows, device="cuda")
        wb = torch.randn(G, tb.dim, device="cuda")
        cb = torch.randn(G, tb.num_rows, device="cuda")
        for pass_name, sched, src, bank, n_blocks, n_src, n_out in (
            ("z", tb.z_sched, w, wb, tb.num_row_blocks, tb.dim, tb.num_rows),
            ("g", tb.g_sched, c, cb, tb.num_feat_blocks, tb.num_rows, tb.dim),
        ):
            if args.design_only:
                record(shape, "k1", pass_name, "design",
                       lambda: k1.bilinear_pass(sched, src, n_blocks, win),
                       sched, n_src, n_out, 1, None)
                record(shape, "k2", pass_name, "design",
                       lambda: k2.grid_bilinear_pass(sched, bank, n_blocks, win),
                       sched, n_src, n_out, G, None)
                if "spill" in inspect.signature(k1.bilinear_pass).parameters:
                    record(shape, "k1", pass_name, "design_spill",
                           lambda: k1.bilinear_pass(sched, src, n_blocks, win, spill=True),
                           sched, n_src, n_out, 1, None)
                    record(shape, "k2", pass_name, "design_spill",
                           lambda: k2.grid_bilinear_pass(sched, bank, n_blocks, win, spill=True),
                           sched, n_src, n_out, G, None)
                continue
            padded = dataclasses.replace(
                sched, plans={},
                step_sizes=torch.full_like(sched.step_sizes, sched.in_pos.shape[1]),
            )
            old_target = -(-sched.num_steps // 8)
            for variant, s, cfg in (
                ("design", sched, k1.launch_config(sched, sched.vals, dev)),
                ("staged", sched, k1_variant(k1, sched, dev, mode=k1.STAGED)),
                ("gathered", sched, k1_variant(k1, sched, dev, mode=k1.GATHERED)),
                ("plan_8_steps", sched, k1_variant(k1, sched, dev, target=old_target)),
                ("no_vec", sched, k1_variant(k1, sched, dev, vec=False)),
                ("no_sole", sched, k1_variant(k1, sched, dev, sole=False)),
                ("no_padding_skip", padded, k1.launch_config(padded, padded.vals, dev)),
                ("design_again", sched, k1.launch_config(sched, sched.vals, dev)),
            ):
                fn = lambda s=s, cfg=cfg: k1.launch_with(cfg, s, src, n_blocks, win, s.vals)
                record(shape, "k1", pass_name, variant, fn, s, n_src, n_out, 1, cfg)
            for variant, s, cfg in (
                ("design", sched, k2.launch_config(sched, sched.vals, dev, G)),
                ("one_tile_of_4", sched, k2_variant(k1, k2, sched, dev, gt=4)),
                ("tiles_of_2", sched, k2_variant(k1, k2, sched, dev, gt=2)),
                ("tiles_of_1", sched, k2_variant(k1, k2, sched, dev, gt=1)),
                ("plan_8_steps", sched, k2_variant(k1, k2, sched, dev, target=old_target)),
                ("no_vec", sched, k2_variant(k1, k2, sched, dev, vec=False)),
                ("no_sole", sched, k2_variant(k1, k2, sched, dev, sole=False)),
                ("no_padding_skip", padded, k2.launch_config(padded, padded.vals, dev, G)),
                ("design_again", sched, k2.launch_config(sched, sched.vals, dev, G)),
            ):
                fn = lambda s=s, cfg=cfg: k2.launch_with(cfg, s, bank, n_blocks, win, s.vals)
                record(shape, "k2", pass_name, variant, fn, s, n_src, n_out, G, cfg)
    if args.json:
        from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json

        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        atomic_write_json(args.json, {"device": smi, "package": photon_ml_tpu_torch.__file__,
                                      "rows": rows, "ptxas": logs}, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
