"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the port
(``photon_ml_tpu_torch``). It makes the cell's inputs from ``--seed``,
builds and warms up (``setup_s``, from process start), measures for
``--seconds`` (with ``--trace 1`` under ``torch.profiler``, reporting the
cell's per-layer metrics instead of its end-to-end ones), judges what the
timed path produced against the plain reference, and prints the numbers
compared beside their limits as the last lines of standard error and one
JSON object as the last line of standard output. It exits non-zero,
printing no result, without as many CUDA cards as the cell asks for, or
when a module of JAX or of the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    schedule cache (a run builds its schedules, and writes nothing)."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.pop("PHOTON_TILE_CACHE_DIR", None)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import harness

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); found {count}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", START)

    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
