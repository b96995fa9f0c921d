"""The readings a cell's limits are set from: the program's and the
control's numbers over many seeds, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]

For each of ``--seeds`` it sets the cell up as a run does (data, build,
warm-up), fits one more unit through the timed path, and judges it with
the plain reference: the program's readings, whose largest is the lower
reading of each number. For each of ``--control-seeds`` it puts the
reference in the program's place, computed a precision lower than the
configuration states (bfloat16 values and vectors, float32 sums), and
judges that the same way: the control's readings, whose smallest is the
upper reading. Each reading is printed as one JSON line; benchmark runs
never run this. It needs a CUDA card unless given ``--device cpu``.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]

import torch  # noqa: E402

import harness  # noqa: E402


def program_reading(cell, seed, device) -> dict:
    loop = harness.module("loops", cell.traffic["loop"])
    record = harness.Record(cell)
    state = loop.setup(cell, seed, device, record, False)
    loop.step(state)
    outputs = loop.outputs(state)
    del state
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return loop.judge(cell, seed, device, outputs)


def control_reading(cell, seed, device) -> dict:
    """The reference in the program's place, in bfloat16 with float32 sums."""
    cfg, tr = cell.config, cell.traffic
    ref = harness.module("reference", cfg["reference"])
    data = harness.module("generators", cfg["generator"]).generate(cfg, seed, device)
    low = ref.Rows(data, cfg["features"], device, dtype=torch.bfloat16)
    rows = ref.Rows(data, cfg["features"], device)
    if cfg["reference"] == "glm":
        fits = ref.fit(low, tr["lambdas"], warm_start=tr["mode"] == "sequential",
                       max_iter=int(tr["max_iter"]), tolerance=float(tr["tolerance"]),
                       history=int(tr["history"]), acc=torch.float32)
        return ref.judge(rows, [fits], int(tr["history"]))
    lam_g, lam_u = float(tr["global"]["reg_weight"]), float(tr["per_user"]["reg_weight"])
    settings = harness.module("loops", tr["loop"]).global_fit(tr)
    control = ref.fit(low, int(tr["sweeps"]), lam_g, lam_u, settings, acc=torch.float32)
    del low
    return ref.judge(rows, [control], lam_g, lam_u, settings)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.find_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, seeds, fn in (("program", args.seeds, program_reading),
                            ("control", args.control_seeds, control_reading)):
        for seed in seeds:
            t0 = time.perf_counter()
            numbers = fn(cell, seed, args.device)
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                              "seconds": time.perf_counter() - t0, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
