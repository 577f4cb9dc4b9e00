"""Readings for the limits of ``correct``: a cell's program on many seeds and
its lower-precision control on a few, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds <s> --first-seed <n> [--out <file>]

Each seed is one run as the benchmark makes it (its own set-up, a window
of ``--seconds``), at the cell's own size; ``--check-per-replan`` samples
more members a re-plan, so a short window compares as many plans as a
full run does, and ``--lead-in`` shortens the set-up, which the readings
do not need.  The control is the configuration's builder with
``control=True`` (the model's matmuls in bf16).  For every run it prints
the largest defect and stationarity over all sampled members (the numbers
compared) and over the converged ones, with the program's own KKT
errors, and ``--out`` keeps every member's readings as JSON.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def summary(per_member: dict) -> dict:
    import torch
    conv = per_member["converged"].bool()
    out = {"sampled": int(conv.numel()), "converged": int(conv.sum())}
    for col in ("defect", "stationarity", "kkt_error"):
        v = per_member[col]
        out[f"{col}_max_converged"] = (float(v[conv].max())
                                       if conv.any() else None)
        out[f"{col}_max_all"] = float(v.max()) if v.numel() else None
        out[f"{col}_median_all"] = (float(torch.median(v))
                                    if v.numel() else None)
    return out


def main(argv=None):
    from benchmark.harness import env
    env.setup(ROOT)
    import torch
    from benchmark.harness import driver
    from benchmark.harness.layout import Layout

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--check-per-replan", type=int, default=0)
    ap.add_argument("--lead-in", type=int, default=-1,
                    help="lead-in re-plans (default: the mix's)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    layout = Layout(ROOT)
    traffic = {}
    if args.check_per_replan:
        traffic["check_per_replan"] = args.check_per_replan
    if args.lead_in >= 0:
        traffic["lead_in"] = args.lead_in
    over = {"traffic": traffic}
    runs = []
    plan = ([(False, args.first_seed + i) for i in range(args.seeds)]
            + [(True, args.first_seed + 1000 + i)
               for i in range(args.control_seeds)])
    for control, seed in plan:
        detail = {}
        t0 = time.perf_counter()
        result = driver.run(layout, args.workload, seed, args.seconds, False,
                            t_start=t0, control=control, overrides=over,
                            detail=detail)
        s = summary(detail["per_member"])
        s.update(control=control, seed=seed, correct=result["correct"],
                 attempted=result["attempted"], failed=result["failed"],
                 replans=len(detail["records"]),
                 it_max=[r["it_max"] for r in detail["records"]],
                 seconds=time.perf_counter() - t0)
        print(json.dumps(s), flush=True)
        s["per_member"] = {k: v.tolist()
                           for k, v in detail["per_member"].items()}
        runs.append(s)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs))
    print(f"calibration took {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
