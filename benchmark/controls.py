"""The readings the limits are set from: the program's and the control's,
on many seeds, at a cell's own size, in one process.

    python3 -m benchmark.controls --workload <cell> --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 20

Each reading is a whole run of the cell (``benchmark.run.run``: set-up, a
short window at the cell's own load, the judge) on one seed. A program
seed reads the numbers ``run`` compares as the program gives them; a
control seed reads them with the control planted in the program (the
driver module's ``control()``: one precision below what the
configuration states; Whisper: TF32 on, the ladder: the resize in
bfloat16). The benchmark's own runs never run this. One JSON line per
run, then a summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import harness, spec
from benchmark import run as brun


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    driver = spec.load_driver(cell.config["driver"])
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("controls run on the card")
    plans = ([("program", int(s)) for s in args.seeds.split(",") if s]
             + [("control", int(s)) for s in args.control_seeds.split(",")
                if s])
    rows = []
    for side, seed in plans:
        t0 = time.perf_counter()
        run_args = brun.parse_args(["--workload", args.workload, "--seed",
                                    str(seed), "--seconds",
                                    str(args.seconds)])
        with (driver.control() if side == "control"
              else contextlib.nullcontext()):
            result, checks = brun.run(run_args, start=t0)
        row = {"side": side, "seed": seed, "correct": result["correct"],
               **{c.name: c.value for c in checks},
               "rate": next(iter(result["metrics"].values()))["value"]
               if result["metrics"] else None,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for side in ("program", "control"):
        mine = [r for r in rows if r["side"] == side]
        if mine:
            summary[side] = {
                k: {"min": min(r[k] for r in mine),
                    "max": max(r[k] for r in mine)}
                for k in mine[0]
                if k not in ("side", "seed", "correct", "seconds")
                and all(isinstance(r[k], (int, float)) for r in mine)}
            summary[side]["correct"] = sum(r["correct"] for r in mine)
            summary[side]["runs"] = len(mine)
    print(json.dumps({"summary": summary}), flush=True)
    harness.check_isolation("controls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
