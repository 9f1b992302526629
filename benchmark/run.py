"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: validate ``BENCHMARK.json``, point the
program's build caches into the checkout, apply the configuration's
deployment settings, make the inputs from the seed, warm up on the
cell's own shapes (set-up ends there), measure the window, then check
what the window produced against the plain reference. The last line of
standard output is the result; the numbers compared, beside their
limits, are the last lines of standard error and the result's last key.
With ``--trace 1`` the metrics are the cell's per-layer ones, read over
one profiled unit of the window and the window's counters.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness, spec  # noqa: E402
from benchmark.harness import log  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(workload: str, root=spec.ROOT):
    """The validated spec's cell, with the program's environment set."""
    cell = spec.cell(spec.load(root), workload, root)
    harness.prepare_environment(cell.config.get("env", {}))
    return cell


def run(args, *, device: str = "cuda", root=spec.ROOT,
        start: float | None = None) -> tuple[dict, list]:
    """One run; returns (the result object, the checks). ``device="cuda"``
    needs as many cards as the cell asks for; tests pass ``"cpu"``."""
    start = _START if start is None else start
    cell = prepare(args.workload, root)
    import torch

    from benchmark.trace import Profiler

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"{args.workload}: needs {cell.chips} CUDA "
                         f"device(s), found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(device)
    trace = bool(args.trace)
    if trace and dev.type != "cuda":
        raise SystemExit("--trace 1 reads a device trace: CUDA only")
    profiler = Profiler(torch, trace)
    driver = spec.load_driver(cell.config["driver"]).Driver(
        cell, dev, trace, profiler)
    try:
        driver.setup(args.seed)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        harness.check_isolation("after set-up")
        log("setup " + json.dumps({"setup_s": setup_s,
                                   **driver.setup_parts}))
        print("setup " + json.dumps({"setup_s": setup_s,
                                     **driver.setup_parts}), flush=True)
        window = driver.measure(args.seconds)
        profiler.finish()
        if profiler.slice is not None:
            log(f"profile: {len(profiler.slice.kernels)} kernels, "
                f"{len(profiler.slice.host_ops)} host events, slice "
                f"{profiler.slice.wall_s:.3f} s, stop "
                f"{profiler.slice.meta['stop_s']:.3f} s")
        harness.check_isolation("after the window")
        span = window.span
        log(f"window: {len(window.inside())} events over "
            f"{None if span is None else span[1] - span[0]} s")
        device_info = (harness.device_info(torch, cell.chips,
                                           _trace_info(profiler))
                       if dev.type == "cuda" else
                       {"platform": "cpu", "kind": "cpu", "count": 1,
                        "memory_peak_bytes": 0})
        log("end to end " + json.dumps(driver.end_to_end()))
        metrics = {}
        if trace:
            for m in cell.per_layer:
                v = spec.load_reader(m["name"], root)(driver)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = dict(driver.end_to_end(), setup_s=setup_s)
            for m in cell.end_to_end:
                if values.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        t0 = time.perf_counter()
        checks = driver.judge(args.seed)
        log(f"judge: {time.perf_counter() - t0:.2f} s")
        attempted, failed = driver.attempted_failed()
        harness.check_isolation("before the result")
    finally:
        driver.close()
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in metrics] \
        if not trace else []
    correct = all(c.ok for c in checks) and not missing
    if missing:
        log(f"not measured: {missing}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info,
              "breakdown": (profiler.slice.breakdown()
                            if trace and profiler.slice else None)}
    return result, checks


def _trace_info(profiler) -> dict | None:
    sl = profiler.slice
    if sl is None:
        return None
    return {"busy_s": sl.busy_s, "window_s": sl.wall_s}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, checks = run(args)
    except (harness.IsolationError, spec.SpecError) as exc:
        log(f"benchmark refused: {exc}")
        return 2
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
            + ("" if c.ok else "  FAILED"))
    print(harness.result_line(
        correct=result["correct"], attempted=result["attempted"],
        failed=result["failed"], metrics=result["metrics"],
        device=result["device"], checks=checks,
        breakdown=result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
