"""Multi-device dry run: the sharded ladder step on N devices, plus the
mesh-shape and scheduler throughput harness (port of
``vlog_tpu/parallel/dryrun.py``).

    python -m vlog_tpu_torch.parallel.dryrun N [--records PATH]

runs on the first N visible CUDA devices and raises when there are
fewer; :func:`run` takes an explicit device list instead (a device may
repeat: ``["cpu"] * 4`` in the tests, one card as four logical devices
on a one-card machine, where the numbers are not multi-card scaling).

The body is the grid path the worker dispatches per batch, at the
reference's shapes (a 96x128 source): the intra step sharded over a data
mesh (one frame per device, per-device resize and intra encode of every
rung, the per-shard PSNR partials summed in data order where the
reference reduces with ``psum``), the H.264 I+P chain ladder and the
HEVC chain ladder with one 3-frame chain per device, then:

- per (data x rung) shape, chain-ladder throughput (frames/s) on two
  workloads, "full" (one chain per data slot) and "small_batch" (2
  chains whatever the shape) (``shape_fps``), over the four sweep
  rungs; and
- two queued jobs run serialized on full-width leases vs concurrently on
  two narrow slots through the real ``MeshScheduler`` admit/acquire path
  (``sched``: wall seconds, jobs per minute, speedup).

It prints the record as its last JSON line and returns it. Labeled
records go only to the file the caller names (``records``); nothing is
written otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from vlog_tpu_torch.parallel.mesh import visible_cuda_devices

RUNGS = (("64p", 64, 96, 28), ("32p", 32, 48, 30))
# enough rungs for a real rung axis (up to 4 columns); all fit 96x128
SWEEP_RUNGS = (("96p", 96, 128, 26), ("64p", 64, 96, 28),
               ("48p", 48, 64, 29), ("32p", 32, 48, 30))
SRC_H, SRC_W, CLEN = 96, 128, 3


def _devices(n_devices: int, devices) -> list:
    if devices is None:
        have = len(visible_cuda_devices())
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have} "
                               "(pass devices= to run on others)")
        return [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, given {len(devices)}")
    return devices


def run(n_devices: int, devices=None, records=None, *,
        iters: int = 3) -> dict:
    """The dry run on ``n_devices`` devices (the first N visible CUDA
    devices, or ``devices``); appends labeled records to ``records``
    when given; returns the printed record (``psnr`` per rung of the
    sharded step, ``shape_fps``, ``sched``). ``iters``: timed dispatches
    per shape and workload, and per job in the packing comparison."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.executor import to_host
    from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_grid
    from vlog_tpu_torch.parallel.ladder import (ladder_chain_grid,
                                                sharded_ladder_step,
                                                valid_mask)
    from vlog_tpu_torch.parallel.mesh import (MeshShape, make_mesh,
                                              pad_batch, rung_grid)

    devices = _devices(n_devices, devices)
    mesh = make_mesh("data:-1", devices=devices)
    h, w = SRC_H, SRC_W

    # the sharded intra step: one frame per device, every rung, PSNR
    # partials summed over the data axis
    step, mats = sharded_ladder_step(mesh, RUNGS, h, w)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (n_devices, h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (n_devices, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (n_devices, h // 2, w // 2)).astype(np.uint8)
    (y, u, v), real = pad_batch(n_devices, y, u, v)
    out, stats = step(y, u, v, mats, valid_mask(y.shape[0], real))
    out = to_host(out)
    psnr = {}
    for name, *_ in RUNGS:
        psnr[name] = float(stats[name])
        assert 10.0 < psnr[name] < 99.0, \
            f"rung {name}: implausible PSNR {psnr[name]}"
        assert out[name]["luma_ac"].shape[0] == n_devices

    # the I+P chain ladder and the HEVC chain ladder: one chain per
    # device, the chain axis over the data axis, deblocking and the
    # in-chain rate adaptation live (alpha > 0)
    grid = rung_grid(RUNGS, MeshShape(n_devices, 1), devices) \
        if n_devices > 1 else None
    qps = {name: np.full((n_devices, CLEN), qp, np.int32)
           for name, _, _, qp in RUNGS}
    rc = {name: {"budget": np.float32(2000.0), "alpha": np.float32(0.5)}
          for name, *_ in RUNGS}
    cy, cu, cv = _chain_batch(2, n_devices, CLEN, h, w)
    cprog = ladder_chain_grid(RUNGS, h, w, search=4, grid=grid,
                              deblock=config.H264_DEBLOCK, device=devices[0])
    couts = to_host(cprog.dispatch(cy, cu, cv, qps, rc))
    hprog = hevc_chain_ladder_grid(RUNGS, h, w, search=4, grid=grid,
                                   device=devices[0])
    houts = to_host(hprog.dispatch(cy, cu, cv, qps, rc))
    for name, *_ in RUNGS:
        for ro in (couts[name], houts[name]):
            assert ro["p_luma"].shape[:2] == (n_devices, CLEN - 1)
            assert ro["mv"].shape[:2] == (n_devices, CLEN - 1)
            assert ro["sse_y"].shape == (n_devices, CLEN)
            assert ro["qp_eff"].shape == (n_devices, CLEN)

    print(f"dryrun ok: {n_devices} devices, rungs "
          f"{[(r[0], round(psnr[r[0]], 2)) for r in RUNGS]}, "
          f"chain clen={CLEN} ok, hevc chain ok", flush=True)

    shape_fps = measure_mesh_shapes(devices, SWEEP_RUNGS, h, w, CLEN,
                                    iters=iters)
    sched = measure_scheduler_packing(devices, RUNGS, h, w, CLEN,
                                      dispatches=iters)
    record = {"multichip": "ok", "devices": n_devices,
              "device_kinds": sorted({str(d) for d in devices}),
              "psnr": psnr, "shape_fps": shape_fps, "sched": sched}
    if records is not None:
        _append_records(records, _multichip_records(
            n_devices, shape_fps, sched, devices))
    print(json.dumps(record), flush=True)
    return record


def _append_records(path, records: list[dict]) -> None:
    """Labeled-record trail: read the list at ``path``, extend it,
    rewrite it (rounds accumulate)."""
    existing: list = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, list):
                existing = loaded
        except (OSError, ValueError):
            existing = []
    existing.extend(records)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1)
        f.write("\n")


def _multichip_records(n_devices: int, shape_fps: dict, sched: dict,
                       devices=()) -> list[dict]:
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.compile_cache import compile_seconds

    ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    kinds = sorted({str(d) for d in devices})
    speed = {"resize": ("cuda" if any(k.startswith("cuda") for k in kinds)
                        else "plain"),
             "device_kinds": kinds,
             "distinct_devices": len(kinds),
             "whisper_quant": config.WHISPER_QUANT,
             "compile_s": round(compile_seconds(), 3)}
    recs = []
    for workload in ("full", "small_batch"):
        for label, fps in (shape_fps.get(workload) or {}).items():
            recs.append({
                "step": f"{workload}:{label}",
                "metric": "ladder_chain_fps",
                "fps": fps,
                "timestamp": ts,
                "config": {"devices": n_devices, "mesh_shape": label,
                           "workload": workload, **speed}})
    summary = shape_fps.get("small_batch_summary")
    if summary:
        recs.append({"step": "small_batch_summary",
                     "metric": "ladder_shape_win_x",
                     "win_x": summary.get("win_x"),
                     "timestamp": ts,
                     "config": {"devices": n_devices, **summary, **speed}})
    if sched and "speedup" in sched:
        recs.append({"step": "sched_packing",
                     "metric": "sched_speedup_x",
                     "speedup_x": sched["speedup"],
                     "timestamp": ts,
                     "config": {"devices": n_devices,
                                "jobs": sched.get("jobs"),
                                "slot_widths": sched.get("slot_widths"),
                                **speed}})
    return recs


def _chain_batch(seed: int, n_chains: int, clen: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (n_chains, clen, h, w)).astype(np.uint8)
    u = rng.integers(0, 256,
                     (n_chains, clen, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256,
                     (n_chains, clen, h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _dispatch_grid(prog, rungs, y, u, v, clen) -> None:
    """One grid chain-ladder dispatch: pad the chain axis to the grid's
    data width, stage per column, and pull one output per rung (the
    dispatch + pull the production consume loop pays)."""
    from vlog_tpu_torch.parallel.executor import to_host
    from vlog_tpu_torch.parallel.mesh import pad_batch

    (y, u, v), _ = pad_batch(prog.data, y, u, v)
    n = y.shape[0]
    qps = {name: np.full((n, clen), qp, np.int32)
           for name, _, _, qp in rungs}
    rc = {name: {"budget": np.float32(2000.0), "alpha": np.float32(0.0)}
          for name, *_ in rungs}
    outs = prog.dispatch(y, u, v, qps, rc)
    to_host({name: outs[name]["sse_y"] for name, *_ in rungs})


def measure_mesh_shapes(devices, rungs, h: int, w: int, clen: int,
                        shapes=None, iters: int = 3) -> dict:
    """Chain-ladder throughput (real frames/s) per (data x rung) shape,
    on "full" (one chain per data slot) and "small_batch" (2 chains,
    padded to the data width). The default sweep is every data-only
    divisor shape plus the full-device 2-D shapes (N/r x r, r <= rung
    count). No untimed warm-up dispatch, unlike the reference's (whose
    first dispatch per shape compiles): nothing compiles in the port,
    and :func:`run`'s chain and HEVC checks have already warmed the
    libraries and the allocator; a program's first dispatch builds its
    matrices' band forms (one small copy to the host per matrix)."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.ladder import ladder_chain_grid
    from vlog_tpu_torch.parallel.mesh import MeshShape, rung_grid

    n_dev = len(devices)
    if shapes is None:
        divs = [d for d in range(1, n_dev + 1) if n_dev % d == 0]
        shapes = [(d, 1) for d in divs]
        shapes += [(n_dev // r, r) for r in divs if 1 < r <= len(rungs)]

    out: dict = {}
    for d, r in shapes:
        if d * r > n_dev or r > len(rungs):
            continue
        shape = MeshShape(d, r)
        grid = (rung_grid(rungs, shape, list(devices[:d * r]))
                if d * r > 1 else None)
        prog = ladder_chain_grid(rungs, h, w, search=4, grid=grid,
                                 deblock=config.H264_DEBLOCK,
                                 device=devices[0])
        for workload, chains in (("full", d), ("small_batch", 2)):
            y, u, v = _chain_batch(7, chains, clen, h, w)
            t0 = time.perf_counter()
            for _ in range(iters):
                _dispatch_grid(prog, rungs, y, u, v, clen)
            dt = (time.perf_counter() - t0) / iters
            out.setdefault(workload, {})[shape.label] = round(
                chains * clen / dt, 2)

    small = out.get("small_batch", {})
    data_only = small.get(f"{n_dev}x1")
    two_d = {k: v for k, v in small.items() if not k.endswith("x1")}
    if data_only and two_d:
        best = max(two_d, key=lambda k: two_d[k])
        out["small_batch_summary"] = {
            "data_only_shape": f"{n_dev}x1", "data_only": data_only,
            "best_2d_shape": best, "best_2d": two_d[best],
            "win_x": round(two_d[best] / data_only, 2)}
    return out


def measure_scheduler_packing(devices, rungs, h: int, w: int, clen: int,
                              chains_per_job: int | None = None,
                              dispatches: int = 3) -> dict:
    """Two queued jobs: serialized on full-width leases vs concurrently on
    two narrow slots (each job's batch carries half-width chains)."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.ladder import ladder_chain_grid
    from vlog_tpu_torch.parallel.mesh import MeshShape, rung_grid
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    n_dev = len(devices)
    if n_dev < 2:
        # one device is one slot: the two-party barrier would deadlock
        return {"skipped": "needs >= 2 devices for 2 slots"}
    slots = 2
    chains = chains_per_job or max(1, n_dev // 2)

    def prepare_job(lease, seed: int):
        """Build this job's program on its lease; returns the timed
        dispatch loop (no warm-up: see :func:`measure_mesh_shapes`)."""
        devs = list(lease.devices)
        grid = rung_grid(rungs, MeshShape(len(devs), 1), devs) \
            if len(devs) > 1 else None
        prog = ladder_chain_grid(rungs, h, w, search=4, grid=grid,
                                 deblock=config.H264_DEBLOCK,
                                 device=devs[0])
        y, u, v = _chain_batch(seed, chains, clen, h, w)

        def go() -> None:
            for _ in range(dispatches):
                _dispatch_grid(prog, rungs, y, u, v, clen)
        return go

    # serialized: each job is alone, so it gets every device
    sched = MeshScheduler(devices=list(devices), slots=slots)
    serial_s = 0.0
    serial_widths = []
    for seed in (11, 12):
        ticket = sched.admit()
        lease = ticket.acquire()
        serial_widths.append(lease.width)
        try:
            go = prepare_job(lease, seed)
            t0 = time.perf_counter()
            go()
            serial_s += time.perf_counter() - t0
        finally:
            ticket.close()

    # slotted: both admitted before either acquires, so the grant gives
    # two narrow slots; a barrier aligns the timed regions
    sched = MeshScheduler(devices=list(devices), slots=slots)
    tickets = [sched.admit() for _ in range(2)]
    barrier = threading.Barrier(2)
    slot_widths, spans, errors = [], [], []

    def slot_job(ticket, seed: int) -> None:
        try:
            lease = ticket.acquire()
            slot_widths.append(lease.width)
            try:
                go = prepare_job(lease, seed)
                barrier.wait()
                t0 = time.perf_counter()
                go()
                spans.append((t0, time.perf_counter()))
            finally:
                ticket.close()
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=slot_job, args=(t, 21 + i),
                                name=f"vlog-dryrun-slot-{i}")
               for i, t in enumerate(tickets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    slotted_s = max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans)
    return {
        "jobs": 2,
        "chains_per_job_batch": chains,
        "dispatches_per_job": dispatches,
        "serial_widths": serial_widths,
        "slot_widths": sorted(slot_widths),
        "serial_full_mesh_s": round(serial_s, 3),
        "two_slot_s": round(slotted_s, 3),
        "speedup": round(serial_s / slotted_s, 3) if slotted_s else 0.0,
        "jobs_per_min_1slot": round(2 * 60.0 / serial_s, 2),
        "jobs_per_min_2slot": round(2 * 60.0 / slotted_s, 2),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m vlog_tpu_torch.parallel.dryrun",
        description="the multi-device dry run on N CUDA devices")
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--records", default=None,
                    help="append labeled records to this JSON file")
    args = ap.parse_args(argv)
    run(args.n, records=args.records)


if __name__ == "__main__":
    main()
