"""Chip smoke for the PyTorch/CUDA port: drive its main path on one card.

    python3 chip_smoke.py            # every phase, one card, no options

Phases (any failure exits non-zero; none is caught):

1. the card's name and power limit (nvidia-smi);
2. build the fused resize kernel (nvcc, sm_90a) and the native CABAC
   coder from the checkout's sources, timed;
3. the kernel against its plain PyTorch version on the card at every
   rung shape of the 1080p ladder (Y and chroma, 24 frames): max abs
   diff, differing pixels; for the kernel, the plain version and the
   library call (torch.matmul pair) the device milliseconds per call
   (torch.profiler: the sum of the call's own kernel durations, each
   call after an L2 flush) and the host-inclusive milliseconds per call
   (CUDA events around a loop of calls); the card's bound for the same
   work (the larger of bytes over the memory rate and the FLOP of the
   matrices' nonzero taps over the FP32 rate) and the kernel's share of
   it; the card's clocks, temperature and power before and after;
4. the integer stages (intra, P, deblock) on CPU and on CUDA from the
   same uint8 frames: levels, MVs and reconstructions must be identical;
5. the slice: a seeded synthetic 1920x1080 Y4M through
   ``TorchBackend(device="cuda").plan/run`` with the default ladder;
   the CMAF tree must parse with the port's own readers, the kernel's
   launch counter must rise by 3 scaled rungs x 3 planes x 1 launch
   per dispatch, and each rung's mean PSNR-Y must clear a floor;
6. where one 1080p frame's device time goes, stage by stage.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or vlog_tpu.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet peaks (non-tensor FP32; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version on the card: both are float32 with different
# summation orders, so a value within an ulp of x.5 may round the other
# way. Allowed: |diff| <= 1 everywhere, at most this share of pixels.
RESIZE_MAX_ABS = 1
RESIZE_MAX_SHARE = 1e-3
PSNR_FLOOR_DB = 30.0

SRC_H, SRC_W = 1080, 1920
FRAMES = 24             # one full 24-frame I+P chain: one dispatch
REPS = 20               # timed repetitions per kernel shape
L2_FLUSH_BYTES = 256 << 20   # > the 50 MB L2: each profiled call starts cold
CLOCKS_QUERY = ("--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
                "temperature.gpu,power.draw")
RUNG_SHAPES = ((720, 1280), (480, 854), (360, 640))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int) -> float:
    """Host-inclusive ms per call: CUDA events around a loop of calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_kernels(prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


class DeviceTimer:
    """Device ms per call from torch.profiler: the sum of the durations
    of the kernels the call launched, each call after a write of
    L2_FLUSH_BYTES (its kernels are told apart by name and left out)."""

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile

        self._profile = lambda: profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        self.flush()
        torch.cuda.synchronize()
        with self._profile() as prof:
            self.flush()
            torch.cuda.synchronize()
        self._flush_names = {e.name for e in _device_kernels(prof)}
        if not self._flush_names:
            fail("torch.profiler recorded no device kernels")

    def flush(self) -> None:
        self._buf.bitwise_not_()

    def ms(self, fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        with self._profile() as prof:
            for _ in range(reps):
                self.flush()
                fn()
            torch.cuda.synchronize()
        own = [e for e in _device_kernels(prof)
               if e.name not in self._flush_names]
        if not own:
            fail("torch.profiler recorded no device kernels of the call")
        return sum(e.device_time_total for e in own) / reps / 1e3


# ---------------------------------------------------------------------------
def phase_build():
    from vlog_tpu_torch.native import build as native_build
    from vlog_tpu_torch.ops import fused_resize

    t0 = time.perf_counter()
    fused_resize.load_library()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_build.get_lib()
    t_native = time.perf_counter() - t0
    report = [ln.strip() for ln in fused_resize.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log("ptxas: " + " | ".join(report))
    log(f"build: fused_resize {t_kernel:.2f}s (nvcc {fused_resize.build_seconds:.2f}s), "
        f"native cabac {t_native:.2f}s")


def phase_kernel(n: int) -> dict:
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix

    dev = torch.device("cuda")
    log("clocks before kernel phase (sm, mem, max sm, temp, power): "
        + smi(CLOCKS_QUERY))
    timer = DeviceTimer(dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    worst = 0
    keys = ("ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms",
            "library_call_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    for (h, w) in RUNG_SHAPES:
        for plane, (H, W, dh, dw) in (("Y", (SRC_H, SRC_W, h, w)),
                                      ("C", (SRC_H // 2, SRC_W // 2,
                                             h // 2, w // 2))):
            x = torch.randint(0, 256, (n, H, W), generator=g, device=dev,
                              dtype=torch.uint8)
            a_h = torch.as_tensor(resample_matrix(H, dh), device=dev)
            a_w = torch.as_tensor(resample_matrix(W, dw), device=dev)
            saved = fused_resize.launches
            got = fused_resize.fused_resize_plane(x, a_h, a_w)
            ref = apply_resize_matrices(x, a_h, a_w)
            torch.cuda.synchronize()
            diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
            max_abs = int(diff.max())
            n_diff = int((diff > 0).sum())
            share = n_diff / diff.numel()
            if max_abs > RESIZE_MAX_ABS or share > RESIZE_MAX_SHARE:
                fail(f"kernel disagrees at {plane} {H}x{W}->{dh}x{dw}: "
                     f"max |diff| {max_abs}, {n_diff} pixels ({share:.2e})")
            worst = max(worst, max_abs)
            xf = x.to(torch.float32)
            a_wt = a_w.t()
            fns = {"": lambda: fused_resize.fused_resize_plane(x, a_h, a_w),
                   "plain_": lambda: apply_resize_matrices(x, a_h, a_w),
                   "library_": lambda: torch.matmul(torch.matmul(a_h, xf), a_wt)}
            row = {"plane": plane, "src": [H, W], "dst": [dh, dw], "n": n,
                   "max_abs_err": max_abs, "diff_pixels": n_diff}
            for prefix, fn in fns.items():
                row[prefix + "ms"] = timer.ms(fn, REPS)
                row[prefix + "call_ms"] = call_ms(fn, REPS)
            fused_resize.launches = saved       # comparison launches do not count
            # The work the function needs: a zero tap leaves an fmaf sum
            # unchanged, so only the bands' nonzero taps count as FLOP.
            nnz_h, nnz_w = int((a_h != 0).sum()), int((a_w != 0).sum())
            flops = 2.0 * n * (nnz_h * W + dh * nnz_w)
            nbytes = n * H * W + n * dh * dw + 4 * (nnz_h + nnz_w)
            row["ops_ms"] = flops / PEAK_FP32_FLOPS * 1e3
            row["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["faster_than_plain_and_library"] = (
                row["ms"] < row["plain_ms"] and row["ms"] < row["library_ms"])
            row["taps_per_row"] = [nnz_h / dh, nnz_w / dw]
            rows.append(row)
            log("resize " + json.dumps(row))
            # chroma runs twice per dispatch (U and V)
            mult = 1 if plane == "Y" else 2
            for k in keys:
                tot[k] += mult * row[k]
            del x, xf, got, ref, diff
    tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
    tot["faster_than_plain_and_library_at_every_shape"] = all(
        r["faster_than_plain_and_library"] for r in rows)
    log("resize per dispatch " + json.dumps(tot))
    log("clocks after kernel phase (sm, mem, max sm, temp, power): "
        + smi(CLOCKS_QUERY))
    return {"max_abs_err": worst, **tot}


def _smooth_frames(n: int, h: int, w: int, seed: int):
    """Seeded 4:2:0 frames: a panning smooth texture, a moving square,
    mild noise (content with real motion for ME and deblocking)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ys, us, vs = [], [], []
    for t in range(n):
        px, py = xx + 3 * t, yy + 2 * t
        y = (110 + 50 * np.sin(px / 23.0) * np.cos(py / 31.0)
             + 30 * np.sin((px + py) / 57.0))
        bx, by = (40 + 9 * t) % max(1, w - 96), (24 + 5 * t) % max(1, h - 96)
        y[by:by + 96, bx:bx + 96] = 220.0
        y += rng.normal(0, 1.5, size=y.shape)
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        cy, cx = yy[::2, ::2], xx[::2, ::2]
        us.append(np.clip(128 + 30 * np.sin((cx + 3 * t) / 40.0), 0, 255).astype(np.uint8))
        vs.append(np.clip(128 + 30 * np.cos((cy + 2 * t) / 35.0), 0, 255).astype(np.uint8))
    return np.stack(ys), np.stack(us), np.stack(vs)


def phase_integer(devices=("cpu", "cuda")) -> None:
    from vlog_tpu_torch.codecs.h264.deblock import deblock_frame, intra_bs, p_bs
    from vlog_tpu_torch.codecs.h264.encoder import encode_frame
    from vlog_tpu_torch.codecs.h264.inter import encode_p_frame

    y, u, v = _smooth_frames(3, 144, 176, seed=7)
    results = {}
    for dev in devices:
        t = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
        qp = torch.tensor([26], dtype=torch.int32, device=dev)
        out = {}
        i = encode_frame(t(y[:1]), t(u[:1]), t(v[:1]), qp=qp)
        bv, bh = intra_bs(9, 11, dev)
        rec = deblock_frame(i["recon_y"], i["recon_u"], i["recon_v"], qp=qp,
                            bs_v=bv, bs_h=bh)
        rec = tuple(p.to(torch.uint8) for p in rec)
        out.update({f"i_{k}": val for k, val in i.items()})
        out.update({f"i_db{k}": val for k, val in enumerate(rec)})
        for f in (1, 2):
            p = encode_p_frame(t(y[f:f + 1]), t(u[f:f + 1]), t(v[f:f + 1]),
                               *rec, qp=qp + f, search=8)
            nz = (p["luma"] != 0).any(-1).any(-1)
            nz4 = nz.permute(0, 1, 3, 2, 4).reshape(1, 36, 44)
            bsv, bsh = p_bs(nz4, p["mv"])
            rec = deblock_frame(p["recon_y"], p["recon_u"], p["recon_v"],
                                qp=qp + f, bs_v=bsv, bs_h=bsh)
            rec = tuple(q.to(torch.uint8) for q in rec)
            out.update({f"p{f}_{k}": val for k, val in p.items()})
            out.update({f"p{f}_db{k}": val for k, val in enumerate(rec)})
        results[dev] = {k: val.cpu().numpy() for k, val in out.items()}
    ref, got = (results[d] for d in devices)
    bad = [k for k in ref if not np.array_equal(ref[k], got[k])]
    if bad:
        fail(f"integer stages differ between CPU and CUDA: {bad}")
    mv_max = int(np.abs(got["p2_mv"]).max())
    log(f"integer stages: {len(ref)} arrays identical on {devices[0]} and "
        f"{devices[1]} (max |mv| {mv_max} qpel)")
    # cost_proxy is a float32 log2 sum (summation order differs by
    # device): reported, and held to rtol 1e-5
    from vlog_tpu_torch.ops.bitproxy import cost_proxy

    levels = [ref[k] for k in ("p2_luma", "p2_chroma_dc", "p2_chroma_ac")]
    costs = [float(cost_proxy(*(torch.as_tensor(a, device=d) for a in levels),
                              batch_ndim=1)[0]) for d in devices]
    rel = abs(costs[1] - costs[0]) / max(abs(costs[0]), 1e-30)
    if rel > 1e-5:
        fail(f"cost_proxy differs between devices: {costs} (rel {rel:.2e})")
    log(f"cost_proxy: {devices[0]} {costs[0]!r}, {devices[1]} {costs[1]!r} "
        f"(rel diff {rel:.3e})")


def phase_breakdown() -> None:
    """Where one 1080p frame's device time goes, stage by stage (host
    clock around synchronized calls, after one warm-up call each), and
    the launch count and device-busy share of one P frame + deblock from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from vlog_tpu_torch.codecs.h264.deblock import deblock_frame, intra_bs, p_bs
    from vlog_tpu_torch.codecs.h264.encoder import encode_frame
    from vlog_tpu_torch.codecs.h264.inter import encode_p_frame, motion_search

    dev = torch.device("cuda")
    y, u, v = (torch.as_tensor(p, device=dev)
               for p in _smooth_frames(2, 1088, 1920, seed=3))
    qp = torch.tensor([30], dtype=torch.int32, device=dev)
    mbh, mbw = 1088 // 16, 1920 // 16
    ibv, ibh = intra_bs(mbh, mbw, dev)
    i = encode_frame(y[:1], u[:1], v[:1], qp=qp)
    ref = (i["recon_y"], i["recon_u"], i["recon_v"])
    p = encode_p_frame(y[1:], u[1:], v[1:], *ref, qp=qp, search=8)
    nz = (p["luma"] != 0).any(-1).any(-1)
    pbv, pbh = p_bs(nz.permute(0, 1, 3, 2, 4).reshape(1, 4 * mbh, 4 * mbw),
                    p["mv"])
    stages = {
        "intra_encode": lambda: encode_frame(y[:1], u[:1], v[:1], qp=qp),
        "intra_deblock": lambda: deblock_frame(*ref, qp=qp, bs_v=ibv, bs_h=ibh),
        "p_motion_search": lambda: motion_search(y[1:], ref[0], search=8),
        "p_encode": lambda: encode_p_frame(y[1:], u[1:], v[1:], *ref, qp=qp,
                                           search=8),
        "p_deblock": lambda: deblock_frame(p["recon_y"], p["recon_u"],
                                           p["recon_v"], qp=qp, bs_v=pbv,
                                           bs_h=pbh),
    }
    secs = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages["p_encode"]()
        stages["p_deblock"]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    prof_line = ({"launches": len(kernels), "device_busy_s": round(busy_us / 1e6, 4),
                  "wall_s": round(wall, 4),
                  "busy_share": round(busy_us / 1e6 / wall, 4)}
                 if kernels else "not measured (no device events)")
    log("breakdown 1080p frame " + json.dumps(
        {"stage_s": secs, "p_frame_and_deblock_profile": prof_line}))


def _write_y4m(path: Path, n: int, seed: int) -> None:
    with open(path, "wb") as fp:
        fp.write(f"YUV4MPEG2 W{SRC_W} H{SRC_H} F24:1 Ip A1:1 C420\n".encode())
        for k in range(0, n, 8):
            y, u, v = _smooth_frames(min(8, n - k), SRC_H, SRC_W, seed + k)
            for j in range(y.shape[0]):
                fp.write(b"FRAME\n")
                fp.write(y[j].tobytes())
                fp.write(u[j].tobytes())
                fp.write(v[j].tobytes())


def phase_slice() -> int:
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media import hls
    from vlog_tpu_torch.media.boxes import parse_box_tree
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize

    work = ROOT / "vlog_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    src = work / "src_1080p.y4m"
    t0 = time.perf_counter()
    _write_y4m(src, FRAMES, seed=11)
    log(f"slice: wrote {FRAMES}-frame 1920x1080 Y4M in {time.perf_counter() - t0:.1f}s")

    backend = TorchBackend(device="cuda")
    plan = backend.plan(get_video_info(src), out_dir=work / "out")
    log("slice plan: " + ", ".join(f"{r.name} {r.width}x{r.height} qp{r.qp} "
                                   f"{r.video_bitrate}bps" for r in plan.rungs)
        + f"; gop {plan.gop_len}, frame_batch {plan.frame_batch}")
    chains_per = max(1, -(-plan.frame_batch // plan.gop_len))
    dispatches = math.ceil(FRAMES / (chains_per * plan.gop_len))
    scaled = sum(1 for r in plan.rungs
                 if (r.height, r.width) != (SRC_H, SRC_W))
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = backend.run(plan)
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = scaled * 3 * fused_resize.LAUNCHES_PER_CALL * dispatches
    if launches != expected:
        fail(f"kernel launches {launches}, expected {expected} "
             f"({scaled} scaled rungs x 3 planes x "
             f"{fused_resize.LAUNCHES_PER_CALL} launches x {dispatches} dispatches)")
    log(f"slice: {res.frames_processed} frames in {wall:.2f}s wall; stage_s "
        + json.dumps(res.stage_s) + f"; kernel launches {launches}")

    out = work / "out"
    hls.validate_master_playlist(out / "master.m3u8")
    if not (out / "manifest.mpd").read_text().startswith("<?xml"):
        fail("manifest.mpd malformed")
    for r in res.rungs:
        with open(out / r.name / "init.mp4", "rb") as fp:
            if not any(b.type == "moov" for b in parse_box_tree(fp)):
                fail(f"{r.name}/init.mp4 has no moov")
        segs = sorted((out / r.name).glob("segment_*.m4s"))
        n_samples = 0
        for seg in segs:
            with open(seg, "rb") as fp:
                tree = parse_box_tree(fp)
            moof = next(b for b in tree if b.type == "moof")
            trun = moof.find("traf", "trun")
            n_samples += int.from_bytes(trun.payload[4:8], "big")
        if n_samples != FRAMES:
            fail(f"{r.name}: {n_samples} samples in segments, want {FRAMES}")
        if r.mean_psnr_y is None or not r.mean_psnr_y > PSNR_FLOOR_DB:
            fail(f"{r.name}: mean PSNR-Y {r.mean_psnr_y} <= {PSNR_FLOOR_DB}")
        log(f"rung {r.name} {r.width}x{r.height}: {len(segs)} segments, "
            f"{r.bytes_written} bytes, {r.achieved_bitrate} bps "
            f"(target {r.target_bitrate}), mean PSNR-Y {r.mean_psnr_y:.2f} dB")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    card = smi("--query-gpu=name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    phase_build()
    kern = phase_kernel(n=FRAMES)
    phase_integer()
    launches = phase_slice()
    phase_breakdown()

    log(json.dumps({"kernels": [{
        "name": "fused_resize_plane", "route": "cuda",
        "source": "vlog_tpu_torch/csrc/fused_resize.cu",
        "replaces": "vlog_tpu/ops/pallas_ladder.py:101",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "call_ms": kern["call_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
