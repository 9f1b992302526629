"""Ladder: back-to-back re-encodes of one seeded clip through
``vlog_tpu_torch.worker.process_video`` under a scheduler job lease, as
the worker daemon runs them, one job at a time (closed loop).

Completion events are ``process_video``'s progress callbacks: one per
dispatch whose every rung is entropy-coded and packaged, carrying its
source frames; the time between them holds every job's probe, plan,
thumbnail, verify and manifest.

The reference's view: ``check_chains`` jobs among ``check_jobs`` (an
inclusive range of job numbers) are drawn from the seed before the
window, and for each of them one dispatch and one chain, also drawn from
the seed. Each drawn chain is recorded at the chain DSP's door (its input
planes, QPs and rate-control scalars, and every integer it returns),
copied off the card into pinned host buffers made during warm-up, so the
peak memory read after the window is the program's own. After the window
the plain resize (``reference/resize.py``) is run on the benchmark's own
source frames against the planes the DSP was given, and the frozen plain
DSP (``reference/hevc_core.py``) replays the chain from those planes and
QPs. The rate control that chose the QPs is the program's state: its
start (each job's first dispatch at the rungs' configured QPs) is
checked by itself. Finished jobs' trees are checked by
``reference/cmaf.py``.

The control (``control()``): the plain resize in bfloat16 put in place
of the program's.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark import content
from benchmark.flops import resize_call_cost, roofline_seconds
from benchmark.harness import Check, Window, log
from benchmark.reference import cmaf
from benchmark.reference import hevc_core
from benchmark.reference import resize as ref_resize

RESIZE_KERNELS = ("streaming_resize_kernel", "chunked_resize_kernel")


class _Stop(Exception):
    """The window closed: the running job is left."""


def _pad(h: int, block: int = 32) -> int:
    return h + (-h) % block


class Driver:
    def __init__(self, cell, device, trace, profiler):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.device = device
        self.trace = trace
        self.profiler = profiler
        self.rungs = self.cfg["rungs"]
        self.src_h, self.src_w = self.traffic["height"], self.traffic["width"]
        self.fps = int(self.traffic["fps"])
        self.frames = int(self.traffic["frames"])
        self.gop = int(self.cfg["gop"])
        self.batch = int(self.cfg["env"]["VLOG_TPU_FRAME_BATCH"])
        self.chains = -(-self.batch // self.gop)
        self.per_dispatch = self.chains * self.gop
        self.dispatches = -(-self.frames // self.per_dispatch)
        self.jobs: list[dict] = []
        self.errors: list[str] = []
        self.samples: dict[tuple, dict] = {}
        self.host: dict[tuple, object] = {}
        self.start_qps: list[tuple] = []
        self.setup_parts: dict[str, float] = {}
        self.by_shape = {(_pad(r["height"]), _pad(r["width"])): r
                         for r in self.rungs}

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        import torch

        from vlog_tpu_torch.backends import hevc_path
        from vlog_tpu_torch.backends.torch_backend import TorchBackend
        from vlog_tpu_torch.config import QualityRung
        from vlog_tpu_torch.native import build as native_build
        from vlog_tpu_torch.ops import fused_resize
        from vlog_tpu_torch.parallel import hevc_ladder
        from vlog_tpu_torch.parallel.compile_cache import compile_seconds
        from vlog_tpu_torch.parallel.scheduler import MeshScheduler
        from vlog_tpu_torch.worker import process_video

        self.torch = torch
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            fused_resize.load_library()
        native_build.get_lib()
        self.setup_parts["build_s"] = time.perf_counter() - t0
        self.setup_parts["build_compiler_s"] = compile_seconds()

        t0 = time.perf_counter()
        base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
        self.work = Path(tempfile.mkdtemp(prefix="bench-ladder-", dir=base))
        self.clip = content.write_clip(self.work / "clip.y4m", self.frames,
                                       self.src_h, self.src_w, self.fps, seed,
                                       self.device)
        self.setup_parts["clip_s"] = time.perf_counter() - t0

        self.backend = TorchBackend(device=self.device)
        self.scheduler = (MeshScheduler() if self.device.type == "cuda"
                          else MeshScheduler(devices=["cpu"], slots=1))
        self.process_video = process_video
        self.hevc_ladder, self.hevc_path = hevc_ladder, hevc_path
        self.rung_objs = tuple(
            QualityRung(name=r["name"], height=r["height"],
                        video_bitrate=r["video_bitrate"],
                        audio_bitrate=r["audio_bitrate"], base_qp=r["qp"])
            for r in self.rungs)
        rng = np.random.default_rng(seed)
        lo, hi = self.traffic["check_jobs"]
        drawn = rng.permutation(np.arange(lo, hi + 1))[
            :int(self.traffic["check_chains"])]
        self.judged = {int(j): (slot, int(rng.integers(self.dispatches)),
                                int(rng.integers(self.chains)))
                       for slot, j in enumerate(sorted(drawn.tolist()))}
        self._install_taps()
        self.profiler.warm(self.device)

        # warm-up: one dispatch of a job at the window's shapes; the
        # drawn chains' host buffers are made here
        t0 = time.perf_counter()
        self._measuring = False

        def stop_after_first(done, total, msg):
            raise _Stop()

        try:
            self._job(self.work / "warm-up", stop_after_first)
        except _Stop:
            pass
        shutil.rmtree(self.work / "warm-up", ignore_errors=True)
        self.setup_parts["warm_up_s"] = time.perf_counter() - t0

    def _job(self, out: Path, progress):
        ticket = self.scheduler.admit()
        try:
            with ticket.acquire():
                return self.process_video(
                    self.clip, out, backend=self.backend, codec="h265",
                    keep_original=False, progress_cb=progress,
                    rungs=self.rung_objs, frame_batch=self.batch)
        finally:
            ticket.close()

    def _install_taps(self) -> None:
        """At the chain DSP's door: the drawn chain of each judged job,
        every rung; each job's first-dispatch QPs. Around the ladder
        program: the dispatch count, and in a traced run one profiled
        dispatch."""
        orig_dsp = self.hevc_ladder.encode_chain_dsp
        orig_grid = self.hevc_path.hevc_chain_ladder_grid
        self._orig = (orig_dsp, orig_grid)

        def dsp(y, u, v, search, qp_i, qp_p, partitions=False, deblock=False,
                rc=None):
            out = orig_dsp(y, u, v, search, qp_i, qp_p, partitions, deblock, rc)
            rung = self.by_shape.get(tuple(y.shape[-2:]))["name"]
            if not self._measuring:
                for slot, _, _ in self.judged.values():
                    self._keep(slot, rung, 0, _named(y, u, v, out), copy=False)
                return out
            job, d = len(self.jobs) - 1, self._dispatch
            if d == 0:
                self.start_qps.append((rung, qp_i.clone(), qp_p.clone()))
            slot, want_d, want_c = self.judged.get(job, (None, -1, -1))
            if d == want_d and want_c < y.shape[0]:
                c = want_c
                self.samples[(job, rung)] = {
                    "dispatch": d, "chain": c, "search": search,
                    "deblock": deblock, "qp_i": qp_i[c:c + 1].clone(),
                    "qp_p": qp_p[c:c + 1].clone(),
                    "rc": None if rc is None else {
                        k: val.clone() if hasattr(val, "clone")
                        else np.asarray(val) for k, val in rc.items()},
                    "kept": self._keep(slot, rung, c, _named(y, u, v, out))}
            return out

        def grid(*a, **kw):
            prog = orig_grid(*a, **kw)
            inner = prog.dispatch

            def dispatch(*da, **dkw):
                if (self._measuring and self.trace
                        and not self.profiler.taken
                        and self.window.closed(time.perf_counter())):
                    n = int(da[0].shape[0]) * int(da[0].shape[1])
                    out = self.profiler.record(
                        inner, *da, meta={"frames": n,
                                          "first": self._dispatch == 0},
                        **dkw)
                else:
                    out = inner(*da, **dkw)
                self._dispatch += 1
                return out

            prog.dispatch = dispatch
            return prog

        self._dispatch = 0
        self.hevc_ladder.encode_chain_dsp = dsp
        self.hevc_path.hevc_chain_ladder_grid = grid

    def _keep(self, slot: int, rung: str, c: int, tensors: dict,
              copy: bool = True) -> dict:
        """Chain ``c`` of each tensor, copied without a wait into this
        slot's host buffer (pinned on the card's machine); with ``copy``
        false the buffers are only made."""
        torch = self.torch
        kept = {}
        for name, t in tensors.items():
            if t is None:
                kept[name] = None
                continue
            src = t[c:c + 1]
            key = (slot, rung, name)
            if key not in self.host:
                self.host[key] = torch.empty(
                    src.shape, dtype=src.dtype,
                    pin_memory=self.device.type == "cuda")
            if copy:
                self.host[key].copy_(src, non_blocking=True)
            kept[name] = self.host[key]
        return kept

    # -- the window -------------------------------------------------------
    def measure(self, seconds: float) -> Window:
        self.window = Window(seconds)
        self._measuring = True
        hard = time.perf_counter() + seconds + float(
            self.traffic["first_event_wait_s"])
        while True:
            k = len(self.jobs)
            rec = {"k": k, "out": self.work / f"job{k}", "frames": 0}
            self.jobs.append(rec)
            self._dispatch = 0

            def progress(done, total, msg, rec=rec):
                now = time.perf_counter()
                self.window.add(now, done - rec["frames"])
                rec["frames"] = done
                if now > hard or (self.window.closed(now) and (
                        not self.trace or self.profiler.taken)):
                    raise _Stop()

            rec["t0"] = time.perf_counter()
            try:
                rec["result"] = self._job(rec["out"], progress)
                rec["t1"] = time.perf_counter()
            except _Stop:
                rec["stopped"] = True
                break
            except Exception as exc:  # noqa: BLE001 — counted as failed
                self.errors.append(f"job{k}: {exc!r}")
                break
            now = time.perf_counter()
            if now > hard or (self.window.closed(now) and (
                    not self.trace or self.profiler.taken)):
                break
        self._measuring = False
        self.hevc_ladder.encode_chain_dsp, self.hevc_path.hevc_chain_ladder_grid \
            = self._orig
        return self.window

    def finished(self) -> list[dict]:
        """Jobs that finished inside the window."""
        span = self.window.span
        if span is None:
            return []
        return [j for j in self.jobs if "result" in j
                and span[0] <= j["t1"] <= span[1]]

    def end_to_end(self) -> dict:
        return {"ladder_fps": self.window.rate()}

    def attempted_failed(self) -> tuple[int, int]:
        return len(self.jobs), len(self.errors)

    # -- what the per-layer readers read ----------------------------------
    def resize_roofline_pct(self) -> float | None:
        """The profiled dispatch's resize kernels against the bound of
        their calls (three per scaled rung, and the thumbnail's three when
        they fall inside the slice): the summed least times over the
        summed kernel times."""
        sl = self.profiler.slice
        if sl is None:
            return None
        calls = [k for k in sl.kernels
                 if any(name in k[0] for name in RESIZE_KERNELS)]
        frames = sl.meta["frames"]
        want = []
        if sl.meta["first"] and len(calls) == 3 * (len(self.rungs) - 1) + 3:
            # a job's first dispatch, with its thumbnail's three one-frame
            # calls (on the host pool) inside the slice
            (ah, aw), (ch, cw) = ref_resize.rung_matrices(
                self.src_h, self.src_w, *self.cfg["thumbnail_hw"])
            want.append(resize_call_cost(1, (self.src_h, self.src_w), ah, aw))
            for _ in range(2):
                want.append(resize_call_cost(
                    1, (self.src_h // 2, self.src_w // 2), ch, cw))
        for r in self.rungs:
            if (r["height"], r["width"]) == (self.src_h, self.src_w):
                continue
            (ah, aw), (ch, cw) = ref_resize.rung_matrices(
                self.src_h, self.src_w, r["height"], r["width"])
            want.append(resize_call_cost(frames, (self.src_h, self.src_w),
                                         ah, aw))
            for _ in range(2):
                want.append(resize_call_cost(
                    frames, (self.src_h // 2, self.src_w // 2), ch, cw))
        if len(calls) != len(want) or not want:
            log(f"resize roofline: {len(calls)} kernels for {len(want)} "
                "calls in the slice; not read")
            return None
        bound = sum(roofline_seconds(b, o) for b, o in want)
        took = sum(d for _, _, d in calls) / 1e6
        return 100.0 * bound / took

    # -- correctness ------------------------------------------------------
    def judge(self, seed: int):
        torch = self.torch
        faults = list(self.errors)
        dsp_bad, maes = 0, []
        if self.device.type == "cuda":
            torch.cuda.synchronize()            # the host copies have landed
        torch.backends.cuda.matmul.allow_tf32 = False
        for (job, rung_name), s in sorted(self.samples.items()):
            rung = next(r for r in self.rungs if r["name"] == rung_name)
            first = s["dispatch"] * self.per_dispatch + s["chain"] * self.gop
            planes = [s["kept"][k].to(self.device) for k in "yuv"]
            n = planes[0].shape[1]
            src = [torch.as_tensor(p, device=self.device)
                   for p in content.read_clip(self.clip, first, n)]
            got = [p[0, :, :h, :w] for p, (h, w) in zip(
                planes, ((rung["height"], rung["width"]),
                              (rung["height"] // 2, rung["width"] // 2),
                              (rung["height"] // 2, rung["width"] // 2)))]
            if (rung["height"], rung["width"]) == (self.src_h, self.src_w):
                dsp_bad += sum(int((a != b).sum()) for a, b in zip(got, src))
            else:
                (ah, aw), (ch, cw) = ref_resize.rung_matrices(
                    self.src_h, self.src_w, rung["height"], rung["width"])
                for plane, g, mh, mw in zip(src, got, (ah, ch, ch),
                                            (aw, cw, cw)):
                    want = ref_resize.resize_plane(plane, mh, mw)
                    maes.append(float((want.float() - g.float()).abs().mean()))
            dsp_bad += self._replay(s, planes)
        for rung_name, qp_i, qp_p in self.start_qps:
            qp_i, qp_p = qp_i.cpu().numpy(), qp_p.cpu().numpy()
            base = next(r for r in self.rungs if r["name"] == rung_name)["qp"]
            if (qp_p != base).any() or (qp_i != max(base - 2, 10)).any():
                dsp_bad += 1
                faults.append(f"{rung_name}: first dispatch QPs "
                              f"{qp_i.tolist()} {np.unique(qp_p).tolist()}")
        tree = 0
        done = self.finished()
        rng = np.random.default_rng(seed + 1)
        for j in rng.permutation(done)[:int(self.traffic["check_trees"])]:
            bad = cmaf.tree_faults(j["out"], self.rungs, self.frames, self.fps,
                                   self.gop)
            tree += len(bad)
            faults += bad[:3]
        if not self.samples or not done:
            faults.append("no sampled chain or no finished job in the window")
            tree += 1
        resize_mae = max(maes) if maes else 0.0
        log(f"ladder: {len(self.samples)} chains judged, "
            f"{len(done)} jobs finished in the window")
        for f in faults[:8]:
            log(f"fault: {f}")
        lim = self.cfg["limits"]
        return [Check("resize_mae", resize_mae, lim["resize_mae"]),
                Check("dsp_mismatch", float(dsp_bad), 0.0),
                Check("tree_faults", float(tree + len(self.errors)), 0.0)]

    def _replay(self, s: dict, planes: list) -> int:
        """Integers of the recorded chain that the reference DSP gives
        otherwise (the byte proxy's float cost within rtol 1e-5)."""
        torch = self.torch
        y, u, v = planes
        rc = None if s["rc"] is None else {
            k: torch.as_tensor(val, device=self.device)
            for k, val in s["rc"].items()}
        with torch.inference_mode():
            ref = hevc_core.encode_chain_dsp(y, u, v, s["search"], s["qp_i"],
                                             s["qp_p"], False, s["deblock"],
                                             rc)
        want = _named(y, u, v, ref)
        bad = 0
        for name, a in s["kept"].items():
            if name in "yuv" or name.startswith("rc.") or a is None:
                continue
            b = want.get(name)
            bad += a.numel() if b is None else int(
                (a.to(self.device) != b).sum())
        if len(ref) > 2:
            got = s["kept"]["rc.qp_eff"].to(self.device)
            bad += int((got != ref[2]["qp_eff"]).sum())
            want_cost = ref[2]["cost"]
            bad += int((torch.abs(s["kept"]["rc.cost"].to(self.device)
                                  - want_cost)
                        > 1e-5 * torch.abs(want_cost)).sum())
        return bad

    def close(self) -> None:
        work = getattr(self, "work", None)       # None when set-up failed
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)


def _named(y, u, v, out) -> dict:
    """The chain DSP's inputs and outputs by name (``i_levels.0``, ...)."""
    (li, ri), (p32, _, _, mvs, prec) = out[0], out[1]
    named = {"y": y, "u": u, "v": v, "mvs": mvs}
    for tag, seq in (("i_levels", li), ("i_recon", ri),
                     ("p_levels", p32 or ()), ("p_recon", prec or ())):
        for i, a in enumerate(seq):
            named[f"{tag}.{i}"] = a
    if len(out) > 2:
        for k, val in out[2].items():
            named[f"rc.{k}"] = val
    return named


@contextlib.contextmanager
def control():
    """The control, planted in the program: the plain resize with its
    products in bfloat16 (one precision below the configuration's
    float32) in place of the program's, from the reference's own
    matrices."""
    import torch

    from vlog_tpu_torch.parallel import hevc_ladder

    orig = hevc_ladder.resize_yuv420

    def low(y, u, v, mats):
        if mats is None:
            return orig(y, u, v, mats)
        (ah, aw), (ch, cw) = mats
        return tuple(ref_resize.resize_plane(
            p, ref_resize.resample_matrix(p.shape[-2], mh.shape[0]),
            ref_resize.resample_matrix(p.shape[-1], mw.shape[0]),
            dtype=torch.bfloat16)
            for p, mh, mw in zip((y, u, v), (ah, ch, ch), (aw, cw, cw)))

    hevc_ladder.resize_yuv420 = low
    try:
        yield
    finally:
        hevc_ladder.resize_yuv420 = orig
