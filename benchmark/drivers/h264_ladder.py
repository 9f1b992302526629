"""H.264 ladder: back-to-back encodes of one seeded clip through
``vlog_tpu_torch.worker.process_video`` with the default codec
(``codec="h264"``: CABAC, in-loop deblocking, I+P chains with the
in-chain rate cascade), under a scheduler job lease, one job at a time
(closed loop). The window, the jobs loop, the job records and the
profiled dispatch are the HEVC ladder driver's (``drivers/ladder.py``),
taken over by subclassing; what differs is where the chains are tapped
and what judges them.

The reference's view: ``check_chains`` (job, chain) pairs among the jobs
``check_jobs`` (an inclusive range of job numbers) are drawn from the
seed before the window, with one dispatch each, also drawn. Each drawn
chain is recorded inside the chain step (``parallel/ladder.py::
_one_rung``): the planes its resize gave the DSP, its QPs and rate-control
scalars, every frame's filtered reconstruction and every integer the
step returns, copied off the card into host buffers made during warm-up
(pinned on the card's machine), so the peak memory read after the window
is the program's own. After the window the frozen plain H.264 DSP
(``reference/h264_core.py``) replays the drawn chains, in one batch, from
those planes, QPs and scalars; the planes of the identity rung must
equal the benchmark's own source frames, and each job's first-dispatch
QPs the rungs' configured ones. Finished jobs' trees are checked by
``reference/cmaf_avc.py``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import content
from benchmark.drivers import ladder
from benchmark.harness import Check, log
from benchmark.reference import cmaf_avc, h264_core

# the chain step's names the taps replace, in parallel/ladder.py
TAPPED = ("_one_rung", "resize_yuv420", "encode_frame", "encode_p_frame",
          "deblock_frame")
LEVELS = ("i_luma_dc", "i_luma_ac", "i_chroma_dc", "i_chroma_ac", "p_luma",
          "p_chroma_dc", "p_chroma_ac", "mv")


class Driver(ladder.Driver):
    def __init__(self, cell, device, trace, profiler):
        super().__init__(cell, device, trace, profiler)
        for r in self.rungs:
            if (r["height"], r["width"]) != (self.src_h, self.src_w):
                raise ValueError(f"{r['name']}: this driver judges identity "
                                 "rungs only (no resize check)")
        # the HEVC driver's measure() puts its taps back through these
        # two attributes: here they point at a stand-in, and this
        # driver's taps come off in measure() below
        self.hevc_ladder = SimpleNamespace()
        self.hevc_path = SimpleNamespace()
        self._orig = (None, None)

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        import torch

        from vlog_tpu_torch.backends import torch_backend
        from vlog_tpu_torch.backends.torch_backend import TorchBackend
        from vlog_tpu_torch.config import QualityRung
        from vlog_tpu_torch.native import build as native_build
        from vlog_tpu_torch.ops import fused_resize
        from vlog_tpu_torch.parallel import ladder as chain_ladder
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
        self.work = Path(tempfile.mkdtemp(prefix="bench-h264-", dir=base))
        self.clip = content.write_clip(self.work / "clip.y4m", self.frames,
                                       self.src_h, self.src_w, self.fps, seed,
                                       self.device)
        self.setup_parts["clip_s"] = time.perf_counter() - t0

        self.backend = TorchBackend(device=self.device)
        self.scheduler = (MeshScheduler() if self.device.type == "cuda"
                          else MeshScheduler(devices=["cpu"], slots=1))
        self.process_video = process_video
        self.chain_ladder, self.torch_backend = chain_ladder, torch_backend
        self.rung_objs = tuple(
            QualityRung(name=r["name"], height=r["height"],
                        video_bitrate=r["video_bitrate"],
                        audio_bitrate=r["audio_bitrate"], base_qp=r["qp"])
            for r in self.rungs)
        rng = np.random.default_rng(seed)
        lo, hi = self.traffic["check_jobs"]
        pairs = [(j, c) for j in range(lo, hi + 1) for c in range(self.chains)]
        drawn = sorted(pairs[int(i)] for i in rng.permutation(len(pairs))[
            :int(self.traffic["check_chains"])])
        # {(job, dispatch): [(slot, chain), ...]}
        self.judged: dict[tuple, list] = {}
        for slot, (j, c) in enumerate(drawn):
            d = int(rng.integers(self.dispatches))
            self.judged.setdefault((j, d), []).append((slot, c))
        self._install_taps()
        self.profiler.warm(self.device)

        # warm-up: one dispatch of a job at the window's shapes; the
        # drawn chains' host buffers are made here
        t0 = time.perf_counter()
        self._measuring = False

        def stop_after_first(done, total, msg):
            raise ladder._Stop()

        try:
            self._job(self.work / "warm-up", stop_after_first)
        except ladder._Stop:
            pass
        shutil.rmtree(self.work / "warm-up", ignore_errors=True)
        self.setup_parts["warm_up_s"] = time.perf_counter() - t0

    def _job(self, out: Path, progress):
        ticket = self.scheduler.admit()
        try:
            with ticket.acquire():
                return self.process_video(
                    self.clip, out, backend=self.backend, codec="h264",
                    keep_original=False, progress_cb=progress,
                    rungs=self.rung_objs, frame_batch=self.batch)
        finally:
            ticket.close()

    def _install_taps(self) -> None:
        """Inside the chain step: the drawn chains of each judged job's
        dispatch, every rung, and each job's first-dispatch QPs. Around
        the ladder program: the dispatch count, and in a traced run one
        profiled dispatch."""
        mod = self.chain_ladder
        orig = {name: getattr(mod, name) for name in TAPPED}
        orig_grid = self.torch_backend.ladder_chain_grid
        self._orig_taps = (orig, orig_grid)
        self._tap = None        # the running judged call's chains

        def keep(tensors: dict, step_of=None) -> None:
            tap = self._tap
            for slot, c in tap["chains"]:
                self._keep(slot, tap["rung"], c,
                           {k if step_of is None else f"{k}.{step_of}": t
                            for k, t in tensors.items()},
                           copy=tap["copy"])

        def one_rung(y, u, v, rung_mats, qps, h, w, *, search, deblock, rcr):
            rung = next(r["name"] for r in self.rungs
                        if (r["height"], r["width"]) == (h, w))
            if not self._measuring:
                chains = [(slot, 0) for pairs in self.judged.values()
                          for slot, _ in pairs]
                copy = False
            else:
                job, d = len(self.jobs) - 1, self._dispatch
                if d == 0:
                    self.start_qps.append((rung, qps.clone()))
                chains = [(slot, c) for slot, c in
                          self.judged.get((job, d), ()) if c < y.shape[0]]
                copy = True
            if not chains:
                return orig["_one_rung"](y, u, v, rung_mats, qps, h, w,
                                         search=search, deblock=deblock,
                                         rcr=rcr)
            self._tap = {"chains": chains, "rung": rung, "copy": copy,
                         "lead": tuple(y.shape[:2]), "step": 0}
            try:
                out = orig["_one_rung"](y, u, v, rung_mats, qps, h, w,
                                        search=search, deblock=deblock,
                                        rcr=rcr)
                keep({"qps": qps, **{k: out[k] for k in LEVELS},
                      **{k: out[k] for k in ("qp_eff", "cost") if k in out}})
            finally:
                self._tap = None
            if copy:
                for slot, c in chains:
                    job = len(self.jobs) - 1
                    self.samples[(job, rung, c)] = {
                        "slot": slot, "dispatch": self._dispatch, "chain": c,
                        "search": search, "deblock": deblock,
                        "rc": None if rcr is None else
                        {k: float(val) for k, val in rcr.items()}}
            return out

        def resize(y, u, v, mats):
            out = orig["resize_yuv420"](y, u, v, mats)
            if self._tap is not None:
                lead = self._tap["lead"]
                keep({k: p.reshape(lead + tuple(p.shape[1:]))
                      for k, p in zip("yuv", out)})
            return out

        def recon(tensors: dict) -> None:
            keep({f"recon_{k}": t.to(self.torch.uint8)
                  for k, t in tensors.items()}, step_of=self._tap["step"])

        def encode_frame(y, u, v, *, qp):
            out = orig["encode_frame"](y, u, v, qp=qp)
            if self._tap is not None:
                self._tap["step"] = 0
                recon({k: out[f"recon_{k}"] for k in "yuv"})
            return out

        def encode_p_frame(y, u, v, ref_y, ref_u, ref_v, *, qp, search=8):
            out = orig["encode_p_frame"](y, u, v, ref_y, ref_u, ref_v, qp=qp,
                                         search=search)
            if self._tap is not None:
                self._tap["step"] += 1
                recon({k: out[f"recon_{k}"] for k in "yuv"})
            return out

        def deblock_frame(y, u, v, *, qp, bs_v, bs_h):
            out = orig["deblock_frame"](y, u, v, qp=qp, bs_v=bs_v, bs_h=bs_h)
            if self._tap is not None:
                recon(dict(zip("yuv", out)))        # the filtered frame
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
        for name, fn in (("_one_rung", one_rung), ("resize_yuv420", resize),
                         ("encode_frame", encode_frame),
                         ("encode_p_frame", encode_p_frame),
                         ("deblock_frame", deblock_frame)):
            setattr(mod, name, fn)
        self.torch_backend.ladder_chain_grid = grid

    def _untap(self) -> None:
        orig, orig_grid = self._orig_taps
        for name, fn in orig.items():
            setattr(self.chain_ladder, name, fn)
        self.torch_backend.ladder_chain_grid = orig_grid

    # -- the window -------------------------------------------------------
    def measure(self, seconds: float):
        try:
            return super().measure(seconds)
        finally:
            self._untap()

    # -- correctness ------------------------------------------------------
    def judge(self, seed: int):
        torch = self.torch
        faults = list(self.errors)
        dsp_bad = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize()            # the host copies have landed
        by_rung: dict[str, list] = {}
        for (job, rung, c), s in sorted(self.samples.items()):
            by_rung.setdefault(rung, []).append(s)
        for rung_name, samples in by_rung.items():
            bad, why = self._replay(rung_name, samples)
            dsp_bad += bad
            faults += why
        for rung_name, qps in self.start_qps:
            qps = qps.cpu().numpy()
            base = next(r for r in self.rungs if r["name"] == rung_name)["qp"]
            if (qps[:, 1:] != base).any() or \
                    (qps[:, 0] != max(base - 2, 0)).any():
                dsp_bad += 1
                faults.append(f"{rung_name}: first dispatch QPs "
                              f"{np.unique(qps).tolist()}")
        tree = 0
        # jobs that ran to their end, inside the window or after it: the
        # window's two or three events leave one job or none whose end
        # falls inside it
        done = [j for j in self.jobs if "result" in j]
        rng = np.random.default_rng(seed + 1)
        for j in rng.permutation(done)[:int(self.traffic["check_trees"])]:
            bad = cmaf_avc.tree_faults(j["out"], self.rungs, self.frames,
                                       self.fps, self.gop)
            tree += len(bad)
            faults += bad[:3]
        if not self.samples or not done:
            faults.append("no sampled chain or no finished job")
            tree += 1
        log(f"h264 ladder: {len(self.samples)} chains judged, "
            f"{len(done)} jobs finished, {len(self.finished())} in the "
            "window")
        for f in faults[:8]:
            log(f"fault: {f}")
        return [Check("dsp_mismatch", float(dsp_bad), 0.0),
                Check("tree_faults", float(tree + len(self.errors)), 0.0)]

    def _replay(self, rung_name: str, samples: list) -> tuple[int, list]:
        """Integers of the recorded chains of one rung that the reference
        DSP gives otherwise (the bit proxy's float cost within rtol 1e-5),
        and the planes' pixels that differ from the source frames."""
        torch = self.torch
        dev = self.device

        def kept(s, name):
            return self.host[(s["slot"], rung_name, name)].to(dev)

        bad, why = 0, []
        planes = {k: torch.cat([kept(s, k) for s in samples]) for k in "yuv"}
        clen = planes["y"].shape[1]
        for i, s in enumerate(samples):
            first = s["dispatch"] * self.per_dispatch + s["chain"] * self.gop
            src = content.read_clip(self.clip, first, clen)
            for k, want in zip("yuv", src):
                n = int((planes[k][i] != torch.as_tensor(want, device=dev))
                        .sum())
                if n:
                    bad += n
                    why.append(f"{rung_name}: chain {s['chain']}: {n} {k} "
                               "pixels differ from the source")
        qps = torch.cat([kept(s, "qps") for s in samples])
        rcs = [s["rc"] for s in samples]
        rc = None if rcs[0] is None else {
            k: torch.tensor([r[k] for r in rcs], dtype=torch.float32,
                            device=dev) for k in rcs[0]}
        s0 = samples[0]
        with torch.inference_mode():
            ref = h264_core.encode_chain(planes["y"], planes["u"],
                                         planes["v"], qps,
                                         search=s0["search"],
                                         deblock=s0["deblock"], rc=rc)
        names = list(LEVELS) + [f"recon_{k}.{t}" for t in range(clen)
                                for k in "yuv"]
        if rc is not None:
            names.append("qp_eff")
        for name in names:
            got = torch.cat([kept(s, name) for s in samples]).to(torch.int32)
            if "." in name:
                key, t = name.split(".")
                want = ref[key][:, int(t)]
            else:
                want = ref[name]
            n = int((got != want.to(torch.int32)).sum())
            if n:
                bad += n
                why.append(f"{rung_name}: {name}: {n} differ")
        if rc is not None:
            got = torch.cat([kept(s, "cost") for s in samples])
            want = ref["cost"]
            diff = torch.abs(got - want)
            log(f"{rung_name}: cost: largest relative difference "
                f"{float((diff / torch.abs(want)).max()):.3e}")
            n = int((diff > 1e-5 * torch.abs(want)).sum())
            if n:
                bad += n
                why.append(f"{rung_name}: cost: {n} beyond rtol 1e-5")
        return bad, why


@contextlib.contextmanager
def control():
    """The control, planted in the program: the rate cascade's bit proxy
    summed in bfloat16 (one precision below the configuration's float32;
    everything else the DSP computes is integer and exact)."""
    import torch

    from vlog_tpu_torch.parallel import ladder as chain_ladder

    orig = chain_ladder.cost_proxy

    def low(*level_arrays, batch_ndim=0):
        tot = 0.0
        for a in level_arrays:
            af = a.to(torch.bfloat16).abs()
            dims = tuple(range(batch_ndim, a.dim()))
            tot = tot + torch.sum((af > 0).to(torch.bfloat16)
                                  + torch.log2(1.0 + af), dim=dims)
        return tot.to(torch.float32)

    chain_ladder.cost_proxy = low
    try:
        yield
    finally:
        chain_ladder.cost_proxy = orig
