"""Chip smoke for the PyTorch/CUDA port: drive its main path on one card.

    python3 chip_smoke.py            # every phase, one card, no options

Phases (any failure exits non-zero; none is caught):

1. the card's name and power limit (nvidia-smi);
2. build the fused resize kernel (nvcc, sm_90a) and the native entropy
   coders (CABAC, CAVLC, JPEG scan) from the checkout's sources, the two
   builds started together, timed;
3. the kernel against its plain PyTorch version on the card at every
   rung shape of the 1080p ladder (Y and chroma) and at every frame
   count a backend phase calls it with (24, 8, 6, 4 and 1), and at the
   sprite tiles' shapes (160x90, chroma 80x45) at the counts the sprite
   phase calls with (8 and 2): max abs diff, differing pixels; at 24
   frames (sprite tiles: 8), for the kernel, the plain version and
   the library call (torch.matmul pair) the device milliseconds per call
   (torch.profiler: the sum of the call's own kernel durations, each
   call after an L2 flush; the raw kineto events and ``prof.events()``
   must agree) and the host-inclusive milliseconds per call
   (CUDA events around a loop of calls); the card's bound for the same
   work (the larger of bytes over the memory rate and the FLOP of the
   matrices' nonzero taps over the FP32 rate) and the kernel's share of
   it; the card's clocks, temperature and power before and after;
4. the integer stages (intra, P, deblock) on CPU and on CUDA from the
   same uint8 frames: levels, MVs and reconstructions must be identical;
5. the slice: the first 8 frames of a seeded synthetic 1920x1080 Y4M
   through ``TorchBackend(device="cuda").plan/run`` with the defaults
   (default ladder, thumbnail, resume, the executor at depth 2: one
   24-frame chain cut to 8 frames, one dispatch); ``stage_s`` must hold
   the reference's stage keys and the executor's gauges
   (``max_in_flight`` >= 1); the CMAF tree must parse with the port's
   own readers, the kernel's launch counter must rise by 3 scaled rungs
   x 3 planes x 1 launch per dispatch plus 3 for the thumbnail, each
   rung's mean PSNR-Y must clear a floor, the journal must hold one line
   per dispatch after its header, and ``thumbnail.jpg`` must be a
   1280x720 JPEG, the packed blocks of the backend's thumbnail stages
   on the card; the same stages on the CPU path must agree with the
   card's within the kernel's bound (resized planes) and the
   coefficients' bound;
6. intra: the same source, ``gop_mode="intra"``, 8 frames (one
   dispatch), default ladder: 9 launches, the tree parses, PSNR floor;
7. pipeline: the first 4 samples of the slice's 1080p rung (1 IDR + 3
   P, CABAC, deblocked, its rate control's QPs), taken from its CMAF
   segment with the avcC of its init segment, with an AAC track as long
   as the video (a seeded stereo 48 kHz signal encoded by the port's
   ``AacEncoder`` on the card), written as a progressive MP4 by the
   port's writer, through ``process_video(path, out,
   backend=get_backend("torch"))`` with the defaults: probe, original,
   the ladder (the decoder reconstructs and deblocks on the card; 12
   launches, 9 + 3 for the thumbnail), three audio renditions (192k,
   128k, 96k) that decode to the source track, ``master.m3u8`` with
   EXT-X-MEDIA, ``manifest.mpd`` with the audio adaptation set,
   ``outputs.json`` verifying the tree, one ``qualities`` row per rung,
   the seconds of each step; the run's frames 0-1 bit-identical to the
   port's CPU decode of the same samples; frame 1 read on a fresh
   source equal to the run's frame 1 (a read that starts mid-GOP);
   ``decode_s`` split into the host parse, the reconstruction and the
   deblocking filter;
   pipeline_ts: the same MP4, the 360p rung, ``hls_ts``: whole 188-byte
   packets, 4 video PES, audio PES on the audio PID in every segment,
   6 launches (3 + 3 for the thumbnail);
8. sprites: ``generate_sprites(device="cuda")`` on an all-intra 1080p MP4
   made the same way from the intra phase's 1080p rung (8 samples),
   sampling every frame (one chunk of 8 tiles), and on the I+P MP4
   sampling frames 0 and 2 (a chunk of 2; the second read continues
   from frame 1, no restart at the IDR): sheet size, VTT cues, 3
   launches each, each call's tiles held to the plain version, the I+P
   run's sampled frames equal to the mp4 run's;
9. resume: the same source, the 360p rung, 12 frames, 0.25 s segments
   and one 6-frame chain per dispatch (two dispatches): an uninterrupted
   run, and a run stopped after dispatch 1 by its ``progress_cb`` (at
   depth 2 the executor may have queued dispatch 2 by then; the launch
   count allows for it) and then resumed; the two trees must be
   identical, journal included;
10. MPEG-TS: the same source and rung, 6 frames (one 0.25 s segment),
   ``hls_ts``: whole 188-byte packets, one video PES per frame;
10a. hevc: the 24-frame source through ``process_video(src, out,
   backend=get_backend("torch"), codec="h265")`` with the defaults (the
   4-rung ladder, one 24-frame I+P chain in one dispatch, deblocking,
   rate control, thumbnail): 12 launches (9 + 3 for the thumbnail), the
   tree parses with the port's readers (hvc1 sample entry with the
   encoder's hvcC, every segment's samples), ``outputs.json`` verifies,
   hvc1 ``qualities`` rows, the PSNR floor, seconds per step and
   ``stage_s``; the chain DSP on CPU and CUDA from the same padded 1080p
   frames (1 I + 2 P, deblock, the rate cascade): levels, MVs,
   reconstructions and ``qp_eff`` identical, ``cost`` within 1e-5; a
   640x360 source on its identity rung (6 frames, no thumbnail, no
   resize) written by ``TorchBackend`` on CUDA and on the CPU: the two
   trees byte-identical; where one 1080p HEVC frame's time goes (seconds,
   launches and device-busy share per stage, host entropy for I and P);
10b. aac (run right after the integer stages, sharing the kernel
   phase's profiler timer): ``AacEncoder(device="cuda")`` against
   ``device="cpu"`` at 128 kbps on 6 s of seeded stereo 48 kHz audio
   (283 payloads): identical,
   or within AAC_BYTES_RTOL of bytes and AAC_SNR_DB_TOL of SNR; the same
   on a band-limited 1 s track (printed); the host seconds of
   everything after the MDCT per audio second; ``forward_mdct`` alone on
   a 30 s chunk ((2, 1408, 2048) x (2048, 1024) float32, TF32 off),
   device ms against its bound; no resize launch;
10c. runtime (the device runtime): HEVC on the 24-frame source at
   depths 1, 2 and 3 (``VLOG_PIPELINE_DEPTH``) with the 4-rung ladder at
   constant QP in four 6-frame dispatches: byte-identical trees (the
   journal and ``outputs.json`` aside), 36 launches each, wall and
   ``stage_s`` per depth; H.264 on the resume phase's 360p rung at
   constant QP (12 frames, two dispatches) at depths 1 and 2: identical
   trees, depth 2 reaching ``max_in_flight`` 2; ``backend.pull`` armed
   once (its second hit) at depth 2: the run raises, no ``vlog-pipe*`` or
   ``vlog-decode*`` thread is left, the resumed run writes the
   uninterrupted tree; a ``MeshScheduler`` over the card with one slot:
   an HEVC ``process_video`` under a lease (given a CPU backend, it runs
   on the lease's card: 12 launches) and a ``transcribe_video`` through
   an ``AsrEngine`` given the scheduler (a tiny random-weight Whisper,
   35 s of audio) run one after the other on width-1 leases, capacity
   returns to 1, a fault at threshold 1 quarantines the card (slots 0)
   and the CUDA probe reinstates it; a 1 s ``DeviceProfiler`` session
   started on the main thread around an HEVC run on another thread: the
   Chrome trace names the resize kernel; ``compile_seconds()`` of the
   build phase (cold) and of a fresh process on the warm build
   directory (0);
10d. daemon: the port's ``WorkerDaemon(device="cuda")`` over a sqlite
   queue in the work directory (the port's ``create_all``), the
   registry's torch backend and ``get_scheduler()`` (one card, one
   slot), driven by ``run()`` until the queue is empty: the pipeline
   phase's A/V MP4 transcoded with the default 4-rung ladder and 3
   audio renditions, its first attempt hit by ``device.fault`` (refunded
   as ``device_fault``, the card quarantined to 0 slots and reinstated
   by the probe loop at ``VLOG_DEVICE_PROBE_INTERVAL_S`` = 0.5 s), then
   ready with 4 ``video_qualities`` rows and ``outputs.json`` verifying
   the tree; its sprite and transcription jobs (the tiny random-weight
   Whisper) on the card; a 35 s WAV transcribed (2 windows); an HEVC
   re-encode of the 24-frame source; with 6-frame dispatches, an HEVC
   re-encode whose dispatch thread starts ``handle_command("profile")``
   at its first ladder resize (1 s: the Chrome trace names
   ``streaming_resize_kernel``), and one whose first attempt a 2 s
   timeout cancels at the first batch boundary (no ``vlog-pipe*`` or
   ``vlog-decode*`` thread left, the rise of
   ``torch.cuda.memory_allocated()`` under DAEMON_MEM_RISE_MAX) before
   its retry completes; every job completed at progress 100 with its
   spans in ``job_spans`` (the transcode's ``stage.*`` keys the
   reference's), launches per job (12, 3, 12, 39, 39; 0 for the
   transcriptions), ``ping``, ``stats`` (the mesh snapshot) and
   ``get_metrics`` (CUDA initialized, bytes in use); each job's
   enqueue-to-complete and span seconds printed; then, where ``aiohttp``
   is installed, ``python -m vlog_tpu_torch.worker.daemon`` in a
   subprocess for one HEVC re-encode, its health routes, SIGTERM: the
   drain and exit code 0 (without ``aiohttp`` it prints that the CLI is
   tested on the CPU only);
11. asr: Whisper at whisper-small width (seeded random weights, a
   synthetic vocabulary at whisper-small's special-token ids, written as
   a checkpoint directory) on a seeded 100 s WAV of voiced-like bursts
   whose last window is silent, through
   ``transcribe_video(wav, out, model_dir=..., device="cuda")`` with the
   defaults (language detection, beam 5, the engine's 8-window
   buckets): ``captions.vtt`` parses, 4 windows, 3 live, one batch of 3
   windows in 4 rows, no resize launch, TF32 off; then on one window the
   card against the port's CPU path (mel, encoder states, teacher-forced
   logits within stated bounds; the CPU stepped along the card's greedy
   tokens: the first differing step and the largest logit gap, bounded),
   the window decoded solo and packed in an 8-window batch on the card
   (greedy and beam 5: identical tokens), int8 greedy card against CPU,
   and the times (mel, encoder, decoder step greedy and beam, the beam's
   bookkeeping, windows/s, tokens/s, audio seconds per wall second,
   launches and device-busy share of one beam step, the memory peak);
12. where one 1080p frame's device time goes, stage by stage.

Each phase prints its wall seconds. Prints a ``{"kernels": [...]}``
line, the card's name and power limit, then as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or vlog_tpu.
Whether the optional libav ingest shim builds is printed on a line of
its own; no phase uses it.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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

# The card's thumbnail against the CPU path's: the resize kernel and the
# plain version may round a value within an ulp of x.5 apart (above), so
# quantized JPEG coefficients may differ by 1 in a few blocks.
THUMB_COEF_MAX_ABS = 1
THUMB_MAX_BLOCK_SHARE = 1e-3

SRC_H, SRC_W = 1080, 1920
FRAMES = 24             # one full 24-frame I+P chain: one dispatch
SLICE_FRAMES = 8        # the slice: one I+P chain cut to 8 frames
INTRA_FRAMES = 8        # one intra dispatch (frame_batch 8)
MP4_FRAMES = 4          # samples of the I+P MP4 (1 IDR + 3 P: a cut chain)
SEEK_FRAME = 1          # read mid-GOP on a fresh source
SPRITE_INTRA_FRAMES = 8  # samples of the all-intra MP4 (one decode chunk)
SHORT_SEG_S = 0.25      # resume and TS: 6-frame segments and chains,
SHORT_BATCH = 6         # one chain per dispatch
RESUME_FRAMES = 12      # two dispatches of one 0.25 s segment each
TS_FRAMES = 6
REPS = 20               # timed repetitions per kernel shape
L2_FLUSH_BYTES = 256 << 20   # > the 50 MB L2: each profiled call starts cold
CLOCKS_QUERY = ("--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
                "temperature.gpu,power.draw")
RUNG_SHAPES = ((720, 1280), (480, 854), (360, 640))
# Frames per kernel call on the driven paths: a 24-frame chain (hevc,
# the scheduler's HEVC job, the daemon's re-encode), the slice's chain
# cut to 8 frames and an intra dispatch, a 6-frame chain (resume, ts,
# runtime, the daemon's 6-frame dispatches), the MP4's cut 4-frame chain
# (pipeline, the daemon's transcode), the thumbnail's one frame (the
# 720p rung's shapes). The kernel phase holds the kernel to its plain
# version at each; every backend phase checks that its plan calls with
# one.
COMPARE_N = tuple(dict.fromkeys((FRAMES, SLICE_FRAMES, INTRA_FRAMES,
                                 SHORT_BATCH, MP4_FRAMES, 1)))
# Sprite tiles (the default 160x90) of the 1080p sources, at the frames
# per call of the sprite phase's two runs (a full decode chunk of 8, the
# skipping run's 2 tiles) and of the daemon's sprite job (the MP4's one
# tile at the default 10 s interval).
SPRITE_SHAPES = (((SRC_H, SRC_W), (90, 160)),
                 ((SRC_H // 2, SRC_W // 2), (45, 80)))
SPRITE_N = (8, 2, 1)
SPRITE_SKIP_INTERVAL_S = 2 / 24     # tiles at frames 0 and 2 of 4

# AAC: the MP4 sources' track, and the aac phase (one default 6 s
# segment at 128 kbps: 283 payloads with the priming frame)
AAC_SR = 48000
AAC_TRACK_BPS = 128_000
AAC_SECONDS = 6.0
AAC_PAYLOADS = 283
AAC_BAND_LIMITED_SECONDS = 1.0
# Card against CPU: both MDCTs are float32 sums in other orders (cuBLAS,
# the CPU's BLAS); the host stages after them are exact. Expected:
# identical payloads. A coefficient that lands on a quantizer or
# scalefactor boundary may flip a level, which rate control carries on;
# past this bound the phase fails: total bytes within 1%, and the two
# streams' SNRs against the source (decoded by the port's decoder)
# within 0.1 dB.
AAC_BYTES_RTOL = 0.01
AAC_SNR_DB_TOL = 0.1
# forward_mdct timed on one 30 s stereo chunk: (2, 1408, 2048) blocks
MDCT_CHUNK = (2, 1408, 2048)
# The pipeline's MPEG-TS run: the 360p rung of the A/V MP4
TS_PIPELINE_RUNG = "360p"
# HEVC: the chain DSP card vs CPU on the first frames of the slice's
# source (1 I + 2 P at 1080p), and a whole tree card vs CPU on a 640x360
# source with one identity rung (the ladder's 360p: no resize)
HEVC_INT_FRAMES = 3
HEVC_TREE_FRAMES = 6
HEVC_TREE_H, HEVC_TREE_W = 360, 640
HEVC_COST_RTOL = 1e-5


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


def _raw_kernels(prof) -> list[tuple[str, float]]:
    """(name, us) of every device event of a profile, from its kineto
    events: the list ``prof.events()`` is built from, read without the
    event tree it builds on top (minutes for ~10^5 launches)."""
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _tree_kernels(prof) -> list[tuple[str, float]]:
    """The same from ``prof.events()`` (the cross-check of the reader)."""
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


class DeviceTimer:
    """Device ms per call from torch.profiler: the sum of the durations
    of the kernels the call launched, each call after a write of
    L2_FLUSH_BYTES (its kernels are told apart by name and left out).
    Every profile is read twice, raw (``_raw_kernels``, the reader the
    breakdown uses) and through ``prof.events()``; the two must agree."""

    READERS_RTOL = 1e-6

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
        self._flush = {read: {name for name, _ in read(prof)}
                       for read in (_raw_kernels, _tree_kernels)}
        if not all(self._flush.values()):
            fail("torch.profiler recorded no device kernels (raw, "
                 "prof.events(): "
                 f"{[len(read(prof)) for read in self._flush]})")
        self.max_reader_gap = 0.0

    def flush(self) -> None:
        self._buf.bitwise_not_()

    def ms(self, fn, reps: int) -> float:
        """Device ms per call. A profile whose device kernels of the calls
        are no whole number per call has lost events: it is taken again
        (at most twice more); ``kernels_per_call`` keeps the count."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with self._profile() as prof:
                for _ in range(reps):
                    self.flush()
                    fn()
                torch.cuda.synchronize()
            raw, tree = ([us for name, us in read(prof) if name not in flush]
                         for read, flush in self._flush.items())
            if raw and len(raw) % reps == 0:
                break
            log(f"profile holds {len(raw)} device kernels for {reps} calls; "
                "profiling again")
        else:
            fail("torch.profiler lost device kernels of the call three times")
        self.kernels_per_call = len(raw) // reps
        gap = abs(sum(raw) - sum(tree)) / sum(tree) if tree else math.inf
        if len(raw) != len(tree) or gap > self.READERS_RTOL:
            fail(f"profiler readers disagree: raw {len(raw)} kernels "
                 f"{sum(raw):.3f} us, prof.events() {len(tree)} kernels "
                 f"{sum(tree):.3f} us")
        self.max_reader_gap = max(self.max_reader_gap, gap)
        return sum(raw) / reps / 1e3


# ---------------------------------------------------------------------------
def phase_build():
    from vlog_tpu_torch.native import build as native_build
    from vlog_tpu_torch.ops import fused_resize

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # nvcc and g++ run at once; an error in either is raised here
    with ThreadPoolExecutor(2) as pool:
        kernel = pool.submit(timed, fused_resize.load_library)
        native = pool.submit(timed, native_build.get_lib)
        t_kernel, t_native = kernel.result(), native.result()
    report = [ln.strip() for ln in fused_resize.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log("ptxas: " + " | ".join(report))
    log(f"build: fused_resize {t_kernel:.2f}s (nvcc {fused_resize.build_seconds:.2f}s), "
        f"native CABAC/CAVLC/JPEG {t_native:.2f}s")


def _held_to_plain(got, ref, what: str) -> tuple[int, int]:
    """(max |diff|, differing pixels) of the kernel's output against the
    plain version's; fails past RESIZE_MAX_ABS / RESIZE_MAX_SHARE."""
    diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    max_abs, n_diff = int(diff.max()), int((diff > 0).sum())
    if max_abs > RESIZE_MAX_ABS or n_diff > RESIZE_MAX_SHARE * diff.numel():
        fail(f"{what} disagrees with the plain version: max |diff| "
             f"{max_abs}, {n_diff} of {diff.numel()} pixels")
    return max_abs, n_diff


def _shape_row(timer, plane, src, dst, n, counts, gens) -> dict:
    """One plane shape: the kernel held to its plain version at every
    count in ``counts`` (each on its own seeded input), timed at ``n``
    against the plain version and the library call, with its bound."""
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix

    dev = torch.device("cuda")
    (H, W), (dh, dw) = src, dst
    a_h = torch.as_tensor(resample_matrix(H, dh), device=dev)
    a_w = torch.as_tensor(resample_matrix(W, dw), device=dev)
    saved = fused_resize.launches
    # held at every frame count a driven path gives the kernel (the tile
    # schedule depends on n); timed at n
    differ = {}
    for m in counts:
        xm = torch.randint(0, 256, (m, H, W), device=dev,
                           generator=gens[0] if m == n else gens[1],
                           dtype=torch.uint8)
        differ[m] = _held_to_plain(
            fused_resize.fused_resize_plane(xm, a_h, a_w),
            apply_resize_matrices(xm, a_h, a_w),
            f"kernel at {plane} {H}x{W}->{dh}x{dw}, n={m}")
        if m == n:
            x = xm
    max_abs, n_diff = differ[n]
    xf = x.to(torch.float32)
    a_wt = a_w.t()
    fns = {"": lambda: fused_resize.fused_resize_plane(x, a_h, a_w),
           "plain_": lambda: apply_resize_matrices(x, a_h, a_w),
           "library_": lambda: torch.matmul(torch.matmul(a_h, xf), a_wt)}
    row = {"plane": plane, "src": [H, W], "dst": [dh, dw], "n": n,
           "max_abs_err": max(d[0] for d in differ.values()),
           "diff_pixels": n_diff,
           "held_at_n": {m: list(d) for m, d in differ.items()}}
    for prefix, fn in fns.items():
        row[prefix + "ms"] = timer.ms(fn, REPS)
        row[prefix + "kernels_per_call"] = timer.kernels_per_call
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
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["faster_than_plain_and_library"] = (
        row["ms"] < row["plain_ms"] and row["ms"] < row["library_ms"])
    row["taps_per_row"] = [nnz_h / dh, nnz_w / dw]
    return row


def phase_kernel(timer: DeviceTimer, n: int) -> dict:
    dev = torch.device("cuda")
    log("clocks before kernel phase (sm, mem, max sm, temp, power): "
        + smi(CLOCKS_QUERY))
    gens = (torch.Generator(device=dev).manual_seed(1234),
            torch.Generator(device=dev).manual_seed(4321))   # the other n
    rows = []
    keys = ("ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms",
            "library_call_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    for (h, w) in RUNG_SHAPES:
        for plane, dst in (("Y", (h, w)), ("C", (h // 2, w // 2))):
            src = (SRC_H, SRC_W) if plane == "Y" else (SRC_H // 2, SRC_W // 2)
            row = _shape_row(timer, plane, src, dst, n, COMPARE_N, gens)
            rows.append(row)
            log("resize " + json.dumps(row))
            # chroma runs twice per dispatch (U and V)
            mult = 1 if plane == "Y" else 2
            for k in keys:
                tot[k] += mult * row[k]
    # the sprite tiles: their own shapes, timed at a full decode chunk
    sprite_rows = []
    for plane, (src, dst) in zip("YC", SPRITE_SHAPES):
        row = _shape_row(timer, plane, src, dst, SPRITE_N[0], SPRITE_N, gens)
        sprite_rows.append(row)
        log("resize sprite " + json.dumps(row))
    tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
    tot["faster_than_plain_and_library_at_every_shape"] = all(
        r["faster_than_plain_and_library"] for r in rows + sprite_rows)
    tot["profiler_readers_max_gap"] = timer.max_reader_gap
    log("resize per dispatch " + json.dumps(tot))
    log("clocks after kernel phase (sm, mem, max sm, temp, power): "
        + smi(CLOCKS_QUERY))
    worst = max(r["max_abs_err"] for r in rows + sprite_rows)
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
    clock around one synchronized call each; the slice and pipeline phases
    ran every stage at these shapes before), and
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
    # the kernel phase's reader (cross-checked there against prof.events(),
    # whose event tree would take minutes for this profile's launches)
    kernels = _raw_kernels(prof)
    busy_us = sum(us for _, us in kernels)
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


def _write_sources(work: Path, counts, seed: int) -> dict[int, Path]:
    """One generated Y4M of the largest count; each shorter source is its
    first frames (the same bytes _write_y4m writes for that count)."""
    counts = sorted(set(counts))
    paths = {n: work / f"src_1080p_{n}.y4m" for n in counts}
    _write_y4m(paths[counts[-1]], counts[-1], seed)
    data = paths[counts[-1]].read_bytes()
    head = data.index(b"\n") + 1
    frame = len(b"FRAME\n") + SRC_H * SRC_W * 3 // 2
    for n in counts[:-1]:
        paths[n].write_bytes(data[:head + n * frame])
    return paths


def _cmaf_samples(rdir: Path) -> int:
    """Samples in a rung's fMP4 segments (init and every moof must parse)."""
    from vlog_tpu_torch.media.boxes import parse_box_tree

    with open(rdir / "init.mp4", "rb") as fp:
        if not any(b.type == "moov" for b in parse_box_tree(fp)):
            fail(f"{rdir.name}/init.mp4 has no moov")
    n = 0
    for seg in sorted(rdir.glob("segment_*.m4s")):
        with open(seg, "rb") as fp:
            moof = next(b for b in parse_box_tree(fp) if b.type == "moof")
        n += int.from_bytes(moof.find("traf", "trun").payload[4:8], "big")
    return n


def _check_rungs(res, out: Path, frames: int) -> None:
    from vlog_tpu_torch.media import hls

    hls.validate_master_playlist(out / "master.m3u8")
    for r in res.rungs:
        n = _cmaf_samples(out / r.name)
        if n != frames:
            fail(f"{r.name}: {n} samples in segments, want {frames}")
        if r.mean_psnr_y is None or not r.mean_psnr_y > PSNR_FLOOR_DB:
            fail(f"{r.name}: mean PSNR-Y {r.mean_psnr_y} <= {PSNR_FLOOR_DB}")
        log(f"  rung {r.name} {r.width}x{r.height}: {r.segment_count} segments, "
            f"{r.bytes_written} bytes, {r.achieved_bitrate} bps "
            f"(target {r.target_bitrate}), mean PSNR-Y {r.mean_psnr_y:.2f} dB")


def _jpeg_size(data: bytes) -> tuple[int, int]:
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        fail("thumbnail.jpg lacks SOI/EOI")
    sof = data.index(b"\xff\xc0")
    return (int.from_bytes(data[sof + 5:sof + 7], "big"),
            int.from_bytes(data[sof + 7:sof + 9], "big"))


def _frames_per_call(plan, phase: str, frames: int) -> list[int]:
    """Frames per kernel call of each dispatch of a plan over ``frames``
    source frames (the backend dispatches only the chains that hold real
    frames, a lone chain cut to its last real frame); fails unless the
    kernel phase held the kernel at every such count."""
    clen = plan.gop_len
    if clen > 1:
        batch_n = max(1, -(-plan.frame_batch // clen)) * clen
    else:
        batch_n = max(plan.frame_batch, 1)
    counts = []
    for start in range(0, frames, batch_n):
        n_real = min(batch_n, frames - start)
        chains = -(-n_real // clen)
        counts.append(batch_n if clen == 1 else
                      chains * clen if chains > 1 else max(2, n_real))
    bad = sorted(set(counts) - set(COMPARE_N))
    if bad:
        fail(f"{phase}: the kernel is called with {bad} frames, counts the "
             f"kernel phase did not hold ({COMPARE_N})")
    return counts


def phase_slice(src: Path) -> int:
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.codecs.jpeg.encoder import pack_jpeg
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.y4m import Y4mReader
    from vlog_tpu_torch.ops import fused_resize

    out = src.parent / "slice"
    backend = TorchBackend(device="cuda")
    plan = backend.plan(get_video_info(src), out_dir=out)
    log("slice plan: " + ", ".join(f"{r.name} {r.width}x{r.height} qp{r.qp} "
                                   f"{r.video_bitrate}bps" for r in plan.rungs)
        + f"; gop {plan.gop_len}, frame_batch {plan.frame_batch}, "
        f"thumbnail {plan.thumbnail}")
    dispatches = len(_frames_per_call(plan, "slice", SLICE_FRAMES))
    scaled = sum(1 for r in plan.rungs
                 if (r.height, r.width) != (SRC_H, SRC_W))
    thumb_launches = 3 * fused_resize.LAUNCHES_PER_CALL   # Y, U, V once
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = backend.run(plan)
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = scaled * 3 * fused_resize.LAUNCHES_PER_CALL * dispatches \
        + thumb_launches
    if launches != expected:
        fail(f"kernel launches {launches}, expected {expected} "
             f"({scaled} scaled rungs x 3 planes x "
             f"{fused_resize.LAUNCHES_PER_CALL} launches x {dispatches} "
             f"dispatches + {thumb_launches} for the thumbnail)")
    log(f"slice: {res.frames_processed} frames in {wall:.2f}s wall; stage_s "
        + json.dumps(res.stage_s) + f"; kernel launches {launches}")
    _check_stage_s("slice", res.stage_s)
    if not (out / "manifest.mpd").read_text().startswith("<?xml"):
        fail("manifest.mpd malformed")
    _check_rungs(res, out, SLICE_FRAMES)
    journal = (out / "rc_journal.jsonl").read_text().splitlines()
    if len(journal) != 1 + dispatches or json.loads(journal[0])["v"] != 1:
        fail(f"rc_journal.jsonl has {len(journal)} lines, want 1 + {dispatches}")

    thumb = (out / "thumbnail.jpg").read_bytes()
    th = max(2, round(SRC_H * 1280 / SRC_W / 2) * 2)
    if _jpeg_size(thumb) != (th, 1280):
        fail(f"thumbnail is {_jpeg_size(thumb)}, want {(th, 1280)}")
    # The backend's own thumbnail stages (``_write_thumbnail`` is
    # ``pack_jpeg`` of ``_thumbnail_blocks`` of ``_thumbnail_planes``) on
    # the card again (launches not counted) and on the CPU path: the
    # file on disk is the card's blocks packed; the resized planes are
    # held to the kernel's bound, the quantized coefficients to theirs.
    with Y4mReader(src) as reader:
        frame = reader.read_frame(0)
    saved = fused_resize.launches
    card_planes = backend._thumbnail_planes(*frame)
    fused_resize.launches = saved
    card = backend._thumbnail_blocks(*card_planes)
    cpu_backend = TorchBackend(device="cpu")
    cpu_planes = cpu_backend._thumbnail_planes(*frame)
    cpu = cpu_backend._thumbnail_blocks(*cpu_planes)
    if pack_jpeg(card) != thumb:
        fail("thumbnail.jpg is not the card's thumbnail blocks packed")
    planes = [_held_to_plain(a.cpu(), b, f"thumbnail plane {i}")
              for i, (a, b) in enumerate(zip(card_planes, cpu_planes))]
    coef_diff = [np.abs(a.astype(np.int64) - b)
                 for a, b in ((card.y, cpu.y), (card.u, cpu.u), (card.v, cpu.v))]
    n_blocks = sum(d.shape[0] for d in coef_diff)
    bad_blocks = sum(int((d > 0).any(1).sum()) for d in coef_diff)
    coef_max = max(int(d.max()) for d in coef_diff)
    log("thumbnail card vs CPU path: " + json.dumps({
        "resized_planes_max_abs_and_differ_yuv": planes,
        "coefs_differ": sum(int((d > 0).sum()) for d in coef_diff),
        "coef_max_abs": coef_max, "blocks_differ": bad_blocks,
        "blocks": n_blocks, "jpeg_bytes_equal": pack_jpeg(cpu) == thumb}))
    if coef_max > THUMB_COEF_MAX_ABS or bad_blocks > THUMB_MAX_BLOCK_SHARE * n_blocks:
        fail(f"thumbnail coefficients differ from the CPU path: max {coef_max}, "
             f"{bad_blocks} of {n_blocks} blocks")
    return launches


def phase_intra(src: Path) -> int:
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize

    out = src.parent / "intra"
    backend = TorchBackend(device="cuda")
    plan = backend.plan(get_video_info(src), out_dir=out, gop_mode="intra",
                        thumbnail=False)
    dispatches = len(_frames_per_call(plan, "intra", INTRA_FRAMES))
    scaled = sum(1 for r in plan.rungs if (r.height, r.width) != (SRC_H, SRC_W))
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = backend.run(plan)
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = scaled * 3 * fused_resize.LAUNCHES_PER_CALL * dispatches
    if launches != expected:
        fail(f"intra: kernel launches {launches}, expected {expected}")
    log(f"intra: {res.frames_processed} frames (gop {plan.gop_len}) in "
        f"{wall:.2f}s wall; stage_s {json.dumps(res.stage_s)}; "
        f"kernel launches {launches}")
    _check_rungs(res, out, INTRA_FRAMES)
    return launches


def _av_audio(seconds: float, seed: int) -> np.ndarray:
    """Seeded stereo 48 kHz PCM: 440 / 1234.5 Hz tones plus white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(AAC_SR * seconds))) / AAC_SR
    return np.stack([0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(t.size)
                     for f in (440.0, 1234.5)])


def _segment_samples(seg: Path) -> list:
    """The samples (data, duration, sync flag) of one fMP4 media segment,
    from its trun and mdat."""
    from vlog_tpu_torch.media.boxes import parse_box_tree
    from vlog_tpu_torch.media.fmp4 import Sample

    data = seg.read_bytes()
    with open(seg, "rb") as fp:
        moof = next(b for b in parse_box_tree(fp) if b.type == "moof")
    trun = moof.find("traf", "trun").payload
    pos = moof.offset + int.from_bytes(trun[8:12], "big", signed=True)
    samples = []
    for k in range(int.from_bytes(trun[4:8], "big")):
        dur, size, flags = (int.from_bytes(trun[i:i + 4], "big")
                            for i in range(12 + 16 * k, 24 + 16 * k, 4))
        samples.append(Sample(data[pos:pos + size], dur,
                              is_sync=not flags & 0x00010000))
        pos += size
    return samples


def _cmaf_to_mp4(rdir: Path, n: int, path: Path) -> Path:
    """The first ``n`` samples of a CMAF rung (its segments' trun/mdat,
    the avc1 entry and timescale of its init.mp4) as a progressive MP4
    written by the port's muxer, with an AAC track as long as the video
    (a seeded stereo 48 kHz signal, encoded by the port's encoder on the
    card): an upload in the platform's own output format."""
    from vlog_tpu_torch.codecs.aac import AacEncoder
    from vlog_tpu_torch.media.boxes import parse_box_tree
    from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig,
                                           mp4a_sample_entry,
                                           progressive_mp4_multi)

    with open(rdir / "init.mp4", "rb") as fp:
        moov = next(b for b in parse_box_tree(fp) if b.type == "moov")
    entry = moov.find("trak", "mdia", "minf", "stbl", "stsd").payload[8:]
    timescale = int.from_bytes(
        moov.find("trak", "mdia", "mdhd").payload[12:16], "big")
    samples = [s for seg in sorted(rdir.glob("segment_*.m4s"))
               for s in _segment_samples(seg)]
    if len(samples) < n:
        fail(f"{rdir}: {len(samples)} samples, want {n}")
    width, height = (int.from_bytes(entry[i:i + 2], "big") for i in (32, 34))
    samples = samples[:n]
    seconds = sum(s.duration for s in samples) / timescale
    enc = AacEncoder(AAC_SR, 2, AAC_TRACK_BPS, device="cuda")
    audio = [Sample(p, 1024) for p in enc.encode_frames(_av_audio(seconds, n))]
    atrack = TrackConfig(2, "soun", AAC_SR, mp4a_sample_entry(
        2, AAC_SR, enc.config.audio_specific_config(), AAC_TRACK_BPS))
    path.write_bytes(progressive_mp4_multi(
        [(TrackConfig(1, "vide", timescale, entry, width, height), samples),
         (atrack, audio)]))
    return path


def _frames_equal(a, b, what: str) -> None:
    for name, x, y in zip("yuv", a, b):
        if x.shape != y.shape or not np.array_equal(x, y):
            bad = int((x != y).sum()) if x.shape == y.shape else "shape"
            fail(f"{what}: plane {name} differs ({bad} pixels)")


def _log_steps(name: str, res) -> None:
    log(f"{name}: seconds per step " + json.dumps(
        {k: round(v, 4) for k, v in res.step_s.items()}))


def phase_pipeline(work: Path) -> tuple[int, Path, tuple]:
    """The slice's 1080p rung as an A/V MP4 upload through
    ``process_video`` with the default plan on the card. Returns the
    launches, the MP4 and the run's decoded frames."""
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.backends import source as source_mod
    from vlog_tpu_torch.backends import torch_backend
    from vlog_tpu_torch.codecs.aac import AacConfig, AacDecoder
    from vlog_tpu_torch.media import mp4 as mp4mod
    from vlog_tpu_torch.media.audio import extract_audio
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker import process_video

    path = _cmaf_to_mp4(work / "slice" / "1080p", MP4_FRAMES,
                        work / "ip_1080p.mp4")
    info = get_video_info(path)
    sync = mp4mod.parse_mp4(path).video.samples.sync_indices
    if (info.width, info.height, info.frame_count) != (SRC_W, SRC_H, MP4_FRAMES) \
            or sync is None or list(sync) != [0] or info.audio_codec is None:
        fail(f"mp4 source: {info.width}x{info.height}, {info.frame_count} "
             f"samples, sync samples {sync}, audio {info.audio_codec}; want "
             f"1 IDR + {MP4_FRAMES - 1} P and an AAC track")

    # the run's own source, its batches recorded: the sequential decode
    opened, batches = [], []

    def recording_source(*args, **kwargs):
        src = source_mod.open_source(*args, **kwargs)
        read = src.read_batches

        def recorded(batch, start=0):
            for item in read(batch, start):
                batches.append(item)
                yield item

        src.read_batches = recorded
        opened.append(src)
        return src

    out = work / "pipeline"
    backend = get_backend("torch")
    if backend.device.type != "cuda":
        fail(f"pipeline: get_backend('torch') runs on {backend.device}")
    plan = backend.plan(info, out_dir=out)
    dispatches = len(_frames_per_call(plan, "pipeline", MP4_FRAMES))
    scaled = sum(1 for r in plan.rungs if (r.height, r.width) != (SRC_H, SRC_W))
    torch_backend.open_source = recording_source
    fused_resize.launches = 0
    try:
        t0 = time.perf_counter()
        res = process_video(path, out, backend=backend)
        wall = time.perf_counter() - t0
    finally:
        torch_backend.open_source = source_mod.open_source
    launches = fused_resize.launches
    expected = (scaled * 3 * dispatches + 3) * fused_resize.LAUNCHES_PER_CALL
    if launches != expected:
        fail(f"pipeline: kernel launches {launches}, expected {expected}")
    _check_rungs(res.run, out, MP4_FRAMES)
    src = opened[0]
    if not isinstance(src, source_mod.Mp4H264FrameSource) \
            or src.device.type != "cuda" or src.frames_decoded != MP4_FRAMES:
        fail(f"pipeline: the run read {type(src).__name__} on {src.device}, "
             f"{src.frames_decoded} frames decoded")
    seq = tuple(np.concatenate([b[i] for b in batches]) for i in range(3))
    split = {k: round(v, 4) for k, v in src._decoder.stage_s.items()}
    log(f"pipeline: {res.run.frames_processed} frames in {wall:.2f}s wall; "
        f"stage_s " + json.dumps(res.run.stage_s) + f"; kernel launches "
        f"{launches}; decode by stage (s, {MP4_FRAMES} frames: 1 I + "
        f"{MP4_FRAMES - 1} P, 1080p) " + json.dumps(split) + "; per frame "
        + json.dumps({k: round(v / MP4_FRAMES, 4) for k, v in split.items()}))
    _log_steps("pipeline", res)

    # the outputs: one DB row per rung, the audio group, the manifests
    want_rows = [r.name for r in plan.rungs]
    if [q["quality"] for q in res.qualities] != want_rows \
            or res.qualities != res.to_db_rows():
        fail(f"pipeline: qualities {res.qualities}; want one row per rung "
             f"{want_rows}")
    kbps = sorted({r.audio_bitrate // 1000 for r in plan.rungs}, reverse=True)
    names = [a["name"] for a in res.audio_renditions]
    if names != [f"audio_{k}k" for k in kbps] or len(names) != 3:
        fail(f"pipeline: audio renditions {names}; want 192k, 128k, 96k")
    master = (out / "master.m3u8").read_text()
    mpd = (out / "manifest.mpd").read_text()
    if master.count("#EXT-X-MEDIA:TYPE=AUDIO") != 3 \
            or 'mimeType="audio/mp4"' not in mpd:
        fail("pipeline: master.m3u8 lacks EXT-X-MEDIA or manifest.mpd its "
             "audio adaptation set")
    files = integrity.load_manifest(out)
    problems = integrity.verify_tree(out, files or {})
    if not files or problems or "rc_journal.jsonl" in files \
            or set(files) != set(integrity.build_manifest(out)):
        fail(f"pipeline: outputs.json does not verify the tree: {problems}")
    # each rendition decodes to the MP4's own audio track
    src_pcm = extract_audio(path).pcm
    corr = {}
    for name in names:
        dec = AacDecoder(AacConfig(sample_rate=AAC_SR, channels=2))
        pcm = np.concatenate([dec.decode_frame(s.data) for seg in
                              sorted((out / name).glob("segment_*.m4s"))
                              for s in _segment_samples(seg)], axis=1)
        n = min(pcm.shape[1], src_pcm.shape[1])
        corr[name] = float(np.corrcoef(pcm[0, 2048:n], src_pcm[0, 2048:n])[0, 1])
    if min(corr.values()) < 0.9:
        fail(f"pipeline: audio renditions do not follow the source: {corr}")
    log(f"pipeline: {len(files)} files in outputs.json verified; audio "
        f"renditions {names}, correlation with the source track "
        + json.dumps({k: round(v, 4) for k, v in corr.items()})
        + f"; qualities {json.dumps(res.qualities)}")

    # the port's CPU decode of the same samples: frames 0-1 bit-identical
    t0 = time.perf_counter()
    with source_mod.Mp4H264FrameSource(path, "cpu") as cpu:
        head = next(cpu.read_batches(2, 0))
        cpu_split = {k: round(v, 4) for k, v in cpu._decoder.stage_s.items()}
    t_cpu = time.perf_counter() - t0
    _frames_equal(tuple(p[:2] for p in seq), head, "card vs CPU decode, frames 0-1")
    # a read that starts mid-GOP on a fresh source: the sequential frame
    t0 = time.perf_counter()
    with source_mod.Mp4H264FrameSource(path, "cuda") as fresh:
        got = next(fresh.read_batches(1, SEEK_FRAME))
        n_dec = fresh.frames_decoded
    t_seek = time.perf_counter() - t0
    _frames_equal(tuple(p[SEEK_FRAME:SEEK_FRAME + 1] for p in seq), got,
                  f"fresh read of frame {SEEK_FRAME}")
    if n_dec != SEEK_FRAME + 1:
        fail(f"fresh read of frame {SEEK_FRAME} decoded {n_dec} frames")
    log(f"pipeline: card frames 0-1 identical to the CPU decode ({t_cpu:.2f}s, "
        f"by stage {json.dumps(cpu_split)}); frame {SEEK_FRAME} on a fresh "
        f"source equals the run's ({n_dec} frames decoded from the IDR, "
        f"{t_seek:.2f}s)")
    return launches, path, seq


def phase_pipeline_ts(path: Path) -> int:
    """The same A/V MP4 through ``process_video`` as classic HLS: the
    360p rung, ``hls_ts``, the audio muxed into every segment."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.ts import AUDIO_PID, VIDEO_PID
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker import process_video

    rung = next(r for r in config.QUALITY_LADDER if r.name == TS_PIPELINE_RUNG)
    out = path.parent / "pipeline_ts"
    backend = get_backend("torch")
    plan = backend.plan(get_video_info(path), (rung,), out,
                        streaming_format="hls_ts")
    dispatches = len(_frames_per_call(plan, "pipeline_ts", MP4_FRAMES))
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = process_video(path, out, backend=backend, rungs=(rung,),
                        streaming_format="hls_ts")
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = (3 * dispatches + 3) * fused_resize.LAUNCHES_PER_CALL
    if launches != expected:
        fail(f"pipeline_ts: kernel launches {launches}, expected {expected}")
    segs = sorted((out / rung.name).glob("segment_*.ts"))
    counts = []
    for seg in segs:
        data = seg.read_bytes()
        if not data or len(data) % 188:
            fail(f"pipeline_ts {seg.name}: {len(data)} bytes, not whole "
                 "188-byte packets")
        pes = {VIDEO_PID: 0, AUDIO_PID: 0}
        for i in range(0, len(data), 188):
            if data[i] != 0x47:
                fail(f"pipeline_ts {seg.name}: packet at {i} lacks 0x47")
            pid = ((data[i + 1] & 0x1F) << 8) | data[i + 2]
            if pid in pes and data[i + 1] & 0x40:
                pes[pid] += 1
        counts.append(pes)
        if not pes[AUDIO_PID]:
            fail(f"pipeline_ts {seg.name}: no audio PES on PID {AUDIO_PID:#x}")
    if not segs or sum(c[VIDEO_PID] for c in counts) != MP4_FRAMES:
        fail(f"pipeline_ts: video PES per segment {counts}, want "
             f"{MP4_FRAMES} in all")
    if res.audio_renditions or (out / "manifest.mpd").exists() \
            or integrity.verify_tree(out, integrity.load_manifest(out) or {}):
        fail("pipeline_ts: audio renditions or a DASH manifest written, or "
             "outputs.json does not verify")
    log(f"pipeline_ts: {len(segs)} segments, PES per segment (video, audio) "
        f"{[(c[VIDEO_PID], c[AUDIO_PID]) for c in counts]}, "
        f"{res.run.rungs[0].bytes_written} bytes, {wall:.2f}s wall; "
        f"kernel launches {launches}")
    _log_steps("pipeline_ts", res)
    return launches


def _aac_snr(ref: np.ndarray, payloads: list[bytes]) -> float:
    """SNR (dB) of a payload stream (priming frame first) decoded by the
    port's decoder against its source PCM, past the first 2048 samples."""
    from vlog_tpu_torch.codecs.aac import AacConfig, AacDecoder

    dec = AacDecoder(AacConfig(sample_rate=AAC_SR, channels=ref.shape[0]))
    out = np.concatenate([dec.decode_frame(p) for p in payloads], axis=1)
    n = min(out.shape[1] - 1024, ref.shape[1])
    r, o = ref[:, 2048:n], out[:, 1024 + 2048:1024 + n]
    return float(10 * np.log10(np.sum(r ** 2) / np.sum((r - o) ** 2)))


def _aac_card_vs_cpu(pcm: np.ndarray, bitrate: int) -> dict:
    """AacEncoder on the card against the CPU on the same PCM: payload
    differences, bytes, SNRs, and the card run's host seconds split into
    the MDCT step and the rest (scalefactors, quantization, the Huffman
    pack, rate control)."""
    from vlog_tpu_torch.codecs.aac import AacEncoder

    card = AacEncoder(AAC_SR, 2, bitrate, device="cuda")
    mdct_s = []
    mdct = card._mdct_all

    def timed_mdct(x):
        t0 = time.perf_counter()
        out = mdct(x)
        mdct_s.append(time.perf_counter() - t0)
        return out

    card._mdct_all = timed_mdct
    t0 = time.perf_counter()
    got = card.encode_frames(pcm)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = AacEncoder(AAC_SR, 2, bitrate, device="cpu").encode_frames(pcm)
    cpu_s = time.perf_counter() - t0
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    audio_s = pcm.shape[1] / AAC_SR
    row = {"seconds_of_audio": audio_s, "bitrate": bitrate,
           "payloads": [len(got), len(want)],
           "differing_payloads": len(differ),
           "first_differing": differ[0] if differ else None,
           "bytes": [sum(map(len, got)), sum(map(len, want))],
           "card_encode_s": round(card_s, 4), "card_mdct_s": round(mdct_s[0], 4),
           "cpu_encode_s": round(cpu_s, 4),
           "host_pack_s_per_audio_s": round((card_s - mdct_s[0]) / audio_s, 4)}
    row["snr_db"] = [_aac_snr(pcm, got), _aac_snr(pcm, want)]
    return row


def phase_aac(timer: DeviceTimer) -> dict:
    """AacEncoder on the card against the CPU at 128 kbps on one default
    segment of seeded stereo audio (held to AAC_BYTES_RTOL and
    AAC_SNR_DB_TOL when any payload differs), the same on a band-limited
    track (printed), and forward_mdct timed alone on a 30 s chunk."""
    from vlog_tpu_torch.codecs.aac import AacEncoder, decode_adts
    from vlog_tpu_torch.codecs.aac.mdct import forward_mdct, mdct_matrix
    from vlog_tpu_torch.ops import fused_resize

    fused_resize.launches = 0
    row = _aac_card_vs_cpu(_av_audio(AAC_SECONDS, 6), AAC_TRACK_BPS)
    log("aac card vs CPU (6 s broadband, 128 kbps): " + json.dumps(row))
    if row["payloads"] != [AAC_PAYLOADS] * 2:
        fail(f"aac: {row['payloads']} payloads, want {AAC_PAYLOADS}")
    if row["differing_payloads"]:
        b_card, b_cpu = row["bytes"]
        s_card, s_cpu = row["snr_db"]
        if abs(b_card - b_cpu) > AAC_BYTES_RTOL * b_cpu \
                or abs(s_card - s_cpu) > AAC_SNR_DB_TOL:
            fail(f"aac: card and CPU streams differ past the bound: bytes "
                 f"{row['bytes']}, SNR {row['snr_db']} dB")
    # band-limited input (the tones through AAC once): its empty bands
    # hold only the MDCT's float32 rounding noise (ROADMAP Queue C item
    # 13); printed, not bounded
    t = np.arange(int(AAC_SR * AAC_BAND_LIMITED_SECONDS)) / AAC_SR
    tones = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (440.0, 660.0)])
    _, limited = decode_adts(AacEncoder(AAC_SR, 2, AAC_TRACK_BPS,
                                        device="cuda").encode_adts(tones))
    limited_row = _aac_card_vs_cpu(limited, AAC_TRACK_BPS)
    log("aac card vs CPU (1 s band-limited tones, 128 kbps): "
        + json.dumps(limited_row))

    # forward_mdct alone on a 30 s chunk, against its bound
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.rand(MDCT_CHUNK, generator=gen, device=dev) * 65536 - 32768
    basis = torch.as_tensor(mdct_matrix(MDCT_CHUNK[-1]), dtype=torch.float32,
                            device=dev)
    got = forward_mdct(x, basis).cpu()
    want = forward_mdct(x.cpu(), basis.cpu())
    err = float((got - want).abs().max()) / float(want.abs().max())
    if err > 1e-5:
        fail(f"aac: forward_mdct on the card differs from the CPU by {err:.2e} "
             "of max |X|")
    n_rows = MDCT_CHUNK[0] * MDCT_CHUNK[1]
    k, n = MDCT_CHUNK[-1] // 2, MDCT_CHUNK[-1]
    flops = 2.0 * n_rows * n * k + n_rows * k          # the product, the 2x
    nbytes = 4 * (n_rows * n + k * n + n_rows * k)
    fn = lambda: forward_mdct(x, basis)                 # noqa: E731
    mdct = {"shape": [list(MDCT_CHUNK), [n, k]], "ms": timer.ms(fn, REPS),
            "kernels_per_call": timer.kernels_per_call,
            "call_ms": call_ms(fn, REPS), "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "max_rel_err_vs_cpu": err,
            "tf32": torch.backends.cuda.matmul.allow_tf32}
    mdct["bound_ms"] = max(mdct["ops_ms"], mdct["bytes_ms"])
    mdct["bound_by"] = ("bytes" if mdct["bytes_ms"] >= mdct["ops_ms"]
                        else "operations")
    mdct["share_of_bound"] = mdct["bound_ms"] / mdct["ms"]
    log("aac forward_mdct (30 s stereo chunk, float32, TF32 off): "
        + json.dumps(mdct))
    if mdct["tf32"]:
        fail("aac: TF32 is on")
    if fused_resize.launches:
        fail(f"aac: {fused_resize.launches} resize launches")
    return {"card_vs_cpu": row, "band_limited": limited_row, "mdct": mdct}


def phase_sprites(work: Path, ip_path: Path, seq: tuple) -> int:
    """generate_sprites on the card: every frame of an all-intra MP4, and
    frames 0 and 2 of the I+P MP4 (a forward read)."""
    from vlog_tpu_torch.backends import source as source_mod
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.resize import apply_resize_matrices, resize_yuv420_with
    from vlog_tpu_torch.worker import sprites

    intra = _cmaf_to_mp4(work / "intra" / "1080p", SPRITE_INTRA_FRAMES,
                         work / "intra_1080p.mp4")
    calls, opened = [], []

    def spy_resize(y, u, v, mats):
        out = fused_resize.resize_yuv420(y, u, v, mats)
        calls.append(((y, u, v), mats, out))
        return out

    def spy_open(*args, **kwargs):
        opened.append(source_mod.open_source(*args, **kwargs))
        return opened[-1]

    runs = (("intra, every frame", intra, 1 / 24, 8, None),
            ("I+P, frames 0 and 2", ip_path, SPRITE_SKIP_INTERVAL_S, 2, (0, 2)))
    total = 0
    sprites.resize_yuv420, sprites.open_source = spy_resize, spy_open
    try:
        for k, (name, path, interval, tiles, frames) in enumerate(runs):
            calls.clear()
            opened.clear()
            fused_resize.launches = 0
            t0 = time.perf_counter()
            res = sprites.generate_sprites(path, work / f"sprites{k}",
                                           interval_s=interval, device="cuda")
            wall = time.perf_counter() - t0
            launches = fused_resize.launches
            total += launches
            sheet = Path(res.sheet_paths[0]).read_bytes()
            cues = Path(res.vtt_path).read_text().count("-->")
            per_call = [c[0][0].shape[0] for c in calls]
            if (res.tile_count, res.sheet_count, cues) != (tiles, 1, tiles) \
                    or _jpeg_size(sheet) != (900, 1600):
                fail(f"sprites ({name}): {res.tile_count} tiles, "
                     f"{res.sheet_count} sheets, {cues} cues, sheet "
                     f"{_jpeg_size(sheet)}; want {tiles}, 1, {tiles}, (900, 1600)")
            if per_call != [tiles] or tiles not in SPRITE_N or launches != 3:
                fail(f"sprites ({name}): kernel calls of {per_call} frames, "
                     f"{launches} launches; want [{tiles}] held, 3")
            held = []
            for planes, mats, out in calls:
                plain = resize_yuv420_with(*planes, mats,
                                           plane_fn=apply_resize_matrices)
                held += [_held_to_plain(o, r, f"sprite tile plane {i}")
                         for i, (o, r) in enumerate(zip(out, plain))]
            decoded = opened[0].frames_decoded
            if frames is not None:
                # the sampled frames are the sequential decode's, read
                # forward: frames 0..2 decoded once each
                got = tuple(p.cpu().numpy() for p in calls[0][0])
                _frames_equal(tuple(p[list(frames)] for p in seq), got,
                              f"sprites ({name}) sampled frames")
                if decoded != frames[-1] + 1:
                    fail(f"sprites ({name}): {decoded} frames decoded, want "
                         f"{frames[-1] + 1} (a restart at the IDR decodes more)")
            log(f"sprites ({name}): {res.tile_count} tiles, sheet "
                f"{len(sheet)} bytes, {cues} cues, {decoded} frames decoded, "
                f"{wall:.2f}s wall; kernel launches {launches}; tile planes "
                f"vs plain (max |diff|, differing) {held}")
    finally:
        sprites.resize_yuv420 = fused_resize.resize_yuv420
        sprites.open_source = source_mod.open_source
    return total


class _Stop(Exception):
    pass


def phase_resume(src: Path) -> int:
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize

    backend = TorchBackend(device="cuda")
    rung = config.QUALITY_LADDER[-1]                     # 360p
    info = get_video_info(src)
    plan_for = lambda out: backend.plan(           # noqa: E731
        info, (rung,), out, segment_duration_s=SHORT_SEG_S,
        frame_batch=SHORT_BATCH, thumbnail=False)
    whole, cut = src.parent / "resume_whole", src.parent / "resume_cut"
    per_call = _frames_per_call(plan_for(whole), "resume", RESUME_FRAMES)
    if len(per_call) != 2:
        fail(f"resume: {len(per_call)} dispatches, want 2")

    def stop_after_first(done, total, msg):
        if done >= per_call[0]:
            raise _Stop(msg)

    per_dispatch = 3 * fused_resize.LAUNCHES_PER_CALL
    fused_resize.launches = 0
    t0 = time.perf_counter()
    backend.run(plan_for(whole), resume=False)
    t_whole = time.perf_counter() - t0
    if fused_resize.launches != 2 * per_dispatch:
        fail(f"resume: {fused_resize.launches} launches uninterrupted, "
             f"want {2 * per_dispatch}")
    t0 = time.perf_counter()
    try:
        backend.run(plan_for(cut), progress_cb=stop_after_first, resume=False)
        fail("resume: the interrupted run was not stopped")
    except _Stop:
        pass
    t_cut = time.perf_counter() - t0
    # at depth 2 the executor may have queued dispatch 2 before dispatch
    # 1's progress callback stopped the run (its consumers skip it)
    cut_launches = fused_resize.launches - 2 * per_dispatch
    if cut_launches not in (per_dispatch, 2 * per_dispatch):
        fail(f"resume: {cut_launches} launches in the stopped run")
    t0 = time.perf_counter()
    res = backend.run(plan_for(cut), resume=True)
    t_resumed = time.perf_counter() - t0
    launches = fused_resize.launches
    if launches != (3 * per_dispatch + cut_launches):
        fail(f"resume: kernel launches {launches}, expected "
             f"{3 * per_dispatch + cut_launches}")
    if res.resumed_segments != 1:
        fail(f"resume: resumed_segments {res.resumed_segments}, want 1")
    files = {p.relative_to(whole): p.read_bytes()
             for p in sorted(whole.rglob("*")) if p.is_file()}
    got = {p.relative_to(cut): p.read_bytes()
           for p in sorted(cut.rglob("*")) if p.is_file()}
    differ = sorted(str(k) for k in files.keys() | got.keys()
                    if files.get(k) != got.get(k))
    if differ:
        fail(f"resume: the resumed tree differs from the uninterrupted one: {differ}")
    log(f"resume: {len(files)} files identical (journal included); "
        f"uninterrupted {t_whole:.2f}s, stopped after dispatch 1 {t_cut:.2f}s, "
        f"resumed {t_resumed:.2f}s; kernel launches {launches}")
    return launches


def phase_ts(src: Path) -> int:
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize

    out = src.parent / "ts"
    backend = TorchBackend(device="cuda")
    plan = backend.plan(get_video_info(src), (config.QUALITY_LADDER[-1],), out,
                        segment_duration_s=SHORT_SEG_S,
                        frame_batch=SHORT_BATCH, thumbnail=False,
                        streaming_format="hls_ts")
    _frames_per_call(plan, "ts", TS_FRAMES)
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = backend.run(plan)
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    if launches != 3 * fused_resize.LAUNCHES_PER_CALL:
        fail(f"ts: kernel launches {launches}, expected 3")
    pes = 0
    segs = sorted((out / "360p").glob("segment_*.ts"))
    for seg in segs:
        data = seg.read_bytes()
        if not data or len(data) % 188:
            fail(f"{seg.name}: {len(data)} bytes, not whole 188-byte packets")
        for i in range(0, len(data), 188):
            if data[i] != 0x47:
                fail(f"{seg.name}: packet at {i} lacks the 0x47 sync byte")
            pid = ((data[i + 1] & 0x1F) << 8) | data[i + 2]
            pes += pid == 0x100 and bool(data[i + 1] & 0x40)
    if pes != TS_FRAMES:
        fail(f"ts: {pes} video PES, want {TS_FRAMES}")
    if (out / "360p" / "init.mp4").exists() or (out / "manifest.mpd").exists():
        fail("ts: a CMAF init segment or DASH manifest was written")
    log(f"ts: {len(segs)} segments, {pes} video PES in {wall:.2f}s wall; "
        f"{res.rungs[0].bytes_written} bytes; kernel launches {launches}")
    return launches



def _tree_files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _check_hvc1(res, out: Path) -> None:
    """Each rung's init segment carries an hvc1 sample entry whose hvcC
    is the one the port's encoder writes for that rung (port readers)."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
    from vlog_tpu_torch.media.mp4 import parse_mp4

    for r in res.run.rungs:
        (trk,) = parse_mp4(out / r.name / "init.mp4").tracks
        want = HevcEncoder(width=r.width, height=r.height,
                           deblock=config.HEVC_DEBLOCK, device="cpu")
        if (trk.codec, trk.sample_entry_type, trk.width, trk.height) != \
                ("hevc", "hvc1", r.width, r.height) \
                or trk.codec_config != want.hvcc_config \
                or r.codec_string != want.codec_string:
            fail(f"hevc: {r.name}/init.mp4 holds {trk.sample_entry_type} "
                 f"{trk.width}x{trk.height}, codec {r.codec_string}")


def _hevc_padded_frames(src: Path, n: int):
    """The first ``n`` frames of a Y4M, edge-padded to CTB alignment."""
    from vlog_tpu_torch.media.y4m import Y4mReader

    with Y4mReader(src) as reader:
        frames = [reader.read_frame(i) for i in range(n)]
    out = []
    for k, block in ((0, 32), (1, 16), (2, 16)):
        p = np.stack([f[k] for f in frames])
        ph, pw = -p.shape[1] % block, -p.shape[2] % block
        out.append(np.pad(p, ((0, 0), (0, ph), (0, pw)), mode="edge"))
    return out


def _hevc_integer_card_vs_cpu(src: Path) -> dict:
    """The chain DSP (1 I + 2 P, deblock, the rate cascade) on CPU and
    CUDA from the same padded 1080p frames."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp

    frames = _hevc_padded_frames(src, HEVC_INT_FRAMES)
    # a budget the P frames overspend: the cascade moves the last QP
    rc = {"budget": np.float32(200.0), "alpha": np.float32(1.0)}
    got, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
        t0 = time.perf_counter()
        (intra, rec0), (p32, _, _, mvs, precons), rcout = encode_chain_dsp(
            *(t(p[None]) for p in frames), config.MOTION_SEARCH_RADIUS,
            t(np.array([28], np.int32)), t(np.array([[30, 30]], np.int32)),
            False, True, rc)
        named = {"i_levels": intra, "i_recon": rec0, "p_levels": p32,
                 "p_recon": precons}
        got[dev] = {f"{k}{i}": a.cpu().numpy() for k, arrs in named.items()
                    for i, a in enumerate(arrs)}
        got[dev].update(mv=mvs.cpu().numpy(),
                        qp_eff=rcout["qp_eff"].cpu().numpy(),
                        cost=rcout["cost"].cpu().numpy())
        secs[dev] = round(time.perf_counter() - t0, 3)
    ref, card = got["cpu"], got["cuda"]
    bad = [k for k in ref if k != "cost" and not np.array_equal(ref[k], card[k])]
    if (ref["qp_eff"] == 30).all():
        fail(f"hevc: the rate cascade did not move a QP (costs {ref['cost']})")
    if bad:
        fail(f"hevc: integer stages differ between CPU and CUDA: {bad}")
    rel = float(np.max(np.abs(card["cost"] - ref["cost"]) / np.abs(ref["cost"])))
    if rel > HEVC_COST_RTOL:
        fail(f"hevc: cost differs between devices: {ref['cost']} vs "
             f"{card['cost']} (rel {rel:.2e})")
    row = {"arrays_identical": len(ref) - 1, "qp_eff": ref["qp_eff"].tolist(),
           "max_abs_mv_qpel": int(np.abs(ref["mv"]).max()),
           "cost_rel_diff": rel, "seconds": secs}
    log("hevc integer stages card vs CPU (1080p, 1 I + 2 P): " + json.dumps(row))
    return row


def _hevc_tree_card_vs_cpu(work: Path) -> None:
    """A 640x360 source on its identity rung: the CMAF trees that
    ``TorchBackend`` writes on CUDA and on the CPU are byte-identical."""
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.ops import fused_resize

    y, u, v = _smooth_frames(HEVC_TREE_FRAMES, HEVC_TREE_H, HEVC_TREE_W, seed=5)
    src = work / "hevc_360p.y4m"
    write_y4m(src, list(zip(y, u, v)), fps_num=24, fps_den=1)
    info = get_video_info(src)
    trees, secs = [], {}
    saved = fused_resize.launches
    for i, dev in enumerate(("cuda", "cpu")):
        backend = TorchBackend(device=dev)
        out = work / f"hevc_tree_{i}"
        plan = backend.plan(info, out_dir=out, codec="h265", thumbnail=False)
        if [(r.height, r.width) for r in plan.rungs] != [(HEVC_TREE_H, HEVC_TREE_W)]:
            fail(f"hevc tree: plan rungs {plan.rungs}, want one identity rung")
        t0 = time.perf_counter()
        backend.run(plan)
        secs[dev] = round(time.perf_counter() - t0, 3)
        trees.append(_tree_files(out))
    if fused_resize.launches != saved:
        fail("hevc tree: the identity rung launched the resize kernel")
    card, cpu = trees
    differ = sorted(k for k in card.keys() | cpu.keys()
                    if card.get(k) != cpu.get(k))
    if differ:
        fail(f"hevc tree: card and CPU trees differ: {differ}")
    log(f"hevc tree card vs CPU ({HEVC_TREE_W}x{HEVC_TREE_H}, "
        f"{HEVC_TREE_FRAMES} frames): {len(card)} files identical; "
        f"seconds {json.dumps(secs)}")


def _hevc_breakdown(src: Path) -> None:
    """Where one 1080p HEVC frame's time goes: per device stage the wall
    seconds (one synchronized call), then launches and device-busy share
    of a second call under torch.profiler; host entropy of the I and one
    P frame's levels (the C coder, one thread)."""
    from torch.profiler import ProfilerActivity, profile

    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.h264.inter import edge_pad
    from vlog_tpu_torch.codecs.hevc import core
    from vlog_tpu_torch.codecs.hevc import deblock as dbk
    from vlog_tpu_torch.codecs.hevc.api import encode_i_payload, encode_p_payload

    dev = torch.device("cuda")
    y, u, v = (torch.as_tensor(p, device=dev)
               for p in _hevc_padded_frames(src, 2))
    search = config.MOTION_SEARCH_RADIUS
    pad = search + 8
    qp = torch.tensor([30], dtype=torch.int32, device=dev)
    qpc = core.chroma_qp_traced(qp)
    rows, cols = y.shape[1] // 32, y.shape[2] // 32
    (ly, lu, lv), raw = core.encode_frame_dsp(y[:1], u[:1], v[:1], qp)
    ibv, ibh = dbk.intra_bs(rows, cols, dev)
    ref = tuple(p.to(torch.uint8) for p in dbk.deblock_picture(
        *raw, qp=qp, qpc=qpc, bs_v=ibv, bs_h=ibh, chroma=True))
    cur = y[1:].to(torch.int32)

    def ref_planes():
        refp = edge_pad(ref[0].to(torch.int32), pad, pad, pad, pad)
        return refp, core._hfiltered_planes(refp, core._LTAPS)

    refp, hplanes = ref_planes()
    mv_int, c_int = core._integer_search(cur, refp, search=search, pad=pad)
    mv, _ = core._subpel_refine(cur, hplanes, mv_int, c_int, pad=pad)
    part = torch.zeros((1, rows, cols), dtype=torch.int32, device=dev)

    def residual():
        return core._p_residuals_and_recon(
            y[1:], u[1:], v[1:], cur, hplanes, core._rep(mv, 2), part, qp,
            qpc, pad, search, ref[1], ref[2], partitions=False)

    p_out = residual()
    stages = {
        "intra_encode": lambda: core.encode_frame_dsp(y[:1], u[:1], v[:1], qp),
        "intra_deblock": lambda: dbk.deblock_picture(
            *raw, qp=qp, qpc=qpc, bs_v=ibv, bs_h=ibh, chroma=True),
        "p_ref_planes": ref_planes,
        "p_integer_me": lambda: core._integer_search(cur, refp, search=search,
                                                     pad=pad),
        "p_subpel_refine": lambda: core._subpel_refine(cur, hplanes, mv_int,
                                                       c_int, pad=pad),
        "p_mc_and_residual": residual,
        "p_deblock": lambda: core._deblock_p(p_out, qp, qpc),
    }
    rows_out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernels = _raw_kernels(prof)
        busy = sum(us for _, us in kernels) / 1e6
        rows_out[name] = {"s": round(wall, 4), "launches": len(kernels),
                          "device_busy_s": round(busy, 4),
                          "busy_share": (round(busy / prof_wall, 4)
                                         if kernels else "not measured")}
    host_i = [a[0].cpu().numpy() for a in (ly, lu, lv)]
    host_p = [a[0].cpu().numpy() for a in p_out[0]]
    mv_cells = p_out[3][0].cpu().numpy()
    for name, fn in (
            ("host_entropy_i", lambda: encode_i_payload(*host_i, rows, cols, 30)),
            ("host_entropy_p", lambda: encode_p_payload(*host_p, mv_cells, rows,
                                                        cols, 30))):
        t0 = time.perf_counter()
        nbytes = len(fn())
        rows_out[name] = {"s": round(time.perf_counter() - t0, 4),
                          "bytes": nbytes}
    log("hevc breakdown 1080p frame " + json.dumps(rows_out))


def phase_hevc(src: Path, work: Path) -> int:
    """``codec="h265"`` through ``process_video`` on the card; then the
    integer stages and a whole tree card vs CPU, and the breakdown."""
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker import process_video

    out = work / "hevc"
    backend = get_backend("torch")
    if backend.device.type != "cuda":
        fail(f"hevc: get_backend('torch') runs on {backend.device}")
    plan = backend.plan(get_video_info(src), out_dir=out, codec="h265")
    dispatches = len(_frames_per_call(plan, "hevc", FRAMES))
    scaled = sum(1 for r in plan.rungs if (r.height, r.width) != (SRC_H, SRC_W))
    log("hevc plan: " + ", ".join(f"{r.name} {r.width}x{r.height} qp{r.qp} "
                                  f"{r.codec}" for r in plan.rungs)
        + f"; gop {plan.gop_len}, frame_batch {plan.frame_batch}")
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = process_video(src, out, backend=backend, codec="h265")
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = (scaled * 3 * dispatches + 3) * fused_resize.LAUNCHES_PER_CALL
    if launches != expected:
        fail(f"hevc: kernel launches {launches}, expected {expected}")
    log(f"hevc: {res.run.frames_processed} frames in {wall:.2f}s wall; stage_s "
        + json.dumps(res.run.stage_s) + f"; kernel launches {launches}")
    _check_stage_s("hevc", res.run.stage_s)
    _log_steps("hevc", res)
    _check_rungs(res.run, out, FRAMES)
    _check_hvc1(res, out)
    master = (out / "master.m3u8").read_text()
    if "hvc1." not in master or "avc1" in master \
            or not all(q["codec_string"].startswith("hvc1.") for q in res.qualities):
        fail("hevc: master.m3u8 or the qualities rows lack the hvc1 codecs")
    files = integrity.load_manifest(out)
    problems = integrity.verify_tree(out, files or {})
    if not files or problems:
        fail(f"hevc: outputs.json does not verify the tree: {problems}")
    log(f"hevc: {len(files)} files in outputs.json verified; qualities "
        + json.dumps(res.qualities))
    _hevc_integer_card_vs_cpu(src)
    _hevc_tree_card_vs_cpu(work)
    _hevc_breakdown(src)
    return launches


# ---------------------------------------------------------------------------
# ASR: Whisper at whisper-small width (random weights from ASR_SEED, a
# synthetic byte-level vocabulary at whisper-small's special-token ids)
ASR_SEED = 5
ASR_AUDIO_S = 100.0      # windows at 0, 25, 50, 75 s; the last all silent
ASR_SPEECH_END_S = 74.0
ASR_WINDOWS, ASR_LIVE = 4, 3
ASR_PACK_ROWS = 8        # the engine's default bucket (VLOG_ASR_BATCH_WINDOWS)
ASR_PACK_AT = 3          # the solo window's row in the packed batch
# Card against the port's CPU path on one window, float32 on both with
# TF32 off: the sums run in other orders, nothing else differs. Mel
# features lie in about [-1, 2], encoder states in [-10, 10], logits in
# [-1, 1].
ASR_MEL_MAX_ABS = 1e-3
ASR_ENC_MAX_ABS = 1e-3
ASR_LOGIT_MAX_ABS = 1e-3
# A card greedy token's CPU logit (rules applied, the CPU stepped along
# the card's tokens) may trail the CPU's best by at most this: twice the
# logit bound, the most two logits within it can swap by.
ASR_TOKEN_GAP_MAX = 2 * ASR_LOGIT_MAX_ABS
ASR_TIMED_STEPS = 20
_VTT_CUE = r"^\d\d:\d\d:\d\d\.\d{3} --> \d\d:\d\d:\d\d\.\d{3}$"


def _asr_audio(seed: int) -> np.ndarray:
    """ASR_AUDIO_S of 16 kHz mono: voiced-like bursts (a gliding 100-220
    Hz fundamental with 8 harmonics, 0.15-0.3 s each, 0.05-0.2 s apart: a
    syllable rate of 3-5 per second) over a quiet noise bed up to
    ASR_SPEECH_END_S, then digital silence (the last window is silent)."""
    sr = 16000
    rng = np.random.default_rng(seed)
    x = np.zeros(int(ASR_AUDIO_S * sr))
    end = int(ASR_SPEECH_END_S * sr)
    x[:end] = rng.normal(0.0, 1e-3, end)
    pos = 0.2
    while pos < ASR_SPEECH_END_S - 0.5:
        dur, f0 = rng.uniform(0.15, 0.3), rng.uniform(100.0, 220.0)
        i0 = int(pos * sr)
        tt = np.arange(int(dur * sr)) / sr
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.1 * tt / dur)) / sr
        burst = sum(np.sin(h * phase) / h for h in range(1, 9))
        x[i0:i0 + tt.size] += 0.2 * np.sin(np.pi * tt / dur) ** 2 * burst
        pos += dur + rng.uniform(0.05, 0.2)
    return x


def _check_vtt(path: Path, cues: int) -> None:
    import re

    lines = path.read_text().split("\n")
    if lines[0] != "WEBVTT":
        fail(f"{path.name}: no WEBVTT header")
    timing = [i for i, ln in enumerate(lines) if "-->" in ln]
    for i in timing:
        if not re.match(_VTT_CUE, lines[i]) or not lines[i + 1].strip():
            fail(f"{path.name}: malformed cue at line {i + 1}: {lines[i]!r}")
    if len(timing) != cues:
        fail(f"{path.name}: {len(timing)} cues, the result says {cues}")


def _forced_greedy(assets, mel, language: str, forced) -> tuple:
    """The CPU path stepped along the card's greedy tokens (rules
    applied as generation applies them): the first step whose CPU argmax
    is another token (None if none), and the largest gap between the
    CPU's best processed logit and its logit for the card's token."""
    from vlog_tpu_torch.asr import decode as dec
    from vlog_tpu_torch.asr import model as wm

    st, cfg, model = assets.tokens, assets.cfg, assets.model
    prompt = [st.sot, st.language_token(language), st.transcribe]
    sup = torch.as_tensor(dec._suppress_vector(
        cfg.vocab_size, st.suppress + (st.no_timestamps,)))
    bsup = torch.as_tensor(dec._suppress_vector(cfg.vocab_size,
                                                st.begin_suppress))
    one = lambda t: torch.tensor([t])           # noqa: E731
    first, worst, steps = None, 0.0, 0
    with torch.inference_mode():
        ckv = wm.cross_kv(model, wm.encode(model, mel))
        cache = wm.DecoderCache.create(cfg, 1, len(prompt) + len(forced),
                                       "cpu")
        for i, t in enumerate(prompt):
            logits = wm.decoder_step(model, one(t), i, cache, ckv)
        last, penult, last_ts = prompt[-1], prompt[-2], st.timestamp_begin - 1
        for step, tok in enumerate(int(t) for t in forced):
            lg = logits + sup + (bsup if step == 0 else 0.0)
            lg = dec.apply_timestamp_rules(
                lg, one(last), one(penult), one(last_ts), step,
                ts_begin=st.timestamp_begin, eot=st.eot)[0]
            best = int(torch.argmax(lg))
            worst = max(worst, float(lg[best] - lg[tok]))
            if best != tok and first is None:
                first = step
            steps += 1
            if tok == st.eot:
                break
            if tok >= st.timestamp_begin:
                last_ts = tok
            penult, last = last, tok
            logits = wm.decoder_step(model, one(tok), len(prompt) + step,
                                     cache, ckv)
    return first, worst, steps


def phase_asr(work: Path) -> dict:
    """transcribe_video on the card at whisper-small width, then the card
    against the CPU path, solo against packed, int8, and the times."""
    from torch.profiler import ProfilerActivity, profile

    from vlog_tpu_torch import config
    from vlog_tpu_torch.asr import decode as dec
    from vlog_tpu_torch.asr import engine as engine_mod
    from vlog_tpu_torch.asr import load
    from vlog_tpu_torch.asr import mel as melmod
    from vlog_tpu_torch.asr import model as wm
    from vlog_tpu_torch.asr.synthetic import WHISPER_SMALL, write_checkpoint
    from vlog_tpu_torch.media.audio import AudioData, read_wav, write_wav
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.worker.transcribe import _cut_windows, transcribe_video

    out: dict = {}
    t0 = time.perf_counter()
    ckpt = write_checkpoint(work / "whisper-small", WHISPER_SMALL,
                            seed=ASR_SEED)
    wav = work / "speech.wav"
    write_wav(wav, AudioData(pcm=_asr_audio(ASR_SEED)[None],
                             sample_rate=16000))
    out["write_s"] = round(time.perf_counter() - t0, 2)

    # -- the main path: transcribe_video with the defaults ----------------
    engine_mod.reset_engine()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = engine_mod.get_engine(str(ckpt), device="cuda")
    out["load_s"] = round(time.perf_counter() - t0, 2)
    stats: dict = {}
    fused_resize.launches = 0
    t0 = time.perf_counter()
    res = transcribe_video(wav, work / "asr_out", model_dir=str(ckpt),
                           device="cuda", stats_out=stats)
    wall = time.perf_counter() - t0
    if fused_resize.launches:
        fail(f"asr: {fused_resize.launches} resize launches")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("asr: TF32 is on")
    if eng.assets.model.device.type != "cuda" or engine_mod.peek_engine() is not eng:
        fail("asr: the main path did not run on the card's engine")
    _check_vtt(Path(res.vtt_path), res.cue_count)
    log_ = eng.batch_log
    want = {"windows_total": ASR_WINDOWS, "windows_live": ASR_LIVE,
            "windows_submitted": ASR_LIVE}
    if any(stats.get(k) != v for k, v in want.items()) \
            or [(b["n"], b["rows"]) for b in log_] != [(ASR_LIVE, 4)]:
        fail(f"asr: windows {stats}, batches {log_}; want {want} and one "
             f"batch of {ASR_LIVE} windows in 4 rows")
    lang = res.language
    out.update(language=lang, cues=res.cue_count, wall_s=round(wall, 3),
               batch_s=round(log_[0]["elapsed_s"], 3), beam=config.WHISPER_BEAM,
               rows=log_[0]["rows"],
               audio_s_per_wall_s=round(ASR_AUDIO_S / wall, 3),
               windows_per_s=round(ASR_LIVE / log_[0]["elapsed_s"], 3))
    log(f"asr main path: {json.dumps(out)}; windows {json.dumps(stats)}")

    # -- the card against the CPU path, one window at full width ----------
    assets = eng.assets
    samples = read_wav(wav).pcm[0].astype(np.float32)   # what the path read
    windows = _cut_windows(samples, window_s=30.0, overlap_s=5.0)
    win = [melmod.pad_or_trim(w.astype(np.float32)) for _, w in windows]
    t0 = time.perf_counter()
    cpu = load.load_whisper(ckpt, device="cpu")
    mel_card = melmod.log_mel_spectrogram(win[0][None], device="cuda")
    mel_cpu = melmod.log_mel_spectrogram(win[0][None], device="cpu")
    enc_card = wm.encode(assets.model, mel_card)
    enc_cpu = wm.encode(cpu.model, mel_cpu)
    toks, _ = dec.generate_batch(assets, mel_card, language=lang, beam=1)
    st = assets.tokens
    gen = [int(t) for t in toks[0]]
    gen = gen[:gen.index(st.eot) + 1] if st.eot in gen else gen
    forced = [st.sot, st.language_token(lang), st.transcribe] + gen[:64]
    ids = torch.tensor([forced])
    logit_card = wm.decode_logits(assets.model, ids.cuda(), enc_card)
    logit_cpu = wm.decode_logits(cpu.model, ids, enc_cpu)
    first, gap, steps = _forced_greedy(cpu, mel_cpu, lang, toks[0])
    diffs = {"mel": float((mel_card.cpu() - mel_cpu).abs().max()),
             "encoder": float((enc_card.cpu() - enc_cpu).abs().max()),
             "logits": float((logit_card.cpu() - logit_cpu).abs().max())}
    card_vs_cpu = {"max_abs": diffs, "greedy_tokens": len(gen),
                   "first_differing_step": first, "max_token_gap": gap,
                   "steps_checked": steps,
                   "seconds": round(time.perf_counter() - t0, 2)}
    log("asr card vs CPU (one window): " + json.dumps(card_vs_cpu))
    for name, bound in (("mel", ASR_MEL_MAX_ABS), ("encoder", ASR_ENC_MAX_ABS),
                        ("logits", ASR_LOGIT_MAX_ABS)):
        if not diffs[name] <= bound:
            fail(f"asr: {name} differs from the CPU path by {diffs[name]} "
                 f"> {bound}")
    if not gap <= ASR_TOKEN_GAP_MAX:
        fail(f"asr: a card greedy token trails the CPU's best by {gap} > "
             f"{ASR_TOKEN_GAP_MAX}")
    out["card_vs_cpu"] = card_vs_cpu

    # -- solo against packed on the card ----------------------------------
    rows = [win[0]] + [melmod.pad_or_trim(
        samples[int(s * 16000):])
        for s in (7.0, 13.0, 19.0, 31.0, 37.0, 43.0, 49.0)]
    rows.insert(ASR_PACK_AT, rows.pop(0))
    mel8 = melmod.log_mel_spectrogram(np.stack(rows), device="cuda")
    packing = {}
    for beam in (1, config.WHISPER_BEAM):
        solo, _ = dec.generate_batch(assets, mel_card, language=lang, beam=beam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        packed, _ = dec.generate_batch(assets, mel8, language=lang, beam=beam)
        el = time.perf_counter() - t0
        n_tok = int(sum((r != st.eot).sum() for r in packed))
        same = bool(np.array_equal(solo[0], packed[ASR_PACK_AT]))
        diff_at = None if same else int(np.argmax(solo[0] != packed[ASR_PACK_AT]))
        packing[f"beam{beam}"] = {
            "identical": same, "first_differing_step": diff_at,
            "packed_s": round(el, 3), "tokens": n_tok,
            "tokens_per_s": round(n_tok / el, 1),
            "windows_per_s": round(ASR_PACK_ROWS / el, 3),
            "max_memory_allocated_gb": round(
                torch.cuda.max_memory_allocated() / 1e9, 3)}
    log("asr solo vs packed (8 windows) on the card: " + json.dumps(packing))
    bad = [k for k, v in packing.items() if not v["identical"]]
    if bad:
        fail(f"asr: solo and packed tokens differ on the card ({bad})")
    out["packing"] = packing

    # -- int8 (VLOG_WHISPER_QUANT=int8), one window greedy ----------------
    saved = config.WHISPER_QUANT
    config.WHISPER_QUANT = "int8"
    try:
        t0 = time.perf_counter()
        q_card = load.load_whisper(ckpt, device="cuda")
        q_cpu = load.load_whisper(ckpt, device="cpu")
    finally:
        config.WHISPER_QUANT = saved
    qtoks, _ = dec.generate_batch(q_card, mel_card, language=lang, beam=1)
    q_first, q_gap, q_steps = _forced_greedy(q_cpu, mel_cpu, lang, qtoks[0])
    int8 = {"first_differing_step": q_first, "max_token_gap": q_gap,
            "steps_checked": q_steps,
            "seconds": round(time.perf_counter() - t0, 2)}
    log("asr int8 card vs CPU (one window greedy): " + json.dumps(int8))
    if not q_gap <= ASR_TOKEN_GAP_MAX:
        fail(f"asr int8: a card greedy token trails the CPU's best by "
             f"{q_gap} > {ASR_TOKEN_GAP_MAX}")
    out["int8"] = int8
    del q_card, q_cpu, cpu
    load.invalidate()

    # -- times: mel, encoder, decoder step; launches per step ----------
    model = assets.model
    mel_ms = call_ms(lambda: melmod.log_mel_spectrogram(np.stack(rows),
                                                        device="cuda"), 3)
    enc8 = wm.encode(model, mel8)
    enc_ms = call_ms(lambda: wm.encode(model, mel8), 3)
    ckv8 = wm.cross_kv(model, enc8)
    step = {}
    for name, k in (("greedy", 1), ("beam", config.WHISPER_BEAM)):
        ckv = [(a.repeat_interleave(k, 0), b.repeat_interleave(k, 0))
               for a, b in ckv8] if k > 1 else ckv8
        n = ASR_PACK_ROWS * k
        cache = wm.DecoderCache.create(model.cfg, n, 227, "cuda")
        tok = torch.full((n,), st.sot, dtype=torch.int64, device="cuda")
        fn = lambda: wm.decoder_step(model, tok, 100, cache, ckv)   # noqa: E731
        step[name] = {"rows": n, "ms": round(call_ms(fn, ASR_TIMED_STEPS), 4)}
    # the beam's bookkeeping per step at 8 windows: rules, log-softmax, the
    # stable top-k, the cache gather
    n = ASR_PACK_ROWS * config.WHISPER_BEAM
    lg = torch.randn(n, model.cfg.vocab_size, device="cuda")
    ar = torch.zeros(n, dtype=torch.int64, device="cuda")

    def bookkeeping():
        x = dec.apply_timestamp_rules(lg, ar, ar, ar, 5,
                                      ts_begin=st.timestamp_begin, eot=st.eot)
        x = torch.log_softmax(x, -1).reshape(ASR_PACK_ROWS, -1)
        _, i = dec.top_k_lower_index_first(x, config.WHISPER_BEAM)
        g = i.reshape(-1) // model.cfg.vocab_size
        return cache.k[:, g], cache.v[:, g]

    step["beam_bookkeeping_ms"] = round(call_ms(bookkeeping, ASR_TIMED_STEPS), 4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
    kernels = _raw_kernels(prof)
    busy = sum(us for _, us in kernels) / 1e6
    times = {"mel_ms_8_windows": round(mel_ms, 3),
             "encoder_ms_8_windows": round(enc_ms, 3),
             "decoder_step": step,
             "beam_step_profile": {
                 "launches": len(kernels), "device_busy_ms": round(busy * 1e3, 4),
                 "wall_ms": round(step_wall * 1e3, 4),
                 "busy_share": round(busy / step_wall, 4) if kernels else None}}
    log("asr times (8 windows): " + json.dumps(times))
    out["times"] = times
    engine_mod.reset_engine()
    load.invalidate()
    dec.kv_pool.reset()
    return out


# ---------------------------------------------------------------------------
# The device runtime: the executor at several depths, its failpoint drain,
# the mesh scheduler on the card, the profiler, the compile meter
RUNTIME_HEVC_DEPTHS = (1, 2, 3)
RUNTIME_H264_DEPTHS = (1, 2)
RUNTIME_TREE_SKIP = ("rc_journal.jsonl", "outputs.json")   # run state
PROFILE_SESSION_S = 1.0
TINY_WHISPER = dict(d_model=64, encoder_layers=1, decoder_layers=1,
                    encoder_attention_heads=2, decoder_attention_heads=2,
                    encoder_ffn_dim=128, decoder_ffn_dim=128,
                    vocab_size=51865)
SCHED_WAV_S = 35.0        # two 30 s windows (5 s overlap)


def _runtime_tree(out: Path) -> dict[str, bytes]:
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*"))
            if p.is_file() and p.name not in RUNTIME_TREE_SKIP}


def _tree_diff(a: dict, b: dict) -> list[str]:
    return sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))


def _check_stage_s(name: str, stage_s: dict) -> dict:
    """The reference's stage keys and the executor's gauges are there;
    returns the gauges."""
    from vlog_tpu_torch.obs.trace import STAGE_KEYS

    gauges = ("pipeline_depth", "max_in_flight", "host_busy_s",
              "host_wall_s", "host_occupancy")
    missing = [k for k in STAGE_KEYS + gauges + ("pad_frames",)
               if k not in stage_s]
    if missing:
        fail(f"{name}: stage_s lacks {missing}")
    if not 1 <= stage_s["max_in_flight"] <= stage_s["pipeline_depth"]:
        fail(f"{name}: max_in_flight {stage_s['max_in_flight']} outside "
             f"1..{stage_s['pipeline_depth']}")
    return {k: stage_s[k] for k in gauges}


def _at_depth(depth: int, fn, *args, **kw):
    from vlog_tpu_torch import config

    saved = config.PIPELINE_DEPTH
    config.PIPELINE_DEPTH = depth
    try:
        return fn(*args, **kw)
    finally:
        config.PIPELINE_DEPTH = saved


def _runtime_depths(backend, plan_for, depths, name: str, launches_per_run: int,
                    work: Path) -> tuple[dict, dict]:
    """The same plan at each depth: trees identical, launches exact;
    returns the tree and {depth: numbers}."""
    from vlog_tpu_torch.ops import fused_resize

    ref, rows = None, {}
    for depth in depths:
        out = work / f"rt_{name}_d{depth}"
        fused_resize.launches = 0
        t0 = time.perf_counter()
        res = _at_depth(depth, backend.run, plan_for(out), resume=False)
        wall = time.perf_counter() - t0
        if fused_resize.launches != launches_per_run:
            fail(f"runtime {name} depth {depth}: {fused_resize.launches} "
                 f"launches, want {launches_per_run}")
        g = _check_stage_s(f"runtime {name} depth {depth}", res.stage_s)
        if g["pipeline_depth"] != depth:
            fail(f"runtime {name}: pipeline_depth {g['pipeline_depth']}, "
                 f"want {depth}")
        rows[depth] = {"wall_s": round(wall, 3), **g,
                       **{k: res.stage_s[k] for k in (
                           "decode_wait_s", "compute_wait_s",
                           "device_pull_s", "entropy_s", "package_s")}}
        tree = _runtime_tree(out)
        if ref is None:
            ref = tree
        elif _tree_diff(ref, tree):
            fail(f"runtime {name}: the depth-{depth} tree differs from "
                 f"depth {depths[0]}'s: {_tree_diff(ref, tree)}")
        log(f"runtime {name} depth {depth}: " + json.dumps(rows[depth]))
    return ref, rows


def _runtime_failpoint(backend, plan_for, want: dict, work: Path) -> dict:
    """``backend.pull`` armed once (its second hit: dispatch 2 of the one
    rung) at depth 2: the run raises, no executor or prefetch thread is
    left, and the resumed run writes the uninterrupted tree."""
    import threading

    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.utils import failpoints

    out = work / "rt_failpoint"
    fused_resize.launches = 0
    failpoints.arm("backend.pull", count=1, skip=1)
    try:
        _at_depth(2, backend.run, plan_for(out), resume=False)
        fail("runtime failpoint: the run with backend.pull armed finished")
    except failpoints.FailpointError:
        pass
    finally:
        fires = failpoints.counters()["backend.pull"]["fires"]
        failpoints.reset()
    leaked = [t.name for t in threading.enumerate() if t.is_alive()
              and t.name.startswith(("vlog-pipe", "vlog-decode"))]
    if fires != 1 or leaked:
        fail(f"runtime failpoint: {fires} fires, leaked threads {leaked}")
    failed_launches = fused_resize.launches
    res = _at_depth(2, backend.run, plan_for(out), resume=True)
    if res.resumed_segments != 1:
        fail(f"runtime failpoint: resumed_segments {res.resumed_segments}, "
             "want 1")
    got = _runtime_tree(out)
    if _tree_diff(want, got):
        fail(f"runtime failpoint: the resumed tree differs: {_tree_diff(want, got)}")
    return {"fires": fires, "leaked_threads": 0,
            "launches_failed_run": failed_launches,
            "launches_resumed_run": fused_resize.launches - failed_launches,
            "resumed_segments": res.resumed_segments, "files_equal": len(got)}


def _runtime_scheduler(src: Path, work: Path) -> dict:
    """A MeshScheduler over the card with one slot: an HEVC
    ``process_video`` under a lease and a ``transcribe_video`` through an
    engine given the scheduler run one after the other on width-1
    leases; a fault quarantines the card and the CUDA probe reinstates
    it."""
    import threading

    from vlog_tpu_torch import config
    from vlog_tpu_torch.asr.engine import AsrEngine
    from vlog_tpu_torch.asr.load import load_whisper
    from vlog_tpu_torch.asr.model import WhisperConfig
    from vlog_tpu_torch.asr.synthetic import write_checkpoint
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.audio import AudioData, write_wav
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler
    from vlog_tpu_torch.worker import process_video
    from vlog_tpu_torch.worker.transcribe import transcribe_video

    card = torch.device("cuda", 0)
    sched = MeshScheduler(devices=[card], slots=1)
    grants: list[tuple] = []          # (event, thread, t, width, device)
    acquire, release = sched._acquire, sched._release

    def logged_acquire(ticket, timeout, cancel):
        lease = acquire(ticket, timeout, cancel)
        grants.append(("grant", threading.current_thread().name,
                       time.perf_counter(), lease.width, str(lease.devices[0])))
        return lease

    def logged_release(lease):
        grants.append(("release", threading.current_thread().name,
                       time.perf_counter(), lease.width, str(lease.devices[0])))
        release(lease)

    sched._acquire, sched._release = logged_acquire, logged_release

    ckpt = write_checkpoint(work / "whisper-tiny", WhisperConfig(**TINY_WHISPER),
                            seed=ASR_SEED)
    wav = work / "sched.wav"
    n = int(SCHED_WAV_S * 16000)
    write_wav(wav, AudioData(pcm=_asr_audio(ASR_SEED)[None, :n],
                             sample_rate=16000))
    engine = AsrEngine(load_whisper(ckpt, device="cuda"), scheduler=sched)
    ticket = sched.admit()
    lease = ticket.acquire()
    if lease.width != 1 or sched.capacity() != 0:
        fail(f"runtime scheduler: lease width {lease.width}, capacity "
             f"{sched.capacity()}")
    asr_out: dict = {}
    asr_thread = threading.Thread(
        target=lambda: asr_out.update(res=transcribe_video(
            wav, work / "sched_asr", model_dir=str(ckpt), engine=engine,
            language="en", device="cuda")), name="sched-asr")
    t0 = time.perf_counter()
    try:
        with lease:
            asr_thread.start()      # its windows queue behind the lease
            hevc = process_video(src, work / "sched_hevc",
                                 backend=TorchBackend(device="cpu"),
                                 codec="h265")
    finally:
        ticket.close()
    asr_thread.join(timeout=300)
    deadline = time.monotonic() + 10
    while engine.active() and time.monotonic() < deadline:
        time.sleep(0.05)
    engine.close()
    wall = time.perf_counter() - t0
    if "res" not in asr_out:
        fail("runtime scheduler: transcribe_video did not finish")
    events = [(e, th, w, d) for e, th, _, w, d in grants]
    want = [("grant", "MainThread", 1, str(card)),
            ("release", "MainThread", 1, str(card)),
            ("grant", "vlog-asr-engine", 1, str(card)),
            ("release", "vlog-asr-engine", 1, str(card))]
    if events != want:
        fail(f"runtime scheduler: leases {events}, want {want}")
    if sched.capacity() != 1:
        fail(f"runtime scheduler: capacity {sched.capacity()} after both jobs")
    if hevc.run.frames_processed != FRAMES:
        fail(f"runtime scheduler: hevc processed {hevc.run.frames_processed}")
    # quarantine and the CUDA probe
    saved = config.QUARANTINE_THRESHOLD
    config.QUARANTINE_THRESHOLD = 1
    try:
        t = sched.admit()
        faulty = t.acquire()
        newly = sched.report_device_fault(faulty, reason="chip smoke")
        t.close()
    finally:
        config.QUARANTINE_THRESHOLD = saved
    quarantined = sched.snapshot()
    if newly != (card,) or quarantined["slots"] != 0 or sched.capacity() != 0:
        fail(f"runtime scheduler: fault quarantined {newly}, {quarantined}")
    probe = sched.probe_quarantined()
    healed = sched.snapshot()
    if probe != {card: True} or healed["slots"] != 1 or healed["healthy"] != 1:
        fail(f"runtime scheduler: probe {probe}, {healed}")
    return {"leases": [list(e) for e in events], "wall_s": round(wall, 3),
            "hevc_ran_on_lease_device": True,
            "asr_cues": asr_out["res"].cue_count,
            "quarantined": {k: quarantined[k] for k in ("slots", "quarantined")},
            "probe": {str(k): v for k, v in probe.items()},
            "healed": {k: healed[k] for k in ("slots", "healthy")}}


def _runtime_profiler(backend, plan, work: Path) -> dict:
    """A session started from the main thread around an HEVC run on
    another thread: the trace names the resize kernel."""
    import threading

    from vlog_tpu_torch import config
    from vlog_tpu_torch.obs.profiler import DeviceProfiler

    saved = config.PROFILE_DIR
    config.PROFILE_DIR = str(work / "profiles")
    try:
        prof = DeviceProfiler()
        info = prof.start(duration_s=PROFILE_SESSION_S, label="chip smoke")
        if not info.get("profiling"):
            fail(f"runtime profiler: start failed {info}")
        job = threading.Thread(target=backend.run, args=(plan,),
                               kwargs={"resume": False}, name="vlog-job-hevc")
        job.start()
        deadline = time.monotonic() + PROFILE_SESSION_S + 60
        while prof.status()["profiling"] and time.monotonic() < deadline:
            time.sleep(0.1)
        job.join(timeout=120)
        if prof.status()["profiling"] or job.is_alive():
            fail("runtime profiler: the session or the job did not end")
    finally:
        config.PROFILE_DIR = saved
    trace = Path(info["dir"]) / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    resize = [e for e in kernels if "_resize_kernel" in e.get("name", "")]
    threads = {e.get("tid") for e in events if e.get("cat") == "cpu_op"}
    if not resize:
        fail(f"runtime profiler: no resize kernel among the trace's "
             f"{len(kernels)} kernels")
    return {"trace_mb": round(trace.stat().st_size / 2 ** 20, 2),
            "events": len(events), "kernels": len(kernels),
            "resize_kernels": len(resize),
            "resize_names": sorted({e["name"] for e in resize}),
            "cpu_op_threads": len(threads)}


def _compile_warm() -> float:
    """compile_seconds() of a fresh process that loads both libraries
    from the warm build directory."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from vlog_tpu_torch.native import build\n"
            "from vlog_tpu_torch.ops import fused_resize\n"
            "from vlog_tpu_torch.parallel.compile_cache import compile_seconds\n"
            "fused_resize.load_library(); build.get_lib()\n"
            "print(compile_seconds())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    return float(out.stdout.strip().splitlines()[-1])


def phase_runtime(sources: dict, work: Path, compile_cold: float) -> int:
    import dataclasses

    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize

    backend = TorchBackend(device="cuda")
    launches, part_s = 0, {}
    clock = time.perf_counter
    # 1. HEVC, 1080p, constant-QP 4-rung ladder, 6-frame chains: 4 dispatches
    t0 = clock()
    ladder = tuple(dataclasses.replace(r, video_bitrate=0)
                   for r in config.ladder_for_source(SRC_H))
    info = get_video_info(sources[FRAMES])
    hevc_plan = lambda out: backend.plan(           # noqa: E731
        info, ladder, out, codec="h265", segment_duration_s=SHORT_SEG_S,
        frame_batch=SHORT_BATCH, thumbnail=False)
    per_call = _frames_per_call(hevc_plan(work / "rt_probe"), "runtime hevc",
                                FRAMES)
    scaled = sum(1 for r in ladder if r.height != SRC_H)
    _, hevc_rows = _runtime_depths(backend, hevc_plan, RUNTIME_HEVC_DEPTHS,
                                   "hevc", scaled * 3 * len(per_call), work)
    launches += scaled * 3 * len(per_call) * len(RUNTIME_HEVC_DEPTHS)
    part_s["hevc_depths"] = clock() - t0
    # 2. H.264, the resume phase's 360p rung at constant QP: 2 dispatches
    t0 = clock()
    rung = dataclasses.replace(config.QUALITY_LADDER[-1], video_bitrate=0)
    info12 = get_video_info(sources[RESUME_FRAMES])
    h264_plan = lambda out: backend.plan(           # noqa: E731
        info12, (rung,), out, segment_duration_s=SHORT_SEG_S,
        frame_batch=SHORT_BATCH, thumbnail=False)
    n_disp = len(_frames_per_call(h264_plan(work / "rt_probe"), "runtime h264",
                                  RESUME_FRAMES))
    tree, h264_rows = _runtime_depths(backend, h264_plan, RUNTIME_H264_DEPTHS,
                                      "h264", 3 * n_disp, work)
    launches += 3 * n_disp * len(RUNTIME_H264_DEPTHS)
    if h264_rows[2]["max_in_flight"] != 2:
        fail(f"runtime h264: depth 2 reached max_in_flight "
             f"{h264_rows[2]['max_in_flight']}, want 2")
    part_s["h264_depths"] = clock() - t0
    # 3. the backend.pull failpoint: clean drain, equal resumed tree
    t0 = clock()
    fp = _runtime_failpoint(backend, h264_plan, tree, work)
    launches += fp["launches_failed_run"] + fp["launches_resumed_run"]
    log("runtime failpoint: " + json.dumps(fp))
    part_s["failpoint"] = clock() - t0
    # 4. the scheduler on the card (an HEVC job and a transcription)
    t0 = clock()
    fused_resize.launches = 0
    sched = _runtime_scheduler(sources[FRAMES], work)
    if fused_resize.launches != 12 * fused_resize.LAUNCHES_PER_CALL:
        fail(f"runtime scheduler: {fused_resize.launches} launches, want 12")
    launches += fused_resize.launches
    log("runtime scheduler: " + json.dumps(sched))
    part_s["scheduler"] = clock() - t0
    # 5. the profiler around an HEVC run on another thread
    t0 = clock()
    fused_resize.launches = 0
    plan6 = backend.plan(get_video_info(sources[TS_FRAMES]), ladder,
                         work / "rt_profiled", codec="h265", thumbnail=False)
    prof = _runtime_profiler(backend, plan6, work)
    if fused_resize.launches != scaled * 3 * fused_resize.LAUNCHES_PER_CALL:
        fail(f"runtime profiler: {fused_resize.launches} launches")
    launches += fused_resize.launches
    log("runtime profiler: " + json.dumps(prof))
    part_s["profiler"] = clock() - t0
    # 6. the compile meter, cold (this process's builds) and warm
    t0 = clock()
    warm = _compile_warm()
    if warm != 0.0:
        fail(f"runtime: compile_seconds() {warm} in a warm build directory")
    log("runtime compile_seconds: " + json.dumps(
        {"cold": round(compile_cold, 3), "warm": warm}))
    part_s["compile_warm"] = clock() - t0
    log("runtime depths: " + json.dumps({"hevc": hevc_rows, "h264": h264_rows}))
    log("runtime part seconds: " + json.dumps(
        {k: round(v, 2) for k, v in part_s.items()}))
    return launches


# The daemon phase: the worker daemon on a sqlite queue in the work dir.
DAEMON_PROBE_S = 0.5        # VLOG_DEVICE_PROBE_INTERVAL_S for the phase
DAEMON_TIMEOUT_S = 2.0      # the cancelled attempt's timeout envelope
# The rise of torch.cuda.memory_allocated() across a cancelled attempt:
# read when the attempt's handler starts and again when its retry's
# starts. The caches a run fills (the resize matrices' band forms, the
# thumbnail matrices) are in place after the identical job before it;
# what may remain is one cuBLAS workspace, when the attempt ran on a
# pool thread whose handle had not yet met the device's compute stream
# (torch keeps one per pair; 32 MiB as this phase measured it on an
# NVIDIA H100 80GB HBM3 at 700 W). One 6-frame 1080p HEVC batch left
# referenced (its planes, levels and reconstructions on four rungs) is
# larger than this.
DAEMON_MEM_RISE_MAX = 64 << 20
DAEMON_QUEUE_TIMEOUT_S = 600.0
DAEMON_CLI_TIMEOUT_S = 180.0
HEVC_PAYLOAD = {"codec": "h265", "streaming_format": "cmaf"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _daemon_cli(d: Path, src: Path) -> dict:
    """``python -m vlog_tpu_torch.worker.daemon`` in a subprocess for one
    HEVC re-encode, its health server read, then SIGTERM: the drain and
    exit code 0. Needs ``aiohttp`` (the health server), which the card's
    machine may lack; then the CLI is tested on the CPU only."""
    import asyncio
    import os
    import signal
    import sqlite3
    import urllib.request

    try:
        import aiohttp  # noqa: F401
    except ImportError:
        log("daemon cli: aiohttp is not installed on this machine; the "
            "worker CLI is tested on the CPU only "
            "(tests/test_torch_worker_cli.py)")
        return {"cli": "not run: no aiohttp"}
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids

    db_path = d / "cli.db"

    async def seed() -> int:
        db = Database(f"sqlite:///{db_path}")
        await db.connect()
        await create_all(db)
        video = await vids.create_video(db, "CLI", source_path=str(src))
        job = await claims.enqueue_job(db, video["id"], JobKind.REENCODE,
                                       payload=HEVC_PAYLOAD)
        await db.disconnect()
        return job

    job_id = asyncio.run(seed())
    port = _free_port()
    env = {**os.environ, "VLOG_BASE_DIR": str(d / "cli"),
           "VLOG_WORKER_POLL_INTERVAL": "0.2",
           "VLOG_WORKER_HEALTH_PORT": str(port), "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    log_path = d / "cli.log"
    with open(log_path, "w") as log_fp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vlog_tpu_torch.worker.daemon", "--name",
             "smoke-cli", "--db", f"sqlite:///{db_path}", "--kinds",
             "reencode"], cwd=ROOT, env=env, stdout=log_fp,
            stderr=subprocess.STDOUT)
    try:
        done = None
        deadline = time.monotonic() + DAEMON_CLI_TIMEOUT_S
        while done is None and time.monotonic() < deadline \
                and proc.poll() is None:
            time.sleep(0.2)
            with sqlite3.connect(db_path) as con:
                done = con.execute(
                    "SELECT completed_at FROM jobs WHERE id=?",
                    (job_id,)).fetchone()[0]
        t_job = time.perf_counter() - t0
        if done is None:
            proc.kill()
            proc.wait()
            fail("daemon cli: the job did not complete: "
                 + log_path.read_text()[-3000:])
        health = {}
        for route in ("/health", "/ready", "/metrics"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                        timeout=10) as r:
                health[route] = (r.status, len(r.read()))
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log_path.read_text()
    if proc.returncode != 0 or "entering drain (SIGTERM)" not in out:
        fail(f"daemon cli: exit code {proc.returncode} after SIGTERM: "
             + out[-3000:])
    if any(s != 200 for s, _ in health.values()):
        fail(f"daemon cli: health routes {health}")
    with sqlite3.connect(db_path) as con:
        status = con.execute(
            "SELECT status FROM workers WHERE name='smoke-cli'").fetchone()
    if status != ("offline",):
        fail(f"daemon cli: worker row {status} after the drain")
    return {"cli_job_s": round(t_job, 2), "health": health,
            "exit_code": proc.returncode, "worker": status[0]}


def phase_daemon(work: Path, ip_path: Path, sources: dict) -> int:
    """The port's ``WorkerDaemon(device="cuda")`` over a sqlite queue, the
    registry's torch backend and ``get_scheduler()``, driven by ``run()``
    until the queue is empty: the pipeline phase's A/V MP4 transcoded
    (its first attempt hit by ``device.fault``: refunded, the card
    quarantined and reinstated by the probe loop), its sprite and
    transcription jobs, a 35 s WAV transcribed, an HEVC re-encode of the
    24-frame source; then with 6-frame dispatches an HEVC re-encode with
    a 1 s profile session from its first resize, and one whose first
    attempt a timeout cancels
    between dispatches (no executor thread left, the allocated bytes held
    to a bound) before its retry completes; the command verbs; the CLI."""
    import asyncio
    import os
    import threading

    from vlog_tpu_torch import config
    from vlog_tpu_torch.asr.engine import reset_engine
    from vlog_tpu_torch.asr.model import WhisperConfig
    from vlog_tpu_torch.asr.synthetic import write_checkpoint
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids
    from vlog_tpu_torch.media.audio import AudioData, write_wav
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.obs.trace import STAGE_KEYS
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420
    from vlog_tpu_torch.parallel import hevc_ladder
    from vlog_tpu_torch.parallel.scheduler import get_scheduler
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.utils import failpoints
    from vlog_tpu_torch.worker import pipeline as pipeline_mod
    from vlog_tpu_torch.worker.daemon import WorkerDaemon
    from vlog_tpu_torch.worker.pipeline import process_video

    d = work / "daemon"
    d.mkdir()
    ckpt = work / "whisper-tiny"
    if not ckpt.exists():
        write_checkpoint(ckpt, WhisperConfig(**TINY_WHISPER), seed=ASR_SEED)
    wav = d / "speech.wav"
    write_wav(wav, AudioData(pcm=_asr_audio(ASR_SEED)[None, :int(
        SCHED_WAV_S * 16000)], sample_rate=16000))
    backend = get_backend("torch")
    sched = get_scheduler()
    if backend.device.type != "cuda" or sched.devices != (
            torch.device("cuda", 0),) or sched.slots != 1:
        fail(f"daemon: backend on {backend.device}, scheduler "
             f"{sched.snapshot()}")
    # every kernel call of the phase's plans is at a count the kernel
    # phase held
    a_info, b_info = get_video_info(ip_path), get_video_info(sources[FRAMES])
    _frames_per_call(backend.plan(a_info, out_dir=d / "p"), "daemon transcode",
                     MP4_FRAMES)
    _frames_per_call(backend.plan(b_info, out_dir=d / "p", codec="h265"),
                     "daemon re-encode", FRAMES)
    _frames_per_call(backend.plan(b_info, out_dir=d / "p", codec="h265",
                                  segment_duration_s=SHORT_SEG_S,
                                  frame_batch=SHORT_BATCH),
                     "daemon 6-frame re-encode", FRAMES)
    saved = {k: getattr(config, k) for k in (
        "RETRY_BACKOFF_BASE_S", "DEVICE_PROBE_INTERVAL_S", "PROFILE_DIR",
        "SEGMENT_DURATION_S", "TPU_FRAME_BATCH", "transcode_timeout_s")}
    os.environ["VLOG_DEVICE_PROBE_INTERVAL_S"] = str(DAEMON_PROBE_S)
    config.DEVICE_PROBE_INTERVAL_S = DAEMON_PROBE_S
    config.RETRY_BACKOFF_BASE_S = 0.0
    config.PROFILE_DIR = str(d / "profiles")
    timeouts: list[float] = []     # one-shot timeout envelopes

    def timeout_s(duration_s, rung):
        return timeouts.pop() if timeouts else saved["transcode_timeout_s"](
            duration_s, rung)

    config.transcode_timeout_s = timeout_s

    events: list[dict] = []        # job outcomes, in order
    quarantine: list = []
    probes: list = []
    report, probe = sched.report_device_fault, sched.probe_quarantined

    def spy_report(lease, **kw):
        newly = report(lease, **kw)
        quarantine.append({"devices": [str(x) for x in newly],
                           "slots": sched.snapshot()["slots"]})
        return newly

    def spy_probe(*a, **kw):
        res = probe(*a, **kw)
        probes.append({str(k): v for k, v in res.items()})
        return res

    sched.report_device_fault, sched.probe_quarantined = spy_report, spy_probe

    async def on_event(event: str, payload: dict) -> None:
        events.append({
            "event": event, "video_id": payload.get("video_id"),
            "kind": payload.get("kind"), "error": payload.get("error"),
            "launches": fused_resize.launches, "t": time.perf_counter(),
            "allocated": torch.cuda.memory_allocated(),
            "executor_threads": [t.name for t in threading.enumerate()
                                 if t.name.startswith(("vlog-pipe",
                                                       "vlog-decode"))]})

    hooks: dict = {}               # video id -> fn(done, supervisor)
    job_video: dict = {}
    # video id -> allocated bytes when each attempt's handler started
    allocated_at_start: dict = {}
    notes: dict = {"hook_errors": []}

    async def drive():
        db = Database(f"sqlite:///{d / 'vlog.db'}")
        await db.connect()
        await create_all(db)
        daemon = WorkerDaemon(
            db, name="smoke-w1", device="cuda", backend=backend,
            scheduler=sched, video_dir=d / "videos",
            transcription_model_dir=str(ckpt), poll_interval_s=0.1,
            heartbeat_interval_s=5.0, progress_min_interval_s=0.0,
            on_event=on_event)
        loop = asyncio.get_running_loop()
        dispatch, make_cb = daemon._dispatch, daemon._make_progress_cb

        async def spy_dispatch(job):
            job_video[job["id"]] = job["video_id"]
            return await dispatch(job)

        def hooked_cb(job_id, total_hint, rung_names):
            cb = make_cb(job_id, total_hint, rung_names)
            allocated_at_start.setdefault(job_video.get(job_id), []).append(
                torch.cuda.memory_allocated())
            hook = hooks.pop(job_video.get(job_id), None)
            if hook is None:
                return cb
            sup = daemon._sup()
            first = [True]

            def wrapped(done, total, msg):
                if first[0]:
                    first[0] = False
                    try:
                        hook(done, sup)
                    except Exception as exc:  # noqa: BLE001 — checked below
                        notes["hook_errors"].append(repr(exc))
                return cb(done, total, msg)
            return wrapped

        daemon._dispatch, daemon._make_progress_cb = spy_dispatch, hooked_cb

        def profiled_process_video(source, out_dir, **kw):
            if Path(out_dir).name == "profiled":
                notes["profile_armed"] = True
            return process_video(source, out_dir, **kw)

        def profiled_resize(*args):
            # the profiled job's first ladder resize, on its dispatch
            # thread: the 1 s session is running when these kernels run
            if notes.get("profile_armed") and "profile" not in notes:
                fut = asyncio.run_coroutine_threadsafe(daemon.handle_command(
                    "profile", {"duration_s": 1, "label": "daemon"}), loop)
                notes["profile"] = fut.result(30)
            return resize_yuv420(*args)

        pipeline_mod.process_video = profiled_process_video
        hevc_ladder.resize_yuv420 = profiled_resize

        def cancel_hook(done, sup):
            # dispatch 1 is done: hold its batch-done callback until the
            # timeout fires, so the cancel lands at this boundary
            notes["cancel_done"] = done
            deadline = time.monotonic() + 60
            while not sup._cancel.is_set() and time.monotonic() < deadline:
                time.sleep(0.01)
            notes["cancel_reason"] = sup._cancel_reason

        async def enqueue(title, src, kind=JobKind.TRANSCODE, payload=None,
                          hook=None):
            video = await vids.create_video(db, title, source_path=str(src))
            if hook is not None:
                hooks[video["id"]] = hook
            await claims.enqueue_job(db, video["id"], kind, payload=payload)
            return video

        async def wait_idle():
            deadline = time.monotonic() + DAEMON_QUEUE_TIMEOUT_S
            while time.monotonic() < deadline:
                await asyncio.sleep(0.1)
                if runner.done():
                    runner.result()
                    fail("daemon: run() ended early")
                rows = await db.fetch_all("SELECT * FROM jobs")
                if rows and not daemon._tasks and all(
                        r["completed_at"] or r["failed_at"] for r in rows):
                    return
            fail("daemon: the queue did not drain in time")

        failpoints.arm("device.fault", count=1)
        fused_resize.launches = 0
        t_run = time.perf_counter()
        runner = asyncio.create_task(daemon.run())
        try:
            vid = {"upload": await enqueue("Upload", ip_path),
                   "speech": await enqueue("Speech", wav,
                                           JobKind.TRANSCRIPTION),
                   "hevc": await enqueue("HEVC", sources[FRAMES],
                                         JobKind.REENCODE, HEVC_PAYLOAD)}
            await wait_idle()
            # 6-frame dispatches (four per re-encode of 24 frames)
            config.SEGMENT_DURATION_S = SHORT_SEG_S
            config.TPU_FRAME_BATCH = SHORT_BATCH
            vid["profiled"] = await enqueue("Profiled", sources[FRAMES],
                                            JobKind.REENCODE, HEVC_PAYLOAD)
            await wait_idle()
            timeouts.append(DAEMON_TIMEOUT_S)
            vid["cancelled"] = await enqueue("Cancelled", sources[FRAMES],
                                             JobKind.REENCODE, HEVC_PAYLOAD,
                                             hook=cancel_hook)
            await wait_idle()
            t_queue = time.perf_counter() - t_run
            verbs = {v: await daemon.handle_command(v, {})
                     for v in ("ping", "stats", "get_metrics")}
        finally:
            daemon.request_stop()
            await asyncio.wait_for(runner, 120)
            failpoints.reset()
            pipeline_mod.process_video = process_video
            hevc_ladder.resize_yuv420 = resize_yuv420
        rows = {t: await db.fetch_all(f"SELECT * FROM {t} ORDER BY id")
                for t in ("jobs", "videos", "video_qualities", "job_failures",
                          "job_spans", "workers")}
        await db.disconnect()
        return vid, rows, verbs, t_queue

    t0 = time.perf_counter()
    try:
        vid, rows, verbs, t_queue = asyncio.run(drive())
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
        os.environ.pop("VLOG_DEVICE_PROBE_INTERVAL_S", None)
        sched.report_device_fault, sched.probe_quarantined = report, probe
        reset_engine()
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    # per job: enqueue-to-complete seconds and its steps' seconds
    for j in rows["jobs"]:
        spans = {s["name"]: round(s["duration_s"] or 0.0, 3)
                 for s in rows["job_spans"] if s["job_id"] == j["id"]
                 and s["name"] != "job"}
        done_s = (j["completed_at"] - j["created_at"]
                  if j["completed_at"] else None)
        log(f"daemon job {j['id']} {j['kind']} (video {j['video_id']}): "
            f"enqueue to complete {done_s}s, attempts {j['attempt']}; "
            f"spans (s) " + json.dumps(spans))
    # launches per job (jobs run one at a time: the counter between
    # outcome events); the cancelled attempt's depend on when it stopped
    prev, per_job = 0, []
    for e in events:
        per_job.append((e["event"], e["video_id"], e["launches"] - prev))
        prev = e["launches"]
    log("daemon launches per job outcome: " + json.dumps(per_job))
    log("daemon allocated bytes at each attempt's start, by video: "
        + json.dumps({str(k): v for k, v in allocated_at_start.items()}))
    if notes["hook_errors"]:
        fail(f"daemon: hooks failed {notes['hook_errors']}")
    ids = {k: v["id"] for k, v in vid.items()}
    by_video = {}
    for j in rows["jobs"]:
        by_video.setdefault(j["video_id"], {})[j["kind"]] = j
    # every job completed, progress 100
    bad = [(j["id"], j["kind"], j["error"]) for j in rows["jobs"]
           if j["completed_at"] is None or j["progress"] != 100.0]
    if bad or len(rows["jobs"]) != 7:
        fail(f"daemon: {len(rows['jobs'])} jobs, not completed: {bad}")
    up = by_video[ids["upload"]]
    if set(up) != {"transcode", "sprite", "transcription"}:
        fail(f"daemon: the upload's jobs are {sorted(up)}")
    # the device fault: refunded, quarantined, reinstated, retried
    fails = {(f["job_id"], f["failure_class"]) for f in rows["job_failures"]}
    cancelled = by_video[ids["cancelled"]]["reencode"]
    if fails != {(up["transcode"]["id"], "device_fault"),
                 (cancelled["id"], "transient")}:
        fail(f"daemon: job_failures {sorted(fails)}")
    if up["transcode"]["attempt"] != 1 or cancelled["attempt"] != 2:
        fail(f"daemon: attempts {up['transcode']['attempt']} (transcode, "
             f"want 1: refunded), {cancelled['attempt']} (cancelled, want 2)")
    if quarantine != [{"devices": ["cuda:0"], "slots": 0}] or not any(
            p == {"cuda:0": True} for p in probes) \
            or sched.snapshot()["healthy"] != 1:
        fail(f"daemon: quarantine {quarantine}, probes {probes}, "
             f"{sched.snapshot()}")
    # the transcode's tree: 4 rungs, verified, sprites and captions
    video = next(v for v in rows["videos"] if v["id"] == ids["upload"])
    quals = [q for q in rows["video_qualities"] if q["video_id"] == video["id"]]
    out = d / "videos" / video["slug"]
    files = integrity.load_manifest(out)
    if video["status"] != "ready" or len(quals) != 4 or not files \
            or integrity.verify_tree(out, files) \
            or "captions.vtt" not in files \
            or not (out / "sprites" / "sprite_01.jpg").exists() \
            or len(list(out.glob("audio_*k"))) != 3:
        fail(f"daemon: upload {video['status']}, {len(quals)} qualities, "
             f"outputs.json {sorted(files or {})}")
    # the WAV's transcription: windows decoded on the card's engine
    speech = by_video[ids["speech"]]["transcription"]
    asr_span = next(s for s in rows["job_spans"]
                    if s["job_id"] == speech["id"]
                    and s["name"] == "worker.transcribe")
    asr_attrs = json.loads(asr_span["attributes"])
    if asr_attrs.get("asr.windows_total") != 2:
        fail(f"daemon: the 35 s WAV's transcription span {asr_attrs}")
    vtt = d / "videos" / next(v["slug"] for v in rows["videos"]
                              if v["id"] == ids["speech"]) / "captions.vtt"
    _check_vtt(vtt, vtt.read_text().count("-->"))
    # the HEVC re-encodes
    for key in ("hevc", "profiled", "cancelled"):
        v = next(x for x in rows["videos"] if x["id"] == ids[key])
        inits = sorted((d / "videos" / v["slug"]).glob("*p/init.mp4"))
        if v["codec"] != "h265" or len(inits) != 4 \
                or not all(b"hvcC" in p.read_bytes() for p in inits):
            fail(f"daemon: re-encode {key}: codec {v['codec']}, "
                 f"{len(inits)} hvc1 rungs")
    # the cancel: between dispatches, no thread left, memory bounded
    failed = [e for e in events if e["event"] == "job.failed"]
    cancel_ev = next(e for e in failed if e["video_id"] == ids["cancelled"])
    at_start = allocated_at_start[ids["cancelled"]]
    if len(at_start) != 2:
        fail(f"daemon: the cancelled job started {len(at_start)} attempts")
    rise = at_start[1] - at_start[0]
    if notes.get("cancel_done") != SHORT_BATCH \
            or "timed out" not in (cancel_ev["error"] or "") \
            or cancel_ev["executor_threads"] or rise > DAEMON_MEM_RISE_MAX:
        fail(f"daemon: cancel at {notes.get('cancel_done')} frames, error "
             f"{cancel_ev['error']}, threads {cancel_ev['executor_threads']}, "
             f"allocated rise {rise} (bound {DAEMON_MEM_RISE_MAX})")
    # the profile session: the trace names the resize kernel
    from vlog_tpu_torch.obs.profiler import profiler

    prof = notes.get("profile") or {}
    deadline = time.monotonic() + 30
    while profiler().status()["profiling"] and time.monotonic() < deadline:
        time.sleep(0.2)
    trace = Path(prof.get("dir", d / "none")) / "trace.json"
    if not prof.get("profiling") or not trace.exists():
        fail(f"daemon: profile session {prof} wrote no trace")
    kernels = {e.get("name", "") for e in json.loads(
        trace.read_text())["traceEvents"] if e.get("cat") == "kernel"}
    resize_names = sorted(k for k in kernels if "_resize_kernel" in k)
    if "streaming_resize_kernel" not in " ".join(resize_names):
        fail(f"daemon: the profile trace names no streaming_resize_kernel "
             f"among {len(kernels)} kernels")
    # the verbs
    metrics = verbs["get_metrics"]["device"]
    if not verbs["ping"].get("pong") \
            or (verbs["stats"]["mesh"] or {}).get("slots") != 1 \
            or verbs["stats"]["completed"] != 7 \
            or metrics.get("initialized") is not True \
            or metrics.get("platform") != "cuda" \
            or not isinstance(metrics.get("bytes_in_use"), int):
        fail(f"daemon: verbs {verbs}")
    # spans: every job's, the transcode's stage keys
    span_jobs = {s["job_id"] for s in rows["job_spans"]}
    stages = {s["name"] for s in rows["job_spans"]
              if s["job_id"] == up["transcode"]["id"]
              and s["name"].startswith("stage.")}
    if span_jobs != {j["id"] for j in rows["jobs"]} \
            or stages != {f"stage.{k[:-2]}" for k in STAGE_KEYS}:
        fail(f"daemon: spans for jobs {sorted(span_jobs)}, stages {stages}")
    scaled = 3 * 3 * fused_resize.LAUNCHES_PER_CALL
    thumb = 3 * fused_resize.LAUNCHES_PER_CALL
    want = {("video.ready", ids["upload"]): scaled + thumb,
            ("video.sprites_ready", ids["upload"]): 3,
            ("video.reencoded", ids["hevc"]): scaled + thumb,
            ("video.reencoded", ids["profiled"]): 4 * scaled + thumb,
            ("video.reencoded", ids["cancelled"]): 4 * scaled + thumb,
            ("job.failed", ids["upload"]): 0}
    got = {(e, v): n for e, v, n in per_job if (e, v) in want}
    if got != want or any(n for e, v, n in per_job
                          if e == "video.transcribed"):
        fail(f"daemon: launches per job {per_job}, want {want}")
    cli = _daemon_cli(d, sources[TS_FRAMES])
    log("daemon: " + json.dumps({
        "wall_s": round(wall, 2), "queue_s": round(t_queue, 2),
        "launches": launches, "launches_per_job": per_job,
        "quarantine": quarantine, "probes": probes,
        "allocated_at_attempt_start": {
            str(k): v for k, v in allocated_at_start.items()},
        "cancel": {"at_frames": notes["cancel_done"],
                   "reason": notes["cancel_reason"],
                   "allocated_at_attempt_start": at_start,
                   "allocated_at_failure_event": cancel_ev["allocated"],
                   "rise": rise, "bound": DAEMON_MEM_RISE_MAX},
        "profile": {"trace_mb": round(trace.stat().st_size / 2 ** 20, 2),
                    "kernels": len(kernels), "resize": resize_names},
        "asr_windows": asr_attrs.get("asr.windows_total"),
        "verbs": {"stats_mesh": verbs["stats"]["mesh"],
                  "device": metrics}, **cli}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    card = smi("--query-gpu=name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        value = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 2)
        log(f"phase {name}: {phase_s[name]}s")
        return value

    timed("build", phase_build)
    from vlog_tpu_torch.parallel.compile_cache import compile_seconds

    compile_cold = compile_seconds()      # this process's builds
    from vlog_tpu_torch.native import get_av_lib

    log("libav ingest shim: " + ("built" if get_av_lib() is not None else
                                 "unavailable on this machine (optional; "
                                 "no phase uses it)"))
    # one profiler-backed timer for the process (the kernel and aac phases)
    timer = DeviceTimer(torch.device("cuda"))
    kern = timed("kernel", phase_kernel, timer, FRAMES)
    timed("integer", phase_integer)
    timed("aac", phase_aac, timer)      # fails on any resize launch
    launches = {"aac": 0}
    work = ROOT / "vlog_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sources = timed("write_y4m", _write_sources, work,
                    (FRAMES, SLICE_FRAMES, INTRA_FRAMES, RESUME_FRAMES,
                     TS_FRAMES), 11)
    launches["slice"] = timed("slice", phase_slice, sources[SLICE_FRAMES])
    launches["intra"] = timed("intra", phase_intra, sources[INTRA_FRAMES])
    launches["pipeline"], ip_path, seq = timed("pipeline", phase_pipeline,
                                               work)
    launches["pipeline_ts"] = timed("pipeline_ts", phase_pipeline_ts, ip_path)
    launches["sprites"] = timed("sprites", phase_sprites, work, ip_path, seq)
    launches["resume"] = timed("resume", phase_resume, sources[RESUME_FRAMES])
    launches["ts"] = timed("ts", phase_ts, sources[TS_FRAMES])
    launches["hevc"] = timed("hevc", phase_hevc, sources[FRAMES], work)
    launches["runtime"] = timed("runtime", phase_runtime, sources, work,
                                compile_cold)
    launches["daemon"] = timed("daemon", phase_daemon, work, ip_path, sources)
    timed("asr", phase_asr, work)       # fails on any resize launch
    launches["asr"] = 0
    shutil.rmtree(work, ignore_errors=True)
    timed("breakdown", phase_breakdown)
    log("launches by phase " + json.dumps(launches))
    log("phase seconds " + json.dumps(phase_s))

    log(json.dumps({"kernels": [{
        "name": "fused_resize_plane", "route": "cuda",
        "source": "vlog_tpu_torch/csrc/fused_resize.cu",
        "replaces": "vlog_tpu/ops/pallas_ladder.py:101",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": kern["max_abs_err"],
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
