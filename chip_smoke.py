"""Chip smoke for the PyTorch/CUDA port: drive its main path on one card.

    python3 chip_smoke.py            # every phase, one card, no options

Phases (any failure exits non-zero; none is caught):

1. the card's name and power limit (nvidia-smi);
2. build the fused resize kernel, the HEVC motion search kernel and the
   H.264 deblocking kernel (nvcc, sm_90a) and the native entropy coders
   (CABAC, CAVLC, JPEG scan) from the checkout's sources, the four builds
   started together, timed;
2a. analysis: the port's static-analysis passes
   (``vlog_tpu_torch.analysis.run_passes``) over the checkout's
   ``vlog_tpu_torch/`` on this machine's Python: the count of findings
   printed, any finding outside the port's baseline
   (``vlog_tpu_torch/analysis/BASELINE.txt``) fails the run;
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
3a. the HEVC motion search kernel against the plain search stages
   (``codecs/hevc/core.py``: ``_integer_search``, ``_subpel_refine``) on
   the card at the four rung shapes of the 1080p ladder, CTB-padded
   (1088x1920, 736x1280, 480x864, 384x640), 6 chains of moving content,
   the configured search: MVs and costs identical; the kernel's device
   ms per call (the timer above), its host-inclusive call ms, its bound
   (the larger of its int32 inputs' bytes over the memory rate and its
   SAD and filter operations over the int32 rate) and share of it, and
   the plain version's device and call ms;
3b. the H.264 deblocking kernel against the plain wavefront
   (``codecs/h264/deblock.py::wavefront``) on the card at the ladder's
   call (6 chains of 368x640, the 360p rung) and the decoder's (one
   1088x1920 picture), each with all-intra bS and with P bS of seeded
   coded blocks and MVs: every pixel identical, one kernel a call; its
   device ms per call after an L2 flush, its call ms, the plain
   wavefront's call ms (CUDA events), its chain bound (the luma
   block's 8 steps a diagonal at the barrier step latency that the
   library's probe measures at the call's block size) beside its bytes
   bound, and its share; every later phase counts the chain step's and
   the decoder's filter calls on the card and fails unless each launched
   the kernel once, and the slice, intra and TS phases unless the chain
   step made the calls their plans fix;
4. the integer stages (intra, P, deblock) on CPU and on CUDA from the
   same uint8 frames: levels, MVs and reconstructions must be identical;
   the HEVC motion search on the CPU (the plain stages) and on CUDA (the
   kernel) at both block sizes: MVs and costs identical;
5. the slice: the first 4 frames of a seeded synthetic 1920x1080 Y4M
   through ``TorchBackend(device="cuda").plan/run`` with the defaults
   (default ladder, thumbnail, resume, the executor at depth 2: one
   24-frame chain cut to 4 frames, one dispatch; 6 until the library
   phase was added); ``stage_s`` must hold
   the reference's stage keys and the executor's gauges
   (``max_in_flight`` >= 1); the CMAF tree must parse with the port's
   own readers, the kernel's launch counter must rise by 3 scaled rungs
   x 3 planes x 1 launch per dispatch plus 3 for the thumbnail (and the
   motion search kernel's not at all: the slice is H.264), each
   rung's mean PSNR-Y must clear a floor, the journal must hold one line
   per dispatch after its header, and ``thumbnail.jpg`` must be a
   1280x720 JPEG, the packed blocks of the backend's thumbnail stages
   on the card; the same stages on the CPU path must agree with the
   card's within the kernel's bound (resized planes) and the
   coefficients' bound;
6. intra: the same source, ``gop_mode="intra"``, 8 frames (one
   dispatch), default ladder: 9 launches, the tree parses, PSNR floor;
6a. library: the surface the JAX package offers beside its backend:
   ``H264Encoder(1920, 1080, device="cuda").encode`` on the first 2
   frames of the 24-frame source (CAVLC, every frame an IDR), the
   Annex-B decoded on the card by the port's decoder to the encoder's
   reconstruction bit for bit (its PSNR-Y the reported ``psnr_y``); the
   360p rung of those frames encoded with CABAC at IDR period 2 on the
   card and on the CPU: identical bytes; ``ops.ladder_resize_yuv420`` on
   the 24 frames to the default ladder (3 launches per scaled rung, none
   for the identity rung, every plane held to the plain version);
   ``parallel.single_chip_ladder`` over the default ladder, one 1-frame
   dispatch (9 launches, each rung's PSNR-Y above the floor); and the GPU
   image's warm-up step (the ``RUN python - <<'PY'`` heredoc of
   ``deploy/gpu/Dockerfile.worker-gpu``, as written, in a subprocess
   beside the phase) building the native coders and both kernels into a
   fresh build directory;
7. pipeline: the first 3 samples of the slice's 1080p rung (1 IDR + 2
   P, CABAC, deblocked, its rate control's QPs; cut from 4 for time),
   taken from its CMAF
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
   rate control, thumbnail): 12 launches (9 + 3 for the thumbnail) and
   92 of the motion search kernel (23 P frames x 4 rungs), the
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
10c-10d run under the port's lock witness (``utils/locktrace.py``:
   installed before the runtime phase builds its scheduler and
   executors, uninstalled after the daemon phase): every annotated lock
   the two phases construct is a witness that checks the ``# lock-order:``
   ranks and walks the waits-for graph while blocked; printed: the
   witnesses built, the acquisitions, the reports, the five locks with
   the most wait seconds and the five with the most hold seconds
   (``vlog_lock_wait_seconds``/``vlog_lock_hold_seconds``), and both
   phases' walls beside WITNESS_BASE_WALLS (the same phases without the
   witness); any report, or a witness that covered nothing, fails the
   run, and reports are checked again at the end (the daemon phase's
   scheduler keeps its witnesses in the later phases);
10c. runtime (the device runtime): HEVC on the 24-frame source at
   depths 1 and 2 (``VLOG_PIPELINE_DEPTH``) with the 4-rung ladder at
   constant QP in four 6-frame dispatches: byte-identical trees (the
   journal and ``outputs.json`` aside), 36 launches each, wall and
   ``stage_s`` per depth; H.264 on the resume phase's 360p rung at
   constant QP (12 frames, two dispatches) at depth 2 (the depth-1 run
   was cut for time), reaching ``max_in_flight`` 2; ``backend.pull`` armed
   once (its second hit) at depth 2: the run raises, no ``vlog-pipe*`` or
   ``vlog-decode*`` thread is left, the resumed run writes the
   uninterrupted tree; a ``MeshScheduler`` over the card with one slot:
   an HEVC ``process_video`` under a lease (given a CPU backend, it runs
   on the lease's card: 12 launches) and a ``transcribe_video`` through
   an ``AsrEngine`` given the scheduler (a tiny random-weight Whisper,
   35 s of audio) run one after the other on width-1 leases, capacity
   returns to 1, a fault at threshold 1 quarantines the card (slots 0)
   and the CUDA probe reinstates it; a 1 s ``DeviceProfiler`` session
   started on the main thread while an HEVC run on another thread waits
   at its first scaled rung's resize: the Chrome trace names the resize
   kernel (session and run taken again, up to PROFILE_TRIES, only while
   the trace lost records); ``compile_seconds()`` of the
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
   re-encode whose first attempt a 2 s timeout cancels at the first
   batch boundary (no ``vlog-pipe*`` or ``vlog-decode*`` thread left,
   the rise of ``torch.cuda.memory_allocated()`` under
   DAEMON_MEM_RISE_MAX) and whose retry's dispatch thread starts
   ``handle_command("profile")`` at its first scaled rung's resize (1 s;
   the trace names ``streaming_resize_kernel``, or lost records and
   another session at a later resize does, up to PROFILE_TRIES) and
   completes; every
   job completed at progress 100 with its spans in ``job_spans`` (the
   transcode's ``stage.*`` keys the reference's), launches per job (12,
   3, 12, and 12 + 39 for the cancelled attempt and its retry; 0 for the
   transcriptions), ``ping``, ``stats`` (the mesh snapshot) and
   ``get_metrics`` (CUDA initialized, bytes in use); each job's
   enqueue-to-complete and span seconds printed; then, where ``aiohttp``
   is installed, ``python -m vlog_tpu_torch.worker.daemon`` in a
   subprocess for one HEVC re-encode, its health routes, SIGTERM: the
   drain and exit code 0 (without ``aiohttp`` it prints that the CLI is
   tested on the CPU only);
10e. remote: the port's Worker API (``build_worker_app`` on an
   ephemeral 127.0.0.1 port over a sqlite file in the work directory)
   and ``RemoteWorker(device="cuda")`` in this process, registered
   through ``WorkerAPIClient.register``: worker 1 runs until the queue
   is empty: the pipeline phase's A/V MP4 transcoded with the defaults
   (4 rungs, 3 audio renditions; the first attempt hit by
   ``device.fault``, refunded by the server), the sprite and
   transcription jobs the server's ``complete`` enqueues after verifying
   the uploaded tree, an HEVC re-encode of the 24-frame source (the
   opt-in kind enabled); then with one rung (360p) in 6-frame
   dispatches: worker 2 preempted through ``preempt.notice`` after
   dispatch 1 of a 12-frame transcode (0 s grace: the checkpoint flush,
   a ``preempted`` failure); worker 3 resumes it from the server's
   partial tree (``resumed_segments`` > 0, the tree equal to an
   uninterrupted run's file for file), and runs a 12-frame transcode
   whose lease is swept and reclaimed after dispatch 1:
   the next progress post gets 409, the run stops at the next batch
   boundary (its last),
   no executor thread is left, the allocated bytes rise at most
   REMOTE_MEM_RISE_MAX; printed: each job's enqueue-to-ready, claim
   latencies, files and bytes uploaded, the transcode's upload overlap
   with its compute, progress posts, allocated bytes at each attempt's
   start, launches per job, the 409-to-stop seconds;
10f. serve: whether the system libpq loads (printed; the Postgres
   facade needs it); on the port's ``FakePg`` over a ``postgresql://``
   URL where it does, else on a sqlite file, the port's public app on
   loopback and ``WorkerDaemon(device="cuda")`` polling every 30 s in
   this process: one 360p transcode of the 4-frame 1080p source (one
   dispatch, 6 launches) claimed within 5 s of its enqueue (the wakeup
   bus: ``PgNotifyBus`` on Postgres), ``finalize_ready`` prewarming the
   app's delivery plane (the init and the segment); then over HTTP that
   tree and the remote phase's 1080p A/V tree (its sqlite file): every
   file of ``outputs.json`` equal to the file and its SHA-256, a
   segment's cold miss and its hit (0 DB queries, 0 disk reads),
   ``Range`` 206, ``If-None-Match`` 304, ``HEAD``, 403 on the daemon
   tree's source with downloads off, 404 on a tree that is not ready; a second plane
   filled from the disk L2 (``l2_bytes`` given to the constructor); a
   peer fill each way between two loopback origins on a ring of two;
   printed: the claim latency, the prewarm counts, miss and hit
   milliseconds per segment, the phase's wall seconds with the card's
   name and power limit;
10g. admin: the port's quick start in this process: the port's admin
   app (``build_admin_app(..., device="cuda")``, audit log on) and
   public app on loopback over one sqlite file and
   ``WorkerDaemon(device="cuda")`` on one slot, the ladder cut to 360p as
   in the serve phase; the 4-frame 1080p Y4M uploaded through the port's
   CLI (``cli.main(["upload", path, "--wait"])``, ``VLOG_ADMIN_URL`` the
   loopback admin) while an SSE client reads ``/api/events/progress``
   (at least one event of the job): ready, 6 launches, the tree
   verifies, the public app serves ``master.m3u8`` and a segment equal
   to the files, the audit log holds the upload; ``POST
   .../thumbnail/from-time`` at frame 2 on the card: exactly 3 launches,
   the grabbed planes held to the plain version, ``thumbnail.jpg`` the
   packed blocks of those planes at 1280x720; an HEVC re-encode through
   ``POST .../reencode`` (6 launches, hvc1, the tree verifies); the
   libav shim probed as ``tests/test_av1.py`` does (printed), then an
   AV1 re-encode: with the shim and an encoder it must end ready with an
   av01 tree that verifies, without it its failure row must hold
   ``Av1Unavailable``'s message; printed: the parts' seconds (upload,
   transcode, thumbnail, each re-encode) and the card's name and power
   limit;
11. asr: Whisper at whisper-small width (seeded random weights, a
   synthetic vocabulary at whisper-small's special-token ids, written as
   a checkpoint directory) on a seeded 75 s WAV of voiced-like bursts
   whose last window is silent, through
   ``transcribe_video(wav, out, model_dir=..., device="cuda")`` with the
   defaults (language detection, beam 5, the engine's 8-window
   buckets): ``captions.vtt`` parses, 3 windows, 2 live, one batch of 2
   windows in 2 rows, no resize launch, TF32 off; then on one window the
   card against the port's CPU path (mel, encoder states, teacher-forced
   logits within stated bounds; the CPU stepped along the card's greedy
   tokens: the first differing step and the largest logit gap, bounded),
   the window decoded solo and packed in an 8-window batch on the card
   (greedy and beam 5: identical tokens), int8 greedy card against CPU,
   and the times (mel, encoder, decoder step greedy and beam, the beam's
   bookkeeping, windows/s, tokens/s, audio seconds per wall second,
   launches and device-busy share of one beam step, the memory peak);
11a. grid (after asr, on its checkpoint): the (data x rung) grid
   on one card as four logical devices (``[cuda:0] * 4``; placement
   across distinct cards is not shown on a one-card machine): the
   slice's default plan on its 4-frame source under a one-slot
   ``MeshScheduler`` lease at ``VLOG_TPU_MESH=data:1,rung:4`` (one rung
   per column, 1x4): the tree byte-identical to the slice phase's, 12
   launches; ``process_video(codec="h265")`` on the 24-frame source at
   2x2 (each column's one real chain padded to the data width; the 4x1
   run was cut for time): the tree byte-identical to the hevc
   phase's, 21 launches (per column: data width x scaled rungs x 3, + 3
   for the thumbnail); the
   ASR engine on the asr phase's 2 live windows (greedy, 64 tokens, one
   batch) on a 1-wide and a 2-wide lease (a row on each device): the
   same tokens, rows a multiple of 2; ``dryrun.run(2, devices=[cuda:0] *
   2)`` (GRID_DRYRUN_WIDTH, 3 shapes; cut from 4 devices and 5 shapes
   for time; records under the work directory) and the same run on the
   CPU in a
   subprocess beside the phase: the asserts, the PSNR within 1e-5, the
   shape sweep printed (not multi-card scaling); every kernel call of
   the phase recorded by (shape, frames) and each held to the plain
   version afterwards on seeded planes with the matrices it used;
12. where one 1080p frame's device time goes, stage by stage.

Every phase from the slice on counts the HEVC motion search kernel's
launches in its runs of the main path: the counter is set to 0 just
before a run and must then read the run's plan (rungs x P steps of
each dispatch, x the data width on a grid; 0 in a phase that runs no
HEVC; the daemon's per job, as its cancelled attempt stops where its
timeout lands). The kernels line sums them by phase; the launches made
only for checks (3a, 4, the card-vs-CPU comparisons, 12) count nowhere.

Each phase prints its wall seconds. Prints a ``{"kernels": [...]}``
line, the card's name and power limit, then as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or vlog_tpu.
Whether the optional libav shim builds is printed on a line of its own;
only the admin phase's AV1 re-encode uses it (and expects
``Av1Unavailable`` where it is missing).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet peaks (non-tensor FP32; HBM3). The int32 rate:
# 132 SMs x 64 int32 lanes at the 1.98 GHz boost clock (half the FP32
# lanes, an operation a lane a clock).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS = 16.7e12

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
SLICE_FRAMES = 4        # the slice: one I+P chain cut to 4 frames (6 until
                        # the library phase was added)
INTRA_FRAMES = 8        # one intra dispatch (frame_batch 8)
MP4_FRAMES = 3          # samples of the I+P MP4 (1 IDR + 2 P: a cut chain)
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
# The HEVC motion search: the 1080p ladder's luma rungs padded to whole
# CTBs, 6 chains (a 144-frame dispatch), its plain version timed at
# ME_PLAIN_REPS (it launches ~2,000 kernels a call)
ME_SHAPES = ((1088, 1920), (736, 1280), (480, 864), (384, 640))
ME_CHAINS = 6
ME_PLAIN_REPS = 3
# The H.264 deblocking kernel: the ladder's call (the 360p rung's 6
# chains, 368x640) and the decoder's (one 1088x1920 picture), each with
# intra and with P bS; the plain wavefront (94,000-284,000 launches a
# call) timed by its call ms alone: a profile that large leaves later
# profiles of the process losing events
DB_SHAPES = ((6, 368, 640), (1, 1088, 1920))
DB_QP = 33                  # the ladder's P QP
# Frames per kernel call on the driven paths: a 24-frame chain (hevc,
# the scheduler's HEVC job, the daemon's and the remote phase's
# re-encodes; the library phase's ladder resize), an intra dispatch of 8
# frames, a 6-frame chain (resume, ts, runtime, the daemon's and the
# remote phase's 6-frame dispatches), the slice's cut 4-frame chain (the
# slice, the grid phase's 1x4 run, the serve and admin uploads), the
# MP4's cut 3-frame chain (pipeline, the daemon's and the remote phase's
# transcodes), the thumbnail's one frame (the 720p rung's shapes; the
# library phase's single_chip_ladder dispatch). The kernel phase holds the kernel to
# its plain version at each; every backend phase checks that its plan
# calls with one.
COMPARE_N = tuple(dict.fromkeys((FRAMES, SLICE_FRAMES, INTRA_FRAMES,
                                 SHORT_BATCH, MP4_FRAMES, 1)))
# Sprite tiles (the default 160x90) of the 1080p sources, at the frames
# per call of the sprite phase's two runs (a full decode chunk of 8, the
# skipping run's 2 tiles) and of the daemon's sprite job (the MP4's one
# tile at the default 10 s interval).
SPRITE_SHAPES = (((SRC_H, SRC_W), (90, 160)),
                 ((SRC_H // 2, SRC_W // 2), (45, 80)))
SPRITE_N = (8, 2, 1)
SPRITE_SKIP_INTERVAL_S = 2 / 24     # tiles at frames 0 and 2 of 3

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
    breakdown uses) and through ``prof.events()``; the two must agree.
    The flush writes are the profile's markers: a profile missing one of
    the kernels of the writes before and right after the calls has lost
    events and is taken again; a few more writes close the session, as
    a session may drop its last events (seen on the card: the last
    kernel missing from every profile of one function). A call's own
    kernel count need not be constant
    (a cuBLAS product may launch one kernel fewer in some calls): a
    count that is no whole number per call is accepted only when the
    next profile repeats it, as dropped events would not."""

    READERS_RTOL = 1e-6
    GUARD_FLUSHES = 3       # writes after the closing one, to be dropped

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile

        self._profile = lambda: profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        self.flush()
        torch.cuda.synchronize()
        # the process's first session may come back without device events
        # (the tracer starting up): it is taken again, at most twice more
        for _ in range(3):
            with self._profile() as prof:
                self.flush()
                torch.cuda.synchronize()
            self._flush = {read: {name for name, _ in read(prof)}
                           for read in (_raw_kernels, _tree_kernels)}
            # kernels per flush write: the marker count a profile must hold
            self._flush_kernels = len(_raw_kernels(prof))
            if all(self._flush.values()):
                break
            log("profile of the flush holds no device kernels; profiling "
                "again")
        else:
            fail("torch.profiler recorded no device kernels (raw, "
                 "prof.events(): "
                 f"{[len(read(prof)) for read in self._flush]})")
        self.max_reader_gap = 0.0

    def flush(self) -> None:
        self._buf.bitwise_not_()

    def ms(self, fn, reps: int) -> float:
        """Device ms per call. A profile missing a flush kernel of the
        reps + 1 writes around the calls has lost events, and one
        whose calls' kernels are no whole number per call stands only when
        the next profile holds the same number: otherwise it is taken
        again (at most four more times). ``kernels_per_call`` is the
        calls' kernels over ``reps``; a count that is no whole number is
        logged with the kernels' names."""
        from collections import Counter

        fn()
        torch.cuda.synchronize()
        want = self._flush_kernels * (reps + 1)
        most = self._flush_kernels * (reps + 1 + self.GUARD_FLUSHES)
        seen = None                     # the last complete profile's count
        for _ in range(5):
            with self._profile() as prof:
                for _ in range(reps):
                    self.flush()
                    fn()
                for _ in range(1 + self.GUARD_FLUSHES):
                    self.flush()        # the closing write, then guards
                torch.cuda.synchronize()
            events = _raw_kernels(prof)
            markers = sum(1 for name, _ in events
                          if name in self._flush[_raw_kernels])
            raw, tree = ([us for name, us in read(prof) if name not in flush]
                         for read, flush in self._flush.items())
            complete = want <= markers <= most
            if raw and complete and (len(raw) % reps == 0
                                     or len(raw) == seen):
                break
            seen = len(raw) if complete else None
            log(f"profile holds {markers} flush kernels ({want} to {most}) "
                f"and {len(raw)} kernels of {reps} calls; profiling again")
        else:
            fail("torch.profiler lost device kernels five times")
        if len(raw) % reps:
            log(f"the calls' kernels vary: {len(raw)} for {reps} calls "
                + json.dumps(Counter(name for name, _ in events
                                     if name not in self._flush[_raw_kernels])))
        self.kernels_per_call = round(len(raw) / reps, 3)
        gap = abs(sum(raw) - sum(tree)) / sum(tree) if tree else math.inf
        if len(raw) != len(tree) or gap > self.READERS_RTOL:
            fail(f"profiler readers disagree: raw {len(raw)} kernels "
                 f"{sum(raw):.3f} us, prof.events() {len(tree)} kernels "
                 f"{sum(tree):.3f} us")
        self.max_reader_gap = max(self.max_reader_gap, gap)
        return sum(raw) / reps / 1e3


# ---------------------------------------------------------------------------
def phase_analysis() -> int:
    """The port's static-analysis gate over the checkout's package; fails
    on any finding outside the port's baseline."""
    from vlog_tpu_torch.analysis import (default_baseline, load_baseline,
                                         run_passes)

    pkg = ROOT / "vlog_tpu_torch"
    t0 = time.perf_counter()
    findings = run_passes(pkg)
    known = load_baseline(default_baseline(pkg))
    fresh = [f for f in findings if f.key not in known]
    log(f"analysis: {len(findings)} finding(s) over vlog_tpu_torch/, "
        f"{len(findings) - len(fresh)} baselined, {len(fresh)} not, in "
        f"{time.perf_counter() - t0:.2f} s on Python "
        f"{sys.version.split()[0]}")
    for f in fresh:
        log("  " + f.render())
    if fresh:
        fail(f"analysis: {len(fresh)} finding(s) outside the port's "
             f"baseline")
    return len(findings)


# The runtime and daemon phases' walls without the witness: the last
# smoke run before it (NVIDIA H100 80GB HBM3, 700.00 W).
WITNESS_BASE_WALLS = {"runtime": 99.03, "daemon": 121.64}
WITNESS_TOP = 5


def _lock_seconds(family: str) -> dict[str, tuple[float, float]]:
    """lock name -> (total seconds, samples) of one witness histogram."""
    from vlog_tpu_torch.obs.metrics import runtime

    out: dict[str, list[float]] = {}
    for fam in getattr(runtime(), family).collect():
        for smp in fam.samples:
            lock = smp.labels.get("lock")
            if lock is None:
                continue
            if smp.name.endswith("_sum"):
                out.setdefault(lock, [0.0, 0.0])[0] = smp.value
            elif smp.name.endswith("_count"):
                out.setdefault(lock, [0.0, 0.0])[1] = smp.value
    return {k: (v[0], v[1]) for k, v in out.items()}


def witness_start() -> dict:
    """Install the port's lock witness; return the counters to diff."""
    from vlog_tpu_torch.utils import locktrace

    t0 = time.perf_counter()
    patched = locktrace.install()
    log(f"witness: installed over {len(patched)} modules in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"stats": locktrace.stats(),
            "wait": _lock_seconds("lock_wait_seconds"),
            "hold": _lock_seconds("lock_hold_seconds")}


def _witness_reports(before: int) -> None:
    from vlog_tpu_torch.utils import locktrace

    fresh = locktrace.reports()[before:]
    for r in fresh:
        log(r.render())
    if fresh:
        fail(f"witness: {len(fresh)} report(s): "
             + "; ".join(r.message for r in fresh))


def witness_end(base: dict, phase_s: dict) -> None:
    """Uninstall the witness, print what it saw, fail on any report."""
    from vlog_tpu_torch.utils import locktrace

    locktrace.uninstall()
    now = locktrace.stats()
    seen = {k: now[k] - base["stats"][k] for k in now}
    log("witness: " + json.dumps(seen) + " (built: witnesses constructed; "
        "acquisitions: completed acquire/release pairs)")
    for family, key in (("lock_wait_seconds", "wait"),
                        ("lock_hold_seconds", "hold")):
        cur = _lock_seconds(family)
        delta = {k: (v[0] - base[key].get(k, (0.0, 0.0))[0],
                     v[1] - base[key].get(k, (0.0, 0.0))[1])
                 for k, v in cur.items()}
        top = sorted(delta.items(), key=lambda kv: -kv[1][0])[:WITNESS_TOP]
        log(f"witness top {WITNESS_TOP} by {key} seconds: " + json.dumps(
            [{"lock": k, "seconds": round(v[0], 6), "samples": int(v[1])}
             for k, v in top]))
    walls = {name: {"wall_s": phase_s[name],
                    "without_witness_s": WITNESS_BASE_WALLS[name],
                    "ratio": round(phase_s[name] / WITNESS_BASE_WALLS[name],
                                   4)}
             for name in WITNESS_BASE_WALLS}
    log("witness walls " + json.dumps(walls))
    if seen["built"] <= 0 or seen["acquisitions"] <= 0:
        fail("witness: no lock of the runtime or daemon phase was a "
             "witness")
    _witness_reports(base["stats"]["reports"])


def phase_build():
    from vlog_tpu_torch.native import build as native_build
    from vlog_tpu_torch.ops import fused_resize, h264_deblock, motion_search

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # the three nvcc runs and g++ at once; an error in any is raised here
    with ThreadPoolExecutor(4) as pool:
        kernel = pool.submit(timed, fused_resize.load_library)
        me = pool.submit(timed, motion_search.load_library)
        db = pool.submit(timed, h264_deblock.load_library)
        native = pool.submit(timed, native_build.get_lib)
        t_kernel, t_me, t_db, t_native = (kernel.result(), me.result(),
                                          db.result(), native.result())
    for mod in (fused_resize, motion_search, h264_deblock):
        report = [ln.strip() for ln in mod.build_log.splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log(f"ptxas ({mod.__name__.rsplit('.', 1)[1]}): " + " | ".join(report))
    log(f"build: fused_resize {t_kernel:.2f}s (nvcc {fused_resize.build_seconds:.2f}s), "
        f"motion_search {t_me:.2f}s (nvcc {motion_search.build_seconds:.2f}s), "
        f"h264_deblock {t_db:.2f}s (nvcc {h264_deblock.build_seconds:.2f}s), "
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


def _me_planes(ref, cur, search: int, dev):
    """The motion search's inputs for ``cur`` against ``ref`` (uint8
    (chains, H, W) arrays): cur as int32, the edge-padded reference, its
    luma fraction planes, the pad (as the P frame pads)."""
    from vlog_tpu_torch.codecs.h264.inter import edge_pad
    from vlog_tpu_torch.codecs.hevc import core

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.int32)

    pad = search + 8
    refp = edge_pad(on_dev(ref), pad, pad, pad, pad)
    return on_dev(cur), refp, core._hfiltered_planes(refp, core._LTAPS), pad


def _me_case(h: int, w: int, chains: int, search: int, seed: int, dev):
    """:func:`_me_planes` for ``chains`` pairs of moving frames (each
    chain's frame 1 against its frame 0)."""
    ys = np.stack([_smooth_frames(2, h, w, seed + c)[0] for c in range(chains)])
    return _me_planes(ys[:, 0], ys[:, 1], search, dev)


def _me_plain(cur, refp, hplanes, search: int, pad: int, n: int = 32):
    """The plain search stages, on whatever device the tensors are."""
    from vlog_tpu_torch.codecs.hevc import core

    mv, cost = core._integer_search(cur, refp, search=search, pad=pad, n=n)
    return core._subpel_refine(cur, hplanes, mv, cost, pad=pad, n=n)


def phase_me_kernel(timer: DeviceTimer) -> dict:
    """The HEVC motion search kernel at the ladder's rung shapes: held to
    the plain stages bit for bit, timed against them and its bound."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.hevc import core

    dev = torch.device("cuda")
    search = config.MOTION_SEARCH_RADIUS
    rows = []
    for k, (h, w) in enumerate(ME_SHAPES):
        cur, refp, hplanes, pad = _me_case(h, w, ME_CHAINS, search, 20 + k, dev)

        def kern():
            return core._p_ctb_search(cur, refp, hplanes, search=search, pad=pad)

        def plain():
            return _me_plain(cur, refp, hplanes, search, pad)

        got, want = kern(), plain()
        for a, b, what in zip(got, want, ("MVs", "costs")):
            if not torch.equal(a, b):
                fail(f"motion search kernel {what} differ from the plain "
                     f"stages at {h}x{w}: {int((a != b).sum())} of {a.numel()}")
        blocks = ME_CHAINS * (h // 32) * (w // 32)
        # bytes: cur, the padded reference's search area and the four
        # fraction planes' picture area, int32, read once; the MVs and
        # costs written once. Operations: the integer SADs, four byte
        # differences a packed lane operation, and the refinement's 16
        # candidates x 8 taps a pixel.
        nbytes = (4 * ME_CHAINS * (h * w + (h + 2 * search) * (w + 2 * search)
                                   + 4 * h * w) + 12 * blocks)
        ops = blocks * 32 * 32 * ((2 * search + 1) ** 2 / 4 + 16 * 8)
        row = {"shape": [ME_CHAINS, h, w], "search": search, "blocks": blocks,
               "max_abs_mv_qpel": int(got[0].abs().max())}
        row["ms"] = timer.ms(kern, REPS)
        if timer.kernels_per_call != 1:
            fail(f"motion search: {timer.kernels_per_call} kernels a call")
        row["call_ms"] = call_ms(kern, REPS)
        row["plain_ms"] = timer.ms(plain, ME_PLAIN_REPS)
        row["plain_kernels_per_call"] = timer.kernels_per_call
        row["plain_call_ms"] = call_ms(plain, ME_PLAIN_REPS)
        row["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = ops / PEAK_INT32_OPS * 1e3
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("motion search " + json.dumps(row))
        del cur, refp, hplanes, got, want
    # one 144-frame dispatch: 23 P steps, each rung once
    tot = {key: (FRAMES - 1) * sum(r[key] for r in rows)
           for key in ("ms", "call_ms", "plain_ms", "plain_call_ms",
                       "bound_ms")}
    tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
    log("motion search per 144-frame dispatch (23 P steps x 4 rungs) "
        + json.dumps(tot))
    return tot


def _db_case(n: int, h: int, w: int, seed: int, dev):
    """A deblocking call's inputs: uint8 planes of moving content (as the
    encoder's reconstructions) and both kinds of bS, {"intra": all-intra,
    "p": ``p_bs`` of seeded coded blocks (30%) and MVs}."""
    from vlog_tpu_torch.codecs.h264.deblock import intra_bs, p_bs

    planes = tuple(torch.as_tensor(p, device=dev)
                   for p in _smooth_frames(n, h, w, seed))
    mbh, mbw = h // 16, w // 16
    rng = np.random.default_rng(seed)
    nz4 = torch.as_tensor(rng.random((n, 4 * mbh, 4 * mbw)) < 0.3,
                          dtype=torch.int32, device=dev)
    mv = torch.as_tensor(rng.integers(-9, 10, (n, mbh, mbw, 2)),
                         dtype=torch.int32, device=dev)
    return planes, {"intra": intra_bs(mbh, mbw, dev), "p": p_bs(nz4, mv)}


def phase_h264_deblock_kernel(timer: DeviceTimer) -> dict:
    """The H.264 deblocking kernel at the ladder's and the decoder's
    shapes: held to the plain wavefront on the card bit for bit, timed
    against it, against its chain bound and its bytes bound. The chain
    bound is the luma block's 8 steps a diagonal at the step latency
    that the kernel library's probe measures at the call's block size:
    a barrier and a dependent write and read of device memory, as the
    kernel's planes are there (``barrier_ms``: the same steps through
    shared memory, the floor of any design)."""
    from vlog_tpu_torch.codecs.h264 import deblock as dbk
    from vlog_tpu_torch.ops import h264_deblock

    dev = torch.device("cuda")
    rows = []
    for k, (n, h, w) in enumerate(DB_SHAPES):
        mbh, mbw = h // 16, w // 16
        planes, cases = _db_case(n, h, w, 40 + k, dev)
        qp = torch.full((n,), DB_QP, dtype=torch.int32, device=dev)
        steps = 8 * (mbh + mbw - 1)
        threads = h264_deblock.threads_per_block(mbh, mbw)
        probe_ms, barrier_ms = (timer.ms(
            lambda g=g: h264_deblock.barrier_probe(threads, steps, dev,
                                                   global_mem=g), REPS)
            for g in (True, False))
        # bytes: the uint8 planes read once, the int32 planes written once
        nbytes = (1 + 4) * n * h * w * 3 // 2
        for kind, (bsv, bsh) in cases.items():
            def kern():
                return dbk.deblock_frame(*planes, qp=qp, bs_v=bsv, bs_h=bsh)

            def plain():
                return dbk.wavefront(*planes, qp=qp, bs_v=bsv, bs_h=bsh)

            got, want = kern(), plain()
            for a, b, name in zip(got, want, "YUV"):
                if not torch.equal(a, b):
                    fail(f"h264 deblock kernel {name} differs from the plain "
                         f"wavefront at {n}x{h}x{w} ({kind}): "
                         f"{int((a != b).sum())} of {a.numel()}")
            row = {"shape": [n, h, w], "bs": kind, "threads": threads,
                   "changed_px": sum(int((a != p.to(torch.int32)).sum())
                                     for a, p in zip(want, planes))}
            # a profile may drop one of the calls' kernels (seen once in 20
            # at 1080p, repeated): every call launches one kernel (the
            # counter), so the ms per call is the mean over those recorded
            calls, before = [0], h264_deblock.launches

            def counted():
                calls[0] += 1
                return kern()

            ms = timer.ms(counted, REPS)
            if h264_deblock.launches - before != calls[0]:
                fail(f"h264 deblock: {h264_deblock.launches - before} "
                     f"launches for {calls[0]} calls")
            row["profiled_kernels_per_call"] = timer.kernels_per_call
            row["ms"] = ms / timer.kernels_per_call
            row["call_ms"] = call_ms(kern, REPS)
            row["plain_call_ms"] = call_ms(plain, 1)
            row["steps"] = steps
            row["step_us"] = probe_ms * 1e3 / steps
            row["chain_ms"] = probe_ms
            row["barrier_ms"] = barrier_ms
            row["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            row["bound_ms"] = max(row["chain_ms"], row["bytes_ms"])
            row["bound_by"] = "chain" if row["chain_ms"] >= row["bytes_ms"] else "bytes"
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            log("h264 deblock " + json.dumps(row))
    # one 144-frame ladder dispatch of the 360p rung: an I and 23 P calls
    i_row, p_row = rows[0], rows[1]
    tot = {key: i_row[key] + (FRAMES - 1) * p_row[key]
           for key in ("ms", "call_ms", "plain_call_ms", "bound_ms")}
    tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
    log("h264 deblock per 144-frame 360p dispatch (1 I + 23 P calls) "
        + json.dumps(tot))
    return tot


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
    # the HEVC motion search: the plain stages on the CPU, the kernel on
    # CUDA, at both block sizes
    from vlog_tpu_torch.codecs.hevc import core

    for n in (16, 32):
        found = []
        for dev in devices:
            cur, refp, hplanes, pad = _me_case(96, 160, 2, 8, 30, dev)
            found.append([a.cpu().numpy() for a in core._p_ctb_search(
                cur, refp, hplanes, search=8, pad=pad, n=n)])
        if not all(np.array_equal(a, b) for a, b in zip(*found)):
            fail(f"hevc motion search (n={n}) differs between "
                 f"{devices[0]} and {devices[1]}")
    log(f"hevc motion search: MVs and costs identical on {devices[0]} and "
        f"{devices[1]} at n=16 and n=32")


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


def _call_counts(plan, frames: int) -> list[int]:
    """Frames per kernel call of each dispatch of a plan over ``frames``
    source frames (the backend dispatches only the chains that hold real
    frames, a lone chain cut to its last real frame)."""
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
    return counts


def _frames_per_call(plan, phase: str, frames: int) -> list[int]:
    """:func:`_call_counts`; fails unless the kernel phase held the
    kernel at every such count."""
    counts = _call_counts(plan, frames)
    bad = sorted(set(counts) - set(COMPARE_N))
    if bad:
        fail(f"{phase}: the kernel is called with {bad} frames, counts the "
             f"kernel phase did not hold ({COMPARE_N})")
    return counts


# The HEVC motion search's launches in each phase's main-path runs. The
# counter is set to 0 just before such a run and read after it, so the
# launches made only for checks (the me_kernel and integer phases, the
# card-vs-CPU comparisons, the breakdown) count nowhere.
ME_LAUNCHES: dict[str, int] = {}


def _me_per_run(plan, frames: int) -> int:
    """The motion search launches of one run of an HEVC ``plan`` over
    ``frames`` source frames on one device: one a P step (the dispatch's
    chains batched) and rung; the ladder runs no partitions."""
    return len(plan.rungs) * sum(min(c, plan.gop_len) - 1
                                 for c in _call_counts(plan, frames))


def _me_reset() -> None:
    from vlog_tpu_torch.ops import motion_search

    motion_search.launches = 0


def _me_check(phase: str, want: int | None) -> int:
    """Fails unless the motion search launched ``want`` times since
    :func:`_me_reset` (None: the caller checks the parts); adds the count
    to ``ME_LAUNCHES[phase]``."""
    from vlog_tpu_torch.ops import motion_search

    got = motion_search.launches
    if want is not None and got != want * motion_search.LAUNCHES_PER_CALL:
        fail(f"{phase}: {got} HEVC motion search launches, expected "
             f"{want * motion_search.LAUNCHES_PER_CALL}")
    ME_LAUNCHES[phase] = ME_LAUNCHES.get(phase, 0) + got
    return got


# The H.264 deblocking kernel's launches in each phase. ``_db_install``
# wraps the two callers of the filter on the main path (the chain step's
# ``deblock_frame`` in parallel/ladder.py and the decoder's
# ``deblock_decoded``) to count their calls on a CUDA tensor; every phase
# must launch the kernel exactly once a call (no fallback), and where a
# phase's plan fixes the chain step's calls (``DB_PLAN``: an I and a P
# call a frame of each dispatch's chain, each rung) it must make those.
# The phases that call the filter only to check or time it are left out.
DB_LAUNCHES: dict[str, int] = {}
DB_CALLS = {"chain": 0, "decoder": 0}
DB_PLAN: dict[str, int] = {}
DB_CHECK_ONLY = ("h264_deblock_kernel", "integer", "breakdown")
_DB_LOCK = threading.Lock()


def _db_install() -> None:
    from vlog_tpu_torch.codecs.h264 import decoder
    from vlog_tpu_torch.parallel import ladder

    def counted(key, fn):
        def call(y, *args, **kw):
            if y.device.type == "cuda":
                with _DB_LOCK:
                    DB_CALLS[key] += 1
            return fn(y, *args, **kw)
        return call

    ladder.deblock_frame = counted("chain", ladder.deblock_frame)
    decoder.deblock_decoded = counted("decoder", decoder.deblock_decoded)


def _db_per_run(plan, frames: int) -> int:
    """The chain step's deblocking calls of one H.264 run of ``plan``
    over ``frames`` source frames: each dispatch's chains filter
    together, one call per frame of the chain, each rung; none for an
    intra plan or with deblocking off."""
    from vlog_tpu_torch import config

    if plan.gop_len < 2 or not config.H264_DEBLOCK:
        return 0
    return len(plan.rungs) * sum(min(c, plan.gop_len)
                                 for c in _call_counts(plan, frames))


def _db_reset() -> None:
    from vlog_tpu_torch.ops import h264_deblock

    with _DB_LOCK:
        h264_deblock.launches = 0
        DB_CALLS.update(chain=0, decoder=0)


def _db_check(phase: str) -> int:
    """Fails unless the phase launched the deblocking kernel once a call
    of the wrapped callers, and made ``DB_PLAN[phase]`` chain calls
    where its plan fixed them; keeps the count in ``DB_LAUNCHES``."""
    from vlog_tpu_torch.ops import h264_deblock

    got, calls = h264_deblock.launches, dict(DB_CALLS)
    if got != sum(calls.values()) * h264_deblock.LAUNCHES_PER_CALL:
        fail(f"{phase}: {got} H.264 deblocking launches for the calls "
             f"{calls} (one a call)")
    want = DB_PLAN.pop(phase, None)
    if want is not None and calls["chain"] != want:
        fail(f"{phase}: {calls['chain']} chain-step deblocking calls, "
             f"expected {want} from its plan")
    DB_LAUNCHES[phase] = got
    return got


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
    DB_PLAN["slice"] = _db_per_run(plan, SLICE_FRAMES)
    scaled = sum(1 for r in plan.rungs
                 if (r.height, r.width) != (SRC_H, SRC_W))
    thumb_launches = 3 * fused_resize.LAUNCHES_PER_CALL   # Y, U, V once
    fused_resize.launches = 0
    _me_reset()
    t0 = time.perf_counter()
    res = backend.run(plan)
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    _me_check("slice", 0)              # an H.264 run
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
    DB_PLAN["intra"] = _db_per_run(plan, INTRA_FRAMES)    # 0: intra
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


LIB_ENC_FRAMES = 2           # the standalone encoder's frames, each size
LIB_SMALL_RUNG = "360p"      # the CABAC run's rung (its frames resized here)
LIB_SMALL_IDR_PERIOD = 2
DOCKERFILE = ROOT / "deploy" / "gpu" / "Dockerfile.worker-gpu"
WARM_UP_TIMEOUT_S = 300.0


def _warm_up_step() -> str:
    """The body of the GPU image's ``RUN python - <<'PY'`` warm-up."""
    m = re.search(r"^RUN python - <<'PY'\n(.*?)^PY$",
                  DOCKERFILE.read_text(), re.S | re.M)
    if m is None:
        fail(f"library: no warm-up heredoc in {DOCKERFILE}")
    return m.group(1)


def phase_library(src: Path, work: Path) -> int:
    """The library surface the JAX package offers beside its backend, on
    the card: the standalone ``H264Encoder.encode`` (1080p CAVLC, decoded
    on the card to its own reconstruction; 360p CABAC at IDR period 2,
    the card's bytes equal to the CPU's), ``ladder_resize_yuv420`` on the
    24-frame source (3 launches per scaled rung, each plane held to the
    plain version), one ``single_chip_ladder`` dispatch of one frame, and
    the GPU image's warm-up step (deploy/gpu/Dockerfile.worker-gpu) run
    as written against a fresh build directory."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.base import plan_rung_geometry
    from vlog_tpu_torch.codecs.h264 import api as h264_api
    from vlog_tpu_torch.codecs.h264.decoder import decode_annexb
    from vlog_tpu_torch.media.y4m import Y4mReader
    from vlog_tpu_torch.ops import fused_resize, ladder_resize_yuv420
    from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix
    from vlog_tpu_torch.parallel import single_chip_ladder

    report: dict = {}
    # the warm-up step builds beside the phase, in a fresh build directory
    build = work / "deploy_build"
    warm = subprocess.Popen(
        [sys.executable, "-c", _warm_up_step()], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "VLOG_COMPILE_CACHE_DIR": str(build)})
    t_warm = time.perf_counter()

    with Y4mReader(src) as reader:
        planes = [np.stack(p) for p in zip(*reader.iter_frames())]
    frames = planes[0].shape[0]
    dev = torch.device("cuda")
    launches = 0

    # -- the resize API: every rung of the default ladder ------------------
    rungs = [plan_rung_geometry(SRC_W, SRC_H, r)
             for r in config.ladder_for_source(SRC_H)]
    hw = tuple((r.height, r.width) for r in rungs)
    y, u, v = (torch.from_numpy(p).to(dev) for p in planes)
    scaled = sum(1 for s in hw if s != (SRC_H, SRC_W))
    fused_resize.launches = 0
    t0 = time.perf_counter()
    out = ladder_resize_yuv420(y, u, v, hw)
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    launches += fused_resize.launches
    if fused_resize.launches != 3 * scaled * fused_resize.LAUNCHES_PER_CALL:
        fail(f"library: ladder_resize_yuv420 launched {fused_resize.launches}"
             f", want {3 * scaled} ({scaled} scaled rungs x 3 planes)")
    if any(a is not b for a, b in zip(out[(SRC_H, SRC_W)], (y, u, v))):
        fail("library: the identity rung did not pass its planes through")
    held = {}
    for (h, w) in hw[1:]:
        for name, got, plane, (dh, dw) in zip(
                "YUV", out[(h, w)], (y, u, v),
                ((h, w), (h // 2, w // 2), (h // 2, w // 2))):
            a_h = torch.from_numpy(resample_matrix(plane.shape[-2], dh)).to(dev)
            a_w = torch.from_numpy(resample_matrix(plane.shape[-1], dw)).to(dev)
            held[f"{h}x{w} {name}"] = list(_held_to_plain(
                got, apply_resize_matrices(plane, a_h, a_w),
                f"library: ladder_resize_yuv420 {h}x{w} {name}"))
    report["ladder_resize"] = {"frames": frames, "rungs": [list(s) for s in hw],
                               "launches": launches, "s": round(resize_s, 3),
                               "held": held}

    # -- single_chip_ladder: one 1-frame dispatch --------------------------
    spec = tuple((r.name, r.height, r.width, r.qp) for r in rungs)
    fn, mats = single_chip_ladder(spec, SRC_H, SRC_W, device="cuda")
    fused_resize.launches = 0
    t0 = time.perf_counter()
    levels = fn(y[:1], u[:1], v[:1], mats)
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    launches += fused_resize.launches
    if fused_resize.launches != 3 * scaled * fused_resize.LAUNCHES_PER_CALL:
        fail(f"library: single_chip_ladder launched {fused_resize.launches}, "
             f"want {3 * scaled}")
    psnrs = {}
    for (name, h, w, _), s in zip(spec, hw):
        rec = levels[name]["recon_y"][0, :h, :w].to(torch.float64)
        mse = float(((rec - out[s][0][0].to(torch.float64)) ** 2).mean())
        psnrs[name] = round(10 * math.log10(255 ** 2 / max(mse, 1e-12)), 3)
        if not psnrs[name] > PSNR_FLOOR_DB:
            fail(f"library: single_chip_ladder {name} PSNR-Y {psnrs[name]}")
    report["single_chip_ladder"] = {"launches": fused_resize.launches,
                                    "s": round(ladder_s, 3), "psnr_y": psnrs}

    # -- H264Encoder.encode at 1080p: decoded on the card ------------------
    recons = []
    real_gop = h264_api.encode_gop

    def recording_gop(*a, **k):
        res = real_gop(*a, **k)
        recons.append(tuple(res[f"recon_{c}"] for c in "yuv"))
        return res

    h264_api.encode_gop = recording_gop
    try:
        enc = h264_api.H264Encoder(width=SRC_W, height=SRC_H, device="cuda")
        t0 = time.perf_counter()
        coded = enc.encode(*(p[:LIB_ENC_FRAMES] for p in planes))
        enc_s = time.perf_counter() - t0
    finally:
        h264_api.encode_gop = real_gop
    t0 = time.perf_counter()
    decoded, sps = decode_annexb(b"".join(f.annexb for f in coded),
                                 device="cuda")
    dec_s = time.perf_counter() - t0
    if (sps.height, sps.width) != (SRC_H, SRC_W) \
            or len(decoded) != LIB_ENC_FRAMES or len(recons) != 1:
        fail(f"library: decoded {len(decoded)} frames at {sps.height}x"
             f"{sps.width}, {len(recons)} encode_gop calls")
    for i, (d, f) in enumerate(zip(decoded, coded)):
        for c, got, rec in zip("yuv", (d.y, d.u, d.v), recons[0]):
            want = rec[i, :got.shape[0], :got.shape[1]].cpu().numpy()
            if not np.array_equal(got, want):
                fail(f"library: decoded frame {i} {c} differs from the "
                     "encoder's reconstruction")
        mse = np.mean((d.y.astype(np.float64) - planes[0][i]) ** 2)
        psnr = 10 * np.log10(255 ** 2 / mse)
        if not f.is_idr or abs(psnr - f.psnr_y) > 1e-9:
            fail(f"library: frame {i} PSNR-Y {psnr} decoded, {f.psnr_y} "
                 f"reported, idr {f.is_idr}")
    report["encode_1080p"] = {
        "frames": LIB_ENC_FRAMES, "entropy": enc.entropy,
        "bytes": sum(len(f.avcc) for f in coded),
        "psnr_y": [round(f.psnr_y, 3) for f in coded],
        "encode_s": round(enc_s, 3), "decode_s": round(dec_s, 3)}

    # -- H264Encoder.encode at 360p, CABAC: the card's bytes == the CPU's --
    small = hw[[r.name for r in rungs].index(LIB_SMALL_RUNG)]
    sy, su, sv = (p[:LIB_ENC_FRAMES].cpu().numpy() for p in out[small])
    runs = {}
    for d in ("cuda", "cpu"):
        enc = h264_api.H264Encoder(width=small[1], height=small[0],
                                   entropy="cabac",
                                   idr_period=LIB_SMALL_IDR_PERIOD, device=d)
        t0 = time.perf_counter()
        runs[d] = (enc.encode(sy, su, sv), time.perf_counter() - t0)
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    if [(f.avcc, f.annexb, f.is_idr) for f in card] != \
            [(f.avcc, f.annexb, f.is_idr) for f in cpu] \
            or [f.is_idr for f in card] != [True, False]:
        fail("library: the 360p CABAC stream differs between the card and "
             "the CPU")
    report["encode_360p_cabac"] = {
        "frames": LIB_ENC_FRAMES, "idr_period": LIB_SMALL_IDR_PERIOD,
        "bytes": sum(len(f.avcc) for f in card), "equal_to_cpu": True,
        "card_s": round(runs["cuda"][1], 3), "cpu_s": round(runs["cpu"][1], 3)}

    # -- the deploy image's warm-up step -----------------------------------
    try:
        w_out, w_err = warm.communicate(timeout=WARM_UP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        warm.kill()
        warm.communicate()
        fail("library: the image's warm-up step did not finish")
    built = sorted(p.name for p in build.glob("*.so"))
    if warm.returncode != 0 or not {"libvt_native.so",
                                    "libvt_fused_resize.so",
                                    "libvt_hevc_motion_search.so",
                                    "libvt_h264_deblock.so"} <= set(built):
        fail(f"library: the warm-up step exited {warm.returncode}, built "
             f"{built}: {w_err[-2000:]}")
    report["deploy_warm_up"] = {"s": round(time.perf_counter() - t_warm, 3),
                                "built": built,
                                "stdout": w_out.strip().splitlines()[-1:]}
    log("library: " + json.dumps(report))
    log(f"library: kernel launches {launches}")
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
    DB_PLAN["ts"] = _db_per_run(plan, TS_FRAMES)
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
    _me_reset()
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
        # the card's run searches on the card, the CPU's in plain PyTorch
        _me_check("hevc", _me_per_run(plan, HEVC_TREE_FRAMES)
                  if dev == "cuda" else 0)
        _me_reset()
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
    mv, _ = core._p_ctb_search(cur, refp, hplanes, search=search, pad=pad)
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
        "p_motion_search": lambda: core._p_ctb_search(cur, refp, hplanes,
                                                      search=search, pad=pad),
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
    counts = _frames_per_call(plan, "hevc", FRAMES)
    dispatches = len(counts)
    scaled = sum(1 for r in plan.rungs if (r.height, r.width) != (SRC_H, SRC_W))
    log("hevc plan: " + ", ".join(f"{r.name} {r.width}x{r.height} qp{r.qp} "
                                  f"{r.codec}" for r in plan.rungs)
        + f"; gop {plan.gop_len}, frame_batch {plan.frame_batch}")
    fused_resize.launches = 0
    _me_reset()
    t0 = time.perf_counter()
    res = process_video(src, out, backend=backend, codec="h265")
    wall = time.perf_counter() - t0
    launches = fused_resize.launches
    expected = (scaled * 3 * dispatches + 3) * fused_resize.LAUNCHES_PER_CALL
    if launches != expected:
        fail(f"hevc: kernel launches {launches}, expected {expected}")
    me_launches = _me_check("hevc", _me_per_run(plan, FRAMES))
    log(f"hevc: {res.run.frames_processed} frames in {wall:.2f}s wall; stage_s "
        + json.dumps(res.run.stage_s) + f"; kernel launches {launches}; "
        f"motion search launches {me_launches}")
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
ASR_AUDIO_S = 75.0       # windows at 0, 25, 50 s; the last all silent
ASR_SPEECH_END_S = 49.0
ASR_WINDOWS, ASR_LIVE = 3, 2
ASR_LIVE_ROWS = 2        # the power-of-two bucket of ASR_LIVE windows
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
            or [(b["n"], b["rows"]) for b in log_] != [(ASR_LIVE,
                                                        ASR_LIVE_ROWS)]:
        fail(f"asr: windows {stats}, batches {log_}; want {want} and one "
             f"batch of {ASR_LIVE} windows in {ASR_LIVE_ROWS} rows")
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
RUNTIME_HEVC_DEPTHS = (1, 2)
RUNTIME_H264_DEPTHS = (2,)   # depth 1 cut for time; depth 2 keeps the tree
RUNTIME_TREE_SKIP = ("rc_journal.jsonl", "outputs.json")   # run state
PROFILE_SESSION_S = 1.0
# A profile session starts at a run's first scaled rung's resize, so its
# kernels run inside the window (the identity rung's call launches none,
# and its encode can outlast the window under tracing). torch.profiler on
# the card's machine can lose kernel records in bulk under load, their
# cudaLaunchKernel records kept: a trace that names no resize kernel and
# holds launch records without their kernels is taken again, up to
# PROFILE_TRIES sessions; one that lost nothing fails the check.
PROFILE_TRIES = 3
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


def _trace_summary(trace: Path) -> dict:
    """A Chrome trace's device kernels: distinct names, kernel events,
    launch records (``cudaLaunch*`` runtime events), the launch records
    whose kernel is missing (``lost``) and the resize kernel's names;
    ``{"missing": True}`` when no trace was written."""
    if not trace.exists():
        return {"missing": True, "resize": [], "lost": 0}
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaLaunch")]
    ran = {e.get("args", {}).get("correlation") for e in kernels}
    names = [e.get("name", "") for e in kernels]
    return {"trace_mb": round(trace.stat().st_size / 2 ** 20, 2),
            "kernel_names": len(set(names)), "kernel_events": len(kernels),
            "launch_records": len(launches),
            "lost": sum(1 for e in launches
                        if e.get("args", {}).get("correlation") not in ran),
            "cpu_op_threads": len({e.get("tid") for e in events
                                   if e.get("cat") == "cpu_op"}),
            "resize": sorted({k for k in names if "_resize_kernel" in k})}


def _runtime_profiler(backend, plan, work: Path) -> list[dict]:
    """A session started from the main thread while an HEVC run on
    another thread waits at its first scaled rung's resize, taken again
    (a new run) while its trace names no resize kernel and lost records
    (PROFILE_TRIES); returns each session's summary."""
    import threading

    from vlog_tpu_torch import config
    from vlog_tpu_torch.obs.profiler import DeviceProfiler
    from vlog_tpu_torch.parallel import hevc_ladder

    saved, real = config.PROFILE_DIR, hevc_ladder.resize_yuv420
    config.PROFILE_DIR = str(work / "profiles")
    sessions: list[dict] = []
    try:
        while not sessions or (not sessions[-1]["resize"]
                               and sessions[-1]["lost"]
                               and len(sessions) < PROFILE_TRIES):
            at_resize, started = threading.Event(), threading.Event()

            def hooked(*args):
                if args[3] is not None and not at_resize.is_set():
                    at_resize.set()
                    started.wait(30)
                return real(*args)

            hevc_ladder.resize_yuv420 = hooked
            job = threading.Thread(target=backend.run, args=(plan,),
                                   kwargs={"resume": False},
                                   name="vlog-job-hevc")
            job.start()
            try:
                if not at_resize.wait(120):
                    fail("runtime profiler: the run reached no scaled "
                         "rung's resize")
                prof = DeviceProfiler()
                info = prof.start(duration_s=PROFILE_SESSION_S,
                                  label=f"chip smoke {len(sessions)}")
            finally:
                started.set()
            if not info.get("profiling"):
                fail(f"runtime profiler: start failed {info}")
            deadline = time.monotonic() + PROFILE_SESSION_S + 60
            while prof.status()["profiling"] and time.monotonic() < deadline:
                time.sleep(0.1)
            job.join(timeout=120)
            if prof.status()["profiling"] or job.is_alive():
                fail("runtime profiler: the session or the job did not end")
            sessions.append(_trace_summary(Path(info["dir"]) / "trace.json"))
    finally:
        config.PROFILE_DIR, hevc_ladder.resize_yuv420 = saved, real
    if not sessions[-1]["resize"]:
        fail(f"runtime profiler: no resize kernel in {len(sessions)} "
             f"sessions' traces: {sessions}")
    return sessions


def _compile_warm() -> float:
    """compile_seconds() of a fresh process that loads the native and
    the three kernel libraries from the warm build directory."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from vlog_tpu_torch.native import build\n"
            "from vlog_tpu_torch.ops import fused_resize, h264_deblock, "
            "motion_search\n"
            "from vlog_tpu_torch.parallel.compile_cache import compile_seconds\n"
            "fused_resize.load_library(); motion_search.load_library()\n"
            "h264_deblock.load_library()\n"
            "build.get_lib()\n"
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
    _me_reset()
    _, hevc_rows = _runtime_depths(backend, hevc_plan, RUNTIME_HEVC_DEPTHS,
                                   "hevc", scaled * 3 * len(per_call), work)
    launches += scaled * 3 * len(per_call) * len(RUNTIME_HEVC_DEPTHS)
    _me_check("runtime", len(RUNTIME_HEVC_DEPTHS)
              * _me_per_run(hevc_plan(work / "rt_probe"), FRAMES))
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
    _me_reset()
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
    _me_check("runtime", 0)            # parts 2 and 3 run H.264
    log("runtime failpoint: " + json.dumps(fp))
    part_s["failpoint"] = clock() - t0
    # 4. the scheduler on the card (an HEVC job and a transcription)
    t0 = clock()
    fused_resize.launches = 0
    _me_reset()
    sched = _runtime_scheduler(sources[FRAMES], work)
    if fused_resize.launches != 12 * fused_resize.LAUNCHES_PER_CALL:
        fail(f"runtime scheduler: {fused_resize.launches} launches, want 12")
    # the HEVC job runs on the lease's device, the card
    _me_check("runtime", _me_per_run(backend.plan(
        info, out_dir=work / "rt_probe", codec="h265"), FRAMES))
    launches += fused_resize.launches
    log("runtime scheduler: " + json.dumps(sched))
    part_s["scheduler"] = clock() - t0
    # 5. the profiler around an HEVC run on another thread
    t0 = clock()
    fused_resize.launches = 0
    plan6 = backend.plan(get_video_info(sources[TS_FRAMES]), ladder,
                         work / "rt_profiled", codec="h265", thumbnail=False)
    _me_reset()
    prof = _runtime_profiler(backend, plan6, work)
    _me_check("runtime", len(prof) * _me_per_run(plan6, TS_FRAMES))
    if fused_resize.launches != len(prof) * scaled * 3 \
            * fused_resize.LAUNCHES_PER_CALL:
        fail(f"runtime profiler: {fused_resize.launches} launches in "
             f"{len(prof)} runs")
    launches += fused_resize.launches
    log("runtime profiler: " + json.dumps({"sessions": prof}))
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
    24-frame source; then with 6-frame dispatches an HEVC re-encode whose
    first attempt a timeout cancels between dispatches (no executor
    thread left, the allocated bytes held to a bound) and whose retry
    completes under a 1 s profile session started at its first resize;
    the command verbs; the CLI."""
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
    from vlog_tpu_torch.obs.profiler import profiler
    from vlog_tpu_torch.obs.trace import STAGE_KEYS
    from vlog_tpu_torch.ops import fused_resize, motion_search
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
    hevc_plans = (backend.plan(b_info, out_dir=d / "p", codec="h265"),
                  backend.plan(b_info, out_dir=d / "p", codec="h265",
                               segment_duration_s=SHORT_SEG_S,
                               frame_batch=SHORT_BATCH))
    _frames_per_call(hevc_plans[0], "daemon re-encode", FRAMES)
    _frames_per_call(hevc_plans[1], "daemon 6-frame re-encode", FRAMES)
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
            "me_launches": motion_search.launches,
            "allocated": torch.cuda.memory_allocated(),
            "executor_threads": [t.name for t in threading.enumerate()
                                 if t.name.startswith(("vlog-pipe",
                                                       "vlog-decode"))]})

    hooks: dict = {}               # video id -> fn(done, supervisor)
    job_video: dict = {}
    # video id -> allocated bytes when each attempt's handler started
    allocated_at_start: dict = {}
    notes: dict = {"hook_errors": [], "profiles": []}

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
            # the cancelled job's retry (its second run) is profiled
            if Path(out_dir).name == "cancelled":
                notes["cancelled_runs"] = notes.get("cancelled_runs", 0) + 1
                notes["profile_armed"] = notes["cancelled_runs"] == 2
            try:
                return process_video(source, out_dir, **kw)
            finally:
                notes["profile_armed"] = False

        def want_session() -> bool:
            # a session at the retry's first scaled resize; another at a
            # later one once the last has ended with no resize kernel in
            # its trace and lost records (see PROFILE_TRIES)
            sessions = notes["profiles"]
            if not sessions:
                return True
            if len(sessions) >= PROFILE_TRIES \
                    or profiler().status()["profiling"]:
                return False
            last = sessions[-1]
            if "trace" not in last:
                last["trace"] = _trace_summary(Path(last["info"].get(
                    "dir", d / "none")) / "trace.json")
            return not last["trace"]["resize"] and bool(last["trace"]["lost"])

        def profiled_resize(*args):
            # on the retry's dispatch thread, at a scaled rung (the
            # identity rung launches nothing): the 1 s session is
            # running when these kernels run
            if notes.get("profile_armed") and args[3] is not None \
                    and want_session():
                fut = asyncio.run_coroutine_threadsafe(daemon.handle_command(
                    "profile", {"duration_s": 1, "label": "daemon"}), loop)
                notes["profiles"].append({"info": fut.result(30)})
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
    _me_reset()
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
    me_launches = _me_check("daemon", None)    # checked per job below
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
    prev, me_per_job = 0, []
    for e in events:
        me_per_job.append((e["event"], e["video_id"], e["me_launches"] - prev))
        prev = e["me_launches"]
    log("daemon motion search launches per job outcome: "
        + json.dumps(me_per_job))
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
    if bad or len(rows["jobs"]) != 6:
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
    for key in ("hevc", "cancelled"):
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
    # the profile sessions: a trace names the resize kernel
    deadline = time.monotonic() + 30
    while profiler().status()["profiling"] and time.monotonic() < deadline:
        time.sleep(0.2)
    for s in notes["profiles"]:
        if not s["info"].get("profiling"):
            fail(f"daemon: profile session {s['info']} did not start")
        if "trace" not in s:
            s["trace"] = _trace_summary(
                Path(s["info"]["dir"]) / "trace.json")
        if s["trace"].get("missing"):
            fail(f"daemon: profile session {s['info']} wrote no trace")
    profiles = [s["trace"] for s in notes["profiles"]]
    if not profiles or not any(
            "streaming_resize_kernel" in " ".join(t["resize"])
            for t in profiles) or any(
            not t["resize"] and not t["lost"] for t in profiles):
        fail(f"daemon: the profile traces do not name "
             f"streaming_resize_kernel: {profiles}")
    # the verbs
    metrics = verbs["get_metrics"]["device"]
    if not verbs["ping"].get("pong") \
            or (verbs["stats"]["mesh"] or {}).get("slots") != 1 \
            or verbs["stats"]["completed"] != 6 \
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
            ("video.reencoded", ids["cancelled"]): 4 * scaled + thumb,
            ("job.failed", ids["upload"]): 0}
    got = {(e, v): n for e, v, n in per_job if (e, v) in want}
    if got != want or any(n for e, v, n in per_job
                          if e == "video.transcribed"):
        fail(f"daemon: launches per job {per_job}, want {want}")
    # the HEVC searches: each re-encode's whole run (the cancelled job's
    # retry runs all four of its dispatches), nothing in the others
    lpc = motion_search.LAUNCHES_PER_CALL
    me_want = dict.fromkeys(want, 0)
    me_want[("video.reencoded", ids["hevc"])] = \
        _me_per_run(hevc_plans[0], FRAMES) * lpc
    me_want[("video.reencoded", ids["cancelled"])] = \
        _me_per_run(hevc_plans[1], FRAMES) * lpc
    me_got = {(e, v): n for e, v, n in me_per_job if (e, v) in me_want}
    if me_got != me_want or any(n for e, v, n in me_per_job
                                if e == "video.transcribed"):
        fail(f"daemon: motion search launches per job {me_per_job}, want "
             f"{me_want}")
    cli = _daemon_cli(d, sources[TS_FRAMES])
    log("daemon: " + json.dumps({
        "wall_s": round(wall, 2), "queue_s": round(t_queue, 2),
        "launches": launches, "launches_per_job": per_job,
        "me_launches": me_launches, "me_launches_per_job": me_per_job,
        "quarantine": quarantine, "probes": probes,
        "allocated_at_attempt_start": {
            str(k): v for k, v in allocated_at_start.items()},
        "cancel": {"at_frames": notes["cancel_done"],
                   "reason": notes["cancel_reason"],
                   "allocated_at_attempt_start": at_start,
                   "allocated_at_failure_event": cancel_ev["allocated"],
                   "rise": rise, "bound": DAEMON_MEM_RISE_MAX},
        "profile": profiles,
        "asr_windows": asr_attrs.get("asr.windows_total"),
        "verbs": {"stats_mesh": verbs["stats"]["mesh"],
                  "device": metrics}, **cli}))
    return launches


# The remote phase: the port's Worker API on an ephemeral port over a
# sqlite file in the work dir, and RemoteWorker(device="cuda") over HTTP.
# The preempted, resumed, uninterrupted and claim-lost jobs run on the
# 1080p sources with one rung (360p: 3 launches a dispatch, as the
# resume phase) in 6-frame dispatches; the main path runs the defaults.
REMOTE_QUEUE_TIMEOUT_S = 600.0
REMOTE_MEM_RISE_MAX = DAEMON_MEM_RISE_MAX     # PR 9's bound, 64 MiB


def _executor_threads() -> list[str]:
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith(("vlog-pipe", "vlog-decode"))]


def phase_remote(work: Path, ip_path: Path, sources: dict) -> int:
    """The port's Worker API (``build_worker_app`` on ``aiohttp.web``,
    127.0.0.1, an ephemeral port, a sqlite file) and ``RemoteWorker
    (device="cuda")`` over HTTP in this process, registered through
    ``WorkerAPIClient.register``. Worker 1 runs until the queue is
    empty: the pipeline phase's A/V MP4 transcoded with the defaults
    (4 rungs, 3 audio renditions; its first attempt hit by
    ``device.fault`` and refunded by the server), the sprite and
    transcription jobs the server's ``complete`` enqueues, an HEVC
    re-encode (an opt-in kind) of the 24-frame source. Then with one
    360p rung in 6-frame dispatches: worker 2 is preempted through
    ``preempt.notice`` after its first dispatch of a 12-frame transcode
    (0 s drain grace: the flush, a ``preempted`` failure); worker 3
    resumes it from the server's partial tree (``resumed_segments`` >
    0; the tree equals an uninterrupted run's, file for file), runs the
    uninterrupted one, and a 12-frame transcode whose lease is swept and
    reclaimed after dispatch 1: the next progress post gets 409 and the
    run stops at the next batch boundary, its last (no executor thread
    left, the allocated bytes held to REMOTE_MEM_RISE_MAX)."""
    import asyncio

    from aiohttp import web

    from vlog_tpu_torch import config
    from vlog_tpu_torch.api.worker_api import build_worker_app
    from vlog_tpu_torch.asr.engine import reset_engine
    from vlog_tpu_torch.asr.model import WhisperConfig
    from vlog_tpu_torch.asr.synthetic import write_checkpoint
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.utils import failpoints
    from vlog_tpu_torch.worker.remote import (ClaimLost, RemoteWorker,
                                              WorkerAPIClient)
    from vlog_tpu_torch.worker.watchdog import JobCancelled

    d = work / "remote"
    d.mkdir()
    ckpt = work / "whisper-tiny"
    if not ckpt.exists():
        write_checkpoint(ckpt, WhisperConfig(**TINY_WHISPER), seed=ASR_SEED)
    backend = get_backend("torch")
    if backend.device.type != "cuda":
        fail(f"remote: backend on {backend.device}")
    one_rung = (config.LADDER_BY_NAME["360p"],)
    a_info = get_video_info(ip_path)
    _frames_per_call(backend.plan(a_info, out_dir=d / "p"),
                     "remote transcode", MP4_FRAMES)
    b_info = get_video_info(sources[FRAMES])
    hevc_plan = backend.plan(b_info, out_dir=d / "p", codec="h265")
    _frames_per_call(hevc_plan, "remote re-encode", FRAMES)
    for n in (RESUME_FRAMES, FRAMES):
        _frames_per_call(backend.plan(get_video_info(sources[n]), one_rung,
                                      out_dir=d / "p",
                                      segment_duration_s=SHORT_SEG_S,
                                      frame_batch=SHORT_BATCH),
                         "remote 360p transcodes", n)
    saved = {k: getattr(config, k) for k in (
        "RETRY_BACKOFF_BASE_S", "PREEMPTION_POLL_S", "SEGMENT_DURATION_S",
        "TPU_FRAME_BATCH", "ladder_for_source")}
    config.RETRY_BACKOFF_BASE_S = 0.0
    config.PREEMPTION_POLL_S = 0.05

    stats: dict = {"claims": [], "uploads": [], "progress_posts": 0,
                   "compute_end": {}, "allocated_at_start": {},
                   "launches": {}, "stops": {}, "hook_errors": []}
    hooks: dict = {}               # video id -> fn(call index, worker)

    def instrument(worker: RemoteWorker) -> RemoteWorker:
        """Count what crosses the wire and when the compute ends; hook
        the progress callback of the videos in ``hooks``."""
        client = worker.client
        claim, upload, progress = (client.claim, client.upload_file,
                                   client.progress)
        run_with_timeout, dispatch = (worker._run_with_timeout,
                                      worker._dispatch)
        make_cb = worker._make_progress_cb
        current: dict = {}

        async def spy_claim(*a, **kw):
            t0 = time.perf_counter()
            got = await claim(*a, **kw)
            if got is not None:
                stats["claims"].append(round(time.perf_counter() - t0, 4))
            return got

        async def spy_upload(video_id, rel, path):
            t0 = time.perf_counter()
            digest = await upload(video_id, rel, path)
            stats["uploads"].append((current.get("job"), rel,
                                     Path(path).stat().st_size, t0,
                                     time.perf_counter()))
            return digest

        async def spy_progress(job_id, **kw):
            stats["progress_posts"] += 1
            try:
                return await progress(job_id, **kw)
            except ClaimLost:
                stats.setdefault("t_409", time.perf_counter())
                raise

        async def spy_run_with_timeout(fn, timeout, what):
            try:
                return await run_with_timeout(fn, timeout, what)
            finally:
                stats["compute_end"][current.get("job")] = \
                    time.perf_counter()

        async def spy_dispatch(job, video):
            current["job"], current["video"] = job["id"], video["id"]
            before = fused_resize.launches
            try:
                return await dispatch(job, video)
            finally:
                stats["launches"].setdefault(job["id"], []).append(
                    fused_resize.launches - before)

        def hooked_cb(job_id, rung_names):
            cb = make_cb(job_id, rung_names)
            stats["allocated_at_start"].setdefault(job_id, []).append(
                torch.cuda.memory_allocated())
            video_id = current.get("video")
            hook = hooks.pop(video_id, None)
            if hook is None:
                return cb
            calls = [0]

            def wrapped(done, total, msg):
                calls[0] += 1
                try:
                    hook(calls[0], done)
                except Exception as exc:  # noqa: BLE001 — checked below
                    stats["hook_errors"].append(repr(exc))
                try:
                    return cb(done, total, msg)
                except JobCancelled:
                    stats["stops"][video_id] = (time.perf_counter(), done)
                    raise
            return wrapped

        client.claim, client.upload_file, client.progress = (
            spy_claim, spy_upload, spy_progress)
        worker._run_with_timeout = spy_run_with_timeout
        worker._dispatch = spy_dispatch
        worker._make_progress_cb = hooked_cb
        return worker

    async def drive():
        db = Database(f"sqlite:///{d / 'vlog.db'}")
        await db.connect()
        await create_all(db)
        runner = web.AppRunner(build_worker_app(db, video_dir=d / "videos"))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        base = "http://127.0.0.1:%d" % runner.addresses[0][1]
        loop = asyncio.get_running_loop()
        workers: list[RemoteWorker] = []

        def make_worker(n: int, **kw) -> RemoteWorker:
            w = RemoteWorker(WorkerAPIClient(base, key), name="smoke-rw",
                             work_dir=d / f"work{n}", device="cuda",
                             backend=backend, poll_interval_s=0.1,
                             heartbeat_interval_s=5.0,
                             progress_min_interval_s=0.0,
                             transcription_model_dir=str(ckpt), **kw)
            workers.append(w)
            return instrument(w)

        async def enqueue(title, src, kind=JobKind.TRANSCODE, payload=None):
            video = await vids.create_video(db, title, source_path=str(src))
            job = await claims.enqueue_job(db, video["id"], kind,
                                           payload=payload)
            return video, job

        async def run_until(worker, done):
            task = asyncio.create_task(worker.run())
            deadline = time.monotonic() + REMOTE_QUEUE_TIMEOUT_S
            try:
                while not await done():
                    if task.done():
                        task.result()
                        fail("remote: a worker's run() ended early")
                    if time.monotonic() > deadline:
                        fail("remote: the queue did not drain in time")
                    await asyncio.sleep(0.1)
            finally:
                worker.request_stop()
                await asyncio.wait_for(task, 120)
                await worker.client.aclose()

        def completed(n: int):
            """Every job terminal (or the thief's), ``n`` of them
            completed: a transcode's follow-on jobs are enqueued just
            after its completion commits, so the count closes that
            window."""
            async def done():
                rows = await db.fetch_all("SELECT * FROM jobs")
                return sum(1 for r in rows if r["completed_at"]) == n \
                    and all(r["completed_at"] or r["failed_at"]
                            or r["claimed_by"] == "smoke-thief"
                            for r in rows)
            return done

        try:
            t_key = time.perf_counter()
            key = await WorkerAPIClient.register(base, "smoke-rw")
            stats["register_s"] = round(time.perf_counter() - t_key, 3)
            # 1. the main path, with the device fault on its first attempt
            vid = {}
            vid["upload"], _ = await enqueue("Upload", ip_path)
            vid["hevc"], _ = await enqueue("HEVC", sources[FRAMES],
                                           JobKind.REENCODE, HEVC_PAYLOAD)
            failpoints.arm("device.fault", count=1)
            w1 = make_worker(1, kinds=tuple(JobKind))
            t0 = time.perf_counter()
            # the transcode, its sprite and transcription jobs, the HEVC
            await run_until(w1, completed(4))
            stats["main_s"] = round(time.perf_counter() - t0, 2)
            failpoints.reset()
            # 2. preempted after dispatch 1 (one rung, 6-frame dispatches)
            config.SEGMENT_DURATION_S = SHORT_SEG_S
            config.TPU_FRAME_BATCH = SHORT_BATCH
            config.ladder_for_source = lambda height: one_rung
            vid["cut"], cut_job = await enqueue("Cut",
                                                sources[RESUME_FRAMES])
            w2 = make_worker(2, kinds=(JobKind.TRANSCODE,),
                             drain_grace_s=0.0)

            def preempt_hook(call, done):
                if call == 1:
                    stats["preempted_at"] = done
                    failpoints.arm("preempt.notice", count=1)
                    deadline = time.monotonic() + 60
                    while not w2._cancel.is_set() \
                            and time.monotonic() < deadline:
                        time.sleep(0.01)
            hooks[vid["cut"]["id"]] = preempt_hook
            failpoints.arm("preempt.notice", count=0)  # watcher on, quiet
            t0 = time.perf_counter()
            w2_task = asyncio.create_task(w2.run())
            await asyncio.wait_for(w2_task, REMOTE_QUEUE_TIMEOUT_S)
            await w2.client.aclose()
            stats["preempted_s"] = round(time.perf_counter() - t0, 2)
            failpoints.reset()
            partial = sorted(str(p.relative_to(d / "videos"))
                             for p in (d / "videos").rglob("*")
                             if p.is_file())
            # 3. the resume, the uninterrupted run, the claim lost
            vid["whole"], _ = await enqueue("Whole", sources[RESUME_FRAMES])
            vid["lost"], lost_job = await enqueue("Lost",
                                                  sources[RESUME_FRAMES])
            w3 = make_worker(3, kinds=(JobKind.TRANSCODE, JobKind.SPRITE))

            async def steal(job_id):
                await db.execute(
                    "UPDATE jobs SET claim_expires_at=1 WHERE id=:i",
                    {"i": job_id})
                await claims.sweep_expired_claims(db)
                got = await claims.claim_job(db, "smoke-thief")
                if got is None or got["id"] != job_id:
                    fail(f"remote: the thief claimed {got and got['id']}")

            def lost_hook(call, done):
                if call == 1:
                    asyncio.run_coroutine_threadsafe(
                        steal(lost_job), loop).result(60)
                    stats["lost_started"] = torch.cuda.memory_allocated()
                elif call == 2:
                    deadline = time.monotonic() + 60
                    while "t_409" not in stats \
                            and time.monotonic() < deadline:
                        time.sleep(0.01)
            hooks[vid["lost"]["id"]] = lost_hook
            poll_once = w3.poll_once

            async def spy_poll_once():
                worked = await poll_once()
                if vid["lost"]["id"] in stats["stops"] \
                        and "lost_end" not in stats:
                    stats["lost_end"] = {
                        "t": time.perf_counter(),
                        "threads": _executor_threads(),
                        "allocated": torch.cuda.memory_allocated()}
                return worked
            w3.poll_once = spy_poll_once
            t0 = time.perf_counter()
            # + the resumed and the uninterrupted transcodes and their
            # sprite jobs; the claim-lost job stays with the thief
            await run_until(w3, completed(8))
            stats["resume_s"] = round(time.perf_counter() - t0, 2)
            rows = {t: await db.fetch_all(f"SELECT * FROM {t} ORDER BY id")
                    for t in ("jobs", "videos", "video_qualities",
                              "job_failures", "job_spans", "workers")}
            return vid, rows, partial, cut_job, lost_job
        finally:
            failpoints.reset()
            for w in workers:
                await w.client.aclose()
            await runner.cleanup()
            await db.disconnect()

    t0 = time.perf_counter()
    launches0 = fused_resize.launches
    _me_reset()
    try:
        vid, rows, partial, cut_job, lost_job = asyncio.run(drive())
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
        reset_engine()
    wall = time.perf_counter() - t0
    launches = fused_resize.launches - launches0
    # the HEVC re-encode's searches; the other jobs run H.264
    me_launches = _me_check("remote", _me_per_run(hevc_plan, FRAMES))
    if stats["hook_errors"]:
        fail(f"remote: hooks failed {stats['hook_errors']}")
    ids = {k: v["id"] for k, v in vid.items()}
    by_video: dict = {}
    for j in rows["jobs"]:
        by_video.setdefault(j["video_id"], {})[j["kind"]] = j
    for j in rows["jobs"]:
        done_s = (round(j["completed_at"] - j["created_at"], 3)
                  if j["completed_at"] else None)
        log(f"remote job {j['id']} {j['kind']} (video {j['video_id']}): "
            f"enqueue to ready {done_s}s, attempts {j['attempt']}, "
            f"claimed by {j['claimed_by']}, launches "
            f"{stats['launches'].get(j['id'])}")
    # 1. the main path over HTTP: ready, verified, follow-on jobs done
    up = by_video[ids["upload"]]
    video = next(v for v in rows["videos"] if v["id"] == ids["upload"])
    quals = [q for q in rows["video_qualities"] if q["video_id"] == video["id"]]
    out = d / "videos" / video["slug"]
    files = integrity.load_manifest(out)
    if set(up) != {"transcode", "sprite", "transcription"} \
            or any(j["completed_at"] is None for j in up.values()) \
            or video["status"] != "ready" or len(quals) != 4 or not files \
            or integrity.verify_tree(out, files) \
            or "captions.vtt" not in files \
            or len(list(out.glob("audio_*k"))) != 3 \
            or not (out / "sprites" / "sprite_01.jpg").exists():
        fail(f"remote: upload jobs {sorted(up)}, status {video['status']}, "
             f"{len(quals)} qualities, outputs.json {sorted(files or {})}")
    # 5. the device fault: refunded, retried to completion
    fails = sorted((f["job_id"], f["failure_class"])
                   for f in rows["job_failures"])
    # (the sweep that hands the claim-lost job to the thief records the
    # lapsed lease as worker_crash, as the reference's sweep does)
    if fails != sorted([(up["transcode"]["id"], "device_fault"),
                        (cut_job, "preempted"),
                        (lost_job, "worker_crash")]) \
            or up["transcode"]["attempt"] != 1:
        fail(f"remote: job_failures {fails}, transcode attempts "
             f"{up['transcode']['attempt']}")
    # 2. the HEVC re-encode
    hv = next(v for v in rows["videos"] if v["id"] == ids["hevc"])
    inits = sorted((d / "videos" / hv["slug"]).glob("*p/init.mp4"))
    if hv["codec"] != "h265" or len(inits) != 4 \
            or not all(b"hvcC" in p.read_bytes() for p in inits):
        fail(f"remote: re-encode codec {hv['codec']}, {len(inits)} rungs")
    # 3. the preempted job: resumed from the server's partial tree into
    # the uninterrupted tree
    cut_row = by_video[ids["cut"]]["transcode"]
    resumed = [json.loads(s["attributes"]).get("resumed_segments")
               for s in rows["job_spans"]
               if s["job_id"] == cut_job and s["name"] == "worker.transcode"]
    trees = {k: _tree_files(d / "videos" / next(
        v["slug"] for v in rows["videos"] if v["id"] == ids[k]))
        for k in ("cut", "whole")}
    differ = _tree_diff(trees["cut"], trees["whole"])
    if cut_row["completed_at"] is None or cut_row["attempt"] != 1 \
            or not any(n and n > 0 for n in resumed) or differ \
            or not trees["cut"]:
        fail(f"remote: preempted job: attempt {cut_row['attempt']}, "
             f"resumed_segments {resumed}, files differing {differ}")
    # 4. the claim lost: stopped at a batch boundary, nothing left behind
    lost_row = by_video[ids["lost"]]["transcode"]
    end = stats.get("lost_end") or {}
    t_stop, stop_done = stats["stops"].get(ids["lost"], (None, None))
    rise = end.get("allocated", 0) - stats.get("lost_started", 0)
    if "t_409" not in stats or t_stop is None \
            or lost_row["claimed_by"] != "smoke-thief" \
            or stop_done != 2 * SHORT_BATCH or end.get("threads") != [] \
            or rise > REMOTE_MEM_RISE_MAX:
        fail(f"remote: claim lost: 409 {'t_409' in stats}, stop at "
             f"{stop_done} frames, owner {lost_row['claimed_by']}, "
             f"threads {end.get('threads')}, rise {rise}")
    # what crossed the wire and when
    sent = stats["uploads"]
    ct = stats["compute_end"].get(up["transcode"]["id"])
    early = [(n, t1 - t0) for job, _, n, t0, t1 in sent
             if job == up["transcode"]["id"] and ct and t1 <= ct]
    log("remote: " + json.dumps({
        "wall_s": round(wall, 2), "main_s": stats["main_s"],
        "preempted_s": stats["preempted_s"], "resume_s": stats["resume_s"],
        "register_s": stats["register_s"],
        "claim_latency_s": stats["claims"],
        "uploaded": {"files": len(sent), "bytes": sum(n for _, _, n, _, _
                                                      in sent)},
        "transcode_overlap": {"bytes": sum(n for n, _ in early),
                              "seconds": round(sum(s for _, s in early), 3),
                              "files": len(early)},
        "progress_posts": stats["progress_posts"],
        "allocated_at_attempt_start": {
            str(k): v for k, v in stats["allocated_at_start"].items()},
        "launches_by_job": {str(k): v for k, v in stats["launches"].items()},
        "launches": launches, "me_launches": me_launches,
        "preempt": {"at_frames": stats["preempted_at"],
                    "partial_files": len(partial),
                    "resumed_segments": resumed,
                    "tree_files": len(trees["cut"])},
        "claim_lost": {"s_409_to_stop": round(t_stop - stats["t_409"], 3),
                       "stopped_at_frames": stop_done,
                       "threads_left": len(end["threads"]),
                       "allocated_rise": rise,
                       "bound": REMOTE_MEM_RISE_MAX}}))
    return launches


SERVE_POLL_S = 30.0          # the daemon's poll: only a wakeup claims sooner
SERVE_CLAIM_MAX_S = 5.0      # a claim slower than this was not woken
SERVE_QUEUE_TIMEOUT_S = 300.0
SERVE_L2_BYTES = 64 << 20
SERVE_LAUNCHES = 6           # one 360p dispatch: 3 planes + 3 thumbnail


def _libpq() -> str | None:
    """The system libpq that the Postgres facade loads, or None."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("pq") or "libpq.so.5"
    try:
        ctypes.CDLL(name)
    except OSError:
        return None
    return name


def phase_serve(work: Path, sources: dict) -> int:
    """The serving plane in one process. Where the system libpq exists,
    the port's ``FakePg`` on loopback and ``create_all`` over a
    ``postgresql://`` URL; else (printed) a sqlite file. On that
    database the port's public app on loopback and ``WorkerDaemon
    (device="cuda")`` polling every SERVE_POLL_S: one 360p transcode of
    the 4-frame 1080p source (one dispatch, SERVE_LAUNCHES launches)
    claimed within SERVE_CLAIM_MAX_S of its enqueue (the wakeup bus,
    ``PgNotifyBus`` on Postgres), its ``finalize_ready`` prewarming the
    app's plane. Then over HTTP, that tree and the remote phase's 1080p
    A/V tree (its own sqlite file): every file of ``outputs.json`` equal
    to the file (bytes and SHA-256), a segment's miss and hit (the hit
    with zero DB queries and zero disk reads), ``Range`` 206,
    ``If-None-Match`` 304, ``HEAD``, 403 on the source with downloads
    off (the daemon's tree; a remote worker uploads no source), 404 on a
    tree that is not ready; a second plane filled from the
    disk L2 (``l2_bytes`` given to the constructor); one peer fill each
    way between two loopback origins on a ring of two."""
    import asyncio
    import hashlib

    import aiohttp
    from aiohttp import web

    from vlog_tpu_torch import config
    from vlog_tpu_torch.api.public_api import DELIVERY, build_public_app
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.db.core import open_database
    from vlog_tpu_torch.delivery import DeliveryPlane, Ring
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids
    from vlog_tpu_torch.jobs.events import bus_for
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.obs.metrics import runtime
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.parallel.scheduler import get_scheduler
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker.daemon import WorkerDaemon

    d = work / "serve"
    d.mkdir()
    remote = work / "remote"
    lib = _libpq()
    log("postgres: unavailable (libpq.so.5 not found)" if lib is None else
        f"postgres: {lib}; the job runs on the port's FakePg")
    backend = get_backend("torch")
    if backend.device.type != "cuda":
        fail(f"serve: backend on {backend.device}")
    one_rung = (config.LADDER_BY_NAME["360p"],)
    src = sources[SLICE_FRAMES]
    _frames_per_call(backend.plan(get_video_info(src), one_rung,
                                  out_dir=d / "p"),
                     "serve transcode", SLICE_FRAMES)
    saved = {k: getattr(config, k) for k in (
        "ladder_for_source", "DOWNLOADS_ENABLED", "DELIVERY_PEERS",
        "DELIVERY_SELF_URL", "DELIVERY_GOSSIP_INTERVAL_S")}
    config.ladder_for_source = lambda height: one_rung
    config.DELIVERY_GOSSIP_INTERVAL_S = 0.0
    out: dict = {}

    async def drive():
        fake, runners, dbs = None, [], []
        session = aiohttp.ClientSession()

        async def serve(app, port: int = 0) -> str:
            runner = web.AppRunner(app)
            await runner.setup()
            runners.append(runner)
            await web.TCPSite(runner, "127.0.0.1", port).start()
            return "http://127.0.0.1:%d" % runner.addresses[0][1]

        async def fetch(url, method="GET", **kw):
            t0 = time.perf_counter()
            async with session.request(method, url, **kw) as r:
                body = await r.read()
                return (r.status, body, r.headers,
                        round((time.perf_counter() - t0) * 1e3, 3))

        async def drain(plane):
            for _ in range(50):
                if not plane._tasks:
                    return
                await asyncio.gather(*list(plane._tasks),
                                     return_exceptions=True)

        try:
            # 1. the job, on Postgres where libpq exists
            if lib is not None:
                from vlog_tpu_torch.db.pgfake import FakePg

                fake = FakePg().start()
                host, port = fake.server_address
                url = (f"postgresql://smoke@{host}:{port}/smoke"
                       "?sslmode=disable&gssencmode=disable")
            else:
                url = f"sqlite:///{d / 'vlog.db'}"
            db = open_database(url)
            await db.connect()
            dbs.append(db)
            await create_all(db)
            app = build_public_app(db, video_dir=d / "videos")
            base = await serve(app)
            plane = app[DELIVERY]
            daemon = WorkerDaemon(
                db, name="smoke-serve", device="cuda", backend=backend,
                scheduler=get_scheduler(), video_dir=d / "videos",
                kinds=(JobKind.TRANSCODE,), poll_interval_s=SERVE_POLL_S,
                heartbeat_interval_s=5.0, progress_min_interval_s=0.0)
            task = asyncio.create_task(daemon.run())
            deadline = time.monotonic() + 60
            while await db.fetch_one("SELECT 1 FROM workers WHERE "
                                     "name='smoke-serve'") is None:
                if task.done() or time.monotonic() > deadline:
                    task.result()
                    fail("serve: the daemon did not start")
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.5)        # past its first, empty poll
            video = await vids.create_video(db, "Serve",
                                            source_path=str(src))
            launches0 = fused_resize.launches
            warmed0 = runtime().delivery_prewarm.labels("warmed")._value.get()
            job_id = await claims.enqueue_job(db, video["id"])
            deadline = time.monotonic() + SERVE_QUEUE_TIMEOUT_S
            while True:
                row = await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                         {"i": job_id})
                if row["completed_at"] or row["failed_at"]:
                    break
                if task.done() or time.monotonic() > deadline:
                    task.result()
                    fail("serve: the transcode did not finish in time")
                await asyncio.sleep(0.05)
            out["launches"] = fused_resize.launches - launches0
            await drain(plane)
            daemon.request_stop()
            await asyncio.wait_for(task, 120)
            bus = bus_for(db)
            out["bus"] = type(bus).__name__
            await bus.close()
            if row["failed_at"]:
                fail(f"serve: the transcode failed: {row['error']}")
            out["dialect"] = getattr(db, "dialect", "sqlite")
            out["claim_latency_s"] = round(row["started_at"]
                                           - row["created_at"], 4)
            out["job_s"] = round(row["completed_at"] - row["created_at"], 3)
            out["prewarm"] = {
                "warmed_total": runtime().delivery_prewarm.labels(
                    "warmed")._value.get() - warmed0,
                **{k: plane.counters[k] for k in (
                    "invalidations", "prewarm_runs", "prewarm_segments",
                    "prewarm_errors")}}
            video = await vids.get_video(db, video["id"])
            # 2. serve both trees over HTTP
            rdb = Database(f"sqlite:///{remote / 'vlog.db'}")
            await rdb.connect()
            dbs.append(rdb)
            rapp = build_public_app(rdb, video_dir=remote / "videos")
            rbase = await serve(rapp)
            rplane = rapp[DELIVERY]
            upload = await rdb.fetch_one(
                "SELECT * FROM videos WHERE title='Upload'")
            trees = {"serve": (base, video["slug"], d / "videos", db,
                               plane),
                     "remote": (rbase, upload["slug"], remote / "videos",
                                rdb, rplane)}
            hits = {}
            for name, (b, slug, vdir, tdb, tplane) in trees.items():
                files = integrity.load_manifest(vdir / slug)
                rel = sorted(r for r in files if r.endswith(".m4s"))[0]
                if name == "serve" and tplane.cache.get((slug, rel)) is None:
                    fail(f"serve: {rel} was not prewarmed")
                tplane.invalidate_slug(slug)     # the miss is a cold one
                q0, reads0 = tdb.query_count, tplane.counters["disk_reads"]
                miss = await fetch(f"{b}/videos/{slug}/{rel}")
                q1, reads1 = tdb.query_count, tplane.counters["disk_reads"]
                hit = await fetch(f"{b}/videos/{slug}/{rel}")
                want = (vdir / slug / rel).read_bytes()
                if miss[0] != 200 or hit[0] != 200 or miss[1] != want \
                        or hit[1] != want or reads1 - reads0 != 1 \
                        or tdb.query_count != q1 \
                        or tplane.counters["disk_reads"] != reads1:
                    fail(f"serve {name}: {rel} miss {miss[0]} hit {hit[0]}, "
                         f"disk reads {reads1 - reads0} then "
                         f"{tplane.counters['disk_reads'] - reads1}, "
                         f"hit queries {tdb.query_count - q1}")
                hits[name] = {"segment": rel, "bytes": len(want),
                              "miss_ms": miss[3], "hit_ms": hit[3],
                              "miss_queries": q1 - q0}
                config.DOWNLOADS_ENABLED = True
                for r, meta in sorted(files.items()):
                    st, body, _, _ = await fetch(f"{b}/videos/{slug}/{r}")
                    if st != 200 or body != (vdir / slug / r).read_bytes() \
                            or hashlib.sha256(body).hexdigest() \
                            != meta["sha256"]:
                        fail(f"serve {name}: {r} answered {st}, "
                             f"{len(body)} bytes")
                config.DOWNLOADS_ENABLED = False
                hits[name]["files"] = len(files)
                etag = hit[2]["ETag"]
                u = f"{b}/videos/{slug}/{rel}"
                ranged = await fetch(u, headers={"Range": "bytes=100-199"})
                cond = await fetch(u, headers={"If-None-Match": etag})
                head = await fetch(u, "HEAD")
                # the daemon's tree keeps the source; a remote worker
                # uploads none (the server holds it)
                orig = next((r for r in files if r.startswith("original")),
                            None)
                gated = (await fetch(f"{b}/videos/{slug}/{orig}"))[0] \
                    if orig else None
                if (ranged[0], ranged[1], ranged[2].get("Content-Range")) \
                        != (206, want[100:200], f"bytes 100-199/{len(want)}") \
                        or cond[0] != 304 or cond[1] \
                        or (head[0], head[1], head[2]["Content-Length"]) \
                        != (200, b"", str(len(want))) \
                        or gated != (403 if name == "serve" else gated):
                    fail(f"serve {name}: range {ranged[0]}, 304 {cond[0]}, "
                         f"HEAD {head[0]}, original {orig}: {gated}")
            pending = await vids.create_video(db, "Not Ready")
            (d / "videos" / pending["slug"]).mkdir(parents=True)
            shutil.copy(d / "videos" / video["slug"] / "master.m3u8",
                        d / "videos" / pending["slug"] / "master.m3u8")
            nr = await fetch(f"{base}/videos/{pending['slug']}/master.m3u8")
            if nr[0] != 404:
                fail(f"serve: a tree that is not ready answered {nr[0]}")
            # the disk L2 fills a second plane
            slug, rel = video["slug"], hits["serve"]["segment"]
            l2 = dict(l2_bytes=SERVE_L2_BYTES, l2_dir=d / "l2")
            first = DeliveryPlane(db, d / "videos", **l2)
            await first.fetch(slug, rel)
            await drain(first)
            second = DeliveryPlane(db, d / "videos", **l2)
            t_l2 = time.perf_counter()
            got = await second.fetch(slug, rel)
            out["l2_fill_ms"] = round((time.perf_counter() - t_l2) * 1e3, 3)
            if got.body != (d / "videos" / slug / rel).read_bytes() \
                    or second.counters["disk_reads"] \
                    or second.l2.stats()["hits"] != 1:
                fail(f"serve: L2 fill {second.counters} {second.l2.stats()}")
            await first.close()
            await second.close()
            # a ring of two origins over the remote tree
            ports = (_free_port(), _free_port())
            urls = tuple(f"http://127.0.0.1:{p}" for p in ports)
            config.DELIVERY_PEERS = urls
            origins = []
            for own, port in zip(urls, ports):
                config.DELIVERY_SELF_URL = own
                oapp = build_public_app(rdb, video_dir=remote / "videos")
                await serve(oapp, port)
                origins.append(oapp[DELIVERY])
            slug = upload["slug"]
            files = integrity.load_manifest(remote / "videos" / slug)
            ring = Ring(urls)
            peer = {}
            immutable = [r for r in sorted(files)
                         if not r.startswith("original")
                         and not r.endswith((".m3u8", ".mpd"))]
            for i, (own, plane_i) in enumerate(zip(urls, origins)):
                other = urls[1 - i]
                rel = next((r for r in immutable
                            if ring.owner(f"{slug}/{r}") == other), None)
                if rel is None:
                    fail(f"serve: {other} owns none of {immutable}")
                before = dict(plane_i.counters)
                got = await fetch(f"{own}/videos/{slug}/{rel}")
                if got[0] != 200 or got[1] != (
                        remote / "videos" / slug / rel).read_bytes() \
                        or plane_i.counters["peer_fills"] != 1 \
                        or plane_i.counters["disk_reads"] \
                        != before["disk_reads"]:
                    fail(f"serve: peer fill at {own}: {got[0]} "
                         f"{plane_i.counters}")
                peer[own] = {"segment": rel, "ms": got[3]}
            out["hits"], out["peer_fills"] = hits, peer
        finally:
            await session.close()
            for runner in runners:
                await runner.cleanup()
            for db_ in dbs:
                await db_.disconnect()
            if fake is not None:
                fake.stop()

    t0 = time.perf_counter()
    try:
        asyncio.run(drive())
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    pre = out["prewarm"]
    if out["launches"] != SERVE_LAUNCHES \
            or out["claim_latency_s"] > SERVE_CLAIM_MAX_S \
            or pre["warmed_total"] < 2 or pre["prewarm_runs"] != 1 \
            or pre["prewarm_errors"] or pre["invalidations"] < 1:
        fail(f"serve: launches {out['launches']}, claim latency "
             f"{out['claim_latency_s']} s, prewarm {pre}")
    log("serve: " + json.dumps(out))
    log("serve on " + smi("--query-gpu=name,power.limit"))
    return out["launches"]


# ---------------------------------------------------------------------------
# admin: the port's quick start on the card (admin API, CLI, daemon, public)
ADMIN_POLL_S = 2.0            # the daemon's poll; the bus wakes it sooner
ADMIN_JOB_TIMEOUT_S = 180.0
ADMIN_SSE_TIMEOUT_S = 120.0
ADMIN_UPLOAD_LAUNCHES = 6     # one 360p dispatch: 3 planes + 3 thumbnail
ADMIN_THUMB_LAUNCHES = 3      # the grabbed frame's Y, U and V
ADMIN_HEVC_LAUNCHES = 6       # the HEVC re-encode: the same at 360p
ADMIN_THUMB_FRAME = 2         # the grab's frame: mid-source of 4


def _av1_probe() -> tuple[bool, str]:
    """Whether the libav shim builds and opens an AV1 encoder (the probe
    of tests/test_av1.py), and the message the re-encode fails with when
    it does not (``backends/av1_path.py``)."""
    from vlog_tpu_torch.native import get_av_lib

    lib = get_av_lib()
    if lib is None:
        log("av1: libav shim unavailable on this machine; the AV1 "
            "re-encode must fail with Av1Unavailable")
        return False, ("Av1Unavailable: AV1 re-encode needs the libav shim "
                       "(system libavcodec with an AV1 encoder); it is "
                       "unavailable or disabled")
    h = lib.vt_av1_open(64, 64, 24, 1, 200_000, 8, 8)
    if not h:
        log("av1: libav shim built, no AV1 encoder in its libavcodec; the "
            "AV1 re-encode must fail with Av1Unavailable")
        return False, "Av1Unavailable: vt_av1_open failed (no AV1 encoder)"
    lib.vt_av1_close(h)
    log("av1: libav shim built with an AV1 encoder; the AV1 re-encode "
        "must end ready")
    return True, ""


def phase_admin(work: Path, sources: dict) -> int:
    """The port's quick start with the card behind it, in one process:
    the port's admin app (``build_admin_app(..., device="cuda")``) and
    public app on loopback over one sqlite file, and
    ``WorkerDaemon(device="cuda")`` on one slot (transcodes and
    re-encodes), the ladder cut to the 360p rung as in the serve phase.
    The 4-frame 1080p Y4M goes up through the port's CLI
    (``vlog_tpu_torch.cli.main.main(["upload", path, "--wait"])`` with
    ``VLOG_ADMIN_URL`` the loopback admin) while an SSE client reads
    ``/api/events/progress``: the job ends ready, the public app serves
    ``master.m3u8`` and a segment equal to the files, the audit log holds
    the upload. ``POST .../thumbnail/from-time`` at frame 2: exactly 3
    kernel launches, the grabbed planes held to the plain version, the
    JPEG the packed blocks of those planes at 1280x720. An HEVC re-encode
    (``codec="h265"``) through the admin API: ready, hvc1, the tree
    verifies. An AV1 re-encode: with the shim and an AV1 encoder it must
    end ready with an av01 tree that verifies and counted launches;
    without, its failure row must hold ``Av1Unavailable``'s message.
    Returns the launches of the upload, the grab and the re-encodes."""
    import asyncio
    import importlib
    import threading

    import aiohttp
    from aiohttp import web

    from vlog_tpu_torch import config
    from vlog_tpu_torch.api.admin_api import THUMBNAILER, build_admin_app
    from vlog_tpu_torch.api.public_api import build_public_app
    from vlog_tpu_torch.backends import get_backend, torch_backend
    from vlog_tpu_torch.codecs.jpeg.encoder import pack_jpeg
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.resize import apply_resize_matrices
    from vlog_tpu_torch.parallel.scheduler import get_scheduler
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker.daemon import WorkerDaemon

    d = work / "admin"
    d.mkdir()
    src = sources[SLICE_FRAMES]
    av1_ok, av1_error = _av1_probe()
    backend = get_backend("torch")
    if backend.device.type != "cuda":
        fail(f"admin: backend on {backend.device}")
    one_rung = (config.LADDER_BY_NAME["360p"],)
    saved = config.ladder_for_source
    config.ladder_for_source = lambda height: one_rung
    out: dict = {"av1_probe": av1_ok}
    t_phase = time.perf_counter()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True,
                              name="smoke-admin-loop")
    thread.start()

    def call(coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    db = Database(f"sqlite:///{d / 'vlog.db'}")
    state: dict = {"runners": [], "events": []}

    async def start():
        await db.connect()
        await create_all(db)
        admin = build_admin_app(db, upload_dir=d / "uploads",
                                video_dir=d / "videos",
                                audit_path=d / "audit.log", device="cuda")
        state["admin_app"] = admin
        for name, app in (("admin", admin),
                          ("public", build_public_app(
                              db, video_dir=d / "videos"))):
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            state["runners"].append(runner)
            state[name] = "http://127.0.0.1:%d" % runner.addresses[0][1]
        daemon = WorkerDaemon(
            db, name="smoke-admin", device="cuda", backend=backend,
            scheduler=get_scheduler(), video_dir=d / "videos",
            kinds=(JobKind.TRANSCODE, JobKind.REENCODE),
            poll_interval_s=ADMIN_POLL_S, heartbeat_interval_s=5.0,
            progress_min_interval_s=0.0)
        state["daemon"] = daemon
        state["task"] = asyncio.create_task(daemon.run())
        state["session"] = aiohttp.ClientSession()

    async def read_sse():
        """Every progress event of the stream, until cancelled."""
        async with state["session"].get(
                state["admin"] + "/api/events/progress",
                params={"poll": "0.2"},
                timeout=aiohttp.ClientTimeout(
                    total=ADMIN_SSE_TIMEOUT_S)) as r:
            async for raw in r.content:
                line = raw.decode()
                if line.startswith("data: "):
                    state["events"].append(json.loads(line[6:]))

    async def request(method, path, **kw):
        t0 = time.perf_counter()
        async with state["session"].request(method, state["admin"] + path,
                                            **kw) as r:
            body = await r.read()
            return r.status, body, time.perf_counter() - t0

    async def fetch(url):
        async with state["session"].get(url) as r:
            return r.status, await r.read()

    async def wait_job(job_id: int, until) -> dict:
        deadline = time.monotonic() + ADMIN_JOB_TIMEOUT_S
        while True:
            row = await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                     {"i": job_id})
            failures = await db.fetch_all(
                "SELECT * FROM job_failures WHERE job_id=:i ORDER BY id",
                {"i": job_id})
            if until(row, failures):
                return {"row": row, "failures": failures}
            if state["task"].done() or time.monotonic() > deadline:
                state["task"].result()
                fail(f"admin: job {job_id} did not end in time: "
                     f"{row['error']}")
            await asyncio.sleep(0.05)

    async def stop():
        sse = state.get("sse")
        if sse is not None and not sse.done():
            sse.cancel()
        if "daemon" in state:
            state["daemon"].request_stop()
            await asyncio.wait_for(state["task"], 120)
        if "session" in state:
            await state["session"].close()
        for runner in state["runners"]:
            await runner.cleanup()
        await db.disconnect()

    def check_tree(slug: str, codec_tag: bytes) -> int:
        root = d / "videos" / slug
        manifest = integrity.load_manifest(root)
        problems = integrity.verify_tree(root, manifest)
        master = (root / "master.m3u8").read_text()
        init = (root / "360p" / "init.mp4").read_bytes()
        if problems or codec_tag not in init \
                or codec_tag.decode()[:4] not in master:
            fail(f"admin: {slug} tree: {problems}, {codec_tag!r} in init "
                 f"{codec_tag in init}, master {master!r}")
        return len(manifest)

    try:
        call(start())
        # 1. the upload through the port's CLI, SSE read while it runs
        os.environ["VLOG_ADMIN_URL"] = state["admin"]
        os.environ["VLOG_PUBLIC_URL"] = state["public"]
        cli = importlib.import_module("vlog_tpu_torch.cli.main")
        if cli.ADMIN_URL != state["admin"]:
            fail(f"admin: the CLI read VLOG_ADMIN_URL as {cli.ADMIN_URL}")
        state["sse"] = asyncio.run_coroutine_threadsafe(read_sse(), loop)
        launches0 = fused_resize.launches
        t0 = time.perf_counter()
        cli.main(["upload", str(src), "--wait", "--title", "Quick Start"])
        out["upload_s"] = round(time.perf_counter() - t0, 3)
        out["upload_launches"] = fused_resize.launches - launches0
        video = call(db.fetch_one("SELECT * FROM videos WHERE "
                                  "title='Quick Start'"))
        row = video and call(db.fetch_one(
            "SELECT * FROM jobs WHERE video_id=:v AND kind='transcode'",
            {"v": video["id"]}))
        if not row or video["status"] != "ready" \
                or row["completed_at"] is None:
            fail(f"admin: the upload ended {video and video['status']}, "
                 f"job {row}")
        out["transcode_s"] = round(row["completed_at"] - row["created_at"], 3)
        out["claim_latency_s"] = round(row["started_at"] - row["created_at"],
                                       4)
        state["sse"].cancel()
        events = [e for e in state["events"] if e["job_id"] == row["id"]]
        if not events:
            fail(f"admin: no SSE progress event for job {row['id']} "
                 f"({len(state['events'])} events)")
        out["sse_events"] = len(events)
        out["sse_states"] = sorted({e["state"] for e in events})
        slug = video["slug"]
        files = check_tree(slug, b"avc1")
        st, body = call(fetch(f"{state['public']}/videos/{slug}/master.m3u8"))
        seg = sorted((d / "videos" / slug / "360p").glob("segment_*.m4s"))[0]
        st2, body2 = call(fetch(f"{state['public']}/videos/{slug}/360p/"
                                f"{seg.name}"))
        if (st, st2) != (200, 200) \
                or body != (d / "videos" / slug / "master.m3u8").read_bytes() \
                or body2 != seg.read_bytes():
            fail(f"admin: the public app served {st}, {st2}")
        audit = [json.loads(x) for x in
                 (d / "audit.log").read_text().splitlines()]
        if not any(e.get("action") == "admin.request" and e.get("method")
                   == "POST" and e.get("path") == "/api/videos"
                   and e.get("status") == 201 for e in audit):
            fail(f"admin: the audit log lacks the upload: {audit}")
        out["files"] = files

        # 2. the thumbnail grab on the card: 3 launches, held to plain
        grabbed = []
        plain_resize = torch_backend.resize_yuv420

        def recording(y, u, v, mats):
            res = plain_resize(y, u, v, mats)
            grabbed.append(((y, u, v), mats, res))
            return res

        torch_backend.resize_yuv420 = recording
        try:
            launches0 = fused_resize.launches
            st, body, dt = call(request(
                "POST", f"/api/videos/{video['id']}/thumbnail/from-time",
                json={"time_s": ADMIN_THUMB_FRAME / 24}))
            thumb_launches = fused_resize.launches - launches0
        finally:
            torch_backend.resize_yuv420 = plain_resize
        out["thumbnail_s"] = round(dt, 3)
        if st != 200 or thumb_launches != ADMIN_THUMB_LAUNCHES \
                or len(grabbed) != 1:
            fail(f"admin: thumbnail grab {st} {body[:300]!r}, launches "
                 f"{thumb_launches}, resizes {len(grabbed)}")
        (gy, gu, gv), mats, res = grabbed[0]
        (a_h, a_w), (c_h, c_w) = mats
        worst = (0, 0)
        for got, plane, ah, aw in zip(res, (gy, gu, gv), (a_h, c_h, c_h),
                                      (a_w, c_w, c_w)):
            want = apply_resize_matrices(plane.cpu(), ah.cpu(), aw.cpu())
            max_abs, n_diff = _held_to_plain(got.cpu(), want, "admin thumb")
            worst = (max(worst[0], max_abs), worst[1] + n_diff)
        jpeg = (d / "videos" / slug / "thumbnail.jpg").read_bytes()
        thumb_backend = state["admin_app"][THUMBNAILER].backend()
        if _jpeg_size(jpeg) != (720, 1280) or jpeg != pack_jpeg(
                thumb_backend._thumbnail_blocks(*(p[0] for p in res))):
            fail(f"admin: thumbnail.jpg {_jpeg_size(jpeg)} is not the "
                 "packed blocks of the grabbed planes")
        out["thumbnail"] = {"launches": thumb_launches,
                            "max_abs_err": worst[0],
                            "pixels_differing": worst[1],
                            "device": str(thumb_backend.device)}

        # 3. the re-encodes through the admin API
        reencodes = {}
        for codec, tag in (("h265", b"hvc1"), ("av1", b"av01")):
            launches0 = fused_resize.launches
            _me_reset()
            t0 = time.perf_counter()
            st, body, _ = call(request(
                "POST", f"/api/videos/{video['id']}/reencode",
                json={"codec": codec}))
            if st != 200:
                fail(f"admin: reencode {codec} answered {st} {body!r}")
            job_id = json.loads(body)["job_id"]
            ended = call(wait_job(
                job_id, lambda r, f: r["completed_at"] or f),
                ADMIN_JOB_TIMEOUT_S + 10)
            n = fused_resize.launches - launches0
            # the HEVC run's searches, on the ladder cut to 360p
            rec = {"s": round(time.perf_counter() - t0, 3), "launches": n,
                   "me_launches": _me_check("admin", _me_per_run(
                       backend.plan(get_video_info(src), one_rung,
                                    out_dir=d / "p", codec="h265"),
                       SLICE_FRAMES) if codec == "h265" else 0)}
            if codec == "av1" and not av1_ok:
                errors = [f["error"] for f in ended["failures"]]
                if ended["row"]["completed_at"] or not errors \
                        or av1_error not in errors[0] or n:
                    fail(f"admin: the AV1 re-encode without the shim ended "
                         f"{ended['row']['completed_at']}, failures "
                         f"{errors}, launches {n}; expected {av1_error!r}")
                rec["failed_with"] = errors[0]
            else:
                if ended["failures"] or not ended["row"]["completed_at"]:
                    fail(f"admin: reencode {codec} failed: "
                         f"{[f['error'] for f in ended['failures']]}")
                if codec == "h265" and n != ADMIN_HEVC_LAUNCHES or n < 3:
                    fail(f"admin: reencode {codec} launched {n}")
                rec["files"] = check_tree(slug, tag)
            reencodes[codec] = rec
        out["reencodes"] = reencodes
    finally:
        try:
            call(stop(), 180)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=30)
            loop.close()
            config.ladder_for_source = saved
    if out["upload_launches"] != ADMIN_UPLOAD_LAUNCHES:
        fail(f"admin: the upload's transcode launched "
             f"{out['upload_launches']}")
    out["wall_s"] = round(time.perf_counter() - t_phase, 2)
    log("admin: " + json.dumps(out))
    log("admin parts (s): upload " + str(out["upload_s"]) + ", transcode "
        + str(out["transcode_s"]) + ", thumbnail " + str(out["thumbnail_s"])
        + ", reencode h265 " + str(out["reencodes"]["h265"]["s"])
        + ", reencode av1 " + str(out["reencodes"]["av1"]["s"]))
    log("admin on " + smi("--query-gpu=name,power.limit"))
    return (out["upload_launches"] + out["thumbnail"]["launches"]
            + sum(r["launches"] for r in out["reencodes"].values()))


# ---------------------------------------------------------------------------
# grid: the (data x rung) grid on one card as several logical devices
GRID_WIDTH = 4               # [cuda:0] * 4: one card, four logical devices
GRID_DRYRUN_WIDTH = 2        # the dry run's logical devices (3 shapes)
GRID_H264_SPEC = "data:1,rung:4"
# 2x2 keeps the padded data axis and the rung split (4x1 cut for time)
GRID_HEVC_SPECS = ("data:2,rung:2",)
GRID_ASR_WIDTH = 2
GRID_ASR_BATCH = ASR_LIVE    # the live windows in one batch, split 1 + 1
GRID_ASR_MAX_NEW = 64
GRID_PSNR_RTOL = 1e-5
GRID_DRYRUN_ITERS = 1        # timed dispatches per shape, workload and job
GRID_CPU_TIMEOUT_S = 400.0


def _grid_launches(rungs_spec, label: str) -> int:
    """Resize launches of one dispatch over a grid labelled "DxR": per
    column, its data width x its scaled rungs x 3 planes."""
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.parallel.mesh import balanced_rung_columns

    data, cols = (int(x) for x in label.split("x"))
    scaled = [(h, w) != (SRC_H, SRC_W) for _, h, w, _ in rungs_spec]
    return sum(data * sum(scaled[i] for i in col) * 3
               for col in balanced_rung_columns(rungs_spec, cols)) \
        * fused_resize.LAUNCHES_PER_CALL


def _under_lease(devices, spec: str, fn, *args, **kw):
    """``fn`` under a one-slot ``MeshScheduler`` lease over ``devices``
    with ``VLOG_TPU_MESH=spec`` (restored after); returns (value, the
    lease's grid label)."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    saved = config.TPU_MESH_SPEC
    config.TPU_MESH_SPEC = spec
    sched = MeshScheduler(devices=devices, slots=1)
    ticket = sched.admit()
    try:
        with ticket.acquire() as lease:
            value = fn(*args, **kw)
            return value, lease.shape
    finally:
        ticket.close()
        config.TPU_MESH_SPEC = saved


def _grid_asr(work: Path, card) -> dict:
    """The engine on a GRID_ASR_WIDTH-wide lease over the card repeated,
    on the asr phase's live windows: the tokens equal the 1-wide run's,
    the rows a multiple of the width."""
    from vlog_tpu_torch.asr import engine as engine_mod
    from vlog_tpu_torch.asr import load
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler
    from vlog_tpu_torch.worker.transcribe import _cut_windows, _live_windows

    assets = load.load_whisper(work / "whisper-small", device="cuda")
    samples = _asr_audio(ASR_SEED).astype(np.float32)
    windows = _cut_windows(samples, window_s=30.0, overlap_s=5.0)
    live = _live_windows(samples, windows, 30.0)
    if len(live) != ASR_LIVE:
        fail(f"grid asr: {len(live)} live windows, want {ASR_LIVE}")
    real_rows = engine_mod.generate_rows
    runs = {}
    for width in (1, GRID_ASR_WIDTH):
        toks = []

        def recorded(*a, **k):
            out = real_rows(*a, **k)
            toks.append(out[0])
            return out

        engine_mod.generate_rows = recorded
        sched = MeshScheduler(devices=[card] * width, slots=1)
        hold = sched.admit()         # hold the card until every window is in
        hold.acquire(timeout=30)
        engine = engine_mod.AsrEngine(assets, scheduler=sched,
                                      batch_windows=GRID_ASR_BATCH, tick_s=0.0)
        t0 = time.perf_counter()
        try:
            lang = engine.detect_language(windows[live[0]][1])
            h = engine.begin_job("grid", language=lang,
                                 max_new=GRID_ASR_MAX_NEW, beam=1)
            for i in live:
                h.submit(i, windows[i][0], windows[i][1])
            hold.close()
            cues = sorted((i, [(c.start_s, c.end_s, c.text) for c in cs])
                          for i, cs, _ in h.results())
            h.close()
        finally:
            hold.close()
            engine.close()
            engine_mod.generate_rows = real_rows
        runs[width] = {"tokens": np.concatenate(toks),
                       "rows": [b["rows"] for b in engine.batch_log],
                       "cues": cues, "s": round(time.perf_counter() - t0, 3)}
    one, wide = runs[1], runs[GRID_ASR_WIDTH]
    if not np.array_equal(one["tokens"], wide["tokens"]) \
            or one["cues"] != wide["cues"]:
        fail(f"grid asr: tokens on a {GRID_ASR_WIDTH}-wide lease differ from "
             "the 1-wide run's")
    if any(r % GRID_ASR_WIDTH for r in wide["rows"]):
        fail(f"grid asr: rows {wide['rows']} not a multiple of "
             f"{GRID_ASR_WIDTH}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("grid asr: TF32 is on")
    return {"windows": len(live), "rows_1": one["rows"],
            f"rows_{GRID_ASR_WIDTH}": wide["rows"],
            "tokens_shape": list(one["tokens"].shape),
            "tokens_equal": True, "s_1": one["s"],
            f"s_{GRID_ASR_WIDTH}": wide["s"]}


def _grid_hold(seen: dict) -> dict:
    """The kernel against its plain version at every (shape, frame count)
    the grid phase called it with, on seeded random planes with the
    matrices the path used."""
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.ops.resize import apply_resize_matrices

    gen = torch.Generator(device="cuda").manual_seed(2468)
    saved = fused_resize.launches
    held = {}
    for (src, dst, n), (a_h, a_w) in sorted(seen.items()):
        x = torch.randint(0, 256, (n,) + src, device="cuda", generator=gen,
                          dtype=torch.uint8)
        held[f"{src[0]}x{src[1]}->{dst[0]}x{dst[1]} n={n}"] = list(
            _held_to_plain(fused_resize.fused_resize_plane(x, a_h, a_w),
                           apply_resize_matrices(x, a_h, a_w),
                           f"grid: kernel at {src}->{dst}, n={n}"))
    fused_resize.launches = saved       # comparison launches do not count
    return held


def phase_grid(work: Path, sources: dict) -> int:
    """The (data x rung) grid on one card as GRID_WIDTH logical devices:
    the slice's H.264 run on a 1x4 grid, the hevc phase's run on a 2x2
    grid (trees byte-identical to those phases'), the ASR engine on
    a 2-wide lease, and the dry run (its PSNR against a CPU run)."""
    from vlog_tpu_torch.backends import get_backend
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.ops import fused_resize
    from vlog_tpu_torch.parallel import dryrun
    from vlog_tpu_torch.worker import process_video

    card = torch.device("cuda", 0)
    devices = [card] * GRID_WIDTH
    # the CPU dry run (the PSNR reference) runs beside the card's parts
    cpu_code = ("import json, torch; torch.set_num_threads(4); "
                "from vlog_tpu_torch.parallel import dryrun; "
                f"dryrun.run({GRID_DRYRUN_WIDTH}, "
                f"devices=['cpu'] * {GRID_DRYRUN_WIDTH}, "
                f"iters={GRID_DRYRUN_ITERS})")
    cpu_env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cpu_proc = subprocess.Popen([sys.executable, "-c", cpu_code], cwd=ROOT,
                                env=cpu_env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    seen: dict = {}
    real_plane = fused_resize.fused_resize_plane

    def recording_plane(plane, a_h, a_w):
        if plane.device.type == "cuda":
            n = int(np.prod(plane.shape[:-2]))
            seen.setdefault((tuple(plane.shape[-2:]), (a_h.shape[0],
                                                       a_w.shape[0]), n),
                            (a_h, a_w))
        return real_plane(plane, a_h, a_w)

    fused_resize.fused_resize_plane = recording_plane
    report: dict = {}
    total = 0
    try:
        # -- H.264: the slice's default plan on a 1x4 grid ---------------
        src = sources[SLICE_FRAMES]
        backend = TorchBackend(device="cuda")
        plan = backend.plan(get_video_info(src), out_dir=work / "grid_h264")
        rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                           for r in plan.rungs)
        fused_resize.launches = 0
        _me_reset()
        t0 = time.perf_counter()
        res, shape = _under_lease(devices, GRID_H264_SPEC, backend.run, plan)
        wall = time.perf_counter() - t0
        launches = fused_resize.launches
        _me_check("grid", 0)
        want = _grid_launches(rungs_spec, shape) + 3 * fused_resize.LAUNCHES_PER_CALL
        if shape != "1x4" or launches != want:
            fail(f"grid h264: shape {shape}, {launches} launches; want 1x4, "
                 f"{want}")
        diff = _tree_diff(_tree_files(work / "slice"),
                          _tree_files(work / "grid_h264"))
        if diff:
            fail(f"grid h264: the 1x4 tree differs from the slice's: {diff}")
        _check_stage_s("grid h264", res.stage_s)
        report["h264"] = {"shape": shape, "launches": launches,
                          "wall_s": round(wall, 3),
                          "files_equal_to_slice": len(
                              _tree_files(work / "slice"))}
        total += launches

        # -- HEVC: the hevc phase's run on the 2x2 grid ---------------------
        hsrc = sources[FRAMES]
        hevc_ref = _tree_files(work / "hevc")
        hplan = backend.plan(get_video_info(hsrc), out_dir=work / "unused",
                             codec="h265")
        rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                           for r in hplan.rungs)
        report["hevc"] = {}
        for spec in GRID_HEVC_SPECS:
            out = work / f"grid_hevc_{spec.replace(':', '').replace(',', '_')}"
            fused_resize.launches = 0
            _me_reset()
            t0 = time.perf_counter()
            res, shape = _under_lease(devices, spec, process_video, hsrc, out,
                                      backend=get_backend("torch"),
                                      codec="h265")
            wall = time.perf_counter() - t0
            launches = fused_resize.launches
            # every data device searches its shard of the chains for each
            # rung of its column: data x rungs launches a P step
            me_launches = _me_check("grid", int(shape.split("x")[0])
                                    * _me_per_run(hplan, FRAMES))
            want = _grid_launches(rungs_spec, shape) \
                + 3 * fused_resize.LAUNCHES_PER_CALL
            if launches != want:
                fail(f"grid hevc {shape}: {launches} launches, want {want}")
            diff = _tree_diff(hevc_ref, _tree_files(out))
            if diff:
                fail(f"grid hevc {shape}: the tree differs from the hevc "
                     f"phase's: {diff}")
            report["hevc"][shape] = {
                "launches": launches, "me_launches": me_launches,
                "wall_s": round(wall, 3),
                "run_wall_s": round(res.run.wall_s, 3),
                "compute_wait_s": res.run.stage_s.get("compute_wait_s"),
                "pad_frames": res.run.stage_s.get("pad_frames"),
                "files_equal_to_hevc": len(hevc_ref)}
            total += launches

        # -- ASR: the engine on a 2-wide lease ------------------------------
        fused_resize.launches = 0
        report["asr"] = _grid_asr(work, card)
        if fused_resize.launches:
            fail(f"grid asr: {fused_resize.launches} resize launches")

        # -- the dry run on two logical devices -----------------------------
        fused_resize.launches = 0
        t0 = time.perf_counter()
        rec = dryrun.run(GRID_DRYRUN_WIDTH,
                         devices=[card] * GRID_DRYRUN_WIDTH,
                         records=work / "grid_records.json",
                         iters=GRID_DRYRUN_ITERS)
        dry_s = time.perf_counter() - t0
        total += fused_resize.launches
        records = json.loads((work / "grid_records.json").read_text())
        if not records or any(r["config"]["distinct_devices"] != 1
                              for r in records):
            fail(f"grid dryrun: records {records[:2]}")
        try:
            out_s, err_s = cpu_proc.communicate(timeout=GRID_CPU_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail("grid dryrun: the CPU run did not finish")
        if cpu_proc.returncode != 0:
            fail(f"grid dryrun: the CPU run failed: {err_s[-2000:]}")
        cpu_rec = json.loads(out_s.strip().splitlines()[-1])
        for name, psnr in rec["psnr"].items():
            ref = cpu_rec["psnr"][name]
            if not math.isclose(psnr, ref, rel_tol=GRID_PSNR_RTOL):
                fail(f"grid dryrun: PSNR {name} {psnr} on the card, {ref} on "
                     "the CPU")
        report["dryrun"] = {"s": round(dry_s, 3), "launches":
                            fused_resize.launches, "psnr": rec["psnr"],
                            "psnr_cpu": cpu_rec["psnr"],
                            "records": len(records)}
        log(f"grid dryrun shape_fps ({GRID_DRYRUN_WIDTH} logical devices on "
            f"one card, not "
            f"multi-card scaling): {json.dumps(rec['shape_fps'])}; sched "
            f"{json.dumps(rec['sched'])}")
    finally:
        fused_resize.fused_resize_plane = real_plane
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.communicate()
    counts = sorted({n for (_, _, n) in seen})
    report["frames_per_call"] = counts
    report["held"] = _grid_hold(seen)
    log("grid: " + json.dumps(report))
    log(f"grid: kernel launches {total}; frames per call {counts}")
    return total


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
        _db_reset()
        t0 = time.perf_counter()
        value = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 2)
        log(f"phase {name}: {phase_s[name]}s")
        if name not in DB_CHECK_ONLY:
            _db_check(name)
        return value

    _db_install()

    timed("build", phase_build)
    timed("analysis", phase_analysis)
    from vlog_tpu_torch.parallel.compile_cache import compile_seconds

    compile_cold = compile_seconds()      # this process's builds
    from vlog_tpu_torch.native import get_av_lib

    log("libav shim: " + ("built" if get_av_lib() is not None else
                          "unavailable on this machine (optional; only "
                          "the admin phase's AV1 re-encode uses it)"))
    # one profiler-backed timer for the process (the kernel and aac phases)
    timer = DeviceTimer(torch.device("cuda"))
    kern = timed("kernel", phase_kernel, timer, FRAMES)
    me = timed("me_kernel", phase_me_kernel, timer)
    db = timed("h264_deblock_kernel", phase_h264_deblock_kernel, timer)
    timed("integer", phase_integer)
    timed("aac", phase_aac, timer)      # fails on any resize launch

    def no_hevc(name, fn, *args):
        """A phase that runs no HEVC: no motion search launch in it."""
        _me_reset()
        value = timed(name, fn, *args)
        _me_check(name, 0)
        return value

    launches = {"aac": 0}
    work = ROOT / "vlog_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sources = timed("write_y4m", _write_sources, work,
                    (FRAMES, SLICE_FRAMES, INTRA_FRAMES, RESUME_FRAMES,
                     TS_FRAMES), 11)
    launches["slice"] = timed("slice", phase_slice, sources[SLICE_FRAMES])
    launches["intra"] = no_hevc("intra", phase_intra, sources[INTRA_FRAMES])
    launches["library"] = no_hevc("library", phase_library, sources[FRAMES],
                                  work)
    launches["pipeline"], ip_path, seq = no_hevc("pipeline", phase_pipeline,
                                                 work)
    launches["pipeline_ts"] = no_hevc("pipeline_ts", phase_pipeline_ts,
                                      ip_path)
    launches["sprites"] = no_hevc("sprites", phase_sprites, work, ip_path,
                                  seq)
    launches["resume"] = no_hevc("resume", phase_resume,
                                 sources[RESUME_FRAMES])
    launches["ts"] = no_hevc("ts", phase_ts, sources[TS_FRAMES])
    launches["hevc"] = timed("hevc", phase_hevc, sources[FRAMES], work)
    witness = witness_start()
    launches["runtime"] = timed("runtime", phase_runtime, sources, work,
                                compile_cold)
    launches["daemon"] = timed("daemon", phase_daemon, work, ip_path, sources)
    witness_end(witness, phase_s)
    launches["remote"] = timed("remote", phase_remote, work, ip_path, sources)
    launches["serve"] = no_hevc("serve", phase_serve, work, sources)
    launches["admin"] = timed("admin", phase_admin, work, sources)
    no_hevc("asr", phase_asr, work)     # fails on any resize launch
    launches["asr"] = 0
    launches["grid"] = timed("grid", phase_grid, work, sources)
    shutil.rmtree(work, ignore_errors=True)
    timed("breakdown", phase_breakdown)

    _witness_reports(witness["stats"]["reports"])
    log("launches by phase " + json.dumps(launches))
    log("motion search launches by phase " + json.dumps(ME_LAUNCHES))
    log("h264 deblock launches by phase " + json.dumps(DB_LAUNCHES))
    log("phase seconds " + json.dumps(phase_s))
    log(f"phase seconds sum {sum(phase_s.values()):.2f}")

    log(json.dumps({"kernels": [{
        "name": "fused_resize_plane", "route": "cuda",
        "source": "vlog_tpu_torch/csrc/fused_resize.cu",
        "replaces": "vlog_tpu/ops/pallas_ladder.py:101",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "call_ms": kern["call_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}, {
        "name": "hevc_motion_search", "route": "cuda",
        "source": "vlog_tpu_torch/csrc/hevc_motion_search.cu",
        "replaces": "none (vlog_tpu/codecs/hevc/jax_core.py::_p_ctb_search "
                    "is plain jnp)",
        "launches": sum(ME_LAUNCHES.values()),
        "launches_by_phase": ME_LAUNCHES,
        "ms_per_dispatch": me["ms"], "call_ms_per_dispatch": me["call_ms"],
        "plain_ms_per_dispatch": me["plain_ms"],
        "bound_ms_per_dispatch": me["bound_ms"]}, {
        "name": "h264_deblock", "route": "cuda",
        "source": "vlog_tpu_torch/csrc/h264_deblock.cu",
        "replaces": "none (vlog_tpu/codecs/h264/deblock.py::deblock_frame "
                    "is plain jnp)",
        "launches": sum(DB_LAUNCHES.values()),
        "launches_by_phase": DB_LAUNCHES,
        "ms_per_dispatch": db["ms"], "call_ms_per_dispatch": db["call_ms"],
        "plain_call_ms_per_dispatch": db["plain_call_ms"],
        "bound_ms_per_dispatch": db["bound_ms"]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
