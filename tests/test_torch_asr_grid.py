"""The port's ASR on wide leases and over several devices, against its
one-device runs and the JAX package's sharded ones, with the shared tiny
checkpoint (``tests/conftest.py::tiny_model_dir``) on the CPU.

- Engine: three 2 s windows of one job, queued while a transcode ticket
  holds the scheduler so the batches are fixed (``batch_windows=2``: a
  tick of 2 windows, then 1). On a port lease over ``["cpu"] * w`` the
  rows round up to the lease width (w=2: [2, 2], w=4: [4, 4]; one device:
  [2, 1]), exactly JAX's ``batch_log["rows"]`` on a JAX lease over its
  first w virtual devices; the cues equal the one-device run's and the
  JAX engine's.
- ``transcribe_audio`` (no engine) on 40 s of speech-like audio (2
  windows) split over ``["cpu"] * k`` (k = 1, 2, 4; batches padded to
  k): the same cues and language as one device and as the JAX package's
  run sharded over the conftest's 8 virtual devices.

Tolerance: equal cue lists (times and text) and VTT bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("transformers")

from vlog_tpu_torch.asr import load as tload  # noqa: E402
from vlog_tpu_torch.asr.engine import AsrEngine, reset_engine  # noqa: E402

# slowlane-ok(module): the tiny random-weight checkpoint, 3 windows


@pytest.fixture(autouse=True)
def _clean_engines():
    from vlog_tpu.asr import engine as jengine
    from vlog_tpu.asr.decode import kv_pool as jax_kv_pool

    # The JAX package's KV page pool is process-wide and keyed by shape
    # only: a page an earlier test's run left on other virtual devices
    # (a second scheduler slot's, devices 4-7) would be leased to this
    # file's JAX lease over devices 0-3 and fail the jitted call.
    jax_kv_pool.reset()
    reset_engine()
    jengine.reset_engine()
    yield
    reset_engine()
    jengine.reset_engine()
    jax_kv_pool.reset()


@pytest.fixture(scope="module")
def assets(tiny_model_dir):
    return tload.load_whisper(tiny_model_dir, device="cpu")


def _tone(duration_s: float, freq: float) -> np.ndarray:
    t = np.arange(int(duration_s * 16000)) / 16000
    return (0.25 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


WINDOWS = [(0, 0.0, 220.0), (1, 25.0, 330.0), (2, 50.0, 440.0)]


def _engine_run(engine_cls, assets, sched):
    """Queue the three windows while a transcode ticket holds ``sched``,
    then let the engine decode them; returns ({index: [(start, end,
    text)]}, rows per batch)."""
    transcode = sched.admit()
    transcode.acquire(timeout=5)
    engine = engine_cls(assets, scheduler=sched, batch_windows=2, tick_s=0.0)
    try:
        h = engine.begin_job("job", language="en", max_new=8, beam=1)
        for idx, start, freq in WINDOWS:
            h.submit(idx, start, _tone(2.0, freq))
        transcode.close()
        got = {i: [(c.start_s, c.end_s, c.text) for c in cues]
               for i, cues, _ in h.results()}
        h.close()
    finally:
        transcode.close()
        engine.close()
    return got, [b["rows"] for b in engine.batch_log]


def test_engine_on_one_device_packs_two_then_one(assets):
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    got, rows = _engine_run(AsrEngine, assets,
                            MeshScheduler(devices=["cpu"], slots=1))
    assert rows == [2, 1] and sorted(got) == [0, 1, 2]


@pytest.mark.parametrize("width", [2, 4])
def test_engine_rows_and_tokens_on_wide_leases(assets, tiny_model_dir,
                                               width):
    import jax

    from vlog_tpu.asr import engine as jengine
    from vlog_tpu.asr.load import load_whisper as jax_load
    from vlog_tpu.parallel.scheduler import MeshScheduler as JaxScheduler
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    one, one_rows = _engine_run(AsrEngine, assets,
                                MeshScheduler(devices=["cpu"], slots=1))
    got, rows = _engine_run(AsrEngine, assets,
                            MeshScheduler(devices=["cpu"] * width, slots=1))
    want, want_rows = _engine_run(
        jengine.AsrEngine, jax_load(tiny_model_dir),
        JaxScheduler(devices=jax.devices()[:width], slots=1))
    assert rows == want_rows == [max(2, width)] * 2
    assert one_rows == [2, 1]
    assert got == one == want


@pytest.fixture(scope="module")
def speech():
    from tests.test_torch_transcribe import _speechlike

    return _speechlike(40.0, 2).astype(np.float32)


@pytest.fixture(scope="module")
def jax_transcript(speech, tiny_model_dir):
    """The JAX package's run, sharded over its 8 virtual devices:
    (VTT text, language)."""
    from vlog_tpu.asr.load import load_whisper as jax_load
    from vlog_tpu.asr.vtt import format_vtt as jax_format
    from vlog_tpu.worker import transcribe as jtr

    cues, lang = jtr.transcribe_audio(speech, jax_load(tiny_model_dir),
                                      max_new=8)
    return jax_format(cues), lang


@pytest.mark.parametrize("k", [1, 2, 4])
def test_transcribe_audio_split_over_devices(assets, speech, jax_transcript,
                                             k):
    from vlog_tpu_torch.asr.vtt import format_vtt
    from vlog_tpu_torch.worker import transcribe as ttr

    cues, lang = ttr.transcribe_audio(speech, assets, max_new=8,
                                      devices=["cpu"] * k, batch_windows=3)
    assert (format_vtt(cues), lang) == jax_transcript


def test_replicas_made_once_per_device_under_contention(assets):
    """16 threads ask for replicas on three distinct devices at once
    (switch interval shortened): one replica per device, the assets
    themselves on their own device, TF32 off."""
    import sys
    import threading

    import torch

    devs = [torch.device("cpu"), torch.device("cpu", 1),
            torch.device("cpu", 2)]
    assets.replicas.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = [], []

    def ask(i):
        try:
            got.append((i % 3, tload.replica_on(assets, devs[i % 3])))
        except BaseException as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(got) == 16
    assert all(rep is assets for k, rep in got if k == 0)
    for k in (1, 2):
        reps = {id(rep) for j, rep in got if j == k}
        assert reps == {id(assets.replicas[devs[k]])}
    assert set(assets.replicas) == set(devs[1:])
    assert not torch.backends.cuda.matmul.allow_tf32
    assets.replicas.clear()
