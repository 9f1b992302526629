"""The port's ``process_video`` (a CPU ``TorchBackend``) against
``vlog_tpu.worker.pipeline.process_video`` on one tiny A/V MP4.

The source is ``tests/test_audio_pipeline.py::make_av_mp4``: 96x64
all-intra H.264 at 12 fps with a JAX-encoded stereo 48 kHz AAC track of
two tones, 1 s. The rungs are the ladder's 360p and 480p (96 and 128
kbps audio), as the JAX package's own A/V pipeline test runs them; at
this source height both plan at 96x64, unscaled. (A scaled rung would
meet the resize rounding difference the port accepts, ROADMAP Queue C
item 1: this ramp content puts pixels within an ulp of x.5; the scaled
rungs' trees are held to JAX's in ``tests/test_torch_backend.py``.)
0.5 s segments, rate control on, the default thumbnail. JaxBackend is
pinned to one device (``grid_for_run`` -> None) so both stage the same
batches.

The audio track is band-limited (it went through AAC once), so the AAC
encoders' float32 MDCT sums, in XLA's order and in PyTorch's, code
different rounding noise in the empty bands and the payloads differ
(ROADMAP Queue C item 13). Hence two port runs per tree:

- with the reference's MDCT values (the JAX encoder's ``_mdct_all``
  patched into the port's encoder; everything after it is the port's):
  every file byte-identical to JAX's tree, ``outputs.json`` included,
  except the rate-control journal's float ``cost`` fields, held to a
  relative 1e-5 (``tests/test_torch_backend.py::assert_journals_match``;
  the journal is not in ``outputs.json``), for CMAF and for ``hls_ts``;
- with its own MDCT (CMAF): every file byte-identical except the audio
  segments, which have the same names, samples and durations, decode
  with the port's decoder and follow the source tone (correlation > 0.9,
  the JAX package's own check); ``outputs.json`` differs only in their
  digests and verifies the port's tree.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

from chip_smoke import _segment_samples
from tests.test_audio_pipeline import make_av_mp4
from tests.test_torch_backend import (JOURNAL, _files,  # noqa: F401
                                      assert_journals_match, assert_same_files,
                                      one_torch_thread)

SEG_S = 0.5
RUNGS = ("360p", "480p")


def _rungs():
    """The same ladder rungs in each package's config type."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    by_name = {r.name: r for r in tconfig.QUALITY_LADDER}
    return (tuple(jconfig.LADDER_BY_NAME[n] for n in RUNGS),
            tuple(by_name[n] for n in RUNGS))


def _jax_mdct(self, pcm):
    """The reference encoder's MDCT values for the port's encoder."""
    from vlog_tpu.codecs.aac import AacEncoder as JaxEncoder

    return JaxEncoder(self.sample_rate, self.channels,
                      self.bitrate)._mdct_all(pcm)


def _run(src: Path, out: Path, **opts):
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.worker import process_video

    return process_video(src, out, backend=TorchBackend(device="cpu"),
                         rungs=_rungs()[1], segment_duration_s=SEG_S, **opts)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The source and, per run, (root, JAX result, port result): the
    port with the reference's MDCT values (``cmaf``, ``hls_ts``) and
    with its own (``cmaf_own``, JAX's tree under ``cmaf``)."""
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.parallel import scheduler
    from vlog_tpu.worker.pipeline import process_video as jax_process
    from vlog_tpu_torch.codecs.aac.encoder import AacEncoder

    root = tmp_path_factory.mktemp("pipeline")
    src = make_av_mp4(root / "av.mp4", seconds=1.0)
    out = {}
    for name, opts in (("cmaf", {}),
                       ("hls_ts", {"streaming_format": "hls_ts",
                                   "thumbnail": False})):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
            jres = jax_process(src, root / name / "jax", backend=JaxBackend(),
                               rungs=_rungs()[0], segment_duration_s=SEG_S,
                               **opts)
            mp.setattr(AacEncoder, "_mdct_all", _jax_mdct)
            out[name] = (root / name, jres, _run(src, root / name / "torch",
                                                 **opts))
    out["cmaf_own"] = (root / "cmaf", out["cmaf"][1],
                       _run(src, root / "cmaf" / "own"))
    return src, out


def test_cmaf_tree_with_audio_byte_identical(trees):
    _, out = trees
    root, jres, tres = out["cmaf"]
    files = assert_same_files(root / "jax", root / "torch")
    assert {"master.m3u8", "manifest.mpd", "thumbnail.jpg", "original.mp4",
            "outputs.json", "rc_journal.jsonl"} <= set(files)
    for name in ("audio_128k", "audio_96k"):
        assert {f"{name}/init.mp4", f"{name}/playlist.m3u8",
                f"{name}/segment_00001.m4s"} <= set(files)
    master = files["master.m3u8"].decode()
    assert 'GROUP-ID="aud128"' in master and 'GROUP-ID="aud96"' in master
    assert 'mimeType="audio/mp4"' in files["manifest.mpd"].decode()
    manifest = json.loads(files["outputs.json"])["files"]
    assert "rc_journal.jsonl" not in manifest
    assert set(manifest) == set(files) - {"outputs.json", "rc_journal.jsonl"}
    assert tres.audio_renditions == jres.audio_renditions
    assert [a["name"] for a in tres.audio_renditions] == ["audio_128k",
                                                         "audio_96k"]


def test_hls_ts_tree_with_muxed_audio_byte_identical(trees):
    from vlog_tpu_torch.media.ts import AUDIO_PID

    _, out = trees
    root, jres, tres = out["hls_ts"]
    files = assert_same_files(root / "jax", root / "torch")
    segs = {k: v for k, v in files.items() if k.endswith(".ts")}
    assert len(segs) == 4 and not any(k.startswith("audio_") for k in files)
    for name, data in segs.items():
        pids = {((data[i + 1] & 0x1F) << 8) | data[i + 2]
                for i in range(0, len(data), 188)}
        assert len(data) % 188 == 0 and AUDIO_PID in pids, name
    assert tres.audio_renditions == [] == jres.audio_renditions


def test_cmaf_tree_with_the_ports_own_mdct(trees):
    import numpy as np

    from tests.test_audio_pipeline import tone
    from vlog_tpu_torch.codecs.aac import AacConfig, AacDecoder
    from vlog_tpu_torch.storage import integrity

    _, out = trees
    root, _, tres = out["cmaf_own"]
    want, got = (_files(root / d) for d in ("jax", "own"))
    assert set(got) == set(want)
    audio_segs = {k for k in got
                  if k.startswith("audio_") and k.endswith(".m4s")}
    assert len(audio_segs) == 6
    for rel in sorted(set(got) - audio_segs - {"outputs.json", JOURNAL}):
        assert got[rel] == want[rel], rel
    assert_journals_match(want[JOURNAL], got[JOURNAL])
    for rel in sorted(audio_segs):
        jd, td = ([s.duration for s in _segment_samples(r / rel)]
                  for r in (root / "jax", root / "own"))
        assert td == jd and set(td) == {1024}, rel
    jm = json.loads(want["outputs.json"])["files"]
    tm = json.loads(got["outputs.json"])["files"]
    assert set(tm) == set(jm)
    assert {k: v for k, v in tm.items() if k not in audio_segs} == \
        {k: v for k, v in jm.items() if k not in audio_segs}
    assert integrity.verify_tree(root / "own",
                                 integrity.load_manifest(root / "own")) == []
    # the 128 kbps rendition decodes to the source tone (the check of
    # tests/test_audio_pipeline.py::test_audio_segments_decode)
    dec = AacDecoder(AacConfig(sample_rate=48000, channels=2))
    pcm = np.concatenate([dec.decode_frame(s.data)
                          for rel in sorted(audio_segs)
                          if rel.startswith("audio_128k/")
                          for s in _segment_samples(root / "own" / rel)],
                         axis=1)
    ref = tone(48000, 1.0, 440)
    n = min(pcm.shape[1], ref.shape[0])
    assert np.corrcoef(pcm[0, 2048:n], ref[2048:n])[0, 1] > 0.9
    assert tres.audio_renditions == out["cmaf"][2].audio_renditions


@pytest.mark.parametrize("fmt", ["cmaf", "hls_ts", "cmaf_own"])
def test_db_rows_equal(trees, fmt):
    _, out = trees
    _, jres, tres = out[fmt]
    assert tres.to_db_rows() == jres.to_db_rows()
    assert tres.qualities == tres.to_db_rows()
    assert [q["audio_bitrate"] for q in tres.qualities] == [96_000, 128_000]
    assert {"probe", "original", "ladder", "audio", "verify",
            "manifest"} <= set(tres.step_s)


def test_resume_skips_original_and_complete_renditions(trees, tmp_path):
    """A second run over a finished tree copies nothing, re-encodes no
    rendition, and leaves every file as it was."""
    import shutil

    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.worker import process_video

    src, out = trees
    tree = tmp_path / "tree"
    shutil.copytree(out["cmaf_own"][2].out_dir, tree)
    stamps = {p: p.stat().st_mtime_ns for p in tree.rglob("*") if p.is_file()}
    before = {p: p.read_bytes() for p in stamps}
    res = process_video(src, tree, backend=TorchBackend(device="cpu"),
                        rungs=_rungs()[1], segment_duration_s=SEG_S)
    for p in (tree / "original.mp4", tree / "audio_128k" / "init.mp4",
              tree / "audio_96k" / "segment_00001.m4s"):
        assert p.stat().st_mtime_ns == stamps[p], p
    assert not any(k.startswith("audio_") for k in res.step_s)
    assert res.run.resumed_segments == 4
    after = {p: p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    assert after == before


def _doctored(run, **changes):
    """A copy of ``run`` whose first rung carries ``changes``."""
    import copy
    import dataclasses

    doc = copy.copy(run)
    doc.rungs = [dataclasses.replace(run.rungs[0], **changes)] + run.rungs[1:]
    return doc


@pytest.mark.parametrize("case", [
    "ts_expected", "missing_master", "overshoot_5_segments",
    "overshoot_10_segments", "av1_cap", "psnr_floor"])
def test_verify_output_gates_raise_with_jax_messages(trees, case, tmp_path):
    from vlog_tpu.worker import pipeline as jpipe
    from vlog_tpu_torch.worker import pipeline as tpipe

    _, out = trees
    root, _, tres = out["cmaf"]
    master = root / "torch" / "master.m3u8"
    run, expect_cmaf = tres.run, True
    if case == "ts_expected":
        expect_cmaf = False
    elif case == "missing_master":
        master = tmp_path / "master.m3u8"
    elif case == "overshoot_5_segments":
        run = _doctored(run, segment_count=5, target_bitrate=100_000,
                        achieved_bitrate=201_000)
    elif case == "overshoot_10_segments":
        run = _doctored(run, segment_count=10, target_bitrate=100_000,
                        achieved_bitrate=151_000)
    elif case == "av1_cap":
        run = _doctored(run, segment_count=12, target_bitrate=100_000,
                        achieved_bitrate=251_000, codec_string="av01.0.04M.08")
    else:
        run = _doctored(run, mean_psnr_y=17.9)
    msgs = []
    for mod in (jpipe, tpipe):
        with pytest.raises(mod.VerificationError) as exc:
            mod.verify_output(master, run, expect_cmaf=expect_cmaf)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    # just inside each cap, and at the floor, both pass
    if case.startswith(("overshoot", "av1")) or case == "psnr_floor":
        ok = _doctored(run, achieved_bitrate=run.rungs[0].target_bitrate,
                       mean_psnr_y=18.0)
        jpipe.verify_output(master, ok, expect_cmaf=True)
        tpipe.verify_output(master, ok, expect_cmaf=True)


def test_process_video_defaults_to_cuda_and_raises_without_it(
        trees, tmp_path, monkeypatch):
    """No CPU fall back: ``backend=None`` selects on ``"cuda"``."""
    import torch

    from vlog_tpu_torch.backends import base
    from vlog_tpu_torch.worker import process_video

    src, _ = trees
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(base, "_SELECTED", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        process_video(src, tmp_path / "out")
    assert os.listdir(tmp_path / "out") == ["original.mp4"]
