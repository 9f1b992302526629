"""The intra-only path (``gop_mode="intra"``) and the CAVLC coder of the
port against the JAX package.

- ``ladder_encode_program`` against the JAX one on seeded frames: int16
  levels identical, ``sse_y`` within rtol 1e-5 (float32 sums in another
  order; ROADMAP Queue C item 2).
- The CAVLC slice writers against the JAX package's on the levels of
  seeded intra and P frames: identical NAL bytes.
- Whole trees: TorchBackend(device="cpu") against JaxBackend on the tiny
  Y4M (setup of tests/test_torch_backend.py; 30 frames in batches of 8,
  so the tail batch is padded), under CABAC and CAVLC, at constant QP
  and with rate control. Intra batches post no bit-proxy cost, so here
  even the journal is byte-identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_backend import (JOURNAL, _files, assert_same_files,  # noqa: F401
                                      one_torch_thread, run_both)

RUNGS = (("96p", 96, 128, 30), ("48p", 48, 64, 34))


def _frames(seed: int, n: int = 3, h: int = 96, w: int = 128):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    # smooth the luma so the levels are not all escapes
    y = ((y.astype(np.int32) + np.roll(y, 1, -1) + np.roll(y, 1, -2)) // 3
         ).astype(np.uint8)
    u = rng.integers(100, 156, (n, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(100, 156, (n, h // 2, w // 2), dtype=np.uint8)
    return y, u, v


def test_ladder_encode_program_matches_jax():  # slowlane-ok: 96x128 source, 3 frames, two small rungs
    from vlog_tpu.parallel.ladder import ladder_encode_program as jax_program
    from vlog_tpu_torch.parallel.ladder import ladder_encode_program

    y, u, v = _frames(seed=5)
    qps = {"96p": np.array([30, 26, 34], np.int32),
           "48p": np.array([34, 34, 22], np.int32)}
    jfn, jmats = jax_program(RUNGS, 96, 128)  # slowlane-ok: tiny shapes
    want = jfn(y, u, v, jmats, qps)
    tfn, tmats = ladder_encode_program(RUNGS, 96, 128, device="cpu")  # slowlane-ok: plain PyTorch on CPU
    got = tfn(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
              tmats, qps)
    for name, *_ in RUNGS:
        for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac"):
            assert got[name][k].dtype == torch.int16
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(want[name][k]),
                                          err_msg=f"{name} {k}")
        np.testing.assert_allclose(got[name]["sse_y"].numpy(),
                                   np.asarray(want[name]["sse_y"]), rtol=1e-5)


def test_cavlc_slices_match_jax():
    from vlog_tpu.codecs.h264 import cavlc as jcavlc
    from vlog_tpu.codecs.h264.encoder import FrameLevels as JLevels
    from vlog_tpu_torch.codecs.h264 import cavlc
    from vlog_tpu_torch.codecs.h264.encoder import FrameLevels, encode_frame
    from vlog_tpu_torch.codecs.h264.inter import encode_p_frame

    y, u, v = (torch.from_numpy(p) for p in _frames(seed=9, n=2))
    qp = torch.tensor([24], dtype=torch.int32)
    i = encode_frame(y[:1], u[:1], v[:1], qp=qp)
    arrs = [i[k][0].numpy().astype(np.int32)
            for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")]
    for idr, frame_num in ((True, 0), (False, 3)):
        got = cavlc.encode_slice(FrameLevels(*arrs, 24), qp=24, init_qp=26,
                                 frame_num=frame_num, idr=idr, idr_pic_id=1)
        want = jcavlc.encode_slice(JLevels(*arrs, 24), qp=24, init_qp=26,
                                   frame_num=frame_num, idr=idr, idr_pic_id=1)
        assert got.to_bytes() == want.to_bytes()
    p = encode_p_frame(y[1:], u[1:], v[1:], i["recon_y"], i["recon_u"],
                       i["recon_v"], qp=qp, search=8)
    plev = {k: p[k][0].numpy().astype(np.int32)
            for k in ("luma", "chroma_dc", "chroma_ac", "mv")}
    assert np.abs(plev["mv"]).max() > 0
    for deblock in (False, True):
        got = cavlc.encode_p_slice(plev, qp=25, init_qp=26, frame_num=1,
                                   deblock=deblock)
        want = jcavlc.encode_p_slice(plev, qp=25, init_qp=26, frame_num=1,
                                     deblock=deblock)
        assert got.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("entropy", ["cabac", "cavlc"])
@pytest.mark.parametrize("bitrate", [0, 150_000])
def test_intra_tree_byte_identical(tmp_path, monkeypatch, entropy, bitrate):
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "H264_ENTROPY", entropy)
    jres, tres = run_both(tmp_path, monkeypatch, bitrate, gop_mode="intra")
    assert tres.gop_len == 1
    got = assert_same_files(tmp_path / "jax", tmp_path / "torch")
    # intra posts no cost: the journal is byte-identical too
    assert got[JOURNAL] == _files(tmp_path / "jax")[JOURNAL]
    assert sum(k.endswith(".m4s") for k in got) == 6
    tag = got["96p/encoder.tag"].decode()
    assert tag == f"h264:{entropy}:deblock=0:gop=1"
    for j, t in zip(jres.rungs, tres.rungs):
        assert t.codec_string == j.codec_string
        assert t.achieved_bitrate == j.achieved_bitrate
        assert t.mean_psnr_y == pytest.approx(j.mean_psnr_y, rel=1e-5)
    assert tres.rungs[0].codec_string.startswith(
        "avc1.4D" if entropy == "cabac" else "avc1.42")


def test_cavlc_chain_tree_byte_identical(tmp_path, monkeypatch):
    """VLOG_H264_ENTROPY=cavlc on the default I+P path (Baseline SPS,
    CAVLC P slices)."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "H264_ENTROPY", "cavlc")
    _, tres = run_both(tmp_path, monkeypatch, 0, n_frames=20)
    assert tres.gop_len == 10
    got = assert_same_files(tmp_path / "jax", tmp_path / "torch")
    assert got["64p/encoder.tag"] == b"h264:cavlc:deblock=1:gop=10"
