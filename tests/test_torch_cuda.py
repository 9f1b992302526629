"""Card-only tests of the PyTorch port: the CUDA resize kernel against
its plain version (the ladder's shapes and the sprite tiles'), the
integer stages and the decoder's device functions on CUDA against the
CPU, the HEVC chain program and deblocking filter on CUDA against the
CPU, the sprite worker, Whisper, the AAC encoder and ``process_video``
on the card, and the device runtime: the executor's event/stream copies
against ``.cpu()``, a pull that does not wait for a later batch's
kernels, and the scheduler's CUDA probe.

Marked ``cuda``; each test skips (in its fixture) without a CUDA
device. On a machine with a card and without JAX, run them alone:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance for the resize: |diff| <= 1 and at most 0.1% of pixels (two
float32 summation orders); the integer stages are bit-exact. At the 1080p
ladder's shapes the kernel's pixels that differ from the plain version
are counted exactly: the banded kernel sums the same products in the
same order as the dense kernel it replaced, so the counts of that
kernel's run stay.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from vlog_tpu_torch.ops import fused_resize
from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix

pytestmark = pytest.mark.cuda

# (source, rung) of every plane call of one 1080p-ladder dispatch, in the
# order chip_smoke.py draws them, and the pixels (of 24 frames) that the
# dense kernel differed from the plain version by, with seed 1234
_SLICE = [((1080, 1920), (720, 1280)), ((540, 960), (360, 640)),
          ((1080, 1920), (480, 854)), ((540, 960), (240, 427)),
          ((1080, 1920), (360, 640)), ((540, 960), (180, 320))]
_SLICE_DIFFS = [0, 23, 0, 20, 33, 10]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _diff(got, want):
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int(diff.max()), int((diff > 0).sum())


def _check_against_plain(x, a_h, a_w):
    before = fused_resize.launches
    got = fused_resize.fused_resize_plane(x, a_h, a_w)
    assert fused_resize.LAUNCHES_PER_CALL == 1
    assert fused_resize.launches == before + 1
    want = apply_resize_matrices(x, a_h, a_w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.uint8
    max_abs, n_diff = _diff(got, want)
    assert max_abs <= 1 and n_diff <= 1e-3 * got.numel()
    return got, n_diff


@pytest.mark.parametrize("n,src,dst,filt", [
    (3, (64, 96), (24, 32), "lanczos3"),          # tiny
    (2, (540, 960), (240, 427), "lanczos3"),      # the 480p rung's odd-width chroma
    (1, (2160, 3840), (1080, 1920), "lanczos3"),  # a 4K source
    (4, (37, 53), (50, 70), "lanczos3"),          # upscale, ragged tiles
    *[(24, src, dst, "lanczos3") for src, dst in _SLICE],
    *[(24, src, dst, f) for f in ("bilinear", "box")
      for src, dst in (_SLICE[4], _SLICE[3])],
])
def test_kernel_matches_plain_version(cuda, n, src, dst, filt):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, 256, (n,) + src, generator=g, device=cuda,
                      dtype=torch.uint8)
    a_h = torch.as_tensor(resample_matrix(src[0], dst[0], filt), device=cuda)
    a_w = torch.as_tensor(resample_matrix(src[1], dst[1], filt), device=cuda)
    _check_against_plain(x, a_h, a_w)


def test_kernel_walks_a_dense_matrix_in_chunks(cuda):
    """Row-normalised random matrices: every band is the whole row, wider
    than one shared-memory chunk on both axes."""
    rng = np.random.default_rng(8)
    a_h, a_w = (rng.random(shape).astype(np.float32) for shape in
                ((48, 300), (96, 700)))
    a_h, a_w = (torch.as_tensor(a / a.sum(1, keepdims=True), device=cuda)
                for a in (a_h, a_w))
    x = torch.as_tensor(rng.integers(0, 256, (4, 300, 700), dtype=np.uint8),
                        device=cuda)
    got, _ = _check_against_plain(x, a_h, a_w)
    # a second call with the same matrices reuses their band form
    again = fused_resize.fused_resize_plane(x, a_h, a_w)
    assert torch.equal(again, got)


def test_slice_shapes_differ_from_plain_as_the_dense_kernel_did(cuda):
    g = torch.Generator(device=cuda).manual_seed(1234)
    counts = []
    for src, dst in _SLICE:
        x = torch.randint(0, 256, (24,) + src, generator=g, device=cuda,
                          dtype=torch.uint8)
        a_h = torch.as_tensor(resample_matrix(src[0], dst[0]), device=cuda)
        a_w = torch.as_tensor(resample_matrix(src[1], dst[1]), device=cuda)
        counts.append(_check_against_plain(x, a_h, a_w)[1])
    assert counts == _SLICE_DIFFS


def test_kernel_rejects_bad_inputs(cuda):
    x = torch.zeros((1, 8, 8), dtype=torch.float32, device=cuda)
    a = torch.zeros((4, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        fused_resize.fused_resize_plane(x, a, a)
    with pytest.raises(ValueError, match="device"):
        fused_resize.fused_resize_plane(x.to(torch.uint8), a.cpu(), a)


def test_chain_program_cpu_and_cuda_identical(cuda):
    """Identity rung (no resize): every integer output of the chain
    program, rate adaptation included, is the same on CPU and CUDA."""
    from vlog_tpu_torch.parallel.ladder import ladder_chain_program

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float32)
    frames = [np.clip(120 + 60 * np.sin((xx + 3 * t) / 7.0)
                      * np.cos((yy + t) / 5.0) + rng.normal(0, 3, xx.shape),
                      0, 255) for t in range(6)]
    y = np.stack(frames).astype(np.uint8).reshape(2, 3, 64, 96)
    u = np.full((2, 3, 32, 48), 120, np.uint8)
    v = np.full((2, 3, 32, 48), 136, np.uint8)
    rungs = (("64p", 64, 96, 28),)
    qps = {"64p": np.full((2, 3), 28, np.int32)}
    rc = {"64p": {"budget": np.float32(30.0), "alpha": np.float32(0.3)}}
    outs = {}
    for dev in ("cpu", cuda):
        fn, mats = ladder_chain_program(rungs, 64, 96, search=4, deblock=True,
                                        device=dev)
        outs[str(dev)] = {k: t.cpu().numpy() for k, t in
                          fn(*(torch.as_tensor(p, device=dev) for p in (y, u, v)),
                             mats, qps, rc)["64p"].items()}
    for k, want in outs["cpu"].items():
        if k in ("sse_y", "cost"):
            np.testing.assert_allclose(outs["cuda"][k], want, rtol=1e-5)
        else:
            np.testing.assert_array_equal(outs["cuda"][k], want, err_msg=k)


def test_thumbnail_float_stages_cpu_and_cuda_identical(cuda):
    """The thumbnail's float stages after the resize (BT.709 RGB, the JPEG
    colour conversion and FDCT + quantization) give the same bits on CPU
    and CUDA from the same planes, and so the same JPEG bytes."""
    from vlog_tpu_torch.codecs.jpeg.encoder import (dct_quantize_420,
                                                    encode_jpeg_rgb,
                                                    rgb_to_jpeg_planes)
    from vlog_tpu_torch.ops.colorspace import yuv420_to_rgb

    rng = np.random.default_rng(12)
    y = rng.integers(0, 256, (720, 1280), dtype=np.uint8)
    u = rng.integers(0, 256, (360, 640), dtype=np.uint8)
    v = rng.integers(0, 256, (360, 640), dtype=np.uint8)
    outs = {}
    for dev in ("cpu", cuda):
        planes = [torch.as_tensor(p, device=dev) for p in (y, u, v)]
        rgb = yuv420_to_rgb(*planes, standard="bt709")
        rgb8 = (rgb * 255).to(torch.uint8)
        jp = rgb_to_jpeg_planes(rgb8)
        outs[str(dev)] = {
            "rgb": rgb.cpu().numpy().view(np.uint32),
            **{f"plane{i}": p.cpu().numpy() for i, p in enumerate(jp)},
            **{f"coef{i}": c.cpu().numpy()
               for i, c in enumerate(dct_quantize_420(*jp, quality=85))},
            "jpeg": np.frombuffer(encode_jpeg_rgb(rgb8, quality=85), np.uint8)}
    for k, want in outs["cpu"].items():
        np.testing.assert_array_equal(outs["cuda"][k], want, err_msg=k)


# Sprite tiles of a 1080p source (160x90, chroma 80x45: an odd height)
# at the frame counts generate_sprites calls with: a full decode chunk
# of 8 and a partial last chunk
_SPRITE = [((1080, 1920), (90, 160)), ((540, 960), (45, 80))]


@pytest.mark.parametrize("n", [8, 3])
@pytest.mark.parametrize("src,dst", _SPRITE)
def test_kernel_at_sprite_tile_shapes(cuda, n, src, dst):
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    x = torch.randint(0, 256, (n,) + src, generator=g, device=cuda,
                      dtype=torch.uint8)
    a_h = torch.as_tensor(resample_matrix(src[0], dst[0]), device=cuda)
    a_w = torch.as_tensor(resample_matrix(src[1], dst[1]), device=cuda)
    _check_against_plain(x, a_h, a_w)


def _decoder_cases(seed: int, mbh: int = 4, mbw: int = 5):
    """Seeded intra levels (3 frames), P levels with the largest accepted
    MVs (+-128 quarter pels) at the corner MBs, reference planes."""
    rng = np.random.default_rng(seed)

    def lv(shape, hi, p_zero):
        a = rng.integers(-hi, hi + 1, shape).astype(np.int32)
        return np.where(rng.random(shape) < p_zero, 0, a).astype(np.int32)

    intra = {"luma_dc": lv((3, mbh, mbw, 4, 4), 40, 0.3),
             "luma_ac": lv((3, mbh, mbw, 4, 4, 4, 4), 6, 0.7),
             "chroma_dc": lv((3, 2, mbh, mbw, 2, 2), 30, 0.3),
             "chroma_ac": lv((3, 2, mbh, mbw, 2, 2, 4, 4), 5, 0.8)}
    mv = rng.integers(-128, 129, (mbh, mbw, 2)).astype(np.int32)
    for (r, c), val in zip(((0, 0), (0, -1), (-1, 0), (-1, -1)),
                           ((-128, -128), (-128, 128), (128, -128), (128, 128))):
        mv[r, c] = val
    p = {"luma": lv((mbh, mbw, 4, 4, 4, 4), 8, 0.7),
         "chroma_dc": lv((2, mbh, mbw, 2, 2), 20, 0.4),
         "chroma_ac": lv((2, mbh, mbw, 2, 2, 4, 4), 5, 0.8), "mv_q": mv}
    h, w = 16 * mbh, 16 * mbw
    ref = (rng.integers(0, 256, (h, w), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    return intra, p, ref


def test_decoder_device_functions_cpu_and_cuda_identical(cuda):
    from vlog_tpu_torch.codecs.h264 import decoder as dec

    intra, p, ref = _decoder_cases(21)
    outs = {}
    for dev in ("cpu", cuda):
        got = {}
        gop = dec.reconstruct_gop(intra, qp=29, device=dev)
        one = dec.reconstruct_frame({k: v[1] for k, v in intra.items()},
                                    qp=17, device=dev)
        rec = dec.reconstruct_p_frame(p, *ref, qp=36, device=dev)
        got.update({f"gop{i}": t for i, t in enumerate(gop)})
        got.update({f"frame{i}": t for i, t in enumerate(one)})
        got.update({f"p{i}": t for i, t in enumerate(rec)})
        for is_p in (False, True):
            planes = dec.deblock_decoded(*rec, p, qp=36, is_p=is_p)
            got.update({f"db{int(is_p)}{i}": t for i, t in enumerate(planes)})
        for k, t in got.items():
            assert t.device.type == torch.device(dev).type, k
        outs[str(dev)] = {k: t.cpu().numpy() for k, t in got.items()}
    for k, want in outs["cpu"].items():
        np.testing.assert_array_equal(outs["cuda"][k], want, err_msg=k)


def test_sprites_on_the_card(cuda, tmp_path):
    """generate_sprites on CUDA: one kernel launch per plane per chunk,
    tiles within the resize bound of the CPU path's, the same VTT."""
    from pathlib import Path

    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.worker import sprites

    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (180, 320), dtype=np.uint8),
               rng.integers(0, 256, (90, 160), dtype=np.uint8),
               rng.integers(0, 256, (90, 160), dtype=np.uint8))
              for _ in range(11)]
    src = tmp_path / "s.y4m"
    write_y4m(src, frames, fps_num=10, fps_den=1)
    before = fused_resize.launches
    card = sprites.generate_sprites(src, tmp_path / "card", interval_s=0.1,
                                    device="cuda")
    assert fused_resize.launches - before == 2 * 3     # chunks of 8 and 3
    cpu = sprites.generate_sprites(src, tmp_path / "cpu", interval_s=0.1,
                                   device="cpu")
    assert card.tile_count == cpu.tile_count == 11
    assert Path(card.vtt_path).read_bytes() == Path(cpu.vtt_path).read_bytes()
    mats = {dev: sprites._tile_mats(180, 320, 90, 160, torch.device(dev))
            for dev in ("cpu", "cuda")}
    for dev_planes in (frames[:8], frames[8:]):
        x = [np.stack([f[i] for f in dev_planes]) for i in range(3)]
        got = fused_resize.resize_yuv420(
            *(torch.as_tensor(p, device=cuda) for p in x), mats["cuda"])
        want = fused_resize.resize_yuv420(
            *(torch.as_tensor(p) for p in x), mats["cpu"])
        for g, w in zip(got, want):
            max_abs, n_diff = _diff(g.cpu(), w)
            assert max_abs <= 1 and n_diff <= 1e-3 * w.numel()


# --------------------------------------------------------------------------
# Whisper (asr/) on the card against the CPU path, tiny widths
# --------------------------------------------------------------------------

# float32 on both sides, TF32 off: sums in other orders only. Bounds on
# mel features (about [-1, 2]), encoder states and logits relative to
# their largest magnitude; tokens must be equal.
_ASR_MEL_MAX_ABS = 1e-4
_ASR_RTOL = 1e-4


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vlog_tpu_torch.asr.model import WhisperConfig
    from vlog_tpu_torch.asr.synthetic import write_checkpoint

    cfg = WhisperConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=2, decoder_attention_heads=2,
                        encoder_ffn_dim=128, decoder_ffn_dim=128,
                        vocab_size=51865, max_target_positions=64)
    return write_checkpoint(tmp_path_factory.mktemp("whisper"), cfg, seed=3)


def _asr_windows(n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    t = np.arange(16000 * 10) / 16000
    out = np.zeros((n, 480000), np.float32)
    for i in range(n):
        out[i, :t.size] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                           * (1 + np.sin(2 * np.pi * 3 * t))
                           + rng.normal(0, 0.02, t.size))
    return out


def test_whisper_card_matches_cpu(cuda, whisper_dir):
    from vlog_tpu_torch.asr import decode, load, mel, model

    audio = _asr_windows(2)
    cpu = load.load_whisper(whisper_dir, device="cpu")
    card = load.load_whisper(whisper_dir, device="cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    m_cpu = mel.log_mel_spectrogram(audio, device="cpu")
    m_card = mel.log_mel_spectrogram(audio, device="cuda")
    assert (m_card.cpu() - m_cpu).abs().max() <= _ASR_MEL_MAX_ABS
    e_cpu = model.encode(cpu.model, m_cpu)
    e_card = model.encode(card.model, m_card)
    assert (e_card.cpu() - e_cpu).abs().max() <= _ASR_RTOL * e_cpu.abs().max()
    toks = torch.tensor([[50258, 50259, 50359, 11, 500, 50364, 50400]] * 2)
    l_cpu = model.decode_logits(cpu.model, toks, e_cpu)
    l_card = model.decode_logits(card.model, toks.cuda(), e_card)
    assert (l_card.cpu() - l_cpu).abs().max() <= _ASR_RTOL * l_cpu.abs().max()
    for beam in (1, 5):
        want, _ = decode.generate_batch(cpu, m_cpu, beam=beam)
        got, _ = decode.generate_batch(card, m_card, beam=beam)
        np.testing.assert_array_equal(got, want, err_msg=f"beam {beam}")
    assert decode.detect_language(card, m_card) == \
        decode.detect_language(cpu, m_cpu)


def test_whisper_solo_and_packed_tokens_identical_on_the_card(cuda,
                                                             whisper_dir):
    from vlog_tpu_torch.asr import decode, load, mel

    card = load.load_whisper(whisper_dir, device="cuda")
    feats = mel.log_mel_spectrogram(_asr_windows(8), device="cuda")
    for beam in (1, 5):
        packed, _ = decode.generate_batch(card, feats, beam=beam)
        for row in (0, 5):
            solo, _ = decode.generate_batch(card, feats[row:row + 1],
                                            beam=beam)
            np.testing.assert_array_equal(solo[0], packed[row],
                                          err_msg=f"beam {beam} row {row}")


# --------------------------------------------------------------------------
# The AAC encoder and process_video on the card
# --------------------------------------------------------------------------

def test_aac_encoder_card_matches_cpu(cuda):
    """forward_mdct within 1e-5 of max |X| of the CPU's (float32 sums in
    other orders); the encoders' payloads identical, or held to the
    bound chip_smoke.py states (total bytes within 1%, SNRs within
    0.1 dB) where a level flips."""
    import chip_smoke
    from vlog_tpu_torch.codecs.aac.mdct import forward_mdct

    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.rand((2, 96, 2048), generator=g, device=cuda) * 65536 - 32768
    got, want = forward_mdct(x).cpu(), forward_mdct(x.cpu())
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    row = chip_smoke._aac_card_vs_cpu(chip_smoke._av_audio(1.0, 7), 128_000)
    assert row["payloads"][0] == row["payloads"][1] == 48
    if row["differing_payloads"]:
        (b_card, b_cpu), (s_card, s_cpu) = row["bytes"], row["snr_db"]
        assert abs(b_card - b_cpu) <= chip_smoke.AAC_BYTES_RTOL * b_cpu, row
        assert abs(s_card - s_cpu) <= chip_smoke.AAC_SNR_DB_TOL, row


def test_process_video_on_the_card(cuda, tmp_path, monkeypatch):
    """A tiny A/V MP4 (the port's 96x128 intra rung plus an AAC track)
    through ``process_video`` with the defaults' device: the backend
    selected on the card, a scaled rung through the kernel, the audio
    group, ``outputs.json`` verifying the tree; the CPU run of the same
    upload writes the same files with the same rows but the bytes."""
    import chip_smoke
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends import base
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker import process_video

    y, u, v = chip_smoke._smooth_frames(8, 96, 128, seed=2)
    y4m = tmp_path / "src.y4m"
    write_y4m(y4m, list(zip(y, u, v)), fps_num=8, fps_den=1)
    ident = config.QualityRung("96p", 96, 0, 128_000, base_qp=28)
    cpu = TorchBackend(device="cpu")
    cpu.run(cpu.plan(get_video_info(y4m), (ident,), tmp_path / "cmaf",
                     gop_mode="intra", thumbnail=False))
    mp4 = chip_smoke._cmaf_to_mp4(tmp_path / "cmaf" / "96p", 8,
                                  tmp_path / "av.mp4")
    rungs = (ident, config.QualityRung("64p", 64, 150_000, 96_000,
                                       base_qp=30))
    monkeypatch.setattr(base, "_SELECTED", {})
    before = fused_resize.launches
    card = process_video(mp4, tmp_path / "card", rungs=rungs,
                         segment_duration_s=0.5)
    # the 64p rung's 3 planes, one dispatch of two 4-frame chains
    assert fused_resize.launches - before == 3
    assert base._SELECTED["cuda"].device.type == "cuda"
    host = process_video(mp4, tmp_path / "cpu", rungs=rungs, device="cpu",
                         segment_duration_s=0.5)
    for res, root in ((card, tmp_path / "card"), (host, tmp_path / "cpu")):
        assert [a["name"] for a in res.audio_renditions] == ["audio_128k",
                                                             "audio_96k"]
        assert integrity.verify_tree(root, integrity.load_manifest(root)) == []
        assert all(r.mean_psnr_y > 30 for r in res.run.rungs)
    assert sorted(p.relative_to(tmp_path / "card") for p in
                  (tmp_path / "card").rglob("*")) == \
        sorted(p.relative_to(tmp_path / "cpu") for p in
               (tmp_path / "cpu").rglob("*"))
    strip = lambda rows: [{k: r[k] for k in ("quality", "width", "height",  # noqa: E731
                                             "codec_string", "audio_bitrate",
                                             "segment_count")} for r in rows]
    assert strip(card.qualities) == strip(host.qualities)


def test_hevc_chain_program_cpu_and_cuda_identical(cuda):  # slowlane-ok: one 96x128 rung
    """The HEVC ladder step on an identity rung (no resize), deblock and
    the rate cascade on: levels, MVs, ``qp_eff`` identical on CPU and
    CUDA (``sse_y`` and ``cost``, float32 sums, within 1e-5); the chain
    DSP's reconstructions too."""
    import chip_smoke
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp
    from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_program

    y, u, v = (p.reshape((2, 3) + p.shape[1:])
               for p in chip_smoke._smooth_frames(6, 96, 128, seed=4))
    rungs = (("96p", 96, 128, 28),)
    qps = {"96p": np.array([[28, 29, 30], [34, 33, 35]], np.int32)}
    rc = {"96p": {"budget": np.float32(200.0), "alpha": np.float32(0.4)}}
    outs, recons = {}, {}
    for dev in ("cpu", cuda):
        planes = [torch.as_tensor(p, device=dev) for p in (y, u, v)]
        fn, mats = hevc_chain_ladder_program(rungs, 96, 128, search=8,
                                             deblock=True, device=dev)
        outs[str(dev)] = {k: t.cpu().numpy() for k, t in
                          fn(*planes, mats, qps, rc)["96p"].items()}
        q = torch.as_tensor(qps["96p"], device=dev)
        res = encode_chain_dsp(*planes, 8, q[:, 0] - 2, q[:, 1:], True, True,
                               rc["96p"])
        recons[str(dev)] = [t.cpu().numpy() for t in res[0][1] + res[1][4]]
    for k, want in outs["cpu"].items():
        if k in ("sse_y", "cost"):
            np.testing.assert_allclose(outs["cuda"][k], want, rtol=1e-5)
        else:
            np.testing.assert_array_equal(outs["cuda"][k], want, err_msg=k)
    for a, b in zip(recons["cpu"], recons["cuda"]):
        np.testing.assert_array_equal(a, b)


def test_hevc_deblock_picture_cpu_and_cuda_identical(cuda):
    """Spec 8.7.2 on the card: intra (luma and chroma) and P boundary
    strengths from random partitions, cbf and MVs."""
    from vlog_tpu_torch.codecs.hevc import deblock as dbk

    rng = np.random.default_rng(9)
    n, rr, cc = 2, 3, 4
    h, w = 32 * rr, 32 * cc

    def blocky(hh, ww, cell):
        base = np.kron(rng.integers(50, 206, (n, hh // cell, ww // cell)),
                       np.ones((1, cell, cell)))
        return np.clip(base + rng.integers(-2, 3, (n, hh, ww)), 0, 255
                       ).astype(np.int32)

    y, u, v = blocky(h, w, 8), blocky(h // 2, w // 2, 8), blocky(h // 2, w // 2, 4)
    part = rng.integers(0, 3, (n, rr, cc)).astype(np.int32)
    cbf = rng.random((n, 2 * rr, 2 * cc)) < 0.5
    mv = rng.integers(-6, 7, (n, 2 * rr, 2 * cc, 2)).astype(np.int32)
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, device=dev)    # noqa: E731
        qp, qpc = t(np.array([30, 45], np.int32)), t(np.array([29, 39], np.int32))
        ibv, ibh = dbk.intra_bs(rr, cc, dev)
        pbv, pbh = dbk.p_bs(t(part), t(cbf), t(mv))
        got = dbk.deblock_picture(t(y), t(u), t(v), qp=qp, qpc=qpc, bs_v=ibv,
                                  bs_h=ibh, chroma=True)
        got += dbk.deblock_picture(t(y), t(u), t(v), qp=qp, qpc=qpc, bs_v=pbv,
                                   bs_h=pbh, chroma=False)
        outs[str(dev)] = [a.cpu().numpy() for a in got + (pbv, pbh)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


def test_executor_pull_equals_cpu_copy(cuda):
    """The executor's copies (an event on the compute stream, pinned
    buffers filled on its copy stream, a second event per rung) read the
    same values as ``.cpu()``, at depths 1 and 2, in batch order."""
    from vlog_tpu_torch.parallel.executor import PipelineExecutor, dispatch_stream

    g = torch.Generator(device=cuda).manual_seed(5)
    batches = [{r: {"a": torch.randint(-300, 300, (3, 17, 29), generator=g,
                                       device=cuda, dtype=torch.int16),
                    "b": torch.rand(4, 5, generator=g, device=cuda)}
                for r in ("x", "y")} for _ in range(4)]
    want = [{r: {k: t.cpu().numpy() for k, t in rung.items()}
             for r, rung in b.items()} for b in batches]
    for depth in (1, 2):
        got: dict = {"x": [], "y": []}
        pipe = PipelineExecutor(
            ["x", "y"], pull=lambda name, b: b.d2h.host(name),
            process=lambda name, b, host: got[name].append((b.index, host)),
            ready=lambda b: b.d2h.wait_compute(), depth=depth, host_threads=1)
        try:
            with dispatch_stream(cuda):
                for b in batches:
                    pipe.reserve()
                    # a fresh copy made on the compute stream, freed here
                    outs = {r: {k: t * 1 for k, t in rung.items()}
                            for r, rung in b.items()}
                    pipe.submit(outs, n_real=1)
                    del outs
            pipe.drain()
        finally:
            pipe.close()
        for name in ("x", "y"):
            assert [i for i, _ in got[name]] == [0, 1, 2, 3]
            for i, host in got[name]:
                for k in ("a", "b"):
                    np.testing.assert_array_equal(host[k], want[i][name][k])


def test_pull_does_not_wait_for_later_kernels(cuda):
    """A batch's pull waits on its own events only: with a long kernel
    queued on the compute stream after batch 0 was submitted, batch 0's
    ready + pull return while that kernel still runs (``.cpu()`` would
    wait for it)."""
    from vlog_tpu_torch.parallel.executor import dispatch_stream, start_d2h

    x = torch.arange(1 << 16, dtype=torch.int32, device=cuda)
    copy_stream = torch.cuda.Stream(cuda)
    with dispatch_stream(cuda):
        d2h = start_d2h({"r": {"v": x * 3}}, copy_stream)
        torch.cuda._sleep(4_000_000_000)        # about 2 s of one SM's clock
        after = torch.cuda.Event()
        after.record()
    t0 = time.perf_counter()
    d2h.wait_compute()
    host = d2h.host("r")
    waited = time.perf_counter() - t0
    still_running = not after.query()
    after.synchronize()
    np.testing.assert_array_equal(host["v"], np.arange(1 << 16) * 3)
    assert still_running, f"the pull waited for the later kernel ({waited:.3f}s)"
    assert waited < 0.5


def test_scheduler_cuda_probe(cuda):
    """The default device list is the visible CUDA devices, and the
    reinstatement probe (arange(8) on the device, summed, pulled) passes
    on a healthy card and heals a quarantined one."""
    from vlog_tpu_torch.parallel import scheduler

    assert scheduler._default_probe(cuda) is True
    sched = scheduler.MeshScheduler(slots=1)
    assert sched.devices == tuple(torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count()))
    t = sched.admit()
    lease = t.acquire()
    sched.report_device_fault(lease)
    t.close()
    assert sched.snapshot()["quarantined"] == len(sched.devices)
    assert all(sched.probe_quarantined().values())
    assert sched.snapshot()["healthy"] == len(sched.devices)


def test_daemon_poll_once_on_the_card(cuda, tmp_path):
    """The port's worker daemon on its default device: a tiny transcode
    claimed from a sqlite queue runs on the card (the selected backend's
    device, one scaled rung through the kernel), reaches ready, and its
    heartbeat advertises the card."""
    import asyncio
    import json

    import chip_smoke
    from vlog_tpu_torch import config
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.jobs import claims, videos as vids
    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.worker.daemon import WorkerDaemon

    y, u, v = chip_smoke._smooth_frames(8, 96, 128, seed=2)
    src = tmp_path / "src.y4m"
    write_y4m(src, list(zip(y, u, v)), fps_num=8, fps_den=1)
    rungs = (config.QualityRung("96p", 96, 0, 128_000, base_qp=28),
             config.QualityRung("64p", 64, 150_000, 96_000, base_qp=30))

    async def go():
        db = Database(f"sqlite:///{tmp_path / 'q.db'}")
        await db.connect()
        await create_all(db)
        video = await vids.create_video(db, "Card", source_path=str(src))
        job_id = await claims.enqueue_job(db, video["id"])
        from vlog_tpu_torch.backends.torch_backend import TorchBackend

        daemon = WorkerDaemon(db, name="card-w", video_dir=tmp_path / "v",
                              backend=TorchBackend())
        assert daemon.device == "cuda"
        before = fused_resize.launches
        saved = config.ladder_for_source
        config.ladder_for_source = lambda h: rungs
        try:
            assert await daemon.poll_once() is True
            await daemon._heartbeat()
        finally:
            config.ladder_for_source = saved
        launches = fused_resize.launches - before
        row = await vids.get_video(db, video["id"])
        job = await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                 {"i": job_id})
        worker = await db.fetch_one("SELECT * FROM workers")
        await db.disconnect()
        return launches, row, job, json.loads(worker["capabilities"])

    launches, row, job, caps = asyncio.run(go())
    assert job["completed_at"] is not None and job["progress"] == 100.0
    assert row["status"] == "ready"
    # the 64p rung's 3 planes, one dispatch (a thumbnail of a source
    # narrower than 1280 is not resized)
    assert launches == 3
    assert caps["backend"] == "torch" and caps["device_kind"] == "gpu"
    assert caps["devices"] == [torch.cuda.get_device_name(0)]


def test_mgmt_device_info_before_and_after_cuda_init(cuda):
    """``get_metrics``' device summary never initializes CUDA: before
    this process touches the card it says so; after, it reports the
    platform, the device count and the allocator's bytes."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = ("import json, torch\n"
            "from vlog_tpu_torch.worker import mgmt\n"
            "a = mgmt._device_info()\n"
            "init = torch.cuda.is_initialized()\n"
            "x = torch.ones(1 << 20, device='cuda')\n"
            "print(json.dumps([a, init, mgmt._device_info()]))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    before, init_after_probe, after = json.loads(out.stdout.splitlines()[-1])
    assert before == {"initialized": False} and init_after_probe is False
    assert after["initialized"] is True and after["platform"] == "cuda"
    assert after["device_count"] == torch.cuda.device_count()
    assert after["bytes_in_use"] >= 4 << 20
    assert after["bytes_limit"] > after["bytes_in_use"]


def test_compute_stream_reused_across_runs(cuda):
    """Every run's dispatch queues on the device's one compute stream: a
    stream per run would leave a cuBLAS workspace allocated for each new
    (handle, stream) pair, run after run."""
    from vlog_tpu_torch.parallel.executor import dispatch_stream

    a = torch.randn(64, 64, dtype=torch.float64, device=cuda)
    streams, allocated = [], []
    for _ in range(3):
        with dispatch_stream(cuda):
            streams.append(torch.cuda.current_stream())
            float((a @ a).sum())
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert streams[0] == streams[1] == streams[2] != torch.cuda.default_stream()
    assert allocated[1] == allocated[2] <= allocated[0]
