"""Card-only tests of the PyTorch port: the CUDA resize kernel against
its plain version (the ladder's shapes and the sprite tiles'), the
integer stages and the decoder's device functions on CUDA against the
CPU, the HEVC chain program and deblocking filter on CUDA against the
CPU, the sprite worker, Whisper, the AAC encoder and ``process_video``
on the card, and the device runtime: the executor's event/stream copies
against ``.cpu()``, a pull that does not wait for a later batch's
kernels, and the scheduler's CUDA probe; the worker daemon and the
remote worker (over the port's Worker API) on the card; the one-call
resize API (``ops.ladder_resize_yuv420``) through the kernel; the HEVC
motion search kernel against the plain search stages (MVs and costs bit
for bit), the chain DSP through it on CUDA against the CPU, and its
launch count; the H.264 deblocking kernel against the plain wavefront on
the CPU (every pixel, at the ladder's and the decoder's shapes, random
bS at every QP, one-macroblock frames) and its launches in a chain
step.

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


def test_remote_worker_round_trip_on_the_card(cuda, tmp_path):
    """The port's remote worker on its default device against the port's
    Worker API in this process: claimed over HTTP, transcoded on the card
    (one scaled rung through the kernel), streamed up, verified and
    finalized by the server."""
    import asyncio

    from aiohttp.test_utils import TestServer

    import chip_smoke
    from vlog_tpu_torch import config
    from vlog_tpu_torch.api.worker_api import build_worker_app
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids
    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker.remote import RemoteWorker, WorkerAPIClient

    y, u, v = chip_smoke._smooth_frames(8, 96, 128, seed=2)
    src = tmp_path / "src.y4m"
    write_y4m(src, list(zip(y, u, v)), fps_num=8, fps_den=1)
    rungs = (config.QualityRung("96p", 96, 0, 128_000, base_qp=28),
             config.QualityRung("64p", 64, 150_000, 96_000, base_qp=30))

    async def go():
        db = Database(f"sqlite:///{tmp_path / 'q.db'}")
        await db.connect()
        await create_all(db)
        server = TestServer(build_worker_app(db, video_dir=tmp_path / "srv"))
        await server.start_server()
        base = str(server.make_url("")).rstrip("/")
        video = await vids.create_video(db, "Card", source_path=str(src))
        job_id = await claims.enqueue_job(db, video["id"])
        key = await WorkerAPIClient.register(base, "card-rw")
        worker = RemoteWorker(WorkerAPIClient(base, key), name="card-rw",
                              work_dir=tmp_path / "work",
                              backend=TorchBackend(), claim_wait_s=0.0,
                              kinds=(JobKind.TRANSCODE,))
        assert worker.device == "cuda"
        before = fused_resize.launches
        saved = config.ladder_for_source
        config.ladder_for_source = lambda h: rungs
        try:
            assert await worker.poll_once() is True
        finally:
            config.ladder_for_source = saved
            await worker.client.aclose()
            await server.close()
        launches = fused_resize.launches - before
        row = await vids.get_video(db, video["id"])
        job = await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                 {"i": job_id})
        await db.disconnect()
        return launches, row, job, tmp_path / "srv" / video["slug"]

    launches, row, job, tree = asyncio.run(go())
    assert job["completed_at"] is not None and job["progress"] == 100.0
    assert row["status"] == "ready"
    assert launches == 3
    manifest = integrity.load_manifest(tree)
    assert manifest and integrity.verify_tree(tree, manifest) == []


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


def test_start_d2h_assembles_shards_of_a_repeated_card(cuda):
    """A grid's outputs on one card repeated (``[cuda] * 2``): a rung of
    two shards and a plain tensor, queued inside ``dispatch_streams``;
    one compute event and one copy stream for the card, and the pull
    concatenates the shards in data order."""
    from vlog_tpu_torch.parallel.executor import dispatch_streams, start_d2h
    from vlog_tpu_torch.parallel.mesh import Sharded

    x = torch.arange(1 << 12, dtype=torch.int32, device=cuda)
    with dispatch_streams([cuda, cuda]):
        tree = {"r": {"a": Sharded([x[:2048] * 2, x[2048:] * 2]),
                      "b": x + 1}}
        d2h = start_d2h(tree)
    d2h.wait_compute()
    host = d2h.host("r")
    np.testing.assert_array_equal(host["a"], np.arange(1 << 12) * 2)
    np.testing.assert_array_equal(host["b"], np.arange(1 << 12) + 1)
    assert len(d2h.streams) == 1


def test_grid_program_on_a_repeated_card_equals_one_device(cuda):  # slowlane-ok: 96x128, 8 frames, card only
    """The intra ladder (96x128, four rungs) on a 2x2 grid over the card
    repeated four times: the same levels as the one-device program."""
    from vlog_tpu_torch.parallel import ladder as tladder
    from vlog_tpu_torch.parallel.executor import to_host
    from vlog_tpu_torch.parallel.mesh import MeshShape, rung_grid

    rungs = (("96p", 96, 128, 26), ("64p", 64, 96, 28), ("48p", 48, 64, 29),
             ("32p", 32, 48, 30))
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (8, 96, 128), dtype=np.uint8)
    u = rng.integers(0, 256, (8, 48, 64), dtype=np.uint8)
    v = rng.integers(0, 256, (8, 48, 64), dtype=np.uint8)
    q = {name: np.full(8, qp, np.int32) for name, _, _, qp in rungs}
    grid = rung_grid(rungs, MeshShape(2, 2), [cuda] * 4)
    got = to_host(tladder.ladder_encode_grid(rungs, 96, 128, grid,
                                             device=cuda).dispatch(y, u, v, q))
    want = to_host(tladder.ladder_encode_grid(rungs, 96, 128, None,
                                              device=cuda).dispatch(y, u, v, q))
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          err_msg=f"{name}/{k}")


def test_thumbnail_grab_resize_on_the_card(cuda, tmp_path):
    """The admin plane's thumbnail grab (``POST .../thumbnail/from-time``
    on an app built with ``device="cuda"``): one 1080p frame down to the
    720x1280 thumbnail in exactly 3 kernel launches, its planes held to
    the plain version, the JPEG written at the thumbnail's size."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from vlog_tpu_torch.api.admin_api import THUMBNAILER, build_admin_app
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.jobs import videos as vids
    from vlog_tpu_torch.media.y4m import write_y4m

    rng = np.random.default_rng(8)
    frames = [(rng.integers(0, 256, (1080, 1920), dtype=np.uint8),
               rng.integers(0, 256, (540, 960), dtype=np.uint8),
               rng.integers(0, 256, (540, 960), dtype=np.uint8))
              for _ in range(3)]
    src = tmp_path / "src.y4m"
    write_y4m(src, frames, fps_num=24, fps_den=1)
    y, u, v = frames[1]
    want = TorchBackend(device="cpu")._thumbnail_planes(y, u, v)

    async def body():
        db = Database(f"sqlite:///{tmp_path / 'vlog.db'}")
        await db.connect()
        await create_all(db)
        video = await vids.create_video(db, "Grab", source_path=str(src))
        app = build_admin_app(db, upload_dir=tmp_path / "up",
                              video_dir=tmp_path / "videos")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            backend = app[THUMBNAILER].backend()
            before = fused_resize.launches
            r = await client.post(
                f"/api/videos/{video['id']}/thumbnail/from-time",
                json={"time_s": 1 / 24})
            return (r.status, await r.json(), fused_resize.launches - before,
                    backend)
        finally:
            await client.close()
            await db.disconnect()

    loop = asyncio.new_event_loop()
    try:
        status, answer, launched, backend = loop.run_until_complete(
            asyncio.wait_for(body(), 120))
    finally:
        loop.close()
    assert status == 200, answer
    assert launched == 3 and backend.device.type == "cuda"
    got = backend._thumbnail_planes(y, u, v)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        max_abs, n_diff = _diff(g.cpu(), w)
        assert max_abs <= 1 and n_diff <= 1e-3 * w.numel()
    jpeg = (tmp_path / "videos" / "grab" / "thumbnail.jpg").read_bytes()
    sof = jpeg.index(b"\xff\xc0")
    assert (int.from_bytes(jpeg[sof + 5:sof + 7], "big"),
            int.from_bytes(jpeg[sof + 7:sof + 9], "big")) == (720, 1280)


def test_av1_rung_resize_on_the_card(cuda, tmp_path, monkeypatch):
    """``TorchBackend(device="cuda").run(codec="av1")``: every scaled
    rung's batch goes through the kernel on the card and is held to the
    plain version; the tree has av01 segments. Skips where the libav shim
    or an AV1 encoder is missing."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends import av1_path
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.y4m import write_y4m
    from vlog_tpu_torch.native.build import get_av_lib

    lib = get_av_lib()
    if lib is None:
        pytest.skip("libav shim unavailable")
    h = lib.vt_av1_open(64, 64, 24, 1, 200_000, 8, 8)
    if not h:
        pytest.skip("no system AV1 encoder")
    lib.vt_av1_close(h)
    checked = []

    def held(y, u, v, mats):
        got = fused_resize.resize_yuv420(y, u, v, mats)
        cpu_mats = tuple(tuple(m.cpu() for m in pair) for pair in mats)
        want = fused_resize.resize_yuv420(y.cpu(), u.cpu(), v.cpu(),
                                          cpu_mats)
        for g, w in zip(got, want):
            max_abs, n_diff = _diff(g.cpu(), w)
            assert max_abs <= 1 and n_diff <= 1e-3 * w.numel()
        checked.append(y.shape[0])
        return got

    monkeypatch.setattr(av1_path, "resize_yuv420", held)
    rng = np.random.default_rng(4)
    src = tmp_path / "src.y4m"
    write_y4m(src, [(rng.integers(0, 256, (360, 640), dtype=np.uint8),
                     rng.integers(0, 256, (180, 320), dtype=np.uint8),
                     rng.integers(0, 256, (180, 320), dtype=np.uint8))
                    for _ in range(12)], fps_num=12, fps_den=1)
    rungs = (config.QualityRung("360p", 360, 600_000, 0, base_qp=30),
             config.QualityRung("240p", 240, 300_000, 0, base_qp=31))
    be = TorchBackend(device="cuda")
    plan = be.plan(get_video_info(src), rungs, tmp_path / "out",
                   codec="av1", segment_duration_s=1.0)
    before = fused_resize.launches
    res = be.run(plan, resume=False)
    assert sum(checked) == 12 and fused_resize.launches - before >= 3
    assert all(r.codec_string.startswith("av01.") and r.segment_count == 1
               for r in res.rungs)


def test_resize_api_on_the_card(cuda):
    """The one-call resize API on CUDA planes: every scaled rung's uint8
    planes go through the kernel (3 launches per rung, none for the
    identity rung), each held to the plain version on the CPU; the
    matrices are built once per key, so a second call derives no new
    band form; a float32 result skips the kernel and equals the CPU's
    products within 1e-4."""
    from vlog_tpu_torch.ops import ladder_resize_yuv420, resize_plane

    gen = torch.Generator(device=cuda).manual_seed(99)
    y, u, v = (torch.randint(0, 256, (2,) + hw, device=cuda, generator=gen,
                             dtype=torch.uint8)
               for hw in ((1080, 1920), (540, 960), (540, 960)))
    rungs = ((1080, 1920), (720, 1280), (480, 854), (360, 640))
    before = fused_resize.launches
    got = ladder_resize_yuv420(y, u, v, rungs)
    assert fused_resize.launches == before + 3 * (len(rungs) - 1)
    assert all(g is p for g, p in zip(got[rungs[0]], (y, u, v)))
    for (h, w) in rungs[1:]:
        for plane, src, (dh, dw) in zip(got[(h, w)], (y, u, v),
                                        ((h, w), (h // 2, w // 2),
                                         (h // 2, w // 2))):
            assert plane.device.type == "cuda" and plane.dtype == torch.uint8
            a_h = torch.from_numpy(resample_matrix(src.shape[-2], dh))
            a_w = torch.from_numpy(resample_matrix(src.shape[-1], dw))
            max_abs, n_diff = _diff(plane.cpu(),
                                    apply_resize_matrices(src.cpu(), a_h, a_w))
            assert max_abs <= 1 and n_diff <= 1e-3 * plane.numel()
    bands = len(fused_resize._BANDS)
    ladder_resize_yuv420(y, u, v, rungs)
    assert len(fused_resize._BANDS) == bands
    before = fused_resize.launches
    f32 = resize_plane(y, 360, 640, out_dtype=torch.float32)
    assert fused_resize.launches == before and f32.dtype == torch.float32
    want = resize_plane(y.cpu(), 360, 640, out_dtype=torch.float32)
    assert float((f32.cpu() - want).abs().max()) <= 1e-4


# --------------------------------------------------------------------------
# Stage spans and device-clock records on the card
# --------------------------------------------------------------------------

def test_stage_spans_stay_off_the_device_timeline(cuda):
    """Under a CPU+CUDA profiler session a ``stage()`` is a host event
    and adds no range to the device's timeline (a trace reader counts
    every device event as device time)."""
    from torch.profiler import ProfilerActivity, profile

    from vlog_tpu_torch.obs.trace import stage

    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with stage("outer.unit"):
            for _ in range(4):
                with stage("inner.step"):
                    x.mul_(1.0001)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    dev = [e.name() for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    host = [e.name() for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    assert host.count("outer.unit") == 1 and host.count("inner.step") == 4
    assert "outer.unit" not in dev and "inner.step" not in dev
    assert len(dev) >= 4                           # the kernels themselves


def test_device_clock_times_the_unit_with_its_gaps(cuda):
    from vlog_tpu_torch.obs.trace import DeviceClock

    x = torch.ones(1 << 22, device=cuda)
    torch.cuda.synchronize()
    clock = DeviceClock([cuda, "cuda"])
    x.mul_(1.0001)
    time.sleep(0.05)                 # the device idles inside the unit
    x.mul_(1.0001)
    clock.stop()
    wall = clock.wall_s()
    assert 0.05 <= wall < 1.0


def test_hevc_dispatch_records_on_the_card(cuda, tmp_path):  # slowlane-ok: 96x128, 24 frames
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.media.y4m import write_y4m

    rng = np.random.default_rng(4)
    frames = [tuple(rng.integers(0, 256, hw, dtype=np.uint8)
                    for hw in ((96, 128), (48, 64), (48, 64)))
              for _ in range(24)]
    write_y4m(tmp_path / "src.y4m", frames, fps_num=6, fps_den=1)
    rungs = (config.QualityRung("96p", 96, 150_000, 0, base_qp=30),
             config.QualityRung("64p", 64, 75_000, 0, base_qp=31))
    be = TorchBackend(device=cuda)
    plan = be.plan(get_video_info(tmp_path / "src.y4m"), rungs,
                   tmp_path / "out", codec="h265", segment_duration_s=1.0)
    res = be.run(plan, None, resume=False)
    recs = res.dispatches
    assert [r["frames"] for r in recs] == [12, 12]
    for r in recs:
        assert r["t_enqueue0"] < r["t_enqueue1"] <= r["t_done"]
        # the device's wall lies within the host's view of the dispatch
        assert 0 < r["wall_s"] <= r["t_done"] - r["t_enqueue0"] + 1e-3
    assert res.stage_s["dispatch_wall_s"] == pytest.approx(
        sum(r["wall_s"] for r in recs), abs=2e-3)


def test_engine_tick_wall_on_the_card(cuda, whisper_dir):  # slowlane-ok: tiny checkpoint, one tick, card only
    from vlog_tpu_torch.asr import load
    from vlog_tpu_torch.asr.engine import AsrEngine
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    def device_seconds():
        for fam in runtime().registry.collect():
            for s in fam.samples:
                if s.name == "vlog_device_seconds_total" and \
                        s.labels == {"plane": "asr", "rung": "forward"}:
                    return s.value
        return 0.0

    before = device_seconds()
    engine = AsrEngine(load.load_whisper(whisper_dir, device="cuda"),
                       batch_windows=4, tick_s=0.3)
    try:
        h = engine.begin_job("A", language="en", max_new=16, beam=5)
        for i, audio in enumerate(_asr_windows(4)):
            h.submit(i, 25.0 * i, audio)
        assert {i for i, _, _ in h.results()} == {0, 1, 2, 3}
        h.close()
    finally:
        engine.close()
    (tick,) = engine.batch_log
    assert 0 < tick["wall_s"] <= tick["t1"] - tick["t0"] + 1e-3
    assert 1 <= tick["steps"] <= 16
    if HAVE_PROMETHEUS:
        assert device_seconds() == pytest.approx(before + tick["wall_s"])


# ---------------------------------------------------------------- HEVC ME
# The motion search kernel (ops/motion_search.py) against the plain
# stages of codecs/hevc/core.py on the same card: MVs and costs bit for
# bit. Grids of n-blocks are non-square, chains run 1-6.
_ME_GRID = {16: (5, 7), 32: (3, 5)}
_ME_CASES = [(n, s) for n in (16, 32) for s in (1, 4, 8, 16, 32)]


def _me_inputs(kind, n, search, chains, dev, seed):
    import chip_smoke

    rows, cols = _ME_GRID[n]
    h, w = rows * n, cols * n
    rng = np.random.default_rng(seed)
    if kind == "random":
        frames = rng.integers(0, 256, (chains + 1, h, w), dtype=np.uint8)
        ref, cur = frames[:-1], frames[1:]
    elif kind == "smooth":
        frames = chip_smoke._smooth_frames(chains + 1, h, w, seed)[0]
        ref, cur = frames[:-1], frames[1:]
    elif kind == "flat":            # every offset ties
        ref = np.full((chains, h, w), 77, np.uint8)
        cur = np.full((chains, h, w), 90, np.uint8)
    else:                           # "edge": the true MV is (search, -search)
        m = 2 * search
        world = rng.integers(0, 256, (chains, h + 2 * m, w + 2 * m),
                             dtype=np.uint8)
        ref = world[:, m:m + h, m:m + w]
        cur = world[:, m + search:m + search + h, m - search:m - search + w]
    return chip_smoke._me_planes(ref, cur, search, dev)


@pytest.mark.parametrize("kind", ["random", "smooth", "flat", "edge"])
@pytest.mark.parametrize("n,search", _ME_CASES)
def test_motion_search_kernel_matches_plain(cuda, kind, n, search):
    from vlog_tpu_torch.codecs.hevc import core
    from vlog_tpu_torch.ops import motion_search

    chains = 1 + _ME_CASES.index((n, search)) % 6
    cur, refp, hplanes, pad = _me_inputs(kind, n, search, chains, cuda,
                                         seed=n * 100 + search)
    before = motion_search.launches
    mv, cost = core._p_ctb_search(cur, refp, hplanes, search=search, pad=pad,
                                  n=n)
    assert motion_search.launches == before + 1
    mv_int, c_int = core._integer_search(cur, refp, search=search, pad=pad,
                                         n=n)
    want_mv, want_cost = core._subpel_refine(cur, hplanes, mv_int, c_int,
                                             pad=pad, n=n)
    torch.cuda.synchronize()
    assert mv.shape == want_mv.shape and mv.dtype == torch.int32
    np.testing.assert_array_equal(mv.cpu().numpy(), want_mv.cpu().numpy())
    np.testing.assert_array_equal(cost.cpu().numpy(), want_cost.cpu().numpy())
    if kind == "flat":
        assert not mv.any()
    if kind == "edge":              # interior blocks find the window's edge
        hit = (mv.cpu().numpy() == [4 * search, -4 * search]).all(-1)
        assert hit.any()


def test_motion_search_kernel_refuses_bad_inputs_on_the_card(cuda):
    from vlog_tpu_torch.ops import motion_search

    cur, refp, hplanes, pad = _me_inputs("random", 32, 4, 1, cuda, seed=1)
    with pytest.raises(ValueError, match="one device"):
        motion_search.p_ctb_search(cur, refp.cpu(), hplanes, search=4, pad=pad)
    with pytest.raises(ValueError, match="search"):
        motion_search.p_ctb_search(cur, refp, hplanes, search=33, pad=pad)


@pytest.mark.parametrize("partitions", [False, True])
def test_hevc_chain_dsp_cpu_and_cuda_identical(cuda, partitions):  # slowlane-ok: 96x128, 2 chains of 4 frames
    """``encode_chain_dsp`` with deblock and the rate cascade: every
    integer output identical on CPU (the plain search) and CUDA (the
    kernel: one launch per P frame, two with partitions)."""
    import chip_smoke
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp
    from vlog_tpu_torch.ops import motion_search

    y, u, v = (p.reshape((2, 4) + p.shape[1:])
               for p in chip_smoke._smooth_frames(8, 96, 128, seed=6))
    rc = {"budget": np.float32(200.0), "alpha": np.float32(0.4)}
    got = {}
    for dev in ("cpu", cuda):
        planes = [torch.as_tensor(p, device=dev) for p in (y, u, v)]
        q = torch.as_tensor([[28, 30, 31, 32], [33, 34, 35, 36]],
                            dtype=torch.int32, device=dev)
        before = motion_search.launches
        res = encode_chain_dsp(*planes, 8, q[:, 0], q[:, 1:], partitions,
                               True, rc)
        launched = motion_search.launches - before
        assert launched == (0 if dev == "cpu" else 3 * (2 if partitions else 1))
        (intra, rec_i), (p32, p16, parts, mvs, precons), out = res
        arrays = [*intra, *rec_i, *p32, parts, mvs, *precons, out["qp_eff"]]
        if partitions:
            arrays += list(p16)
        got[str(dev)] = [a.cpu().numpy() for a in arrays]
    for a, b in zip(got["cpu"], got["cuda"]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got["cuda"][10]).max() > 0          # the MVs moved


def test_motion_search_launches_once_per_p_step_and_rung(cuda):  # slowlane-ok: 4 small rungs, one 144-frame dispatch
    """A 144-frame dispatch (6 chains of 24) over 4 rungs with partitions
    off launches the kernel 23 P steps x 4 rungs = 92 times."""
    from vlog_tpu_torch.ops import motion_search
    from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_program

    rng = np.random.default_rng(9)
    y = torch.as_tensor(rng.integers(0, 256, (6, 24, 128, 256), dtype=np.uint8),
                        device=cuda)
    u = torch.as_tensor(rng.integers(0, 256, (6, 24, 64, 128), dtype=np.uint8),
                        device=cuda)
    rungs = (("128p", 128, 256, 30), ("96p", 96, 192, 31),
             ("64p", 64, 128, 32), ("32p", 32, 64, 33))
    qps = {r[0]: np.full((6, 24), r[3], np.int32) for r in rungs}
    fn, mats = hevc_chain_ladder_program(rungs, 128, 256, search=8,
                                         deblock=True, device=cuda)
    before = motion_search.launches
    out = fn(y, u, u, mats, qps)
    torch.cuda.synchronize()
    assert motion_search.launches - before == 92
    assert all(out[r[0]]["mv"].shape[:2] == (6, 23) for r in rungs)


# --------------------------------------------------------- H.264 deblock
# The deblocking kernel (ops/h264_deblock.py) against the plain wavefront
# of codecs/h264/deblock.py on the CPU, from the same inputs: every output
# pixel bit for bit, one launch a call.

def _deblock_on_card_and_cpu(planes, qp, bs_v, bs_h):
    """deblock_frame on the card (the kernel: one launch) and on the CPU
    (the plain wavefront) from the same inputs; asserts they agree and
    returns the CPU's planes and the pixels the filter changed."""
    from vlog_tpu_torch.codecs.h264.deblock import deblock_frame
    from vlog_tpu_torch.ops import h264_deblock

    before = h264_deblock.launches
    got = deblock_frame(*(p.cuda() for p in planes), qp=qp.cuda(),
                        bs_v=bs_v.cuda(), bs_h=bs_h.cuda())
    assert h264_deblock.launches == before + 1
    want = deblock_frame(*(p.cpu() for p in planes), qp=qp.cpu(),
                         bs_v=bs_v.cpu(), bs_h=bs_h.cpu())
    for g, w, name in zip(got, want, "yuv"):
        assert g.dtype == torch.int32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)
    changed = sum(int((w != p.cpu().to(torch.int32)).sum())
                  for w, p in zip(want, planes))
    return want, changed


def test_deblock_kernel_at_the_ladder_shape(cuda):  # slowlane-ok: 6 frames of 368x640, card only
    """The 360p rung's calls: 6 chains' I frames with intra bS, then
    their P frames with ``p_bs`` of the encoder's levels and MVs."""
    import chip_smoke
    from vlog_tpu_torch.codecs.h264.deblock import intra_bs, p_bs
    from vlog_tpu_torch.codecs.h264.encoder import encode_frame
    from vlog_tpu_torch.codecs.h264.inter import encode_p_frame

    y, u, v = (torch.as_tensor(p, device=cuda)
               for p in chip_smoke._smooth_frames(12, 368, 640, seed=21))
    qp = torch.tensor([26, 29, 31, 33, 36, 40], dtype=torch.int32, device=cuda)
    i = encode_frame(y[0::2], u[0::2], v[0::2], qp=qp)
    rec, changed = _deblock_on_card_and_cpu(
        (i["recon_y"], i["recon_u"], i["recon_v"]), qp, *intra_bs(23, 40, cuda))
    assert changed > 0
    rec = tuple(p.to(torch.uint8).to(cuda) for p in rec)
    p = encode_p_frame(y[1::2], u[1::2], v[1::2], *rec, qp=qp, search=8)
    nz = (p["luma"] != 0).any(-1).any(-1)
    bsv, bsh = p_bs(nz.permute(0, 1, 3, 2, 4).reshape(6, 92, 160), p["mv"])
    assert int(bsv.max()) > 0 and int(bsv.min()) == 0
    _, changed = _deblock_on_card_and_cpu(
        (p["recon_y"], p["recon_u"], p["recon_v"]), qp, bsv, bsh)
    assert changed > 0


@pytest.mark.parametrize("is_p", [False, True])
def test_deblock_kernel_at_the_decoder_shape(cuda, is_p):  # slowlane-ok: one 1088x1920 frame, card only
    """The decoder's call: one 1088x1920 picture, an int qp."""
    import chip_smoke
    from vlog_tpu_torch.codecs.h264.deblock import deblock_frame, intra_bs, p_bs
    from vlog_tpu_torch.ops import h264_deblock

    planes = tuple(torch.as_tensor(p[:1])
                   for p in chip_smoke._smooth_frames(1, 1088, 1920, seed=22))
    rng = np.random.default_rng(22)
    if is_p:
        nz4 = torch.as_tensor(rng.random((1, 272, 480)) < 0.3, dtype=torch.int32)
        mv = torch.as_tensor(rng.integers(-9, 10, (1, 68, 120, 2)), dtype=torch.int32)
        bsv, bsh = p_bs(nz4, mv)
    else:
        bsv, bsh = intra_bs(68, 120, "cpu")
    before = h264_deblock.launches
    got = deblock_frame(*(p.to(cuda) for p in planes), qp=34,
                        bs_v=bsv.to(cuda), bs_h=bsh.to(cuda))
    assert h264_deblock.launches == before + 1
    want = deblock_frame(*planes, qp=34, bs_v=bsv, bs_h=bsh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int((want[0] != planes[0].to(torch.int32)).sum()) > 0


def test_deblock_kernel_random_bs_at_every_qp(cuda):
    """Random bS 0-4 on both edge directions, one frame at each QP 0-51
    (below 16 alpha and beta are 0 and nothing is filtered), noisy
    content around a per-frame level so that every filter branch runs."""
    rng = np.random.default_rng(23)
    n, mbh, mbw = 52, 3, 4
    base = rng.integers(40, 216, (n, 1, 1))

    def plane(h, w, spread):
        a = base + rng.integers(-spread, spread + 1, (n, h, w))
        return torch.as_tensor(np.clip(a, 0, 255)).to(torch.uint8)

    planes = (plane(48, 64, 10), plane(24, 32, 5), plane(24, 32, 5))
    qp = torch.arange(52, dtype=torch.int32)
    bsv, bsh = (torch.as_tensor(rng.integers(0, 5, (n, mbh, mbw, 4, 4)),
                                dtype=torch.int32) for _ in range(2))
    want, changed = _deblock_on_card_and_cpu(planes, qp, bsv, bsh)
    assert changed > 0
    for w, p in zip(want, planes):       # QP < 16: the planes untouched
        assert torch.equal(w[:16], p[:16].to(torch.int32))


@pytest.mark.parametrize("h,w", [(16, 160), (160, 16), (16, 16)])
def test_deblock_kernel_one_macroblock_wide_or_tall(cuda, h, w):
    """A frame one macroblock wide, one one macroblock tall, and a single
    macroblock: diagonals of one macroblock, picture edges everywhere."""
    rng = np.random.default_rng(h + w)
    planes = tuple(torch.as_tensor(rng.integers(90, 130, (3, a, b)),
                                   dtype=torch.uint8)
                   for a, b in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    qp = torch.tensor([30, 40, 51], dtype=torch.int32)
    bsv, bsh = (torch.as_tensor(rng.integers(0, 5, (3, h // 16, w // 16, 4, 4)),
                                dtype=torch.int32) for _ in range(2))
    _, changed = _deblock_on_card_and_cpu(planes, qp, bsv, bsh)
    assert changed > 0


def test_one_rung_launches_the_deblock_kernel_once_a_frame(cuda):  # slowlane-ok: 2 chains of 24 frames at 48x64
    """``_one_rung`` with deblocking on, a 24-frame chain step: one
    launch for the I frame and one a P step (24), and every output equal
    to the CPU's plain wavefront's."""
    from vlog_tpu_torch.ops import h264_deblock
    from vlog_tpu_torch.parallel.ladder import _one_rung

    rng = np.random.default_rng(24)
    y = rng.integers(0, 256, (2, 24, 48, 64), dtype=np.uint8)
    u = rng.integers(0, 256, (2, 24, 24, 32), dtype=np.uint8)
    qps = np.full((2, 24), 30, np.int32)
    got = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
        before = h264_deblock.launches
        out = _one_rung(t(y), t(u), t(u), None, t(qps), 48, 64, search=8,
                        deblock=True, rcr=None)
        torch.cuda.synchronize()
        assert h264_deblock.launches - before == (0 if dev == "cpu" else 24)
        got[str(dev)] = {k: val.cpu().numpy() for k, val in out.items()}
    for k, val in got["cpu"].items():
        if k == "sse_y":                # float32 sums in the device's order
            np.testing.assert_allclose(got["cuda"][k], val, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got["cuda"][k], val, err_msg=k)
