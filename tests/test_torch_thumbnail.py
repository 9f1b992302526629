"""The thumbnail path of the port against the JAX package: resize to a
target size, BT.709 YUV -> RGB, the JPEG encoder (RGB -> YCbCr, FDCT +
quantization, the C scan packer) and ``TorchBackend._write_thumbnail``.

Tolerance: byte identity everywhere, float stages included. The port's
colour conversions and DCT follow the float32 operations XLA's CPU
compiler emits for the JAX functions (see ops/colorspace.py and
codecs/jpeg/encoder.py); these tests hold them at several shapes,
standards, ranges and qualities. The resize is the plain version of the
fused kernel (ROADMAP Queue C item 1: a value within an ulp of x.5 may
round the other way, |diff| <= 1); the seeds here agree exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

SHAPES = [(96, 128), (34, 46), (240, 426), (2, 2)]


def _yuv(seed: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))


def test_inverse_matrices_are_jax_float32_inverses():
    from vlog_tpu.ops import colorspace as jcs
    from vlog_tpu_torch.ops import colorspace as tcs

    for standard in ("bt601", "bt709"):
        jf, ji = (np.asarray(m) for m in jcs._matrices(standard))
        tf, ti = tcs._matrices(standard)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("standard,full_range",
                         [("bt709", False), ("bt709", True), ("bt601", True)])
def test_colorspace_round_trip_matches_jax(shape, standard, full_range):
    import jax.numpy as jnp

    from vlog_tpu.ops import colorspace as jcs
    from vlog_tpu_torch.ops import colorspace as tcs

    y, u, v = _yuv(sum(shape), *shape)
    want = np.asarray(jcs.yuv420_to_rgb(y, u, v, standard=standard,
                                        full_range=full_range))
    got = tcs.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(u),
                            torch.from_numpy(v), standard=standard,
                            full_range=full_range).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    rgb = np.asarray(jnp.asarray((want * 255).astype(np.uint8),
                                 jnp.float32) / 255.0)
    jy = jcs.rgb_to_yuv420(jnp.asarray(rgb), standard=standard,
                           full_range=full_range)
    ty = tcs.rgb_to_yuv420(torch.tensor(rgb), standard=standard,
                           full_range=full_range)
    for a, b in zip(jy, ty):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("quality", [85, 50, 10])
def test_dct_quantize_matches_jax(quality):
    from vlog_tpu.codecs.jpeg import encoder as jjpeg
    from vlog_tpu_torch.codecs.jpeg import encoder as tjpeg

    y, u, v = _yuv(quality, 128, 256)
    want = jjpeg.dct_quantize_420(y, u, v, quality=quality)
    got = tjpeg.dct_quantize_420(torch.from_numpy(y), torch.from_numpy(u),
                                 torch.from_numpy(v), quality=quality)
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", [(96, 128), (35, 47), (720, 1280)])
def test_encode_jpeg_rgb_bytes_match_jax(shape):
    from vlog_tpu.codecs.jpeg import encode_jpeg_rgb as jax_jpeg
    from vlog_tpu_torch.codecs.jpeg import encode_jpeg_rgb

    rng = np.random.default_rng(shape[0])
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    rgb = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256, (xx ^ yy) % 256],
                   -1).astype(np.uint8)
    rgb = np.clip(rgb + rng.integers(-8, 8, rgb.shape), 0, 255).astype(np.uint8)
    data = encode_jpeg_rgb(torch.from_numpy(rgb), quality=85)
    assert data == jax_jpeg(rgb, quality=85)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_c_packer_matches_python_packer():
    from vlog_tpu_torch.codecs.jpeg import encoder as tjpeg

    rng = np.random.default_rng(3)
    n = 6 * 40
    blocks = np.zeros((n, 64), np.int32)
    for i in range(n):              # sparse, mostly small, some escapes
        k = rng.integers(0, 64)
        blocks[i, :k] = rng.integers(-30, 31, k) * (rng.random(k) < 0.4)
        blocks[i, 0] = rng.integers(-1023, 1024)
    blocks[5, 63] = 700                             # last coefficient
    blocks[7, 1:40] = 0
    blocks[7, 40] = -1                              # a run over 16 (ZRL)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), n // 6)
    assert tjpeg._pack_scan_native(blocks, comp) == \
        tjpeg._pack_scan_python(blocks, comp)


def test_thumbnail_resize_matches_jax_and_reuses_matrices():
    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu_torch.backends.torch_backend import TorchBackend

    y, u, v = _yuv(11, 96, 128)
    want = jax_resize(y[None], u[None], v[None], 48, 64)
    backend = TorchBackend(device="cpu")
    got = backend._thumbnail_planes(y, u, v, max_width=64)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a[0]))
    (first,) = backend._thumb_mats.values()
    backend._thumbnail_planes(y, u, v, max_width=64)
    (again,) = backend._thumb_mats.values()
    assert again[0][0] is first[0][0] and again[1][1] is first[1][1]
    same = backend._thumbnail_planes(y, u, v, max_width=128)    # no resize
    for a, b in zip((y, u, v), same):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("shape,max_width", [((96, 128), 64), ((96, 128), 1280)])
def test_write_thumbnail_matches_jax(tmp_path, shape, max_width):
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu_torch.backends.torch_backend import TorchBackend

    y, u, v = _yuv(7, *shape)
    JaxBackend._write_thumbnail(y, u, v, str(tmp_path / "jax.jpg"),
                                max_width=max_width)
    TorchBackend(device="cpu")._write_thumbnail(
        y, u, v, str(tmp_path / "torch.jpg"), max_width=max_width)
    data = (tmp_path / "torch.jpg").read_bytes()
    assert data == (tmp_path / "jax.jpg").read_bytes()
    # SOF0 carries the thumbnail's height and width
    sof = data.index(b"\xff\xc0")
    h, w = (int.from_bytes(data[sof + k:sof + k + 2], "big") for k in (5, 7))
    assert w == min(shape[1], max_width)
    assert h == (shape[0] if shape[1] <= max_width
                 else max(2, round(shape[0] * max_width / shape[1] / 2) * 2))
