"""Card-only tests of the PyTorch port: the CUDA resize kernel against
its plain version, and the integer stages on CUDA against the CPU.

Marked ``cuda``; each test skips (in its fixture) without a CUDA
device. On a machine with a card and without JAX, run them alone:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance for the resize: |diff| <= 1 and at most 0.1% of pixels (two
float32 summation orders); the integer stages are bit-exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vlog_tpu_torch.ops import fused_resize
from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,src,dst", [
    (3, (64, 96), (24, 32)),          # tiny
    (2, (540, 960), (240, 427)),      # the 480p rung's odd-width chroma
    (1, (2160, 3840), (1080, 1920)),  # a 4K source
    (4, (37, 53), (50, 70)),          # upscale, ragged tiles
])
def test_kernel_matches_plain_version(cuda, n, src, dst):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, 256, (n,) + src, generator=g, device=cuda,
                      dtype=torch.uint8)
    a_h = torch.as_tensor(resample_matrix(src[0], dst[0]), device=cuda)
    a_w = torch.as_tensor(resample_matrix(src[1], dst[1]), device=cuda)
    before = fused_resize.launches
    got = fused_resize.fused_resize_plane(x, a_h, a_w)
    assert fused_resize.launches == before + fused_resize.LAUNCHES_PER_CALL
    want = apply_resize_matrices(x, a_h, a_w)
    torch.cuda.synchronize()
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert got.shape == (n,) + dst and got.dtype == torch.uint8
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 1e-3


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
