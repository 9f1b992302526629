"""The port's backend registry (``vlog_tpu_torch/backends/base.py``),
``TorchBackend.detect``, the device-fault oracle
(``vlog_tpu_torch/parallel/faults.py``) and the failpoint sites of the
pipeline path, on the CPU. The classification keeps the JAX package's
rules (``tests/test_self_healing.py``) for the CUDA runtime's errors.
"""

from __future__ import annotations

import pytest
import torch

from vlog_tpu_torch.backends import base
from vlog_tpu_torch.backends.torch_backend import TorchBackend
from vlog_tpu_torch.parallel import faults
from vlog_tpu_torch.utils import failpoints


@pytest.fixture
def registry(monkeypatch):
    """An empty registry and selection cache for one test."""
    monkeypatch.setattr(base, "_REGISTRY", {})
    monkeypatch.setattr(base, "_SELECTED", {})
    return base


def _fake(kind: str, *, broken: bool = False):
    class Fake:
        name = f"fake-{kind}"

        def __init__(self, device="cuda"):
            self.device = torch.device("cpu")

        def detect(self):
            if broken:
                raise RuntimeError("no such accelerator")
            return base.Capabilities(backend=self.name, device_kind=kind,
                                     device_count=1, codecs=("h264",),
                                     decode_codecs=("h264",))
    return Fake


def test_register_get_and_available(registry):
    registry.register_backend("a", _fake("cpu"))
    registry.register_backend("b", _fake("gpu"))
    assert registry.available_backends() == ["a", "b"]
    assert registry.get_backend("b").name == "fake-gpu"
    with pytest.raises(ValueError, match="unknown backend 'c'"):
        registry.get_backend("c")


def test_select_prefers_gpu_and_caches_per_device(registry):
    registry.register_backend("cpu1", _fake("cpu"))
    registry.register_backend("gpu1", _fake("gpu"))
    chosen = registry.select_backend()
    assert chosen.name == "fake-gpu"
    assert registry.select_backend() is chosen
    assert registry.select_backend(device="cpu") is not chosen
    assert registry.select_backend("cpu1").name == "fake-cpu"


def test_select_skips_a_backend_that_raises(registry):
    registry.register_backend("broken", _fake("gpu", broken=True))
    registry.register_backend("cpu1", _fake("cpu"))
    assert registry.select_backend().name == "fake-cpu"


def test_select_raises_when_none_is_left(registry):
    registry.register_backend("broken", _fake("gpu", broken=True))
    with pytest.raises(RuntimeError, match="no such accelerator"):
        registry.select_backend()
    registry._REGISTRY.clear()
    with pytest.raises(RuntimeError, match="registry empty"):
        registry.select_backend()


def test_torch_backend_is_registered_and_cuda_selection_raises_without_cuda(
        monkeypatch):
    import vlog_tpu_torch.backends as backends

    assert "torch" in backends.available_backends()
    monkeypatch.setattr(base, "_SELECTED", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backends.select_backend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backends.get_backend("torch")
    cpu = backends.select_backend(device="cpu")
    assert isinstance(cpu, TorchBackend) and cpu.device.type == "cpu"


def test_detect_on_the_cpu(monkeypatch):
    caps = TorchBackend(device="cpu").detect()
    assert caps == base.Capabilities(
        backend="torch", device_kind="cpu", device_count=1,
        codecs=("h264",), decode_codecs=("h264", "raw"),
        max_parallel_jobs=1, memory_bytes=None, details={"devices": ["cpu"]})
    assert caps.to_dict()["devices"] == ["cpu"]
    # a CUDA backend whose card went away raises instead of reporting
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    gone = TorchBackend(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gone.detect()


@pytest.mark.parametrize("exc", [
    faults.SyntheticDeviceFault("boom"),
    type("OutOfMemoryError", (RuntimeError,), {})("whatever"),
    type("AcceleratorError", (RuntimeError,), {})("whatever"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
    RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR"),
])
def test_cuda_shaped_errors_classify(exc):
    assert faults.is_device_fault(exc)


def test_torch_cuda_error_types_classify():
    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None:
        assert faults.is_device_fault(oom("CUDA out of memory"))
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None:
        assert faults.is_device_fault(acc.__new__(acc))


@pytest.mark.parametrize("exc", [
    ValueError("CUDA error: bad y4m header"),
    OSError("no such file: device-side assert triggered.mp4"),
    RuntimeError("bad payload"),
    failpoints.FailpointError("backend.encode"),
    # XLA's shapes are not the CUDA runtime's
    RuntimeError("INTERNAL: Failed to execute XLA Runtime executable"),
])
def test_input_and_plumbing_errors_do_not_classify(exc):
    assert not faults.is_device_fault(exc)


def test_wrapped_chains():
    def chain(inner, depth):
        exc = inner
        for k in range(depth):
            try:
                raise RuntimeError(f"pipeline stage {k} failed") from exc
            except RuntimeError as outer:
                exc = outer
        return exc

    cuda = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert faults.is_device_fault(chain(cuda, 3))
    assert faults.is_device_fault(chain(faults.SyntheticDeviceFault("x"), 7))
    assert not faults.is_device_fault(chain(cuda, 8))     # walk bounded at 8
    try:                                           # __context__ counts too
        try:
            raise cuda
        except RuntimeError:
            raise KeyError("while handling")
    except KeyError as ctx:
        assert faults.is_device_fault(ctx)
    # a different armed failpoint inside the chain stops the walk
    fp = failpoints.FailpointError("storage.verify")
    fp.__cause__ = cuda
    assert not faults.is_device_fault(chain(fp, 1))


def test_device_fault_failpoint_raises_synthetic_fault():
    faults.maybe_inject_device_fault()               # disarmed: nothing
    failpoints.arm_from_spec("device.fault=1")
    try:
        with pytest.raises(faults.SyntheticDeviceFault,
                           match="CUDA error") as exc:
            faults.maybe_inject_device_fault()
        assert isinstance(exc.value.__cause__, failpoints.FailpointError)
        assert faults.is_device_fault(exc.value)
        faults.maybe_inject_device_fault()           # budget spent
    finally:
        failpoints.reset()


def test_backend_encode_failpoint_at_run_entry(tmp_path):
    from tests.fixtures.media import make_y4m
    from vlog_tpu_torch.media.probe import get_video_info

    src = make_y4m(tmp_path / "s.y4m", n_frames=2, width=32, height=32, fps=2)
    backend = TorchBackend(device="cpu")
    plan = backend.plan(get_video_info(src), out_dir=tmp_path / "out")
    failpoints.arm("backend.encode", count=1)
    try:
        with pytest.raises(failpoints.FailpointError, match="backend.encode"):
            backend.run(plan)
    finally:
        failpoints.reset()
    assert not (tmp_path / "out").exists()


def test_new_sites_are_registered():
    assert {"device.fault", "backend.encode", "storage.verify"} <= \
        set(failpoints.SITES)
    # the worker daemon's job plane registers its sites too
    assert {"claims.claim", "db.commit", "daemon.compute", "db.claim",
            "drain.deadline"} <= set(failpoints.SITES)
    # the remote worker is not ported: its sites stay unknown
    with pytest.raises(ValueError, match="unknown failpoint site"):
        failpoints.arm_from_spec("remote.upload=1")
