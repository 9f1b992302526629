"""Device mesh specs, data-axis sharding and the (data x rung) grid
layout (port of ``vlog_tpu/parallel/mesh.py``).

Two axes cover the media pipeline: ``data`` (frames, I+P chains or ASR
windows of a batch) and ``rung`` (the ladder's rungs in cost-balanced
column groups, :func:`balanced_rung_columns`). The spec syntax
(``VLOG_TPU_MESH``: ``data:-1``, ``data:2,rung:4``, ``auto``), the shape
resolution and the grid layout are the reference's, line for line.

A :class:`Mesh` here is a plain array of devices with axis names. The
grid is MPMD over the reference's per-column submeshes: each rung
column runs its own program, and its "data" axis is a split of the
batch into one shard per device of the column (:func:`shard_frames`),
each shard dispatched on its own device. :class:`Sharded` holds such a
split (a shard per data device, in data order); the host assembles it.
``make_mesh()`` without devices takes every visible CUDA device (each
once); a device list that repeats a device (``["cpu"] * 4``, or one card
as several logical devices) is accepted only when passed explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch import config


@dataclass(frozen=True)
class MeshSpec:
    axes: tuple[tuple[str, int], ...]   # (name, size); -1 = all remaining

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)


def parse_mesh_spec(spec: str | None = None) -> MeshSpec:
    spec = spec or config.TPU_MESH_SPEC
    axes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        axes.append((name.strip(), int(size) if size else -1))
    if not axes:
        axes = [("data", -1)]
    return MeshSpec(tuple(axes))


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` (an object array shaped by the axes) with axis names."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the mesh's devices "
                           "explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_array(devices: list, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr.reshape(shape)


def make_mesh(spec: str | MeshSpec | None = None,
              devices: list | None = None) -> Mesh:
    """Build a Mesh from a spec string; -1 axes absorb remaining devices.
    ``devices`` defaults to every visible CUDA device (raises without
    CUDA)."""
    if not isinstance(spec, MeshSpec):
        spec = parse_mesh_spec(spec)
    devices = list(devices) if devices is not None else _cuda_devices()
    n = len(devices)
    sizes = [s for _, s in spec.axes]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis allowed in mesh spec {spec}")
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    return Mesh(_device_array(devices[:total], sizes), spec.axis_names)


class Sharded(tuple):
    """One array split along its leading axis over a data axis: a tensor
    per data device, in data order (each on its own device). The host
    copy (``parallel/executor.py::start_d2h``) concatenates the shards."""

    __slots__ = ()


def data_devices(mesh, axis: str = "data") -> tuple:
    """The devices along ``axis`` of a mesh (every other axis of size 1),
    or of a plain device list, in order."""
    if not isinstance(mesh, Mesh):
        return tuple(mesh)
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    if int(np.prod(devs.shape[1:])) != 1:
        raise ValueError(f"mesh {mesh.shape}: shards over {axis!r} need "
                         "every other axis of size 1")
    return tuple(devs.reshape(devs.shape[0]).tolist())


def shard_frames(mesh, *arrays, axis: str = "data"):
    """Split (N, ...) arrays along N over the devices of ``axis``: one
    :class:`Sharded` per array, a contiguous block of N / width rows on
    each data device, in data order (``mesh`` may also be a plain device
    list, repeats allowed). N must divide by the axis width: callers pad
    batches to it (:func:`pad_batch`). Each block is staged inside its
    device's ``executor.dispatch_stream`` (host arrays pinned and copied
    without blocking), so the device's compute stream orders the copy
    before the work queued there next."""
    from vlog_tpu_torch.parallel.executor import dispatch_stream, upload

    devices = [torch.device(d) for d in data_devices(mesh, axis)]
    width = len(devices)
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays) or n % width:
        raise ValueError(f"shard_frames: {[a.shape[0] for a in arrays]} rows "
                         f"do not divide over {width} devices (pad_batch "
                         "first)")
    k = n // width
    shards = [[] for _ in arrays]
    for i, dev in enumerate(devices):
        with dispatch_stream(dev):
            for j, a in enumerate(arrays):
                block = a[i * k:(i + 1) * k]
                shards[j].append(block.to(dev) if isinstance(block, torch.Tensor)
                                 else upload(np.asarray(block), dev))
    return tuple(Sharded(s) for s in shards)


def pad_batch(n_devices: int, *arrays):
    """Edge-pad the leading (frame) axis up to a multiple of n_devices.

    Returns (padded_arrays, real_count). On a 2-D grid callers pass the
    DATA-axis width, not the device count."""
    n = arrays[0].shape[0]
    pad = (-n) % n_devices
    if pad == 0:
        return arrays, n
    out = []
    for a in arrays:
        reps = np.repeat(a[-1:], pad, axis=0)
        out.append(np.concatenate([a, reps], axis=0))
    return tuple(out), n


# --- 2-D (data × rung) grid layout ------------------------------------------

# Static description of one rung: (name, height, width, qp).
RungSpecT = tuple[str, int, int, int]


@dataclass(frozen=True)
class MeshShape:
    """Resolved 2-D grid shape: ``data`` × ``rung`` device columns."""

    data: int
    rung: int

    @property
    def label(self) -> str:
        return f"{self.data}x{self.rung}"

    @property
    def n_devices(self) -> int:
        return self.data * self.rung


def balanced_rung_columns(rungs: tuple[RungSpecT, ...],
                          n_cols: int) -> tuple[tuple[int, ...], ...]:
    """Partition rung indices into ``n_cols`` pixel-rate-balanced groups:
    greedy LPT by ``h*w``, ties toward the lower column index."""
    if not 1 <= n_cols <= len(rungs):
        raise ValueError(
            f"need 1 <= columns <= rungs, got {n_cols} cols, "
            f"{len(rungs)} rungs")
    order = sorted(range(len(rungs)),
                   key=lambda i: (-rungs[i][1] * rungs[i][2], i))
    loads = [0] * n_cols
    cols: list[list[int]] = [[] for _ in range(n_cols)]
    for i in order:
        j = min(range(n_cols), key=lambda c: (loads[c], c))
        cols[j].append(i)
        loads[j] += rungs[i][1] * rungs[i][2]
    return tuple(tuple(sorted(c)) for c in cols)


def _column_cost(rungs: tuple[RungSpecT, ...], n_cols: int) -> int:
    """Pixel rate of the heaviest column under the balanced partition."""
    cols = balanced_rung_columns(rungs, n_cols)
    return max(sum(rungs[i][1] * rungs[i][2] for i in col) for col in cols)


def auto_mesh_shape(n_devices: int, rungs: tuple[RungSpecT, ...],
                    batch_hint: int | None = None) -> MeshShape:
    """Pick the (data, rung) split: every divisor pair ``d*r ==
    n_devices`` (``r`` capped at the rung count) scored by the heaviest
    column's pixel rate times the data-axis passes the hinted batch
    needs; ties prefer the wider data axis."""
    n_rungs = max(1, len(rungs))
    hint = max(1, batch_hint or n_devices)
    best: tuple | None = None
    for d in range(1, n_devices + 1):
        if n_devices % d:
            continue
        r = n_devices // d
        if r > n_rungs:
            continue
        passes = -(-hint // d)
        cost = _column_cost(rungs, r) * passes if rungs else passes
        if best is None or (cost, -d) < (best[0], -best[1]):
            best = (cost, d, r)
    assert best is not None   # d == n_devices, r == 1 always qualifies
    return MeshShape(best[1], best[2])


def resolve_mesh_shape(spec: str | None, n_devices: int,
                       rungs: tuple[RungSpecT, ...],
                       batch_hint: int | None = None) -> MeshShape:
    """Resolve VLOG_TPU_MESH (or ``spec``) into a grid shape: ``auto``
    defers to :func:`auto_mesh_shape`; otherwise the ``data`` and
    ``rung`` axes are read (one may be -1; unknown axes are ignored), the
    rung axis clamps to the rung count, and the product must fit."""
    spec = (spec if spec is not None else config.TPU_MESH_SPEC).strip()
    n_rungs = max(1, len(rungs))
    if spec.lower() == "auto":
        return auto_mesh_shape(n_devices, rungs, batch_hint)
    sizes = dict(parse_mesh_spec(spec).axes)
    data = sizes.get("data", -1)
    rung = sizes.get("rung", 1)
    if data == -1 and rung == -1:
        raise ValueError(f"at most one -1 axis allowed in mesh spec {spec!r}")
    if rung != -1:
        rung = min(max(1, rung), n_rungs)
    if data == -1:
        data = max(1, n_devices // max(rung, 1))
    elif rung == -1:
        rung = min(n_rungs, max(1, n_devices // data))
    if data * rung > n_devices:
        raise ValueError(
            f"mesh spec {spec!r} needs {data * rung} devices, "
            f"have {n_devices}")
    return MeshShape(data, rung)


@dataclass(frozen=True)
class GridColumn:
    """One rung column: a 1-D data mesh + the rung subset it owns."""

    mesh: Mesh
    rungs: tuple[RungSpecT, ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(r[0] for r in self.rungs)


@dataclass(frozen=True)
class RungGrid:
    """A resolved (data × rung) device grid for one ladder."""

    shape: MeshShape
    columns: tuple[GridColumn, ...]

    @property
    def data(self) -> int:
        return self.shape.data

    @property
    def label(self) -> str:
        return self.shape.label

    def column_of(self, rung_name: str) -> GridColumn:
        for col in self.columns:
            if rung_name in col.names:
                return col
        raise KeyError(rung_name)


def rung_grid(rungs: tuple[RungSpecT, ...], shape: MeshShape,
              devices: list | tuple) -> RungGrid:
    """Lay ``rungs`` out over ``devices`` as ``shape`` prescribes: column
    ``j`` gets the contiguous block ``devices[j*data:(j+1)*data]`` as a
    1-D "data" mesh."""
    devices = list(devices)
    if shape.n_devices > len(devices):
        raise ValueError(f"grid {shape.label} needs {shape.n_devices} "
                         f"devices, have {len(devices)}")
    groups = balanced_rung_columns(rungs, shape.rung)
    cols = []
    for j, idxs in enumerate(groups):
        block = devices[j * shape.data:(j + 1) * shape.data]
        cols.append(GridColumn(
            mesh=Mesh(_device_array(block, (len(block),)), ("data",)),
            rungs=tuple(rungs[i] for i in idxs)))
    return RungGrid(shape=shape, columns=tuple(cols))
