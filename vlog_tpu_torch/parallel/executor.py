"""Stage-decoupled transcode executor (port of
``vlog_tpu/parallel/executor.py``).

Both codec paths of ``TorchBackend`` run their batches through one
loop, decoupled into overlapping stages:

- The dispatch thread queues a batch's device work on the run's compute
  stream and hands the outputs to :meth:`PipelineExecutor.submit`,
  which starts their device-to-host copies at once (:func:`start_d2h`)
  on a copy stream of the executor's own, so the copies of batch N
  overlap the kernels of batch N+1.
- A bounded in-flight window (``VLOG_PIPELINE_DEPTH``, default 2) lets
  the dispatch of batch N, the pull of batch N-1 and the entropy coding
  and packaging of batch N-2 proceed together;
  :meth:`PipelineExecutor.reserve` is the backpressure (call it BEFORE
  planning the next dispatch).
- One consumer thread per rung pulls and entropy-codes its rung, the
  rungs concurrently, each rung's batches strictly in order: packaging
  order, encoder state and resume semantics are the same at every
  depth.
- Frame-level entropy work fans out onto one host pool
  (``VLOG_ENTROPY_THREADS``), :attr:`PipelineExecutor.host_pool`.

The copies (``start_d2h`` on CUDA tensors): an event recorded on the
compute stream after the dispatch; the copy stream waits on it, copies
every output into pinned host buffers with ``non_blocking=True`` and
records a second event per top-level entry (per rung). The first
consumer of a batch waits on the first event (``ready``, timed as
``compute_wait_s``); a rung's pull waits on its copy event and reads
numpy views of the pinned buffers (``device_pull_s``). Each output
carries ``record_stream(copy_stream)``, so the caching allocator never
hands its memory to another tensor while the copy still reads it, and
nothing on the consumer side synchronizes the device or calls
``.cpu()``: either would also wait for the next batch's kernels, which
the dispatch thread has already queued. On CPU tensors there is nothing
to copy: ``ready`` returns at once and the pull reads the tensors. A
grid's outputs span devices (each rung on its column, a column's data
shards on its devices): then every device gets its own compute event,
copy stream and copy events, and the pull concatenates a rung's shards
on the host in data order (no peer copy onto one device, so each
device's copies overlap its own next kernels only).

Rate control stays deterministic under pipelining through
:class:`LaggedRateControl`: consumers post observations, the dispatch
thread applies them in batch order with a lag equal to the depth, so
the QP plan of batch N depends on exactly the batches <= N - depth
however the threads interleave. While a controller hunts, the backend
drains the window and applies feedback at once.

Chaos: the ``backend.pull`` / ``backend.entropy`` failpoints fire in
the consumer stage; a failing stage records the first error, the
remaining queued work is skipped, the dispatch thread re-raises it from
:meth:`reserve` / :meth:`drain`, and :meth:`close` joins every consumer.

Profiling: ``compute_wait_s`` / ``device_pull_s`` here, ``entropy_s`` /
``package_s`` from the path callbacks through :meth:`prof_add` —
cumulative busy seconds per stage — and :meth:`gauges` adds the overlap
view: configured depth, deepest window reached, consume-side busy vs
wall seconds. A path that queues its dispatch inside
:meth:`PipelineExecutor.timed_dispatch` also gets one record per
dispatch in :attr:`PipelineExecutor.dispatches` (host times of the
enqueue and of the compute seen done, and the dispatch's wall on the
device's clock, read once the first consumer's ``ready`` has waited on
the compute), and the sums ``enqueue_s`` and ``dispatch_wall_s``.

Thread hand-offs (the rung consumers, the host pool's side tasks, the
decode prefetch) carry the run's trace context (``obs/trace.py``
``capture``/``attach``).
"""

from __future__ import annotations

import contextlib
import logging
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.obs.metrics import runtime
from vlog_tpu_torch.obs.trace import DeviceClock, attach, capture
from vlog_tpu_torch.parallel.mesh import Sharded
from vlog_tpu_torch.utils import failpoints

_STOP = object()

# prof keys that count as consume-side busy time (occupancy numerator);
# waits are not busy.
_BUSY_KEYS = frozenset(("device_pull_s", "entropy_s", "package_s"))


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` with ``fn`` applied to every tensor (dicts, lists and
    tuples are walked; other leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _attached(ctx, fn: Callable, *args: Any) -> Any:
    """``fn(*args)`` under the trace context ``ctx`` (a pool task)."""
    with attach(ctx):
        return fn(*args)


def _cuda_tensors(tree: Any) -> list[torch.Tensor]:
    found: list[torch.Tensor] = []
    _map_tensors(tree, lambda t: found.append(t) if t.is_cuda else None)
    return found


def _assemble(tree: Any) -> Any:
    """``tree`` with every :class:`~vlog_tpu_torch.parallel.mesh.Sharded`
    of numpy shards concatenated along the leading axis, in data order."""
    if isinstance(tree, Sharded):
        return np.concatenate([_assemble(s) for s in tree], axis=0)
    if isinstance(tree, dict):
        return {k: _assemble(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_assemble(v) for v in tree)
    return tree


def to_host(tree: Any) -> Any:
    """``tree`` on the host now: every device its CUDA tensors lie on
    synchronized (their kernels may sit on any of its streams), every
    tensor as a numpy array, each ``Sharded`` concatenated in data
    order. For callers outside the pipeline (tests, the dry run); the
    pipeline pulls through :func:`start_d2h`."""
    for d in dict.fromkeys(t.device for t in _cuda_tensors(tree)):
        torch.cuda.synchronize(d)
    return _assemble(_map_tensors(tree, lambda t: t.cpu().numpy()))


class HostCopy:
    """The host side of one batch's outputs (see :func:`start_d2h`).

    ``wait_compute()`` blocks until the dispatch's kernels finished on
    every device; ``host(key)`` blocks until entry ``key``'s copies
    landed and returns it with every tensor as a numpy array, each
    :class:`~vlog_tpu_torch.parallel.mesh.Sharded` concatenated in data
    order (``key=None``: the whole tree)."""

    def __init__(self, host: Any, computed: list, copied: dict,
                 streams: dict):
        self._host = host
        self._computed = computed      # one event per device, compute side
        self._copied = copied          # top-level key -> events, copy side
        self.streams = streams         # device -> its copy stream

    @property
    def stream(self):
        """The copy stream of a one-device tree (None without CUDA
        tensors; the first device's for a tree over several)."""
        return next(iter(self.streams.values()), None)

    def wait_compute(self) -> None:
        for ev in self._computed:
            ev.synchronize()

    def host(self, key: Any = None) -> Any:
        if key is None:
            for evs in self._copied.values():
                for ev in evs:
                    ev.synchronize()
            tree = self._host
        else:
            for ev in self._copied.get(key, ()):
                ev.synchronize()
            tree = self._host[key]
        return _assemble(_map_tensors(tree, lambda t: t.numpy()))


def _pinned_copy(t: torch.Tensor, streams: dict) -> torch.Tensor:
    if not t.is_cuda:
        return t
    stream = streams[t.device]
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
    t.record_stream(stream)
    return host


def start_d2h(tree: Any, copy_stream=None) -> HostCopy:
    """Start the device-to-host copies of every CUDA tensor in ``tree``
    (dicts/lists/tuples of tensors, and ``Sharded`` splits whose shards
    may lie on several devices) and return their :class:`HostCopy`.

    Call it on the thread that queued the kernels, while each device's
    compute stream (the one its kernels were queued on) is that device's
    current stream: per device, an event recorded there is what the
    device's copy stream waits on. ``copy_stream`` is one stream (a
    one-device tree) or ``{device: stream}``; a device without one gets
    a new stream. Each tensor copies on its own device's copy stream
    into pinned host memory; a dict gets one copy event per top-level
    key and device, so a rung's pull waits only for its own devices'
    copies. Raises when a copy cannot be issued. Without CUDA tensors
    nothing starts and ``host`` reads the tensors as they are."""
    cuda = _cuda_tensors(tree)
    if not cuda:
        return HostCopy(tree, [], {}, {})
    devices = list(dict.fromkeys(t.device for t in cuda))
    if isinstance(copy_stream, dict):
        streams = {d: copy_stream[d] for d in devices if d in copy_stream}
    elif copy_stream is not None:
        streams = {copy_stream.device: copy_stream}
    else:
        streams = {}
    computed = []
    for d in devices:
        stream = streams.get(d)
        if stream is None:
            stream = streams[d] = torch.cuda.Stream(d)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        stream.wait_event(ev)
        computed.append(ev)
    groups = tree.items() if isinstance(tree, dict) else ((None, tree),)
    host, copied = {}, {}
    for key, sub in groups:
        host[key] = _map_tensors(sub, lambda t: _pinned_copy(t, streams))
        events = []
        for d in dict.fromkeys(t.device for t in _cuda_tensors(sub)):
            ev = torch.cuda.Event()
            ev.record(streams[d])
            events.append(ev)
        copied[key] = events
    if not isinstance(tree, dict):
        host = host[None]
    return HostCopy(host, computed, copied, streams)


class StagedBatch:
    """One dispatched batch traveling through the consume stages.

    ``outs`` is whatever the path's dispatch staged (per-rung device
    outputs), ``d2h`` their :class:`HostCopy`, ``qps`` the batch-indexed
    plan QPs rate-control attribution needs, ``extra`` any path-specific
    payload."""

    __slots__ = ("index", "outs", "n_real", "qps", "extra", "d2h", "record",
                 "_ready_lock", "_ready", "_remaining")

    def __init__(self, index: int, outs: Any, n_real: int, qps: Any,
                 extra: Any, n_rungs: int, record: dict | None = None):
        self.index = index
        self.outs = outs
        self.n_real = n_real
        self.qps = qps
        self.extra = extra
        self.record = record          # its timed_dispatch record, if any
        self.d2h: HostCopy | None = None
        self._ready_lock = threading.Lock()       # lock-order: 32
        self._ready = False
        self._remaining = n_rungs


class PipelineExecutor:
    """Bounded-depth, per-rung-ordered consumer for staged batches.

    ``pull(rung_name, batch)`` runs in the rung's consumer thread and
    returns the host data of that rung (timed as ``device_pull_s``);
    ``process(rung_name, batch, host)`` entropy-codes and packages it
    (the callback accounts its own ``entropy_s`` / ``package_s`` through
    :meth:`prof_add`). ``ready(batch)``, when given, runs exactly once
    per batch, by the first consumer to reach it (timed as
    ``compute_wait_s``). ``on_batch_done(batch)`` fires after the LAST
    rung finished a batch, before its in-flight slot frees; the calls are
    serialized and in batch order."""

    def __init__(self, rung_names: Iterable[str], *,
                 pull: Callable[[str, StagedBatch], Any],
                 process: Callable[[str, StagedBatch, Any], None],
                 ready: Callable[[StagedBatch], None] | None = None,
                 on_batch_done: Callable[[StagedBatch], None] | None = None,
                 depth: int | None = None,
                 host_pool: ThreadPoolExecutor | None = None,
                 host_threads: int | None = None,
                 prof: dict | None = None,
                 name: str = "vlog-pipe"):
        self.depth = config.PIPELINE_DEPTH if depth is None else max(1, depth)
        self._pull = pull
        self._process = process
        self._ready = ready
        self._on_batch_done = on_batch_done
        self.prof = prof if prof is not None else {}
        for key in ("compute_wait_s", "device_pull_s", "entropy_s",
                    "package_s"):
            self.prof.setdefault(key, 0.0)
        self._prof_lock = threading.Lock()        # lock-order: 34
        self._busy_s = 0.0
        self._cond = threading.Condition()        # lock-order: 30
        self._stop = threading.Event()
        self._in_flight = 0
        self._reserved = 0            # slots reserve() claimed for submit()
        self._max_in_flight = 0
        self._submitted = 0
        self._failure: BaseException | None = None
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._aux: list = []
        self._copy_streams: dict = {}     # device -> its copy stream
        # one record per timed dispatch; the clocks by record index until
        # the first consumer reads them (both under _prof_lock)
        self.dispatches: list[dict] = []
        self._clocks: dict[int, DeviceClock] = {}
        self._own_pool = host_pool is None
        if host_pool is None:
            host_pool = ThreadPoolExecutor(
                max_workers=host_threads or config.ENTROPY_THREADS,
                thread_name_prefix=f"{name}-host")
        self.host_pool = host_pool
        self._queues: dict[str, queue_mod.Queue] = {}
        self._threads: list[threading.Thread] = []
        ctx = capture()
        for rname in rung_names:
            q: queue_mod.Queue = queue_mod.Queue()
            self._queues[rname] = q
            t = threading.Thread(target=self._rung_loop, args=(rname, q, ctx),
                                 daemon=True, name=f"{name}-{rname}")
            self._threads.append(t)
            t.start()

    # ---- profiling ---------------------------------------------------
    def prof_add(self, key: str, seconds: float) -> None:
        """Accumulate stage time (thread-safe; callbacks use this too).
        ``entropy_s``/``package_s``/``device_pull_s`` also count toward
        consume-side busy time (the occupancy numerator)."""
        with self._prof_lock:
            self.prof[key] = self.prof.get(key, 0.0) + seconds
            if key in _BUSY_KEYS:
                self._busy_s += seconds

    @staticmethod
    def note_device_seconds(rung: str, seconds: float) -> None:
        """Device-time attribution into
        ``vlog_device_seconds{plane="ladder",rung=...}``: ``rung="compute"``
        is the shared compute wait, a rung name that rung's pull."""
        if seconds > 0:
            runtime().device_seconds.labels("ladder", rung).inc(seconds)

    def note_pad_waste(self, n_real: int, n_staged: int) -> None:
        """Record one dispatch's batch padding: the padded fraction on the
        ``vlog_ladder_pad_waste`` gauge, the thrown-away frames into the
        run profile as ``pad_frames``."""
        waste = ((n_staged - n_real) / n_staged) if n_staged > 0 else 0.0
        with self._prof_lock:
            self.prof["pad_frames"] = (self.prof.get("pad_frames", 0.0)
                                       + max(0, n_staged - n_real))
        runtime().ladder_pad_waste.set(waste)

    def gauges(self) -> dict:
        """Overlap gauges for ``RunResult.stage_s``: the configured
        window, the deepest it got, and consume-side busy vs wall seconds
        (busy > wall means rungs overlapped; occupancy is the ratio)."""
        with self._cond:
            t_first, t_last = self._t_first, self._t_last
            max_if = self._max_in_flight
        wall = (t_last - t_first) if t_first is not None \
            and t_last is not None else 0.0
        with self._prof_lock:
            busy = self._busy_s
        return {
            "pipeline_depth": self.depth,
            "max_in_flight": max_if,
            "host_busy_s": round(busy, 3),
            "host_wall_s": round(wall, 3),
            "host_occupancy": round(busy / wall, 3) if wall > 0 else 0.0,
        }

    # ---- dispatch-thread API -----------------------------------------
    @contextlib.contextmanager
    def timed_dispatch(self, frames: int, devices):
        """Time the dispatch queued inside (on the dispatch thread, inside
        its compute streams) and yield its record for :meth:`submit`:
        ``index``, ``frames``, ``t_enqueue0``/``t_enqueue1`` (host
        ``perf_counter`` around the enqueue), and, once the first consumer
        has waited on the compute, ``t_done`` and ``wall_s`` (the longest
        :class:`~vlog_tpu_torch.obs.trace.DeviceClock` wall over
        ``devices``; None without CUDA). Adds the enqueue to ``enqueue_s``
        and, when read, the wall to ``dispatch_wall_s``."""
        with self._prof_lock:
            self.prof.setdefault("enqueue_s", 0.0)
            self.prof.setdefault("dispatch_wall_s", 0.0)
            index = len(self.dispatches)
        rec = {"index": index, "frames": int(frames),
               "t_enqueue0": time.perf_counter(), "t_enqueue1": None,
               "t_done": None, "wall_s": None}
        clock = DeviceClock(devices)
        yield rec
        clock.stop()
        rec["t_enqueue1"] = time.perf_counter()
        self.prof_add("enqueue_s", rec["t_enqueue1"] - rec["t_enqueue0"])
        with self._prof_lock:
            self.dispatches.append(rec)
            self._clocks[index] = clock

    def _read_clock(self, rec: dict) -> None:
        """Stamp a dispatch record once its compute is seen done."""
        rec["t_done"] = time.perf_counter()
        with self._prof_lock:
            clock = self._clocks.pop(rec["index"], None)
        wall = None if clock is None else clock.wall_s()
        rec["wall_s"] = wall
        if wall is not None:
            self.prof_add("dispatch_wall_s", wall)

    def _await_slot_locked(self) -> None:
        """Wait for a free in-flight slot; caller holds ``_cond``.
        Raises the first consumer failure instead of waiting forever."""
        while self._failure is None and self._in_flight >= self.depth:
            self._cond.wait()
        if self._failure is not None:
            raise self._failure

    def _claim_locked(self) -> None:
        self._in_flight += 1
        self._max_in_flight = max(self._max_in_flight, self._in_flight)

    def reserve(self) -> None:
        """Block until the in-flight window has a free slot, and claim it
        for the next :meth:`submit`. Call BEFORE planning the next
        dispatch, so QP planning happens at a deterministic point
        (batches <= N-depth fully consumed). The batch counts as in
        flight from here: the port's dispatch queues its kernels
        synchronously, so a batch whose kernels are being queued already
        holds a slot of the window (the reference's asynchronous dispatch
        returns at once, and counts from its submit)."""
        with self._cond:
            self._await_slot_locked()
            self._claim_locked()
            self._reserved += 1

    def submit(self, outs: Any, n_real: int, qps: Any = None,
               extra: Any = None, record: dict | None = None) -> StagedBatch:
        """Hand a staged batch to the consumers (dispatch thread only,
        inside the stream its kernels were queued on), in the slot
        :meth:`reserve` claimed (or a slot claimed here). Starts the
        copies of ``outs``, then enqueues the batch to every rung.
        ``record`` is the batch's :meth:`timed_dispatch` record."""
        with self._cond:
            if self._reserved:
                self._reserved -= 1
            else:
                self._await_slot_locked()
                self._claim_locked()
            batch = StagedBatch(self._submitted, outs, n_real, qps, extra,
                                len(self._queues), record)
            self._submitted += 1
            if self._t_first is None:
                self._t_first = time.perf_counter()
        try:
            batch.d2h = start_d2h(outs, self._copy_streams)
        except BaseException:
            with self._cond:
                self._in_flight -= 1
                self._cond.notify_all()
            raise
        self._copy_streams.update(batch.d2h.streams)
        for q in self._queues.values():
            q.put(batch)
        return batch

    def submit_aux(self, fn: Callable, *args: Any) -> None:
        """Run a side task (the first batch's thumbnail) on the host
        pool; its failure surfaces at the next drain()."""
        self._aux.append(self.host_pool.submit(_attached, capture(), fn,
                                               *args))

    def drain(self) -> None:
        """Wait until every submitted batch is fully consumed (depth 0)
        and every aux task finished; re-raise the first failure."""
        with self._cond:
            while self._failure is None and self._in_flight > 0:
                self._cond.wait()
            if self._failure is not None:
                raise self._failure
        aux, self._aux = self._aux, []
        for fut in aux:
            fut.result()
        with self._cond:
            if self._failure is not None:
                raise self._failure

    def close(self) -> None:
        """Stop the consumers and release the owned pool. Never raises
        and is safe after any abort: the stop flag makes consumers skip
        still-queued batches (a zombie rung thread must not keep writing
        segments into a tree a retry may already be resuming), the
        threads are joined, and a join that times out is logged."""
        self._stop.set()
        for q in self._queues.values():
            q.put(_STOP)
        for t in self._threads:
            t.join(timeout=30)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            logging.getLogger("vlog_tpu_torch.executor").warning(
                "pipeline consumers failed to join within 30s: %s", alive)
        if self._own_pool:
            self.host_pool.shutdown(wait=True)

    # ---- consumer side -----------------------------------------------
    def _rung_loop(self, rname: str, q: queue_mod.Queue, ctx) -> None:
        with attach(ctx):
            while True:
                batch = q.get()
                if batch is _STOP:
                    return
                try:
                    if self._failure is None and not self._stop.is_set():
                        self._consume(rname, batch)
                except BaseException as exc:  # noqa: BLE001 — relayed
                    self._fail(exc)
                finally:
                    self._done(batch)

    def _consume(self, rname: str, batch: StagedBatch) -> None:
        if self._ready is not None and not batch._ready:
            with batch._ready_lock:
                if not batch._ready:
                    t0 = time.perf_counter()
                    self._ready(batch)
                    dt = time.perf_counter() - t0
                    if batch.record is not None:
                        self._read_clock(batch.record)
                    self.prof_add("compute_wait_s", dt)
                    self.note_device_seconds("compute", dt)
                    batch._ready = True
        failpoints.hit("backend.pull")
        t0 = time.perf_counter()
        host = self._pull(rname, batch)
        dt = time.perf_counter() - t0
        self.prof_add("device_pull_s", dt)
        self.note_device_seconds(rname, dt)
        failpoints.hit("backend.entropy")
        self._process(rname, batch, host)
        # per-rung consume busy seconds (pull + entropy + package), as
        # ``rung_<name>_s``; not a _BUSY_KEYS member: the stage sums
        # already count this time
        self.prof_add(f"rung_{rname}_s", time.perf_counter() - t0)

    def _fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._failure is None:
                self._failure = exc
            self._cond.notify_all()

    def _done(self, batch: StagedBatch) -> None:
        with self._cond:
            batch._remaining -= 1
            last = batch._remaining == 0
        if not last:
            return
        # on_batch_done runs BEFORE the slot frees, so drain() returning
        # implies every batch's hook ran; skipped batches (a failure, or
        # the stop flag after an abort) never report completion
        if (self._failure is None and not self._stop.is_set()
                and self._on_batch_done is not None):
            try:
                self._on_batch_done(batch)
            except BaseException as exc:  # noqa: BLE001 — relayed
                self._fail(exc)
        with self._cond:
            self._in_flight -= 1
            self._t_last = time.perf_counter()
            self._cond.notify_all()


# CUDA device index -> its compute stream (guarded by _COMPUTE_LOCK)
_COMPUTE_STREAMS: dict = {}
_COMPUTE_LOCK = threading.Lock()


def dispatch_stream(device: torch.device):
    """The context a run's dispatch thread queues its device work in: the
    device's compute stream on CUDA (the resize kernel and every torch op
    launch on the current stream, so work left on the legacy default
    stream would serialize against the copy stream), nothing on CPU.

    One compute stream per device for the process, reused by every run:
    torch keeps a cuBLAS workspace for each (handle, stream) pair it has
    seen until the process ends, so a stream per run would leave one
    more workspace allocated on the card after each run of a long-lived
    worker. Runs on one device at once (the
    scheduler leases one card to one job) would share it and serialize."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _COMPUTE_LOCK:
        stream = _COMPUTE_STREAMS.get(index)
        if stream is None:
            stream = _COMPUTE_STREAMS[index] = torch.cuda.Stream(index)
    return torch.cuda.stream(stream)


def dispatch_streams(devices):
    """:func:`dispatch_stream` of every distinct device in ``devices`` at
    once (a grid's dispatch thread): each device's compute stream is its
    current stream inside, so :func:`start_d2h` records each device's
    compute event where its kernels were queued."""
    stack = contextlib.ExitStack()
    for d in dict.fromkeys(torch.device(d) for d in devices):
        stack.enter_context(dispatch_stream(d))
    return stack


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` from the dispatch thread: on CUDA
    staged through pinned memory and copied without blocking on the
    current stream (a pageable copy could wait for the kernels already
    queued there)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DecodePrefetch:
    """The decode prefetch thread (``vlog-decode-prefetch``): reads or
    decodes the next batches of ``src.read_batches(batch_n, start)``
    into a fifo of ``maxsize`` while the device computes and the host
    entropy-codes. Sources yield host (numpy) planes, so the MP4
    decoder's device tensors never leave this thread: its reconstruction
    runs here, on the legacy default stream where the source was opened,
    and its planes reach the dispatch thread through host memory.

    :meth:`get` returns the next item, or None at the end, and re-raises
    a producer failure; :meth:`close` stops and joins the thread."""

    _EOF = object()

    def __init__(self, src, batch_n: int, start_frame: int,
                 maxsize: int = 2):
        self._fifo: queue_mod.Queue = queue_mod.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(src, batch_n, start_frame, capture()),
            daemon=True, name="vlog-decode-prefetch")
        self._thread.start()

    def _produce(self, src, batch_n: int, start_frame: int, ctx) -> None:
        with attach(ctx):
            self._produce_all(src, batch_n, start_frame)

    def _produce_all(self, src, batch_n: int, start_frame: int) -> None:
        try:
            for item in src.read_batches(batch_n, start_frame):
                while not self._stop.is_set():
                    try:
                        self._fifo.put(item, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue
                if self._stop.is_set():
                    return
            self._fifo.put(self._EOF)
        except BaseException as exc:  # noqa: BLE001 — relayed to get()
            self._fifo.put(exc)

    def get(self):
        item = self._fifo.get()
        if item is self._EOF:
            return None
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        while True:     # unblock a producer stuck on a full queue
            try:
                self._fifo.get_nowait()
            except queue_mod.Empty:
                break
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            logging.getLogger("vlog_tpu_torch.executor").warning(
                "decode prefetch failed to join within 30s")


class LaggedRateControl:
    """Deterministic rate-control feedback under pipelining.

    Consumer threads :meth:`post` per-batch observations; the dispatch
    thread :meth:`apply_upto` a batch index before planning the next
    dispatch. Observations apply strictly in batch order per rung, so
    the QP plan of batch N is a pure function of batches <= N - lag."""

    def __init__(self, controllers: dict):
        self._controllers = controllers
        self._pending: dict[str, deque] = {n: deque() for n in controllers}
        self._lock = threading.Lock()             # lock-order: 36

    def post(self, name: str, batch_index: int, *, nbytes: int,
             frames: int, frame_qps=None, cost: float | None = None) -> None:
        with self._lock:
            self._pending[name].append(
                (batch_index, nbytes, frames, frame_qps, cost))

    def apply_upto(self, batch_index: int) -> None:
        """Apply observations of batches <= ``batch_index`` in order
        (dispatch thread only). A negative index is a no-op."""
        for name, dq in self._pending.items():
            ctl = self._controllers[name]
            while True:
                with self._lock:
                    if not dq or dq[0][0] > batch_index:
                        break
                    _, nbytes, frames, mix, cost = dq.popleft()
                ctl.observe(nbytes, frames, frame_qps=mix)
                if cost is not None:
                    ctl.calibrate_proxy(nbytes, cost)

    def hunting(self) -> bool:
        """True while any controller wants the tight (depth-0) loop."""
        return any(c.hunting for c in self._controllers.values())

    def replay(self, entries: dict[int, dict], start_batch: int,
               depth: int) -> None:
        """Rebuild controller state from a rate-control journal
        (backends/rc_journal.py) as if batches ``0..start_batch-1`` had
        run live: the same apply lag and hunting drains as the dispatch
        loop. Afterwards, planning the resumed run's batch 0 reads the
        state the uninterrupted run had when it planned ``start_batch``.

        ``entries[k][rung]`` holds what :meth:`post` received for batch
        k. Observations posted but not yet applied at the resume point
        are re-indexed into the resumed run's batch space, so the lag
        schedule continues where it stopped."""
        for k in range(start_batch):
            self.apply_upto(k - depth)
            for name, ob in sorted(entries[k].items()):
                if name not in self._controllers:
                    continue
                self.post(name, k, nbytes=ob["bytes"], frames=ob["frames"],
                          frame_qps=ob.get("qps"), cost=ob.get("cost"))
            if self.hunting():
                self.apply_upto(k)
        with self._lock:
            for dq in self._pending.values():
                shifted = [(k - start_batch, *rest) for (k, *rest) in dq]
                dq.clear()
                dq.extend(shifted)
