"""Remote worker: claims jobs over the Worker API, processes on the card,
streams outputs back (port of ``vlog_tpu/worker/remote.py``).

Reference parity: worker/remote_transcoder.py:390-1698 + http_client.py —
claim over HTTP, download the source, transcode with the local accelerator
backend, upload outputs as they appear (streaming overlap with device
compute — the segment-watcher pipeline, reference streaming_upload.py),
then complete with server-side verification. Every progress post extends
the lease; an HTTP 409 means the claim was lost and aborts the job at the
next batch boundary (reference check_claim_expiration:277-300).

The HTTP client is ``aiohttp`` (the JAX package's uses ``httpx``): each
``httpx`` transport-error site maps to ``aiohttp.ClientError``,
``OSError`` and ``asyncio.TimeoutError``; a non-2xx answer raises
``aiohttp.ClientResponseError``; timeouts are per connect and per socket
read, as ``httpx``'s are per phase. Upload bodies stream from an async
generator, so they go out with chunked transfer encoding (so do
``httpx``'s); the server hashes what it reads either way.

Device: ``RemoteWorker.device`` (default ``"cuda"``, which raises at
construction without CUDA; only tests pass ``"cpu"``) goes to
``process_video``, ``generate_sprites`` and ``transcribe_video``. As in
the reference, a remote worker runs no slot scheduler: the server refunds
a ``device_fault`` attempt and the compute breaker contains the worker;
its restart path is the ``restart`` command verb (exit code
``mgmt.RESTART_EXIT_CODE``).

Run it: ``python -m vlog_tpu_torch.worker.remote --api http://host:9002
--key ...`` (always on CUDA: the CLI has no device option).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import re
import shutil
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import aiohttp

from vlog_tpu_torch import config
from vlog_tpu_torch.codecs import validate_codec_format
from vlog_tpu_torch.enums import AcceleratorKind, FailureClass, JobKind
from vlog_tpu_torch.obs import trace as obs_trace
from vlog_tpu_torch.obs.metrics import runtime as obs_runtime
from vlog_tpu_torch.storage import integrity
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker.breaker import CircuitBreaker
from vlog_tpu_torch.worker.daemon import DaemonStats, _release_frames
from vlog_tpu_torch.worker.drain import (DRAIN_CANCEL_REASON, DrainState,
                                         PreemptionWatcher)
from vlog_tpu_torch.worker.watchdog import ComputeWatchdogMixin, JobCancelled

log = logging.getLogger("vlog_tpu_torch.remote")


class ClaimLost(Exception):
    """HTTP 409: the server handed our claim to someone else."""


class TransientAPIError(Exception):
    pass


RETRY_STATUS = frozenset({502, 503, 504})
# Upload-specific retryables on top of the 5xx family: 422 is the
# server's digest-mismatch verdict (the bytes corrupted in flight — a
# fresh attempt sends a fresh body), 507 is disk-pressure admission
# (the GC sweep or operator frees space; bounded retries cover the
# transient case, exhaustion classifies transient and backs off).
UPLOAD_RETRY_STATUS = RETRY_STATUS | {422, 507}
_UP_CHUNK = 1 << 20
# what httpx.TransportError covers in the reference: no answer arrived
TRANSPORT_ERRORS = (aiohttp.ClientError, OSError, asyncio.TimeoutError)


def _timeout(seconds: float) -> aiohttp.ClientTimeout:
    """Per-phase bounds (connect, each socket read), no total: a long
    download keeps going while bytes flow."""
    return aiohttp.ClientTimeout(total=None, connect=seconds,
                                 sock_read=seconds)


@dataclass
class APIResponse:
    """A finished answer: status, headers and the whole body (read
    before the connection went back to the pool)."""

    status: int
    headers: Any
    body: bytes
    reason: str | None = None
    request_info: Any = None

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.body)

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise aiohttp.ClientResponseError(
                self.request_info, (), status=self.status,
                message=self.reason or "", headers=self.headers)


class WorkerAPIClient:
    """Typed async client for the Worker API with bounded retries.

    Reference parity: worker/http_client.py:55-1170 (retry classification;
    the circuit breaker there protects a much chattier surface — here
    bounded exponential retry on transport errors/5xx covers the same
    failure envelope). The ``aiohttp`` session opens on the first request,
    inside the event loop that uses it.
    """

    def __init__(self, base_url: str, api_key: str, *, timeout: float = 120.0,
                 retries: int = 3):
        self.base_url = base_url.rstrip("/")
        self.retries = retries
        self.api_key = api_key
        self._timeout = timeout
        # Fencing tokens: job id -> the claim's attempt number, sent as
        # X-Claim-Epoch on every claim-gated write so a swept-and-
        # reclaimed job's stale incarnation gets 409 instead of
        # corrupting the successor attempt (video map serves uploads,
        # which are addressed by video id).
        self._epochs: dict[int, int] = {}
        self._video_jobs: dict[int, int] = {}
        self.headers = {"Authorization": f"Bearer {api_key}"}
        self._session: aiohttp.ClientSession | None = None

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                headers=self.headers, timeout=_timeout(self._timeout))
        return self._session

    async def aclose(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    @classmethod
    async def register(cls, base_url: str, name: str, *,
                       admin_secret: str = "", accelerator: str = "tpu",
                       capabilities: dict | None = None) -> str:
        """One-time registration; returns the API key (shown once)."""
        async with aiohttp.ClientSession(timeout=_timeout(30.0)) as c:
            async with c.post(f"{base_url.rstrip('/')}/api/worker/register",
                              json={"name": name, "accelerator": accelerator,
                                    "capabilities": capabilities or {}},
                              headers={"X-Admin-Secret": admin_secret}) as r:
                r.raise_for_status()
                return (await r.json())["api_key"]

    def _epoch_headers(self, *, job_id: int | None = None,
                       video_id: int | None = None) -> dict[str, str]:
        """The X-Claim-Epoch fencing header for a claim-gated write.

        The ``claim.fence`` failpoint forces a STALE epoch onto the next
        armed write — chaos runs use it to prove the server's 409 fence
        actually holds."""
        if job_id is None and video_id is not None:
            job_id = self._video_jobs.get(video_id)
        epoch = self._epochs.get(job_id) if job_id is not None else None
        if epoch is None:
            return {}
        try:
            failpoints.hit("claim.fence")
        except failpoints.FailpointError:
            epoch = max(0, epoch - 1)
        return {"X-Claim-Epoch": str(epoch)}

    def _forget_claim(self, job_id: int | None) -> None:
        if job_id is None:
            return
        self._epochs.pop(job_id, None)
        for vid, jid in list(self._video_jobs.items()):
            if jid == job_id:
                self._video_jobs.pop(vid, None)

    async def _fenced_request(self, method: str, path: str, *,
                              job_id: int | None = None,
                              video_id: int | None = None,
                              **kw) -> APIResponse:
        """A claim-gated write carrying X-Claim-Epoch. Fencing state is
        deliberately KEPT on ClaimLost: a zombie incarnation must keep
        sending its stale epoch (and keep bouncing 409) rather than
        degrade to epochless writes the ownership gate would re-admit
        under the same worker name. The job-lifecycle owner
        (RemoteWorker.poll_once, or complete/fail/release success)
        forgets the entry when the attempt is over, so the map is
        bounded by in-flight jobs, not lost-claim history."""
        headers = {**self._epoch_headers(job_id=job_id, video_id=video_id),
                   **(kw.pop("headers", None) or {})}
        return await self._request(method, path, headers=headers, **kw)

    @staticmethod
    def _trace_headers() -> dict[str, str]:
        """Propagate the active trace across the HTTP hop (the server's
        request-id middleware honors X-Trace-Id / X-Parent-Span, so its
        spans for this call join the job's trace)."""
        ctx = obs_trace.current()
        if ctx is None:
            return {}
        headers = {"X-Trace-Id": ctx.trace_id}
        if ctx.span_id:
            headers["X-Parent-Span"] = ctx.span_id
        return headers

    async def _send(self, method: str, path: str, *,
                    timeout: float | None = None, **kw) -> APIResponse:
        if timeout is not None:
            kw["timeout"] = _timeout(timeout)
        async with self._http().request(method, self.base_url + path,
                                        **kw) as r:
            body = await r.read()
            return APIResponse(r.status, r.headers, body, r.reason,
                               r.request_info)

    async def _request(self, method: str, path: str, **kw) -> APIResponse:
        headers = {**self._trace_headers(), **(kw.pop("headers", None) or {})}
        if headers:
            kw["headers"] = headers
        delay = 0.5
        for attempt in range(self.retries + 1):
            try:
                resp = await self._send(method, path, **kw)
            except TRANSPORT_ERRORS as exc:
                if attempt == self.retries:
                    raise TransientAPIError(str(exc)) from exc
            else:
                if resp.status == 409:
                    raise ClaimLost(resp.text[:300])
                if resp.status in RETRY_STATUS and attempt < self.retries:
                    pass
                else:
                    resp.raise_for_status()
                    return resp
            await asyncio.sleep(delay)
            delay *= 2
        raise TransientAPIError(f"{method} {path}: retries exhausted")

    async def heartbeat(self, capabilities: dict | None = None, *,
                        draining: bool = False) -> None:
        await self._request("POST", "/api/worker/heartbeat",
                            json={"capabilities": capabilities or {},
                                  "draining": draining})

    def _register_claim(self, data: dict) -> dict:
        job = data.get("job") or {}
        if job.get("id") is not None:
            # the claim's attempt number IS the fencing epoch for every
            # write this attempt will make
            self._epochs[job["id"]] = int(job.get("attempt") or 0)
            if job.get("video_id") is not None:
                self._video_jobs[job["video_id"]] = job["id"]
        return data

    def _claim_body_kw(self, kinds: list[str], accelerator: str,
                       wait_s: float) -> tuple[dict, dict]:
        body = {"kinds": kinds, "accelerator": accelerator,
                "code_version": config.CODE_VERSION}
        kw: dict = {}
        if wait_s > 0:
            body["wait_s"] = wait_s
            # the HTTP request must outlive the server-side park
            kw["timeout"] = self._timeout + wait_s
        return body, kw

    async def claim(self, kinds: list[str], accelerator: str, *,
                    wait_s: float = 0.0) -> dict | None:
        """Claim one job. ``wait_s`` > 0 long-polls: the server parks
        the request until a job becomes claimable (or the wait lapses),
        so an idle fleet learns of new work in wakeup latency instead
        of a poll interval."""
        failpoints.hit("remote.claim")
        body, kw = self._claim_body_kw(kinds, accelerator, wait_s)
        r = await self._request("POST", "/api/worker/claim", json=body, **kw)
        if r.status == 204:
            return None
        return self._register_claim(r.json())

    async def claim_batch(self, kinds: list[str], accelerator: str, *,
                          max_jobs: int, wait_s: float = 0.0) -> list[dict]:
        """Claim up to ``max_jobs`` jobs in ONE request (one server-side
        transaction); returns the claim entries (``{job, video, trace}``
        each), empty when nothing is eligible after any long-poll wait."""
        failpoints.hit("remote.claim")
        body, kw = self._claim_body_kw(kinds, accelerator, wait_s)
        body["max_jobs"] = max_jobs
        r = await self._request("POST", "/api/worker/claim", json=body, **kw)
        if r.status == 204:
            return []
        return [self._register_claim(e)
                for e in (r.json().get("jobs") or [])]

    async def progress(self, job_id: int, *, progress: float | None = None,
                       current_step: str | None = None,
                       qualities: dict | None = None,
                       checkpoint: dict | None = None) -> None:
        """Progress post; extends the lease. ``checkpoint`` lands in the
        job row's ``last_checkpoint`` — the incremental upload inventory
        a successor reads after a preemption. Epoch-fenced like every
        claim-gated write: a stale incarnation's checkpoint gets 409."""
        await self._fenced_request(
            "POST", f"/api/worker/jobs/{job_id}/progress", job_id=job_id,
            json={"progress": progress, "current_step": current_step,
                  "qualities": qualities, "checkpoint": checkpoint})

    async def complete(self, job_id: int, result: dict) -> None:
        await self._fenced_request(
            "POST", f"/api/worker/jobs/{job_id}/complete", job_id=job_id,
            json={"result": result})
        self._forget_claim(job_id)

    async def fail(self, job_id: int, error: str, *,
                   permanent: bool = False,
                   failure_class: str | None = None) -> None:
        await self._fenced_request(
            "POST", f"/api/worker/jobs/{job_id}/fail", job_id=job_id,
            json={"error": error, "permanent": permanent,
                  "failure_class": failure_class})
        self._forget_claim(job_id)

    async def release(self, job_id: int) -> None:
        await self._fenced_request(
            "POST", f"/api/worker/jobs/{job_id}/release", job_id=job_id)
        self._forget_claim(job_id)

    async def download_source(self, video_id: int, dest: Path) -> Path:
        """Stream the source into directory ``dest``; returns the file path."""
        dest.mkdir(parents=True, exist_ok=True)
        async with self._http().get(
                f"{self.base_url}/api/worker/source/{video_id}") as r:
            r.raise_for_status()
            name = r.headers.get("X-Source-Name", f"source_{video_id}")
            out = dest / name
            await self._stream_to(r, out)
            return out

    async def download_output(self, video_id: int, rel: str,
                              dest: Path) -> Path:
        """Fetch one server-held output file (the cross-worker resume
        prefetch: a successor pulls the preempted attempt's verified
        partial segments before starting compute)."""
        async with self._http().get(
                f"{self.base_url}/api/worker/output/{video_id}/{rel}") as r:
            if r.status == 409:
                raise ClaimLost((await r.read())[:300].decode("utf-8",
                                                              "replace"))
            r.raise_for_status()
            dest.parent.mkdir(parents=True, exist_ok=True)
            await self._stream_to(r, dest)
            return dest

    @staticmethod
    async def _stream_to(r: aiohttp.ClientResponse, out: Path) -> None:
        """Drain a streaming response into ``out`` via tmp+rename; file
        I/O hops to threads (asyncblock: a slow volume must not stall
        the event loop that is also posting lease heartbeats)."""
        tmp = out.with_suffix(out.suffix + ".part")
        fp = await asyncio.to_thread(open, tmp, "wb")
        try:
            async for chunk in r.content.iter_chunked(1 << 20):
                await asyncio.to_thread(fp.write, chunk)
        finally:
            await asyncio.to_thread(fp.close)
        await asyncio.to_thread(tmp.rename, out)

    async def upload_file(self, video_id: int, rel: str, path: Path) -> str:
        """Stream a file up without buffering it in memory; retries reopen
        the file so each attempt sends a fresh body. The file's SHA-256
        (computed before send, returned to the caller) rides the
        ``X-Content-SHA256`` header; the server re-hashes what it
        received and a mismatch comes back 422 — retried here, since a
        fresh attempt re-sends the true bytes."""
        digest = await asyncio.to_thread(integrity.sha256_file, path)

        async def body():
            # The upload.corrupt failpoint simulates a corrupting hop:
            # the first chunk is bit-flipped while the digest header
            # still carries the truth — only the server's integrity
            # check can catch it. Consumed per attempt, so a count
            # budget corrupts N transfers and then lets retries land.
            corrupt = False
            try:
                failpoints.hit("upload.corrupt")
            except failpoints.FailpointError:
                corrupt = True
            first = True
            fp = await asyncio.to_thread(open, path, "rb")
            try:
                while True:
                    chunk = await asyncio.to_thread(fp.read, _UP_CHUNK)
                    if not chunk:
                        if first and corrupt:
                            yield b"\x00"   # corrupt an empty file too
                        return
                    if first and corrupt:
                        chunk = bytes([chunk[0] ^ 0xFF]) + chunk[1:]
                    first = False
                    yield chunk
            finally:
                await asyncio.to_thread(fp.close)

        delay = 0.5
        url = f"/api/worker/upload/{video_id}/{rel}"
        headers = {"X-Content-SHA256": digest, **self._trace_headers(),
                   **self._epoch_headers(video_id=video_id)}
        for attempt in range(self.retries + 1):
            try:
                failpoints.hit("remote.upload")
                resp = await self._send("PUT", url, data=body(),
                                        headers=headers)
            except (*TRANSPORT_ERRORS, failpoints.FailpointError) as exc:
                # an injected upload fault takes the same bounded-retry
                # path a real transport fault takes
                if attempt == self.retries:
                    raise TransientAPIError(str(exc)) from exc
            else:
                if resp.status == 409:
                    raise ClaimLost(resp.text[:300])
                if not (resp.status in UPLOAD_RETRY_STATUS
                        and attempt < self.retries):
                    resp.raise_for_status()
                    return digest
            await asyncio.sleep(delay)
            delay *= 2
        raise TransientAPIError(f"PUT {url}: retries exhausted")

    async def upload_status(self, video_id: int) -> dict[str, dict]:
        """Server-side inventory: ``rel -> {size, sha256}``."""
        r = await self._request("GET",
                                f"/api/worker/upload/{video_id}/status")
        return r.json()["files"]

    async def post_spans(self, job_id: int, spans: list[dict]) -> None:
        """Ship finished worker spans into the job's server-side trace
        (claim-gated server-side; call before complete/fail)."""
        await self._fenced_request(
            "POST", f"/api/worker/jobs/{job_id}/spans", job_id=job_id,
            json={"spans": spans})

    async def poll_commands(self) -> list[dict]:
        r = await self._request("GET", "/api/worker/commands")
        return r.json()["commands"]

    async def respond_command(self, command_id: int, response: dict) -> None:
        await self._request(
            "POST", f"/api/worker/commands/{command_id}/response",
            json={"response": response})

    async def healthz(self) -> bool:
        """Side-effect-free reachability check (readiness probes must NOT
        go through /heartbeat, whose write would mask a wedged worker)."""
        try:
            r = await self._send("GET", "/healthz")
            return r.status == 200
        except TRANSPORT_ERRORS:
            return False


# --------------------------------------------------------------------------
# Streaming uploader: publish outputs while the transcode is still running
# --------------------------------------------------------------------------

# Manifests/playlists are written last by the backend but must also be
# uploaded last so the server-side validation pass sees segments first.
# The rate-control journal defers too, for the opposite reason: it is
# APPEND-ONLY during the run, and the run-loop uploads each path once —
# shipping it early would freeze a stale prefix on the server. flush()
# (preemption) and drain() (completion) send it fresh.
_DEFER = ("master.m3u8", "manifest.mpd", "rc_journal.jsonl")


class StreamingUploader:
    """Polls an output tree and uploads new stable files concurrently with
    the transcode (reference SegmentWatcher/SegmentUploadWorker,
    segment_watcher.py:39 + streaming_upload.py:306-607). Files are
    published atomically by the backend (tmp+rename), so existence is
    stability."""

    def __init__(self, client: WorkerAPIClient, video_id: int, root: Path,
                 *, poll_s: float = 1.0, skip_prefixes: tuple[str, ...] = (),
                 on_checkpoint=None):
        self.client = client
        self.video_id = video_id
        self.root = root
        self.poll_s = poll_s
        self.skip_prefixes = skip_prefixes
        self.uploaded: set[str] = set()
        self.bytes_sent = 0
        self.errors: list[str] = []
        # async ({files, bytes}) -> None, called after every poll cycle
        # that shipped at least one file — the incremental-checkpoint
        # hook (RemoteWorker posts it as the job's last_checkpoint, so
        # the server knows what it holds the moment this host dies)
        self.on_checkpoint = on_checkpoint
        # (size, mtime_ns) of each file resume_state accepted as already
        # uploaded — if the backend later invalidates and rewrites one
        # (resumed run under a changed encoder config), the stat changes
        # and the final sweeps must re-ship it, or the published tree
        # would silently mix predecessor- and successor-config bytes
        self._resumed_stat: dict[str, tuple[int, int]] = {}
        self._stop = asyncio.Event()

    async def resume_state(self) -> None:
        """Skip files the server already holds with matching size AND
        digest. A corrupt same-size partial (a resumed run after a
        mid-upload crash, a bit-flipped transfer published before the
        integrity plane) digest-mismatches and gets re-uploaded."""
        have = await self.client.upload_status(self.video_id)
        for rel, meta in have.items():
            if rel == integrity.MANIFEST_NAME \
                    or Path(rel).name == "rc_journal.jsonl":
                # never resume the integrity manifest (the tree it must
                # describe is still changing; drain() rewrites it) nor
                # the rate-control journal (append-only during the run —
                # a t0 digest match would freeze the stale prefix on the
                # server). Master/DASH playlists MAY resume: the run
                # rewrites them at the end, so a changed tree simply
                # digest-mismatches and re-uploads.
                continue
            local = self.root / rel
            if not local.exists() \
                    or local.stat().st_size != meta.get("size"):
                continue
            local_digest = await asyncio.to_thread(
                integrity.sha256_file, local)
            if local_digest == meta.get("sha256"):
                self.uploaded.add(rel)
                st = local.stat()
                self._resumed_stat[rel] = (st.st_size, st.st_mtime_ns)

    def _pending(self, include_deferred: bool) -> list[str]:
        out = []
        if not self.root.exists():
            return out
        for p in sorted(self.root.rglob("*")):
            if not p.is_file() or p.suffix in (".part", ".tmp"):
                continue
            rel = str(p.relative_to(self.root))
            if rel in self.uploaded or rel == integrity.MANIFEST_NAME:
                # the manifest is drain()'s last word, never a poll pickup
                continue
            if any(rel.startswith(pre) for pre in self.skip_prefixes):
                continue
            if not include_deferred and Path(rel).name in _DEFER:
                continue
            out.append(rel)
        return out

    async def _upload_one(self, rel: str) -> None:
        await self.client.upload_file(self.video_id, rel, self.root / rel)
        self.uploaded.add(rel)
        self.bytes_sent += (self.root / rel).stat().st_size

    async def run(self) -> None:
        """Poll-and-upload until stopped; manifests deferred to drain().

        Per-cycle error containment: a transient API outage longer than
        the client's retry budget must pause streaming for one poll, not
        silently kill this task for the rest of a multi-hour run (the
        final drain/flush would then have to ship the whole tree inside
        the eviction window — the loss this plane exists to bound)."""
        while not self._stop.is_set():
            try:
                shipped = 0
                for rel in self._pending(include_deferred=False):
                    if self._stop.is_set():
                        return
                    await self._upload_one(rel)
                    shipped += 1
                if shipped:
                    await self._checkpoint()
            except ClaimLost as exc:
                # the claim is gone; the compute thread gets the same
                # verdict from its next progress post — stop streaming
                log.warning("streaming upload stopped, claim lost: %s", exc)
                return
            except Exception as exc:  # noqa: BLE001 — contain, log,
                # retry next cycle (incl. failpoint-injected checkpoint
                # faults: segments keep streaming even when checkpoint
                # posts fail)
                self.errors.append(str(exc))
                log.warning("streaming upload cycle failed (retrying "
                            "next poll): %s", exc)
            try:
                await asyncio.wait_for(self._stop.wait(), self.poll_s)
            except asyncio.TimeoutError:
                pass

    async def _checkpoint(self) -> None:
        """Incremental checkpoint: tell the job plane what the server
        now verifiably holds (``checkpoint.upload`` is the chaos hook)."""
        if self.on_checkpoint is None:
            return
        failpoints.hit("checkpoint.upload")
        await self.on_checkpoint({"files": len(self.uploaded),
                                  "bytes": self.bytes_sent})

    def stop(self) -> None:
        self._stop.set()

    def _unmark_rewritten_resumes(self) -> None:
        """Drop the 'already uploaded' mark from any resumed file the
        backend rewrote since resume_state (stat changed): a resumed run
        under a changed encoder config invalidates and re-encodes the
        prefetched prefix, and those fresh bytes must ship."""
        for rel, (size, mtime_ns) in list(self._resumed_stat.items()):
            p = self.root / rel
            try:
                st = p.stat()
                unchanged = (st.st_size, st.st_mtime_ns) == (size, mtime_ns)
            except OSError:
                unchanged = False      # deleted: nothing to re-upload,
                # but it must not linger as "uploaded" either
            if not unchanged:
                self.uploaded.discard(rel)
                self._resumed_stat.pop(rel, None)

    async def flush(self) -> tuple[int, int]:
        """Preemption flush: stop polling and push every remaining
        stable file — completed segments, the thumbnail, and the
        deferred rate-control journal — so the server-side partial tree
        is as complete as the eviction window allows. Mid-run there are
        no master/DASH manifests yet, so unlike drain() this publishes
        nothing a player could follow. Best effort per file: one failed
        transfer must not forfeit the rest of the eviction window.
        Returns (files, bytes) shipped."""
        self.stop()
        self._unmark_rewritten_resumes()
        n0, b0 = len(self.uploaded), self.bytes_sent
        for rel in self._pending(include_deferred=True):
            try:
                await self._upload_one(rel)
            except Exception as exc:  # noqa: BLE001 — keep flushing the
                # rest; whatever misses, the successor re-encodes
                self.errors.append(f"{rel}: {exc}")
                log.warning("preemption flush of %s failed: %s", rel, exc)
        return len(self.uploaded) - n0, self.bytes_sent - b0

    async def drain(self) -> None:
        """Final sweep: remaining files, then the deferred playlists,
        then — strictly last — the ``outputs.json`` integrity manifest.
        The ordering is the integrity contract: a manifest can only
        describe files that are already uploaded, so the server's
        ``complete`` verification never races a transfer.

        The manifest is built from the server's post-drain inventory,
        not just this run's digests: a reencode uploads only its new
        format while the thumbnail (and anything else published by an
        earlier job) stays on the server — a digests-only manifest
        would silently shrink verify coverage with every reencode."""
        self.stop()
        self._unmark_rewritten_resumes()
        for rel in self._pending(include_deferred=False):
            await self._upload_one(rel)
        for rel in self._pending(include_deferred=True):
            await self._upload_one(rel)
        have = await self.client.upload_status(self.video_id)
        manifest = {
            rel: {"size": meta["size"], "sha256": meta["sha256"]}
            for rel, meta in sorted(have.items())
            if rel != integrity.MANIFEST_NAME
        }
        path = await asyncio.to_thread(
            integrity.write_manifest, self.root, manifest)
        await self.client.upload_file(
            self.video_id, integrity.MANIFEST_NAME, path)


# --------------------------------------------------------------------------
# The remote worker loop
# --------------------------------------------------------------------------

@dataclass
class RemoteWorker(ComputeWatchdogMixin):
    client: WorkerAPIClient
    name: str
    work_dir: Path
    accelerator: AcceleratorKind = AcceleratorKind.TPU
    kinds: tuple[JobKind, ...] = (JobKind.TRANSCODE, JobKind.SPRITE,
                                  JobKind.TRANSCRIPTION)
    # REENCODE is opt-in for remote workers (payload-dependent formats)
    backend: Any = None
    # The jobs' device ("cuda" unless a test asks for "cpu").
    device: str = "cuda"
    poll_interval_s: float = field(
        default_factory=lambda: config.WORKER_POLL_INTERVAL_S)
    heartbeat_interval_s: float = field(
        default_factory=lambda: float(config.HEARTBEAT_INTERVAL_S))
    progress_min_interval_s: float = 2.0
    cancel_grace_s: float = 120.0
    keep_work_dirs: bool = False
    transcription_model_dir: str | None = None
    # Same breaker shape as WorkerDaemon: consecutive compute failures
    # stop the claim loop until a half-open probe succeeds.
    breaker: CircuitBreaker | None = None
    # Stall watchdog (WorkerDaemon parity): cancel compute whose progress
    # has not advanced within this window; 0 disables.
    stall_window_s: float = field(
        default_factory=lambda: config.STALL_WINDOW_S)
    watchdog_tick_s: float = 1.0
    # Coordination-plane brownout breaker (worker/brownout.py): paces the
    # claim loop through an unreachable Worker API instead of fixed-pace
    # hammering; None builds one from config.
    db_breaker: Any = None
    # Grace-budgeted drain (worker/drain.py), WorkerDaemon parity.
    drain_grace_s: float = field(
        default_factory=lambda: config.DRAIN_GRACE_S)
    drain_tick_s: float = 0.2
    # Long-poll claim wait. None = auto: park on the server for up to
    # min(poll_interval_s, VLOG_CLAIM_WAIT_MAX_S); 0 = classic poll-only
    # (tests, bench baselines, servers predating the long-poll claim).
    claim_wait_s: float | None = None

    def __post_init__(self) -> None:
        from vlog_tpu_torch.device import resolve_device

        # no fallback: without CUDA only an explicit device="cpu" runs
        resolve_device(self.device)
        self.stats = DaemonStats()
        self._idle_delay = self.poll_interval_s
        self.restart_requested = False
        self.disk_paused = False
        self._span_buffer = None      # the active attempt's TraceBuffer
        self._next_pressure_sweep = 0.0
        self._stop = asyncio.Event()
        self._cancel = threading.Event()
        self._cancel_reason = ""
        self.drain = DrainState()
        self._drain_task: asyncio.Task | None = None
        self._current_job_id: int | None = None
        if self.breaker is None:
            self.breaker = CircuitBreaker()
        if self.db_breaker is None:
            from vlog_tpu_torch.worker.brownout import CoordinationBreaker

            self.db_breaker = CoordinationBreaker(source="remote")
        self._reset_watchdog()
        from vlog_tpu_torch.utils.logring import install_ring

        install_ring()

    def request_stop(self) -> None:
        self._stop.set()
        self._cancel_reason = self._cancel_reason or "shutdown"
        self._cancel.set()

    def handle_termination(self) -> None:
        """First SIGTERM: grace-budgeted drain. Second: force-stop now
        (claims released) — WorkerDaemon parity."""
        if self._stop.is_set():
            return
        if self.drain.active:
            log.warning("second termination signal during drain: skipping "
                        "the grace window, force-cancelling now")
            self.request_stop()
        else:
            self.begin_drain("SIGTERM")

    def begin_drain(self, reason: str) -> bool:
        """Enter DRAINING: no new claims; the in-flight job keeps
        encoding and streaming segments up, its lease heartbeat-extended,
        until it finishes or the grace deadline force-cancels it (the
        cancel path then flushes a final checkpoint and requeues the job
        as a refunded ``preempted`` failure)."""
        if not self.drain.begin(reason, self.drain_grace_s):
            return False
        obs_runtime().worker_draining.set(1)
        log.warning("entering drain (%s): claiming stopped, job %s in "
                    "flight, grace %.0fs", reason, self._current_job_id,
                    self.drain_grace_s)
        self._drain_task = asyncio.create_task(self._drain_loop(),
                                              name="vlog-drain")
        return True

    async def _drain_loop(self) -> None:
        forced = False
        last_extend = 0.0
        try:
            try:
                await self.client.heartbeat(draining=True)
            except Exception:  # noqa: BLE001 — an API flap must not
                # skip the drain itself
                log.warning("drain heartbeat failed; draining anyway",
                            exc_info=True)
            while not self._stop.is_set():
                job_id = self._current_job_id
                if job_id is None:
                    break
                if forced or self.drain.expired():
                    if not forced:
                        forced = True
                        log.warning("drain grace exhausted; "
                                    "force-cancelling job %s", job_id)
                    # re-set every tick (idempotent): a claim that raced
                    # begin_drain clears _cancel at claim time and must
                    # still see the deadline cancel
                    self._cancel_reason = (self._cancel_reason
                                           or DRAIN_CANCEL_REASON)
                    self._cancel.set()
                now = time.monotonic()
                if not forced and now - last_extend >= min(
                        self.heartbeat_interval_s, 10.0):
                    last_extend = now
                    try:
                        await self.client.progress(job_id)
                    except ClaimLost as exc:
                        # the job is no longer ours (sweep/admin requeue
                        # raced the drain): cancel NOW instead of burning
                        # the rest of the grace window computing for a
                        # claim every write will 409
                        log.warning("claim lost during drain (job %s): "
                                    "cancelling: %s", job_id, exc)
                        self._cancel_reason = (self._cancel_reason
                                               or "claim lost during drain")
                        self._cancel.set()
                    except TransientAPIError:
                        pass    # next tick retries; the lease has slack
                try:
                    await asyncio.wait_for(self._stop.wait(),
                                           self.drain_tick_s)
                except asyncio.TimeoutError:
                    pass
        finally:
            obs_runtime().worker_draining.set(0)
            obs_runtime().drain_seconds.observe(self.drain.elapsed_s())
            log.info("drain complete in %.1fs (%s); stopping worker",
                     self.drain.elapsed_s(),
                     "deadline forced" if forced else "clean")
            self.request_stop()

    async def _on_preemption_notice(self, reason: str) -> None:
        self.begin_drain(reason)

    async def run(self) -> None:
        await self._sweep_workspaces("startup")
        hb = asyncio.create_task(self._heartbeat_loop(),
                                 name="vlog-heartbeat")
        watcher = None
        pw = PreemptionWatcher.from_config()
        if pw is not None:
            watcher = asyncio.create_task(
                pw.watch(self._stop, self._on_preemption_notice),
                name="vlog-preempt-watch")
        try:
            while not self._stop.is_set():
                try:
                    worked = await self.poll_once()
                    self.db_breaker.record_success()
                except TransientAPIError as exc:
                    # coordination-plane brownout: jittered growing
                    # backoff instead of a fixed-pace reconnect herd;
                    # readiness degrades once the breaker opens
                    worked = False
                    delay = self.db_breaker.record_error(exc)
                    log.warning("API unreachable (%s); backing off %.1fs",
                                exc, delay)
                    try:
                        await asyncio.wait_for(self._stop.wait(), delay)
                    except asyncio.TimeoutError:
                        pass
                except Exception:  # noqa: BLE001 — the worker must outlive
                    # any single poll cycle (unexpected API faults,
                    # injected failpoints), same contract as
                    # WorkerDaemon.run; pause so a persistent fault
                    # cannot hot-loop
                    log.exception("poll cycle failed; continuing")
                    worked = False
                    await asyncio.sleep(min(self.poll_interval_s, 1.0))
                if worked or self._stop.is_set():
                    continue
                # poll_once already parked on the server for (part of)
                # the idle window when long-polling; only sleep the
                # remainder, so a shed/legacy server degrades to exactly
                # the classic poll latency instead of doubling it
                if self._idle_delay > 0:
                    try:
                        await asyncio.wait_for(self._stop.wait(),
                                               self._idle_delay)
                    except asyncio.TimeoutError:
                        pass
        finally:
            self._stop.set()
            if self._drain_task is not None:
                await asyncio.gather(self._drain_task,
                                     return_exceptions=True)
            tasks = [t for t in (hb, watcher) if t is not None]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _heartbeat_loop(self) -> None:
        caps = {}
        if self.backend is not None:
            try:
                caps = self.backend.detect().to_dict()
            except Exception:
                caps = {}
        while not self._stop.is_set():
            try:
                await self.client.heartbeat(caps,
                                            draining=self.drain.active)
                for cmd in await self.client.poll_commands():
                    resp = await self.handle_command(cmd["command"],
                                                     cmd.get("args") or {})
                    await self.client.respond_command(cmd["id"], resp)
            except Exception:
                log.warning("heartbeat failed; will retry", exc_info=True)
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.heartbeat_interval_s)
            except asyncio.TimeoutError:
                pass

    async def handle_command(self, command: str, args: dict) -> dict:
        if command == "ping":
            return {"pong": True, "worker": self.name}
        if command == "stats":
            from dataclasses import asdict

            return {**asdict(self.stats),
                    "breaker": self.breaker.snapshot(),
                    "db_breaker": self.db_breaker.snapshot(),
                    "disk_paused": self.disk_paused,
                    "draining": {**self.drain.snapshot(),
                                 "jobs_remaining":
                                 int(self._current_job_id is not None)},
                    "kinds": [k.value for k in self.kinds]}
        if command == "drain":
            started = self.begin_drain("admin drain command")
            return {"draining": True, "started": started,
                    "grace_s": self.drain_grace_s,
                    "jobs_remaining": int(self._current_job_id is not None)}
        if command == "stop":
            log.info("remote stop command received")
            # Defer: the response must be written before shutdown starts
            # cancelling the heartbeat task that is writing it.
            asyncio.get_running_loop().call_later(0.5, self.request_stop)
            return {"stopping": True}
        from vlog_tpu_torch.worker import mgmt

        if command == "get_logs":
            return mgmt.get_logs(args)
        if command == "get_metrics":
            return mgmt.get_metrics({
                "worker": self.name,
                "completed": self.stats.completed,
                "failed": self.stats.failed})
        if command == "profile":
            return mgmt.profile(args)
        if command == "restart":
            log.info("remote restart command received")
            self.restart_requested = True
            asyncio.get_running_loop().call_later(0.5, self.request_stop)
            return {"restarting": True,
                    "exit_code": mgmt.RESTART_EXIT_CODE}
        if command == "update":
            return {"error": "update is not supported: deploys are "
                             "image-based; roll the image and restart"}
        return {"error": f"unknown command {command!r}"}

    async def poll_once(self) -> bool:
        # non-claim exits (drain, disk, breaker) idle the full interval
        self._idle_delay = self.poll_interval_s
        if self.drain.active:
            # draining: no new work on a host that is being evicted
            return False
        # Disk admission BEFORE the breaker: claiming a job we cannot
        # stage the source or outputs for would only burn an attempt
        # (and, in HALF_OPEN, the probe slot) on a guaranteed ENOSPC.
        if integrity.under_pressure(self.work_dir):
            if not self.disk_paused:
                log.warning("scratch volume under disk pressure; pausing "
                            "claiming (%s)", self.work_dir)
                self.disk_paused = True
            # self-heal: stale workspaces from crashed incarnations may
            # be exactly what is filling the volume. Re-sweep on a timer
            # (not just the pause transition) so workspaces that AGE
            # into eligibility while paused still get reclaimed —
            # edge-triggering here would wedge the worker forever.
            if time.monotonic() >= self._next_pressure_sweep:
                self._next_pressure_sweep = time.monotonic() + 300.0
                await self._sweep_workspaces("disk pressure")
            return False
        self.disk_paused = False
        self._next_pressure_sweep = 0.0
        if not self.breaker.allow():
            return False
        # Exits that run no compute must hand a half-open probe slot back
        # (release_probe is a no-op unless this poll holds the probe —
        # same wedge-avoidance contract as WorkerDaemon.poll_once).
        wait_s = (min(self.poll_interval_s, config.CLAIM_WAIT_MAX_S)
                  if self.claim_wait_s is None else self.claim_wait_s)
        t0 = time.monotonic()
        try:
            claimed = await self.client.claim(
                [k.value for k in self.kinds], self.accelerator.value,
                wait_s=wait_s)
        except BaseException:
            self.breaker.release_probe()
            raise
        if claimed is None:
            self.breaker.release_probe()
            # the server park already paid (part of) the idle window
            self._idle_delay = max(
                0.0, self.poll_interval_s - (time.monotonic() - t0))
            return False
        if self._stop.is_set():
            self.breaker.release_probe()
            try:
                await self.client.release(claimed["job"]["id"])
            except (ClaimLost, TransientAPIError):
                pass
            return False
        self.stats.bump("claimed")
        self._cancel.clear()
        self._cancel_reason = ""
        self._reset_watchdog()
        job, video = claimed["job"], claimed["video"]
        self._current_job_id = job["id"]
        if self.drain.active:
            # the drain raced the claim: deliver the cancel ourselves so
            # the drain loop's broadcast cannot have missed this job
            self._cancel_reason = self._cancel_reason or DRAIN_CANCEL_REASON
            self._cancel.set()
        if video is None:
            # The video row vanished under a still-queued job — a data
            # problem, not compute health: resolve any probe.
            self.breaker.release_probe()
            await self._safe_fail(job["id"], "video row vanished",
                                  permanent=True)
            return True
        # Join the server's trace for this job (claim response carries
        # the trace id + root span id); finished spans collect in the
        # buffer and ship via POST .../spans before complete/fail.
        tr = (claimed.get("trace") or {}) if config.TRACE_ENABLED else {}
        tctx = None
        if tr.get("trace_id"):
            tctx = obs_trace.TraceContext(tr["trace_id"],
                                          tr.get("parent_span_id"),
                                          obs_trace.TraceBuffer())
        self._span_buffer = tctx.buffer if tctx else None
        failed_before = self.stats.failed
        with obs_trace.attach(tctx):
            try:
                await self._dispatch(job, video)
                # data problems dead-lettered inside the handler (missing
                # source, bad payload) say nothing about compute health —
                # only a failure-free run closes/armors the breaker
                if self.stats.failed == failed_before:
                    self.breaker.record_success()
            except JobCancelled as exc:
                _release_frames(exc)
                if exc.reason.startswith("preempted"):
                    # drain deadline: the host is being evicted. The
                    # handler already flushed completed segments + the
                    # checkpoint; requeue refunded (PREEMPTED), no
                    # breaker event — compute was healthy.
                    obs_trace.event("worker.preempted", status="error",
                                    error=exc.reason,
                                    grace_s=self.drain_grace_s)
                    await self._safe_fail(
                        job["id"], exc.reason,
                        failure_class=FailureClass.PREEMPTED)
                elif self._stop.is_set():
                    try:
                        await self.client.release(job["id"])
                        self.stats.bump("released")
                    except (ClaimLost, TransientAPIError):
                        pass
                else:
                    obs_trace.event("worker.cancelled", status="error",
                                    error=exc.reason)
                    self.breaker.record_failure()
                    fc = (FailureClass.STALLED
                          if exc.reason.startswith("stalled")
                          else FailureClass.TRANSIENT)
                    await self._safe_fail(job["id"],
                                          f"cancelled: {exc.reason}",
                                          failure_class=fc)
            except ClaimLost as exc:
                _release_frames(exc)
                log.warning("job %s claim lost: %s", job["id"], exc)
                self.stats.last_error = str(exc)
            except Exception as exc:  # noqa: BLE001
                from vlog_tpu_torch.parallel import faults

                _release_frames(exc)
                obs_trace.event("worker.error", status="error",
                                error=f"{type(exc).__name__}: {exc}")
                log.exception("job %s failed", job["id"])
                self.breaker.record_failure()
                if faults.is_device_fault(exc):
                    # the server's fail_job refunds the attempt for
                    # device_fault; the compute breaker (still recorded
                    # above) is this worker's containment — remote
                    # workers run no slot scheduler to quarantine into
                    await self._safe_fail(
                        job["id"], f"{type(exc).__name__}: {exc}",
                        failure_class=FailureClass.DEVICE_FAULT)
                else:
                    await self._safe_fail(job["id"],
                                          f"{type(exc).__name__}: {exc}")
            finally:
                # Resolve any half-open probe the dispatch left unrecorded
                # (claim-lost, shutdown release, pre-dispatch faults) — a
                # wedged HALF_OPEN would never claim again.
                self.breaker.release_probe()
                self._span_buffer = None
                self._current_job_id = None
                # attempt over, whatever the outcome: drop its fencing
                # state so lost claims don't accumulate epoch entries
                self.client._forget_claim(job["id"])
                if not self.keep_work_dirs:
                    # a preempted scratch tree is deliberately kept: if
                    # the requeued job lands back on THIS worker (the
                    # drain was cancelled / the host survived), local
                    # resume beats re-downloading the partials
                    keep = self.drain.active
                    if not keep:
                        shutil.rmtree(self._job_dir(video),
                                      ignore_errors=True)
        return True

    async def _sweep_workspaces(self, why: str) -> None:
        """Reclaim stale job workspaces of previous incarnations
        (storage/gc.py; remote workers own their scratch — the admin
        sweeper cannot see it). Age-thresholded so a fresh workspace a
        reclaimed job could resume onto survives."""
        from vlog_tpu_torch.storage import gc as storage_gc

        try:
            report = await asyncio.to_thread(
                storage_gc.sweep_worker_workspaces, self.work_dir)
            if report.removed:
                log.info("workspace gc (%s): reclaimed %d entries, "
                         "%d bytes", why, len(report.removed),
                         report.bytes_reclaimed)
        except Exception:   # noqa: BLE001 — scratch GC must never kill
            # the claim loop
            log.exception("workspace gc failed")

    async def _post_spans(self, job_id: int) -> None:
        """Ship the attempt's finished spans to the server while the
        claim is still held (the spans endpoint is claim-gated). Best
        effort: a lost trace must never fail the job."""
        buf = getattr(self, "_span_buffer", None)
        if buf is None or not len(buf):
            return
        spans = [sp.to_dict() for sp in buf.drain()]
        try:
            await self.client.post_spans(job_id, spans)
        except (ClaimLost, TransientAPIError, aiohttp.ClientError) as exc:
            # aiohttp.ClientError covers non-retryable statuses (e.g. a 500
            # from a flaky span insert) — a lost trace must never fail
            # a job that already did its work
            log.debug("span report for job %s dropped: %s", job_id, exc)

    async def _safe_fail(self, job_id: int, error: str, *,
                         permanent: bool = False,
                         failure_class: FailureClass | None = None) -> None:
        self.stats.bump("failed")
        self.stats.last_error = error
        await self._post_spans(job_id)
        try:
            await self.client.fail(
                job_id, error, permanent=permanent,
                failure_class=failure_class.value if failure_class else None)
        except (ClaimLost, TransientAPIError) as exc:
            log.warning("could not report failure for job %s: %s",
                        job_id, exc)

    def _job_dir(self, video: dict) -> Path:
        return self.work_dir / video["slug"]

    # files worth prefetching for resume: per-rung init + encoder config
    # tag + media segments (what the backend's resume scan validates —
    # init without its encoder.tag reads as a config mismatch and the
    # segments would be discarded) and the thumbnail (first-batch
    # artifact a resumed run cannot regenerate). The rate-control
    # journal fetches separately below: it is deliberately absent from
    # the manifest/inventory (run state, not a published artifact).
    _RESUME_RE = re.compile(
        r"^(?:[^/]+/(?:init\.mp4|encoder\.tag|segment_\d+\.(?:m4s|ts))"
        r"|thumbnail\.jpg)$")

    async def _prefetch_partials(self, video: dict, out_dir: Path) -> int:
        """Download the server's digest-verified partial outputs into the
        scratch tree (cross-worker resume). Best effort: any failure
        just means more re-encoding, never a failed attempt. Returns the
        number of files fetched or already present and verified."""
        try:
            have = await self.client.upload_status(video["id"])
        except (ClaimLost, TransientAPIError, aiohttp.ClientError) as exc:
            log.debug("partial inventory unavailable: %s", exc)
            return 0
        ok = 0
        try:
            # the journal is what makes the continuation byte-identical;
            # no inventory digest to check — a torn/corrupt journal is
            # detected by its own line parsing and just means a cold
            # (still deterministic) restart
            await self.client.download_output(
                video["id"], integrity.RC_JOURNAL_NAME,
                out_dir / integrity.RC_JOURNAL_NAME)
            ok += 1
        except (ClaimLost, TransientAPIError, aiohttp.ClientError):
            pass                # predecessor never flushed one
        for rel, meta in sorted(have.items()):
            if not self._RESUME_RE.match(rel):
                continue
            local = out_dir / rel
            want = meta.get("sha256")
            if local.is_file() \
                    and local.stat().st_size == meta.get("size") \
                    and await asyncio.to_thread(
                        integrity.sha256_file, local) == want:
                ok += 1         # crashed-here-before case: already good
                continue
            try:
                await self.client.download_output(video["id"], rel, local)
            except (ClaimLost, TransientAPIError, aiohttp.ClientError) as exc:
                log.warning("partial prefetch of %s failed: %s", rel, exc)
                local.unlink(missing_ok=True)
                continue
            digest = await asyncio.to_thread(integrity.sha256_file, local)
            if digest != want:
                # corrupted hop: re-encoding beats resuming corruption
                log.warning("partial %s digest mismatch; dropped", rel)
                local.unlink(missing_ok=True)
                continue
            ok += 1
        if ok:
            log.info("cross-worker resume: %d verified partial file(s) "
                     "prefetched for %s", ok, video["slug"])
        return ok

    async def _checkpoint_flush(self, uploader: StreamingUploader,
                                job: dict) -> None:
        """Best-effort final checkpoint before eviction (drain deadline
        already fired — whatever this misses, the successor re-encodes)."""
        try:
            files, nbytes = await uploader.flush()
            obs_trace.event("worker.drain", files=len(uploader.uploaded),
                            flushed_files=files, flushed_bytes=nbytes)
            await uploader._checkpoint()
            log.info("preemption flush for job %s: %d file(s), %d bytes",
                     job["id"], files, nbytes)
        except failpoints.FailpointError as exc:
            log.warning("drain checkpoint for job %s injected-failed: %s",
                        job["id"], exc)
        except Exception as exc:  # noqa: BLE001 — the host is dying; an
            # incomplete flush only costs the successor re-encoding
            log.warning("drain checkpoint flush for job %s incomplete: %s",
                        job["id"], exc)

    # -- compute-thread plumbing (HTTP flavor of the daemon's) -------------

    def _make_progress_cb(self, job_id: int, rung_names: list[str]):
        loop = asyncio.get_running_loop()
        last = 0.0
        lost = threading.Event()

        async def post(pct: float, msg: str) -> None:
            try:
                await self.client.progress(
                    job_id, progress=pct, current_step=msg,
                    qualities={rn: {"status": "in_progress", "progress": pct}
                               for rn in rung_names})
            except ClaimLost:
                lost.set()
            except TransientAPIError:
                pass       # missed progress is not fatal; lease has slack

        def cb(done: int, total: int, msg: str) -> None:
            nonlocal last
            self._note_progress(done)   # stall-watchdog feed
            if self._cancel.is_set():
                raise JobCancelled(self._cancel_reason or "cancelled")
            if lost.is_set():
                raise JobCancelled("claim lost (server returned 409)")
            now = time.monotonic()
            if now - last < self.progress_min_interval_s and done < total:
                return
            last = now
            pct = min(100.0 * done / max(total, 1), 99.0)
            asyncio.run_coroutine_threadsafe(post(pct, msg), loop)

        return cb

    # _run_with_timeout / _cancel_and_drain: ComputeWatchdogMixin
    # (worker/watchdog.py) — shared with WorkerDaemon. The stall window
    # opens when compute starts, so the source download + probe that
    # precede it never count as a stall.

    # -- handlers ----------------------------------------------------------

    async def _dispatch(self, job: dict, video: dict) -> None:
        handler = {
            JobKind.TRANSCODE: self._run_transcode,
            JobKind.REENCODE: self._run_reencode,
            JobKind.SPRITE: self._run_sprites,
            JobKind.TRANSCRIPTION: self._run_transcription,
        }[JobKind(job["kind"])]
        await handler(job, video)

    async def _fetch_source(self, video: dict) -> Path:
        jdir = self._job_dir(video)
        src_dir = jdir / "src"
        existing = [p for p in src_dir.glob("*")
                    if p.is_file() and not p.name.endswith(".part")] \
            if src_dir.exists() else []
        if existing:
            return existing[0]
        with obs_trace.span("worker.download") as sp:
            out = await self.client.download_source(video["id"], src_dir)
            try:
                sp.attrs["bytes"] = out.stat().st_size
            except OSError:
                pass
            return out

    async def _run_transcode(self, job: dict, video: dict) -> None:
        from vlog_tpu_torch.media.probe import get_video_info
        from vlog_tpu_torch.worker.pipeline import process_video

        src = await self._fetch_source(video)
        out_dir = self._job_dir(video) / "out"
        info = await asyncio.to_thread(get_video_info, str(src))
        rungs = config.ladder_for_source(info.height)
        timeout = config.transcode_timeout_s(info.duration_s, rungs[0].name)
        cb = self._make_progress_cb(job["id"], [r.name for r in rungs])

        # Cross-worker resume: pull the digest-verified partial tree a
        # preempted (or crashed) predecessor streamed to the server, so
        # the backend's resume scan continues the ladder instead of
        # starting over on this machine.
        with obs_trace.span("worker.resume") as rsp:
            prefetched = await self._prefetch_partials(video, out_dir)
            rsp.attrs["prefetched_files"] = prefetched

        async def post_checkpoint(summary: dict) -> None:
            await self.client.progress(job["id"], checkpoint=summary)

        uploader = StreamingUploader(self.client, video["id"], out_dir,
                                     skip_prefixes=("original",),
                                     on_checkpoint=post_checkpoint)
        await uploader.resume_state()
        up_task = asyncio.create_task(uploader.run())

        def work():
            # write_manifest=False: the uploader's drain() derives the
            # published manifest from the transfer digests — hashing the
            # scratch tree again here would double the digest cost
            return process_video(src, out_dir, backend=self.backend,
                                 device=self.device, progress_cb=cb,
                                 rungs=rungs, keep_original=False,
                                 write_manifest=False)

        preempted = False
        try:
            with obs_trace.span("worker.transcode",
                                rungs=[r.name for r in rungs]) as tsp:
                result = await self._run_with_timeout(work, timeout,
                                                      "transcode")
        except JobCancelled as exc:
            preempted = exc.reason.startswith("preempted")
            raise
        finally:
            uploader.stop()
            await asyncio.gather(up_task, return_exceptions=True)
            if preempted:
                # eviction imminent: push every completed segment + the
                # rc journal and stamp the final checkpoint, so the
                # successor resumes a maximal verified partial tree
                await self._checkpoint_flush(uploader, job)
        obs_trace.record_run_stages(tsp, result.run.stage_s)
        obs_runtime().observe_run(result.run.stage_s)
        if result.run.resumed_segments:
            tsp.attrs["resumed_segments"] = result.run.resumed_segments
            obs_runtime().resume_segments_skipped.inc(
                result.run.resumed_segments)
        with obs_trace.span("worker.upload") as usp:
            await uploader.drain()
            usp.attrs.update(files=len(uploader.uploaded),
                             bytes=uploader.bytes_sent)
        await self._post_spans(job["id"])

        await self.client.complete(job["id"], {
            "probe": {
                "duration_s": result.source.duration_s,
                "width": result.source.width,
                "height": result.source.height,
                "fps": result.source.fps,
                "audio_codec": result.source.audio_codec,
            },
            "qualities": result.qualities,
            "thumbnail": "thumbnail.jpg" if result.run.thumbnail_path else None,
        })
        self.stats.bump("completed")
        log.info("job %s complete: %d files, %d bytes streamed",
                 job["id"], len(uploader.uploaded), uploader.bytes_sent)

    async def _run_reencode(self, job: dict, video: dict) -> None:
        """Format conversion over HTTP: like transcode, but with the
        payload's container/codec and no downstream re-derivation."""
        from vlog_tpu_torch.media.probe import get_video_info
        from vlog_tpu_torch.worker.pipeline import process_video

        payload = job.get("payload") or {}
        fmt = payload.get("streaming_format", "cmaf")
        codec = payload.get("codec", "h264")
        err = validate_codec_format(codec, fmt)
        if err is not None:
            await self._safe_fail(job["id"], err, permanent=True)
            return
        src = await self._fetch_source(video)
        out_dir = self._job_dir(video) / "out"
        info = await asyncio.to_thread(get_video_info, str(src))
        rungs = config.ladder_for_source(info.height)
        timeout = config.transcode_timeout_s(info.duration_s, rungs[0].name)
        cb = self._make_progress_cb(job["id"], [r.name for r in rungs])

        uploader = StreamingUploader(self.client, video["id"], out_dir,
                                     skip_prefixes=("original",))
        up_task = asyncio.create_task(uploader.run())

        def work():
            return process_video(src, out_dir, backend=self.backend,
                                 device=self.device, progress_cb=cb,
                                 rungs=rungs, keep_original=False,
                                 resume=False,
                                 write_manifest=False,
                                 streaming_format=fmt, codec=codec)

        try:
            with obs_trace.span("worker.transcode",
                                rungs=[r.name for r in rungs],
                                streaming_format=fmt, codec=codec) as tsp:
                result = await self._run_with_timeout(work, timeout,
                                                      "reencode")
        finally:
            uploader.stop()
            await asyncio.gather(up_task, return_exceptions=True)
        obs_trace.record_run_stages(tsp, result.run.stage_s)
        obs_runtime().observe_run(result.run.stage_s)
        with obs_trace.span("worker.upload") as usp:
            await uploader.drain()
            usp.attrs.update(files=len(uploader.uploaded),
                             bytes=uploader.bytes_sent)
        await self._post_spans(job["id"])
        await self.client.complete(job["id"], {
            "probe": {
                "duration_s": result.source.duration_s,
                "width": result.source.width,
                "height": result.source.height,
                "fps": result.source.fps,
                "audio_codec": result.source.audio_codec,
            },
            "qualities": result.qualities,
            "thumbnail": "thumbnail.jpg" if result.run.thumbnail_path else None,
            "streaming_format": fmt,
            "codec": codec,
        })
        self.stats.bump("completed")

    async def _run_sprites(self, job: dict, video: dict) -> None:
        from vlog_tpu_torch.worker.sprites import generate_sprites

        src = await self._fetch_source(video)
        out_dir = self._job_dir(video) / "out"
        cb = self._make_progress_cb(job["id"], [])
        timeout = config.transcode_timeout_s(
            float(video.get("duration_s") or 0.0), "360p")

        def work():
            return generate_sprites(src, out_dir, progress_cb=cb,
                                    device=self.device)

        with obs_trace.span("worker.sprites") as sp:
            result = await self._run_with_timeout(work, timeout, "sprites")
            sp.attrs.update(sheets=result.sheet_count,
                            tiles=result.tile_count)
        with obs_trace.span("worker.upload"):
            for p in sorted(Path(result.vtt_path).parent.glob("*")):
                if p.is_file() and not p.name.endswith(".tmp"):
                    await self.client.upload_file(
                        video["id"], f"sprites/{p.name}", p)
        await self._post_spans(job["id"])
        await self.client.complete(job["id"], {
            "sheets": result.sheet_count, "tiles": result.tile_count})
        self.stats.bump("completed")

    def _make_asr_checkpoint_cb(self, job_id: int):
        """ASR resume-state posts (compute thread) through the epoch-
        fenced progress endpoint: completed windows land in the job row's
        ``last_checkpoint`` so a successor on ANY worker re-submits only
        what is missing. Rate-limited; the ``final`` (drain) flush blocks
        so the state lands before the requeue."""
        loop = asyncio.get_running_loop()
        last = 0.0

        async def post(state: dict) -> None:
            try:
                await self.client.progress(job_id,
                                           checkpoint={"asr": state})
            except ClaimLost:
                pass   # the progress cb aborts the thread
            except TransientAPIError:
                pass   # a missed checkpoint only costs re-decode

        def cb(state: dict, done: int, total: int, final: bool) -> None:
            nonlocal last
            now = time.monotonic()
            if (not final and done < total
                    and now - last < self.progress_min_interval_s):
                return
            last = now
            fut = asyncio.run_coroutine_threadsafe(post(state), loop)
            if final:
                try:
                    fut.result(timeout=10.0)
                except Exception:  # noqa: BLE001 — drain deadline wins
                    pass

        return cb

    async def _run_transcription(self, job: dict, video: dict) -> None:
        from vlog_tpu_torch.worker.transcribe import transcribe_video

        src = await self._fetch_source(video)
        out_dir = self._job_dir(video) / "out"
        cb = self._make_progress_cb(job["id"], [])
        ckpt_cb = self._make_asr_checkpoint_cb(job["id"])
        timeout = config.transcode_timeout_s(
            float(video.get("duration_s") or 0.0), "720p")
        # Cross-worker resume: the predecessor's decoded windows are in
        # the job row; decode only the rest, byte-identical output.
        prior = job.get("last_checkpoint") or {}
        resume = prior.get("asr") if isinstance(prior, dict) else None
        asr_stats: dict = {}

        def work():
            return transcribe_video(src, out_dir, progress_cb=cb,
                                    model_dir=self.transcription_model_dir,
                                    job_key=f"job-{job['id']}",
                                    checkpoint_cb=ckpt_cb, resume=resume,
                                    stats_out=asr_stats, device=self.device)

        with obs_trace.span("worker.transcribe") as sp:
            result = await self._run_with_timeout(work, timeout,
                                                  "transcription")
            sp.attrs.update(language=result.language, model=result.model)
            for k, v in asr_stats.items():
                sp.attrs[f"asr.{k}"] = v
        with obs_trace.span("worker.upload"):
            await self.client.upload_file(video["id"], "captions.vtt",
                                          Path(result.vtt_path))
        await self._post_spans(job["id"])
        await self.client.complete(job["id"], {
            "language": result.language, "model": result.model,
            "vtt": "captions.vtt", "text": result.text})
        self.stats.bump("completed")


# --------------------------------------------------------------------------
# Entrypoint
# --------------------------------------------------------------------------

async def _amain(args: argparse.Namespace, *, device: str = "cuda") -> None:
    """The worker process: ``main``'s parsed options, on ``device`` (the
    card; the CLI has no option for it, and only tests pass ``"cpu"``)."""
    from vlog_tpu_torch.device import resolve_device

    resolve_device(device)     # before any network: no CPU fallback
    key = args.key
    if not key:
        key = await WorkerAPIClient.register(
            args.api, args.name, admin_secret=args.admin_secret,
            accelerator=args.accelerator)
        log.info("registered; api key (save it): %s", key)
    client = WorkerAPIClient(args.api, key)
    backend = None
    if not args.no_backend:
        from vlog_tpu_torch.backends import select_backend

        backend = select_backend(args.backend or None, device=device)
    worker = RemoteWorker(
        client, name=args.name, work_dir=Path(args.work_dir),
        accelerator=AcceleratorKind(args.accelerator),
        kinds=tuple(JobKind(k) for k in args.kinds.split(",")),
        backend=backend, device=device,
        transcription_model_dir=args.whisper_dir)

    from vlog_tpu_torch.worker.health import (WorkerHealthServer, breaker_check,
                                        combine, disk_check, drain_check)

    async def api_ready() -> tuple[bool, str]:
        if not await client.healthz():
            return False, "worker API unreachable"
        return True, "ok"

    # Disk pressure degrades readiness (the orchestrator stops routing /
    # scales) without killing liveness — the worker is healthy, just full.
    health = WorkerHealthServer(
        combine(api_ready, disk_check(worker.work_dir, label="scratch"),
                breaker_check(worker.db_breaker, label="worker API"),
                drain_check(worker.drain)))
    await health.start()
    loop = asyncio.get_running_loop()
    # SIGTERM = eviction notice: grace-budgeted drain (twice = now);
    # SIGINT stays immediate (operator ^C).
    loop.add_signal_handler(signal.SIGTERM, worker.handle_termination)
    loop.add_signal_handler(signal.SIGINT, worker.request_stop)
    try:
        await worker.run()
    finally:
        await health.stop()
        await client.aclose()
    log.info("remote worker stopped: %s", worker.stats)
    if worker.restart_requested:
        from vlog_tpu_torch.worker.mgmt import RESTART_EXIT_CODE

        raise SystemExit(RESTART_EXIT_CODE)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="vlog-tpu remote worker (PyTorch/CUDA port)")
    parser.add_argument("--api", default=config.WORKER_API_URL)
    parser.add_argument("--key", default="",
                        help="worker API key; omit to register")
    parser.add_argument("--admin-secret", default=config.ADMIN_SECRET)
    parser.add_argument("--name", default=f"remote-{int(time.time())}")
    parser.add_argument("--work-dir", default=str(config.TMP_DIR / "remote"))
    parser.add_argument("--accelerator", default="tpu",
                        choices=[a.value for a in AcceleratorKind])
    parser.add_argument("--kinds", default="transcode,sprite,transcription")
    parser.add_argument("--backend", default="")
    parser.add_argument("--no-backend", action="store_true")
    parser.add_argument("--whisper-dir", default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
