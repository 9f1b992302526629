"""Persistent rate-control journal: byte-identical mid-stream resume
(copy of ``vlog_tpu/backends/rc_journal.py``; the file format is shared,
so either package can continue a tree the other started).

The output after segment K depends on the rate controllers' state (per-QP
rate estimates, the debt integral, proxy calibration) and on the lag at
which their observations apply. A resumed run that restarts the
controllers cold encodes the remaining segments with other QP plans:
valid output, but not the bytes the uninterrupted run would have made.
The journal closes that gap. The backend appends one canonical JSON line
per dispatch batch with what each rung posted to the rate controller
(bytes, frames, the plan-QP mix, the device bit-proxy cost sum); on
resume ``LaggedRateControl.replay`` re-runs the dispatch schedule against
it, so the controllers reach the state the original run had when it
planned the first resumed batch.

Format (byte-reproducible):

- line 1: the header, the run parameters a replay must match (batch
  size, pipeline depth, frames per segment, GOP length, rung names,
  encoder tag). A mismatch discards the journal: a cold, still
  deterministic, restart.
- line N+2: batch N's observations of every rung, written once all rungs
  have posted for that batch, rung keys sorted.

A torn tail line (host died mid-append) fails the JSON parse and is
dropped; the contiguous prefix is what resume may use.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

# Run state, not a published artifact: its bytes are shaped by the
# dispatch geometry, so storage/integrity.py keeps it out of the
# outputs.json manifest (as the JAX package does).
RC_JOURNAL_NAME = "rc_journal.jsonl"

__all__ = ["RC_JOURNAL_NAME", "RCJournal", "aligned_resume_point",
           "load_journal", "make_header"]


def make_header(*, batch_n: int, depth: int, frames_per_seg: int,
                gop_len: int, rungs: list[str], tag: str) -> dict:
    """The run-parameter fingerprint a resume must match exactly.

    ``origin_frame`` 0 marks the original timeline; a legacy
    (non-batch-aligned) resume stamps the frame it restarted from, so a
    later resume can never replay its entries as the uninterrupted
    run's."""
    return {"v": 1, "batch_n": int(batch_n), "depth": int(depth),
            "frames_per_seg": int(frames_per_seg), "gop_len": int(gop_len),
            "rungs": list(rungs), "tag": tag, "origin_frame": 0}


def _dump(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class RCJournal:
    """Append side of the journal, one per run; batches are written in
    index order once every rung has recorded them."""

    def __init__(self, path: Path, header: dict, *, keep_batches: int = 0):
        self.path = Path(path)
        self.header = header
        # a resumed run indexes its batches from 0; the journal keeps the
        # original timeline so a later resume lines up
        self.index_offset = int(keep_batches)
        # the rungs' consumer threads record concurrently
        self._lock = threading.Lock()           # lock-order: 60
        # batch index -> {rung: obs}
        self._buf: dict[int, dict] = {}     # guarded-by: _lock
        self._next = int(keep_batches)      # guarded-by: _lock
        self._fp = None                     # guarded-by: _lock
        self._rewrite(keep_batches)

    def _rewrite(self, keep_batches: int) -> None:
        """Start (or truncate) the journal: header plus the replayed
        prefix; entries past the resume point belong to a timeline the
        resumed run is about to re-encode."""
        prefix: list[str] = []
        if keep_batches > 0:
            loaded = load_journal(self.path)
            if loaded is not None and loaded[0] == self.header:
                entries = loaded[1]
                for k in range(keep_batches):
                    prefix.append(_dump({"k": k, "obs": entries[k]}))
        tmp = self.path.with_suffix(".jsonl.tmp")
        with open(tmp, "w") as fp:
            fp.write(_dump(self.header) + "\n")
            for line in prefix:
                fp.write(line + "\n")
        tmp.rename(self.path)

    def record(self, batch_index: int, rung: str, *, nbytes: int,
               frames: int, qps, cost: float | None) -> None:
        """Mirror one ``LaggedRateControl.post`` call. ``qps`` is the
        plan-QP mix (array or list) or None."""
        obs = {"bytes": int(nbytes), "frames": int(frames),
               "qps": None if qps is None else [int(q) for q in qps],
               "cost": None if cost is None else float(cost)}
        want = set(self.header["rungs"])
        batch_index += self.index_offset
        with self._lock:
            if batch_index < self._next:
                return          # replayed prefix: already on disk
            self._buf.setdefault(batch_index, {})[rung] = obs
            # The append stays under the lock on purpose: the file's
            # byte-reproducibility contract is "lines in batch-index
            # order", and the only thing serializing competing consumer
            # threads' drains IS this lock. Lines are ~100 buffered
            # bytes — the hold is microseconds, and the alternative (a
            # second writer lock held across the same write) is the
            # same blocking with more states.
            while set(self._buf.get(self._next, ())) >= want:
                line = _dump({"k": self._next,
                              "obs": self._buf.pop(self._next)})
                if self._fp is None:
                    self._fp = open(self.path, "a")    # holds-ok: canonical append order needs the drain serialized
                self._fp.write(line + "\n")            # holds-ok: canonical append order needs the drain serialized
                self._fp.flush()                       # holds-ok: canonical append order needs the drain serialized
                self._next += 1

    def close(self) -> None:
        with self._lock:
            if self._fp is not None:
                self._fp.close()
                self._fp = None


def _clean_entry(obj) -> tuple[int, dict] | None:
    """Shape-check one batch line; None rejects it (a corrupt journal
    degrades to a shorter replayable prefix, never a crash)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("k"), int) \
            or not isinstance(obj.get("obs"), dict):
        return None
    for rung, ob in obj["obs"].items():
        if not isinstance(rung, str) or not isinstance(ob, dict):
            return None
        if not isinstance(ob.get("bytes"), int) \
                or not isinstance(ob.get("frames"), int):
            return None
        if ob.get("qps") is not None and not isinstance(ob["qps"], list):
            return None
        if ob.get("cost") is not None \
                and not isinstance(ob["cost"], (int, float)):
            return None
    return obj["k"], obj["obs"]


def load_journal(path: Path) -> tuple[dict, dict[int, dict]] | None:
    """``(header, {batch_index: {rung: obs}})`` or None. A torn, garbled
    or malformed tail is dropped; only the lines before it count."""
    path = Path(path)
    if not path.is_file():
        return None
    header: dict | None = None
    entries: dict[int, dict] = {}
    try:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    break       # torn tail: stop at the last clean line
                if header is None:
                    if not isinstance(obj, dict) or obj.get("v") != 1:
                        return None
                    header = obj
                else:
                    cleaned = _clean_entry(obj)
                    if cleaned is None:
                        break   # malformed tail: same verdict as torn
                    entries[cleaned[0]] = cleaned[1]
    except OSError:
        return None
    if header is None:
        return None
    return header, entries


def aligned_resume_point(start_segment: int, *, frames_per_seg: int,
                         batch_n: int, entries: dict[int, dict],
                         rungs: list[str]) -> tuple[int, int]:
    """Clamp a segment-scan resume candidate to a point the journal can
    replay: the resume frame must sit on both a segment and a dispatch
    batch boundary, and the journal must hold every rung's record of
    every earlier batch. Returns ``(start_segment, start_batch)``;
    ``(0, 0)`` restarts cold."""
    want = set(rungs)
    complete = 0
    while set(entries.get(complete, ())) >= want:
        complete += 1
    while start_segment > 0:
        frames = start_segment * frames_per_seg
        if frames % batch_n == 0 and frames // batch_n <= complete:
            return start_segment, frames // batch_n
        start_segment -= 1
    return 0, 0
