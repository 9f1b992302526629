"""Gossip/health membership for the self-healing delivery fabric (a copy
of ``vlog_tpu/delivery/gossip.py``).

The peer ring (delivery/ring.py) used to be frozen at construction from
``VLOG_DELIVERY_PEERS``: one dead origin kept absorbing every miss
routed to it until an operator edited an env list and bounced the
fleet. This module makes membership a *live* state machine:

- every origin runs a jittered probe loop (:func:`probe_loop`) that
  heartbeats its peers over ``GET /api/delivery/gossip`` — the same
  public app that serves media, so "the heartbeat answers" and "the
  origin can serve" are one fact;
- each peer walks ``alive -> suspect -> down -> (rejoin) alive``:
  ``VLOG_DELIVERY_GOSSIP_SUSPECT_AFTER`` consecutive transport
  failures mark it suspect (fills route around it immediately), a
  suspect that stays unreachable for ``VLOG_DELIVERY_GOSSIP_DOWN_S``
  goes down (ownership rebalances), and one successful heartbeat
  rejoins it;
- a **digest liar** — a peer that served bytes failing the manifest
  sha256 check — is *quarantined*, not merely cooled down: it leaves
  the ownership set for ``VLOG_DELIVERY_GOSSIP_QUARANTINE_S`` and only
  a successful probe after that window readmits it;
- views are **versioned**: any change to the ownership set (down,
  quarantine, rejoin, join) bumps :attr:`Membership.version`, and the
  delivery plane rebuilds its rendezvous ring from the live member set
  at the next consult — rendezvous hashing guarantees only the dead
  member's keys move;
- probe responses piggyback the sender's own view
  (:meth:`Membership.merge`): remote *suspicion* spreads (a peer the
  whole fleet can't reach is routed around fleet-wide within one
  probe round), but remote views can only make a local peer
  **suspect** — death is always confirmed by local probes, so a
  forged heartbeat (``delivery.gossip`` armed with forge semantics in
  chaos tests) cannot kill a peer this origin can still reach. Views
  may also carry peers the seed list never knew: they join as alive,
  so the fabric grows without a fleet-wide env edit.

Thread model: the state machine is consulted from event-loop
coroutines (probes, peer-fill classification) and from ``to_thread``
fill workers (ring snapshot reads), so every touch happens under one
lock (rank 48 — below the plane's digest/counter locks; nothing else
is ever acquired while it is held).
"""

from __future__ import annotations

import random
import threading
import time

from vlog_tpu_torch.delivery.ring import Ring
from vlog_tpu_torch.utils import failpoints

__all__ = ["Membership", "PeerView", "probe_once", "probe_loop",
           "GOSSIP_FROM_HEADER", "ALIVE", "SUSPECT", "DOWN", "QUARANTINED"]

ALIVE = "alive"
SUSPECT = "suspect"
DOWN = "down"
QUARANTINED = "quarantined"

# A probe carries its sender's identity so one heartbeat proves
# liveness in BOTH directions (the receiver marks the sender alive
# without waiting for its own next probe round).
GOSSIP_FROM_HEADER = "X-Vlog-Gossip-From"

# States that keep a peer in the rendezvous ownership set. A suspect
# peer still OWNS its keys (so a one-probe blip does not churn the
# ring) but fills route around it until it answers again.
_MEMBER_STATES = frozenset({ALIVE, SUSPECT})


class PeerView:
    """Health record for one remote peer."""

    __slots__ = ("url", "state", "fails", "since", "last_ok")

    def __init__(self, url: str):
        self.url = url
        self.state = ALIVE
        self.fails = 0          # consecutive transport/timeout failures
        self.since = time.monotonic()   # when `state` was entered
        self.last_ok = 0.0      # monotonic of last confirmed contact

    def as_dict(self, now: float) -> dict:
        return {
            "url": self.url,
            "state": self.state,
            "fails": self.fails,
            "state_age_s": round(now - self.since, 3),
            "last_ok_age_s": (round(now - self.last_ok, 3)
                              if self.last_ok else None),
        }


class Membership:
    """Versioned, self-healing view of the delivery origin set.

    Seeded from ``VLOG_DELIVERY_PEERS`` but never frozen by it: peers
    die, rejoin, and join (via gossiped views) at runtime. Every
    method is safe from any thread; none performs I/O.
    """

    def __init__(self, peers, self_url: str = "", *,
                 suspect_after: int = 2,
                 down_after_s: float = 3.0,
                 quarantine_s: float = 60.0):
        self.self_url = self_url.strip().rstrip("/")
        self.suspect_after = max(1, int(suspect_after))
        self.down_after_s = float(down_after_s)
        self.quarantine_s = float(quarantine_s)
        self._lock = threading.Lock()             # lock-order: 48
        # guarded-by: _lock
        self._peers: dict[str, PeerView] = {}
        # guarded-by: _lock
        self._version = 0
        # guarded-by: _lock
        self._ring: Ring | None = None      # cached view for _version
        for u in peers:
            u = u.strip().rstrip("/")
            if u and u != self.self_url and u not in self._peers:
                self._peers[u] = PeerView(u)

    # -- read side ---------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def enabled(self) -> bool:
        """Whether there is any remote peer to gossip with at all."""
        with self._lock:
            return bool(self._peers)

    def state_of(self, peer: str) -> str | None:
        with self._lock:
            pv = self._peers.get(peer)
            return pv.state if pv is not None else None

    def routable(self, peer: str) -> bool:
        """May a fill be sent to ``peer`` right now? Only fully alive
        peers take fills — suspects are routed around immediately
        (that is the 'within one suspect window' guarantee)."""
        with self._lock:
            pv = self._peers.get(peer)
            return pv is not None and pv.state == ALIVE

    def members(self) -> tuple[str, ...]:
        """The rendezvous ownership set: self + every peer not down or
        quarantined, in sorted order (deterministic across origins)."""
        with self._lock:
            live = [u for u, pv in self._peers.items()
                    if pv.state in _MEMBER_STATES]
        if self.self_url:
            live.append(self.self_url)
        return tuple(sorted(set(live)))

    def ring(self) -> Ring:
        """The current versioned rendezvous ring (cached per version)."""
        with self._lock:
            ring = self._ring
            version = self._version
        if ring is not None and ring.version == version:
            return ring
        ring = Ring(self.members(), self.self_url, version=version)
        with self._lock:
            # a racing rebuild for the same version stores the same view
            if self._version == version:
                self._ring = ring
        return ring

    def known_peers(self) -> tuple[str, ...]:
        """Every peer the fabric has ever seen (any state) — the probe
        target list. Down peers stay here so rejoin is detectable."""
        with self._lock:
            return tuple(self._peers)

    def snapshot(self) -> dict:
        """Wire/admin view: what ``GET /api/delivery/gossip`` serves."""
        now = time.monotonic()
        with self._lock:
            peers = [pv.as_dict(now) for pv in self._peers.values()]
            version = self._version
        return {"version": version, "self": self.self_url or None,
                "peers": peers}

    # -- transitions -------------------------------------------------------

    def _bump_locked(self) -> None:
        self._version += 1
        self._ring = None

    def record_failure(self, peer: str) -> str | None:
        """One transport/timeout failure against ``peer`` (probe or
        fill). Returns the peer's state after the transition. Status
        and digest failures must NOT land here — a 503 shed or a
        digest liar is not evidence the process is unreachable."""
        now = time.monotonic()
        with self._lock:
            pv = self._peers.get(peer)
            if pv is None:
                return None
            pv.fails += 1
            if pv.state == ALIVE and pv.fails >= self.suspect_after:
                pv.state, pv.since = SUSPECT, now
            elif pv.state == SUSPECT \
                    and now - pv.since >= self.down_after_s:
                pv.state, pv.since = DOWN, now
                self._bump_locked()
            return pv.state

    def record_success(self, peer: str) -> str | None:
        """Confirmed contact with ``peer`` (probe answered, fill
        served + verified). Rejoins down peers; a quarantined peer
        stays out until its window has elapsed."""
        now = time.monotonic()
        with self._lock:
            pv = self._peers.get(peer)
            if pv is None:
                if not peer or peer == self.self_url:
                    return None
                pv = self._peers[peer] = PeerView(peer)   # join
                pv.last_ok = now
                self._bump_locked()
                return pv.state
            if pv.state == QUARANTINED \
                    and now - pv.since < self.quarantine_s:
                return pv.state     # still serving its sentence
            was_member = pv.state in _MEMBER_STATES
            pv.fails = 0
            pv.last_ok = now
            if pv.state != ALIVE:
                pv.state, pv.since = ALIVE, now
                if not was_member:
                    self._bump_locked()     # rejoin: ownership returns
            return pv.state

    def heard_from(self, peer: str) -> None:
        """An inbound probe FROM ``peer`` proves it is alive — same
        evidence as our own probe succeeding (and how a never-seeded
        origin joins the fabric)."""
        self.record_success(peer)

    def quarantine(self, peer: str) -> None:
        """``peer`` served bytes that failed digest verification: it
        leaves the ownership set for ``quarantine_s`` regardless of
        reachability. Liveness is not trustworthiness."""
        now = time.monotonic()
        with self._lock:
            pv = self._peers.get(peer)
            if pv is None:
                return
            if pv.state != QUARANTINED:
                was_member = pv.state in _MEMBER_STATES
                pv.state, pv.since = QUARANTINED, now
                if was_member:
                    self._bump_locked()

    def tick(self) -> None:
        """Clock-driven transitions (called each probe round): a
        suspect that has stayed silent past the down window goes down
        even if nothing new failed in between."""
        now = time.monotonic()
        with self._lock:
            for pv in self._peers.values():
                if pv.state == SUSPECT \
                        and now - pv.since >= self.down_after_s:
                    pv.state, pv.since = DOWN, now
                    self._bump_locked()

    def merge(self, view: dict) -> None:
        """Fold a gossiped remote view in. Remote *suspicion* spreads
        (alive-here peers the sender cannot reach become suspect here,
        unless we have fresh first-hand contact); remote DOWN is still
        only suspicion here — death is confirmed by local probes.
        Unknown peers in the view join as alive."""
        peers = view.get("peers")
        if not isinstance(peers, list):
            return
        now = time.monotonic()
        with self._lock:
            for rec in peers:
                if not isinstance(rec, dict):
                    continue
                url = str(rec.get("url", "")).strip().rstrip("/")
                state = rec.get("state")
                if not url or url == self.self_url:
                    continue
                pv = self._peers.get(url)
                if pv is None:
                    if state in _MEMBER_STATES:
                        self._peers[url] = PeerView(url)    # join
                        self._bump_locked()
                    continue
                if state in (SUSPECT, DOWN) and pv.state == ALIVE \
                        and now - pv.last_ok >= self.down_after_s:
                    pv.state, pv.since = SUSPECT, now


# --------------------------------------------------------------------------
# The probe side: one jittered heartbeat round + the long-running loop.
# Network I/O lives here (event loop, aiohttp); Membership stays pure.
# --------------------------------------------------------------------------

async def probe_once(membership: Membership, session, *,
                     timeout_s: float = 1.0, on_outcome=None) -> int:
    """One heartbeat round: probe every known peer, merge what comes
    back, run clock transitions. Returns how many peers answered.
    ``on_outcome(outcome)`` (ok/fail/drop) feeds the metrics plane
    without importing it here."""
    import aiohttp

    answered = 0
    for peer in membership.known_peers():
        try:
            failpoints.hit("delivery.gossip")
        except failpoints.FailpointError:
            # the heartbeat is dropped on the floor before any network
            # I/O; silence is indistinguishable from death, so the
            # round still counts as a failed contact
            membership.record_failure(peer)
            if on_outcome is not None:
                on_outcome("drop")
            continue
        try:
            async with session.get(
                    f"{peer}/api/delivery/gossip",
                    headers=({GOSSIP_FROM_HEADER: membership.self_url}
                             if membership.self_url else {}),
                    timeout=aiohttp.ClientTimeout(total=timeout_s),
            ) as resp:
                if resp.status != 200:
                    raise OSError(f"gossip probe answered {resp.status}")
                view = await resp.json()
        except Exception:  # noqa: BLE001 — any failure is suspicion
            membership.record_failure(peer)
            if on_outcome is not None:
                on_outcome("fail")
            continue
        answered += 1
        membership.record_success(peer)
        if isinstance(view, dict):
            membership.merge(view)
        if on_outcome is not None:
            on_outcome("ok")
    membership.tick()
    return answered


async def probe_loop(membership: Membership, session_factory, *,
                     interval_s: float, jitter: float = 0.25,
                     on_outcome=None) -> None:
    """Run :func:`probe_once` forever on a bounded jittered cadence.

    Jitter desynchronizes the fleet (N origins probing in lockstep
    would make every suspect window start at once); the interval is
    the *mean*, bounded to ``[interval*(1-jitter), interval*(1+jitter)]``.
    Cancelled by ``DeliveryPlane.close()``.
    """
    import asyncio

    jitter = min(max(jitter, 0.0), 0.9)
    rng = random.Random(hash(membership.self_url) & 0xFFFF)
    timeout_s = min(max(interval_s, 0.2), 2.0)
    while True:
        await asyncio.sleep(interval_s * (1.0 + rng.uniform(-jitter,
                                                            jitter)))
        await probe_once(membership, session_factory(),
                         timeout_s=timeout_s, on_outcome=on_outcome)
