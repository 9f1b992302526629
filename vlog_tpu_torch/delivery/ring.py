"""Rendezvous-hash ring over delivery origin peers (a copy of
``vlog_tpu/delivery/ring.py``: the same owners for every key).

Ownership routing for the distributed delivery tier: every origin
process hashes each object key against the configured peer list and the
highest score wins (highest-random-weight / rendezvous hashing, Thaler &
Ravishankar 1998). Unlike a ring of virtual nodes, HRW needs no state
beyond the member list, gives minimal disruption when a peer joins or
leaves (only the keys whose argmax moves), and every member computes the
same answer independently — no coordination plane involved.

The ring is immutable after construction and every method is pure, so
it is safe to consult from the event loop and from ``to_thread`` fill
workers without locking.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

__all__ = ["Ring"]


def _score(peer: str, key: str) -> int:
    """HRW weight of ``peer`` for ``key``: big-endian sha256 of the pair.

    sha256 (vs a faster non-crypto hash) keeps the scores unarguably
    uniform and the implementation dependency-free; at one hash per
    peer per cache MISS the cost is noise next to the disk read the
    miss is about to do.
    """
    h = hashlib.sha256(f"{peer}|{key}".encode("utf-8", "surrogatepass"))
    return int.from_bytes(h.digest()[:16], "big")


class Ring:
    """The peer set plus this process's own identity within it.

    ``peers`` are base URLs (``http://host:port``); trailing slashes and
    duplicates are dropped so the hash is insensitive to spelling.
    ``self_url`` names which peer is *us* — empty means this process
    owns nothing and treats every keyed object as remotely owned.

    ``version`` stamps which membership view this ring was built from
    (gossip bumps its view version on every ownership change; the
    delivery plane rebuilds the ring only when the stamps diverge). A
    ring constructed outside the gossip plane keeps version 0 and is
    never rebuilt from under its owner.
    """

    __slots__ = ("peers", "self_url", "version")

    def __init__(self, peers: Sequence[str], self_url: str = "", *,
                 version: int = 0) -> None:
        cleaned = []
        for u in peers:
            u = u.strip().rstrip("/")
            if u and u not in cleaned:
                cleaned.append(u)
        self.peers: tuple[str, ...] = tuple(cleaned)
        self.self_url: str = self_url.strip().rstrip("/")
        self.version: int = int(version)

    @property
    def enabled(self) -> bool:
        """Peer-fill is meaningful only with at least two members (a
        one-member ring always resolves to local fill)."""
        return len(self.peers) >= 2 or (
            len(self.peers) == 1 and self.peers[0] != self.self_url)

    def owner(self, key: str) -> str | None:
        """The peer that owns ``key``, or None for an empty ring."""
        if not self.peers:
            return None
        return max(self.peers, key=lambda p: _score(p, key))

    def ranked(self, key: str) -> tuple[str, ...]:
        """All peers in descending HRW preference for ``key``: the
        owner first, then the hedge candidates in the order a fill
        should fall through them. Pure, like every other consult."""
        return tuple(sorted(self.peers,
                            key=lambda p: _score(p, key), reverse=True))

    def is_local(self, key: str) -> bool:
        """True when this process should fill ``key`` from its own disk
        (empty ring, or we are the rendezvous owner)."""
        own = self.owner(key)
        return own is None or own == self.self_url

    def membership(self) -> dict:
        """Admin-facing view of the ring: members + our identity."""
        return {
            "peers": list(self.peers),
            "self": self.self_url or None,
            "enabled": self.enabled,
        }
