"""Delivery plane (a copy of ``vlog_tpu/delivery``): origin segment cache,
single-flight, admission,
publish-keyed invalidation, plus the distributed tier — disk-backed L2,
consistent-hash peer fill, publish-time prewarm, zero-copy large-object
serving (see delivery/plane.py for the design note).

Import surface for the rest of the codebase:

- :class:`DeliveryPlane` — one per serving process (public API).
- :func:`invalidate_slug` / :func:`invalidate_all` — called by the
  publish/re-encode/delete/verify paths and the admin endpoint; fan out
  to every plane registered in this process.
- :func:`prewarm_slug` — publish-time prewarm fan-out (finalize_ready).
- :func:`stats_snapshot` — the admin stats panel's data source.
"""

from vlog_tpu_torch.delivery.cache import (
    CacheEntry,
    FileEntry,
    SegmentCache,
    SingleFlight,
)
from vlog_tpu_torch.delivery.gossip import (
    GOSSIP_FROM_HEADER,
    Membership,
    probe_loop,
    probe_once,
)
from vlog_tpu_torch.delivery.l2 import DiskL2
from vlog_tpu_torch.delivery.plane import (
    FILL_TOKEN_HEADER,
    PEER_FILL_HEADER,
    DeliveryPlane,
    LoadShedError,
    MediaEscapeError,
    PeerFillError,
    ServingState,
    has_planes,
    invalidate_all,
    invalidate_slug,
    prewarm_slug,
    register,
    stats_snapshot,
)
from vlog_tpu_torch.delivery.ring import Ring

__all__ = [
    "CacheEntry",
    "DeliveryPlane",
    "DiskL2",
    "FILL_TOKEN_HEADER",
    "FileEntry",
    "GOSSIP_FROM_HEADER",
    "LoadShedError",
    "MediaEscapeError",
    "Membership",
    "PEER_FILL_HEADER",
    "PeerFillError",
    "Ring",
    "SegmentCache",
    "ServingState",
    "SingleFlight",
    "has_planes",
    "invalidate_all",
    "invalidate_slug",
    "prewarm_slug",
    "probe_loop",
    "probe_once",
    "register",
    "stats_snapshot",
]
