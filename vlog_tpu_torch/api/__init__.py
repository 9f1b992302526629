"""The part of the JAX package's HTTP plane the job plane reads: the
settings service behind per-tenant QoS policies (:mod:`.settings`). The
HTTP services themselves are not ported."""
