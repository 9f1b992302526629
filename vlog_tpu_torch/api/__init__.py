"""The HTTP plane (port of ``vlog_tpu/api``): the Worker API server
(:mod:`.worker_api`) with its key auth (:mod:`.auth`) and request-id
middleware (:mod:`.errors`), the public API (:mod:`.public_api`, media
through the delivery plane, listings paged by :mod:`.pagination`), and
the settings service behind per-tenant QoS policies and the display
config (:mod:`.settings`). The admin API is not ported (ROADMAP Queue A
item 13d)."""
