"""The HTTP plane (port of ``vlog_tpu/api``): the Worker API server
(:mod:`.worker_api`) with its key auth (:mod:`.auth`) and request-id
middleware (:mod:`.errors`), the public API (:mod:`.public_api`, media
through the delivery plane, listings paged by :mod:`.pagination`),
the settings service behind per-tenant QoS policies and the display
config (:mod:`.settings`), and the admin API (:mod:`.admin_api`, with
the catalog routes of :mod:`.catalog` and the audit log of
:mod:`.audit`)."""
