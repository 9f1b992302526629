"""The HTTP plane (port of ``vlog_tpu/api``): the Worker API server
(:mod:`.worker_api`) with its key auth (:mod:`.auth`) and request-id
middleware (:mod:`.errors`), and the settings service behind per-tenant
QoS policies (:mod:`.settings`). The admin and public APIs are not
ported (ROADMAP Queue A items 13c and 13d)."""
