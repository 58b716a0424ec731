"""call_p95_ms.crawl: the 95th percentile (nearest rank) of the
benchmark's own span around each `detect_many` call of the window."""

from portbench.lib.record import call_p95_ms as read  # noqa: F401
