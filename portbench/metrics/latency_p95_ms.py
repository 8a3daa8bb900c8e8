"""latency_p95_ms: the 95th percentile (nearest rank) of every request
due in the window, each timed from when it was due to be sent to when
its answer resolved; a failed or unanswered request counts as answered
when the harness gave up on it."""

from portbench.yardstick import percentile


def read(rec):
    lat = rec.window.latencies_ms
    return None if lat is None or not len(lat) else percentile(lat, 95)
