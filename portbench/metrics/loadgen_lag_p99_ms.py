"""loadgen_lag_p99_ms: the 99th percentile (nearest rank) of how late the
load generator sent each request after it was due (host clock)."""

from portbench.yardstick import percentile


def read(rec):
    lag = rec.window.lag_ms
    return None if lag is None or not len(lag) else percentile(lag, 99)
