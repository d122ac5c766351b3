"""The 95th percentile, over every request of the window, of the time from the call
to its outputs on the host, in ms (host clock)."""
from harbench.timeline import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies(), 95)
