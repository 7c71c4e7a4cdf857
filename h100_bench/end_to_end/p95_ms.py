"""The 95th percentile of every request of the window, from the client's
side: from when the request was due (an open loop's schedule; a closed
loop's send) to its answer; a request that failed counts as infinite."""

import statistics


def read(ctx):
    lat = ctx.latency_s().tolist()
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
