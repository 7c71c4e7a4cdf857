"""Queries answered within the window, over the window's seconds (a
closed loop's rate; an open loop's completed rate follows its offer)."""

import numpy as np


def read(ctx):
    r = ctx.records
    done = r["ok"] & (r["t_done"] <= ctx.window[1])
    return float(np.sum(r["n_queries"][done])) / ctx.seconds
