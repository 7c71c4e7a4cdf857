"""From the start of the process to the first timed request: data made
from the seed, the Engine built and loaded, the server started, the
kernels built where the checkout has none and every shape warmed up."""


def read(ctx):
    return ctx.setup_seconds
