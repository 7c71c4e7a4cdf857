"""Over every query answered in the window, the share of the k = 10 hits
that belong to the plain reference's exact top 10 for the same query
under the same semantics, ties at the 10th place counted as hits."""


def read(ctx):
    if int(ctx.mix["k"]) != 10:
        return None
    return ctx.judged["recall"]
