"""The serving process's host threads: 1 - the threads' CPU time over
the wall time, summed over the `http.body`, `http.decode`, `http.encode`
and `engine.assemble` spans. They touch no device and no lock, so their
time off the CPU is the interpreter's lock or the scheduler."""

from harness.program_spans import BODY, DECODE, ENCODE, offcpu_share


def read(ctx):
    return offcpu_share(ctx, (BODY, DECODE, ENCODE, "engine.assemble"))
