"""The card and the serving process: the share of the traced slice's
device idle time whose gap has its middle in no program span (no request
in the serving process's hands); notes the idle seconds by the deepest
program span over each gap."""

from harness.program_spans import idle_outside_spans as read  # noqa: F401
