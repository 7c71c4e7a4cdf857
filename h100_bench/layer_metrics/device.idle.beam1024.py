"""The card: the share of the traced slice in which no operation ran on
it (1 - the union of kernels, copies and sets over the slice's wall)."""

from harness.layers import device_idle as read  # noqa: F401
