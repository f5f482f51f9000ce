"""The share of the traced merge window in which no operation ran on
the device, %: the same reading as ``device_idle_share.train``."""

from portbench.harness.trace import idle_share as read  # noqa: F401
