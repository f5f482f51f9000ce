"""The share of the traced training window in which no operation ran on
the device, %."""

from portbench.harness.trace import idle_share as read  # noqa: F401
