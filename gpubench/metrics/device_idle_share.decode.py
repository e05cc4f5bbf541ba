"""Percent of the traced window in which the device ran nothing."""

from gpubench.readers import idle_share as read
