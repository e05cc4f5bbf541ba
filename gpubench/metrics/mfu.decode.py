"""Model FLOPs of the traced window's real utterances over its length at
the configuration's dtype's peak, percent."""

from gpubench.readers import mfu as read
