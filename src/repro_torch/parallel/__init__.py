"""Distribution: the blockwise execution core (host and device backends)."""

from . import blockwise  # noqa: F401
