"""Distribution: the blockwise execution core (host backend)."""

from . import blockwise  # noqa: F401
