"""Launchers: the serve and train entry points, the meshes, and the
launch tools -- the cell planner (`cells`), the roofline (`roofline`),
the per-device cost trace (`cost`), the dry run on a fake 256/512-rank
world (`dryrun`), the collective breakdown (`collbreak`) and the memory
diagnosis (`memdebug`), the rank launcher (`ranks`) and the rank
functions of the multi-card run (`cards`).  Submodules load on first
use: a tool run with ``python -m repro_torch.launch.<tool>`` is then not
imported twice (once by the package, once as ``__main__``)."""

import importlib

__all__ = ["cards", "cells", "collbreak", "cost", "dryrun", "memdebug",
           "mesh", "ranks", "roofline", "serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
