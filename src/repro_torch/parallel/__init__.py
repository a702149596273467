"""Distribution: the blockwise execution core (host and device backends),
the sharding rules on torch ``DeviceMesh`` / ``DTensor`` and GPipe."""

from . import blockwise  # noqa: F401
from .sharding import (DEFAULT_RULES, AxisRules, batch_axes,  # noqa: F401
                       mesh_axis_sizes, spec_for, tree_specs_to_shardings)

__all__ = ["blockwise", "AxisRules", "DEFAULT_RULES", "spec_for",
           "tree_specs_to_shardings", "mesh_axis_sizes", "batch_axes"]
