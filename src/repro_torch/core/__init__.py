"""ER_q polarity graphs, GF(q) arithmetic, layout, expansion, routing and
stepping: copies of the JAX package's numpy host modules, kept here so the
port stands alone."""
from .polarfly import PolarFly, build_polarfly, moore_bound, moore_efficiency  # noqa: F401
from .layout import Layout, build_layout  # noqa: F401
from .graph import Graph, GraphBuilder  # noqa: F401
