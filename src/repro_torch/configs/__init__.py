# Architecture configs (counterpart of ``repro.configs``): importing this
# package populates the registry.
from . import lm, gnn, recsys, retrieval  # noqa: F401
from .registry import Arch, ShapeSpec, all_archs, cells, get  # noqa: F401
