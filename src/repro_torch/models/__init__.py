"""The model zoo's serving forwards (counterpart of ``repro.models``): one
``nn.Module`` per model holding the reference's parameter tree under its
keys, and the reference's functions over it.  ``convert`` carries a
reference parameter tree across."""

from .convert import from_reference_params  # noqa: F401
from .gnn import GIN, GINConfig  # noqa: F401
from .recsys import (DIEN, DLRM, FM, DIENConfig, DLRMConfig, FMConfig, TwoTower,  # noqa: F401
                     TwoTowerConfig)
from .transformer import Transformer, TransformerConfig, decode_step, forward, prefill  # noqa: F401
