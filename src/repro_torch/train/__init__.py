"""Training (counterpart of ``repro.train``): the reference's AdamW
(``optimizer``), the atomic keep-k checkpoint manager writing the
reference's files (``checkpoint``) and the fault-tolerant loop (``loop``)."""

from .checkpoint import CheckpointManager  # noqa: F401
from .loop import SimulatedFailure, TrainResult, train  # noqa: F401
from .optimizer import (AdamWConfig, adamw_update, compress_int8, global_norm,  # noqa: F401
                        init_opt_state, make_train_step)
