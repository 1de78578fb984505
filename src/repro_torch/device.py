"""Where the port's entry points run.

Entry points default to ``device="cuda"`` and never fall back: asking for
CUDA on a machine without it raises, and only an explicit ``device="cpu"``
runs the kernels' plain versions on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was asked for but CUDA is not available; "
                f"pass device='cpu' to run the plain versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {str(device)!r}")
    return dev
