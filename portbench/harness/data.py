"""The seeded stand-in data, made on the run's device.

A torch copy of the program's ``data/synthetic.py`` recipe (not imported
from it): ``corpus`` is ``embedding_corpus`` (unit topic centres plus
per-row Gaussian noise scaled by U(0.3, 1.5) x ``noise``) and ``query_pool``
is ``queries_from_corpus`` (seeded corpus rows plus Gaussian noise).  Each
is drawn from one ``torch.Generator`` on the device in a few large calls,
so a seed gives the same bytes on the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))
    return g


def corpus(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """[rows, dim] f32 on ``device``: the configuration's stand-in corpus."""
    a = cfg["assumed"]
    n, d, topics, noise = cfg["rows"], cfg["dim"], a["topics"], a["noise"]
    g = generator(seed, 0, device)
    centres = torch.randn((topics, d), generator=g, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    assign = torch.randint(0, topics, (n,), generator=g, device=device)
    scale = noise * (0.3 + 1.2 * torch.rand((n, 1), generator=g, device=device))
    x = torch.randn((n, d), generator=g, device=device)
    x.mul_(scale).add_(centres[assign])
    return x


def query_pool(cfg: dict, x: torch.Tensor, seed: int, size: int) -> np.ndarray:
    """[size, dim] f32 on the host: noisy copies of seeded corpus rows."""
    g = generator(seed, 1, x.device)
    rows = torch.randint(0, x.shape[0], (size,), generator=g, device=x.device)
    noise = torch.randn((size, x.shape[1]), generator=g, device=x.device)
    q = x[rows] + cfg["assumed"]["query_noise"] * noise
    return q.cpu().numpy()


def fingerprint(x: torch.Tensor) -> int:
    """An integer sum of the tensor's bits, block by block: the same bytes
    give the same number (the judge's check that a corpus made again from
    the seed is the one the program was given)."""
    bits = x.reshape(x.shape[0], -1).view(torch.int32)
    return sum(int(bits[i:i + 65536].sum(dtype=torch.int64).item())
               for i in range(0, bits.shape[0], 65536))
