"""The paper's own workload as a first-class arch: monavec-scan.

Distributed 4-bit brute-force retrieval (corpus sharded over the mesh, packed
scan + local top-k + global top-k).  The corpus sizes sweep from the paper's
AG News (45K) to production scale (1B vectors — only viable because of the
8x quantization, the paper's §4.5 'scaling argument').
"""

from __future__ import annotations

import dataclasses

from .registry import Arch, ShapeSpec, register


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    name: str = "monavec-scan"
    dim: int = 1024                 # BGE-M3 embedding dim (paper's AG News)
    bits: int = 4
    metric: str = "cosine"
    k: int = 10


def monavec_scan() -> RetrievalConfig:
    return RetrievalConfig()


def monavec_smoke() -> RetrievalConfig:
    return RetrievalConfig(name="monavec-smoke", dim=128)


MONAVEC_SHAPES = (
    ShapeSpec("agnews_45k", "mv_scan", {"n_corpus": 45_056, "batch_q": 256}),
    ShapeSpec("glove_1m", "mv_scan", {"n_corpus": 1_179_648, "batch_q": 256}),
    ShapeSpec("corpus_100m", "mv_scan", {"n_corpus": 100_663_296, "batch_q": 256}),
    ShapeSpec("corpus_1b", "mv_scan", {"n_corpus": 1_073_741_824, "batch_q": 64}),
)

register(Arch(
    arch_id="monavec-scan", family="retrieval", make_config=monavec_scan,
    make_smoke=monavec_smoke, shapes=MONAVEC_SHAPES,
    notes="The paper's technique itself as a distributed serving workload; "
          "supplementary to the 40 assigned cells.",
))
