"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--batch B] [--seq-len S] [--ckpt-dir DIR] [--seed N]
[--device {cuda,cpu}]`` (counterpart of ``repro/launch/train.py``).

Trains an arch's REDUCED (smoke) config end to end on one device (the card
unless ``--device cpu``): AdamW at lr 1e-3 over the counter-based
synthetic batches, from seeded weights, checkpointing to ``--ckpt-dir`` when
given (a rerun resumes there).  Prints the reference's line: the first
loss and the mean of the last five.  ``main(argv)`` runs it in-process and
returns the ``TrainResult``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from .. import configs as C
    from ..data import synthetic as syn
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import train
    from ..train.optimizer import AdamWConfig

    arch = C.get(args.arch)
    cfg = arch.make_smoke()
    dev = resolve_device(args.device)

    def generator() -> torch.Generator:
        return torch.Generator(dev).manual_seed(args.seed)

    def on_dev(batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    if arch.family == "lm":
        from ..models import transformer as tf
        loss_fn = lambda m, b: tf.lm_loss(m, cfg, b["tokens"])  # noqa: E731
        init_fn = lambda: tf.Transformer(cfg, generator(), dev)  # noqa: E731
        batch_fn = lambda step: on_dev(syn.lm_batch(args.seed, step, args.batch,  # noqa: E731
                                                    args.seq_len, cfg.vocab))
    elif arch.family == "gnn":
        from ..models import gnn as g
        graph = on_dev(syn.random_graph(args.seed, 500, 2500, cfg.d_feat, cfg.n_classes))
        loss_fn = lambda m, b: g.nll_loss(  # noqa: E731
            g.forward_full(m, cfg, b["x"], b["src"], b["dst"]), b["labels"])
        init_fn = lambda: g.GIN(cfg, generator(), dev)  # noqa: E731
        batch_fn = lambda step: graph  # noqa: E731
    elif arch.family == "recsys":
        from ..dist.steps import _RS_INIT, _RS_LOSS
        init = _RS_INIT[args.arch]
        loss = _RS_LOSS[args.arch]
        loss_fn = lambda m, b: loss(m, cfg, b)  # noqa: E731
        init_fn = lambda: init(cfg, generator(), dev)  # noqa: E731
        batch_fn = lambda step: on_dev(syn.recsys_batch(args.seed, step, args.arch,  # noqa: E731
                                                        cfg, args.batch))
    else:
        raise SystemExit(f"--arch {args.arch}: use examples/retrieval scripts")

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    res = train(loss_fn=loss_fn, init_params_fn=init_fn, batch_fn=batch_fn,
                n_steps=args.steps, opt_cfg=AdamWConfig(lr=1e-3), ckpt=ckpt)
    first, last = res.losses[0], float(np.mean(res.losses[-5:]))
    print(f"[train] {args.arch}: steps {res.start_step}->{res.end_step} "
          f"loss {first:.4f} -> {last:.4f} stragglers={len(res.straggler_steps)}")
    return res


if __name__ == "__main__":
    main()
