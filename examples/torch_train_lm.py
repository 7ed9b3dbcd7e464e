"""Train an LM end to end with the full framework stack, on PyTorch:
Markov data pipeline, AdamW, async checkpointing, straggler monitor,
fault-tolerant restart loop, and (optionally) Torrent chain collectives
for the data-parallel gradient reduction.

The PyTorch twin of ``examples/train_lm.py``, with the same arguments
and defaults. Defaults are laptop-sized; ``--dim/--layers/--steps``
scale it up (e.g. ``--dim 640 --layers 10 --vocab 32000`` is a
~100M-param model). The overrides are applied to the model config
before the ``Trainer`` is built, so the Markov source's transition
table is drawn at the overridden vocabulary.

The script runs on the card and raises without one unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 60
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs as C
from repro_torch.launch.train import TrainConfig, Trainer
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi-6b", choices=C.ARCHS)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--dim", type=int, default=0, help="override d_model")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--collectives", choices=("xla", "torrent"), default="xla")
    p.add_argument("--fail-at", default="", help="e.g. 25,40 to demo restart")
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def model_config(args: argparse.Namespace) -> ModelConfig:
    """The smoke config of ``args.arch`` with ``--dim``, ``--layers``
    and ``--vocab`` applied (``d_ff = 4 * dim``, ``head_dim = dim //
    num_heads``)."""
    cfg = C.get_smoke_config(args.arch)
    overrides = {}
    if args.dim:
        overrides.update(d_model=args.dim, d_ff=4 * args.dim,
                         head_dim=args.dim // cfg.num_heads)
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    return dataclasses.replace(cfg, **overrides)


def build_trainer(args: argparse.Namespace, params=None) -> Trainer:
    """The ``Trainer`` of ``args`` on ``args.device``, from ``params``
    (e.g. carried weights) if given."""
    tc = TrainConfig(
        arch=args.arch, smoke=True, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq,
        collectives=args.collectives, ckpt_dir=args.ckpt_dir,
        ckpt_every=max(10, args.steps // 4), log_every=5,
        fail_at=tuple(int(s) for s in args.fail_at.split(",") if s),
    )
    return Trainer(tc, device=args.device, params=params, model_cfg=model_config(args))


def param_count(trainer: Trainer) -> int:
    return sum(x.numel() for x in leaves(trainer.state["params"]))


def main(argv=None) -> dict:
    args = parse_args(argv)
    trainer = build_trainer(args)
    n = param_count(trainer)
    print(f"training {trainer.cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps, collectives={args.collectives}")
    out = trainer.run()
    print(
        f"done: loss {out['first_loss']:.3f} -> {out['last_loss']:.3f}, "
        f"{out['restarts']} restarts, {out['straggler_events']} stragglers, "
        f"{out['tokens_per_s']:.0f} tok/s"
    )
    return {"name": trainer.cfg.name, "params": n, **out}


if __name__ == "__main__":
    main()
