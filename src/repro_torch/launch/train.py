"""End-to-end LM training launcher.

The port of ``repro.launch.train``, with the same flags and the same
printed lines: random weights drawn on the device from seed 0, AdamW
(warmup 5 steps), the synthetic token stream of ``data.synthetic`` and
the fault-tolerant trainer with checkpoints under ``--ckpt-dir``.  Usage
(on the card; ``main(argv, device="cpu")`` runs it on the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 20 --batch 8 --seq 128

The train step (``launch.steps.build_train_step``) rematerializes each
body period and updates the parameters and moments in place.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.train import AdamWConfig, TrainerConfig, adamw_init, run
from repro_torch.train.tree import leaves


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Train ``--steps`` steps; prints the reference's lines and returns
    the trainer's report, the final state, the config and the parameter
    count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, loss_chunk=min(cfg.loss_chunk, args.seq))

    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    opt = adamw_init(params)
    step = build_train_step(cfg, opt_cfg, device=dev)

    n_params = sum(p.numel() for p in leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}")

    batches = token_batches(cfg.vocab, args.batch, args.seq, seed=0)
    memory = None
    if cfg.frontend_tokens:
        memory = torch.zeros((args.batch, cfg.frontend_tokens, cfg.d_model),
                             dtype=torch.bfloat16, device=dev)

    def step_fn(state, batch):
        p, o, metrics = step(state["params"], state["opt"], batch, memory)
        return {"params": p, "opt": o}, {k: float(v)
                                         for k, v in metrics.items()}

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(args.steps // 2, 5), log_every=5)
    state, report = run(tcfg, {"params": params, "opt": opt}, step_fn,
                        batches)
    print(f"done: {report.steps_done} steps, "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    return {"report": report, "state": state, "cfg": cfg,
            "n_params": n_params, "device": str(dev)}


if __name__ == "__main__":
    main()
