"""LM serving launcher: batched greedy decode with a KV cache.

The port of ``repro.launch.serve``, with the same flags and the same
printed line.  Usage (on the card; ``main(argv, device="cpu")`` runs it on
the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --reduced --batch 4 --tokens 32

The weights are random, drawn on the device from seed 0.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import lm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Decode ``--tokens`` steps greedily; prints the reference's line and
    returns the per-token latencies (ms, the first step excluded as the
    reference excludes its compile) with their p50, p99 and tok/s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=64)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cache = lm.init_cache(cfg, args.batch, args.max_seq, dev)
    step = build_serve_step(cfg, device=dev)

    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, 1)),
                          device=dev)
    lat = []
    for t in range(args.tokens):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok, t)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        tok = logits.argmax(-1)[:, None]
    lat_ms = np.asarray(lat[1:]) * 1e3      # the first step warms up
    out = {
        "arch": cfg.name, "batch": args.batch, "tokens": args.tokens,
        "max_seq": args.max_seq, "lat_ms": lat_ms.tolist(),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "tok_s": float(args.batch / np.mean(lat_ms) * 1e3),
        "device": str(dev),
    }
    print(f"{cfg.name}: {args.tokens} tokens x batch {args.batch}; "
          f"p50 {out['p50_ms']:.1f} ms/tok, "
          f"throughput {out['tok_s']:.1f} tok/s")
    return out


if __name__ == "__main__":
    main()
