"""Deterministic synthetic data pipelines (token LM batches).

The port of ``repro.data.synthetic``: a Zipf unigram stream with local
n-gram structure so cross-entropy has learnable signal, deterministic in
(seed, step), so any worker can regenerate any batch (what makes restart
and elastic rescale exact).  The draw is numpy's, as in the reference, so
both packages give the same batches; they come back as int32 tensors on
the CPU.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def token_batch(vocab: int, batch: int, seq: int, seed: int, step: int
                ) -> torch.Tensor:
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + step)
    # Zipf marginals + copy structure (token repeated with lag 2)
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64) % vocab
    copy_mask = rng.random((batch, seq)) < 0.5
    shifted = np.roll(base, 2, axis=1)
    tokens = np.where(copy_mask, shifted, base)
    return torch.from_numpy(tokens.astype(np.int32))


def token_batches(vocab: int, batch: int, seq: int, seed: int = 0
                  ) -> Iterator[torch.Tensor]:
    step = 0
    while True:
        yield token_batch(vocab, batch, seq, seed, step)
        step += 1
