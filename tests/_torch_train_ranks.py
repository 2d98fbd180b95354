"""Rank function of the port's data-parallel training cases (torch only).

``train_rank`` runs in each of ``tests/_torch_dist.run_ranks``' gloo
ranks, over the world group: two steps of ``compressed_psum`` with error
feedback on this rank's gradients, ``masked_psum_mean`` under an alive
mask, and the trainer's straggler scenario of
``tests/test_train_substrate.py`` with the average taken across the
ranks.  It returns what this rank computed, as numpy.
"""

import os
import tempfile

import numpy as np


def train_rank(rank, world, grads, alive, poisoned):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.collectives import masked_psum_mean
    from repro_torch.train import TrainerConfig, compressed_psum, run

    group = dist.group.WORLD
    mine = {k: torch.as_tensor(v[rank]) for k, v in grads.items()}
    avg, err = compressed_psum(mine, group)
    avg2, err2 = compressed_psum(mine, group, err)
    masked = masked_psum_mean(mine, group, float(alive[rank]))

    # the trainer's straggler case: replica `slow` reports 5x step times
    # and carries a poisoned gradient; every rank's monitor sees the same
    # times, so all drop it at the same step.
    slow = int(np.argmax(poisoned))
    g = torch.tensor(float(poisoned[rank]))
    calls = {"n": 0}

    def step_fn(state, _, alive_mask):
        calls["n"] += 1
        times = np.ones(world)
        times[slow] = 5.0
        mean = masked_psum_mean({"g": g}, group, float(alive_mask[rank]))
        return ({"w": state["w"] - 0.1 * mean["g"]},
                {"loss": 1.0, "replica_step_times": times})

    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(total_steps=6, ckpt_dir=os.path.join(tmp, "c"),
                            ckpt_every=50, log_every=100, n_replicas=world,
                            straggler_drop_factor=4.0, straggler_patience=2)
        state, report = run(cfg, {"w": torch.zeros(())}, step_fn,
                            iter(lambda: None, 1), log=lambda *_: None)

    def host(tree):
        return {k: v.numpy() for k, v in tree.items()}

    return {"avg": host(avg), "err": host(err), "avg2": host(avg2),
            "err2": host(err2), "masked": host(masked),
            "w": float(state["w"]), "dropped": report.dropped_replicas,
            "calls": calls["n"]}
