"""End-to-end example (PyTorch + CUDA port): train a 2-layer GCN with the
fault-tolerant trainer.

The port's counterpart of ``examples/train_gcn.py``: dataset synthesis ->
hybrid preprocessing -> the differentiable ``impl="reference"`` SpMM (the
CUDA kernels have no backward) -> AdamW -> checkpoints ->
restart-on-failure (inject one with --inject-failure).

Run:  PYTHONPATH=src python examples/torch_train_gcn.py --steps 300
      PYTHONPATH=src python examples/torch_train_gcn.py --device cpu
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs import load_dataset
from repro_torch.models.gcn import (
    GCNConfig,
    GCNGraph,
    gcn_accuracy,
    gcn_loss,
    init_params,
)
from repro_torch.train import (
    AdamWConfig,
    StepFailure,
    TrainerConfig,
    adamw_init,
    adamw_update,
    run,
    value_and_grad,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_gcn_ckpt"))
    ap.add_argument("--inject-failure", action="store_true",
                    help="simulate a node loss at step 40")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    ds = load_dataset(args.dataset)
    cfg = GCNConfig(
        in_dim=ds.spec.feature_dim,
        hidden_dim=args.hidden,
        out_dim=ds.spec.classes,
        spmm_impl="reference",
    )
    graph = GCNGraph.build(ds.adj_norm, cfg)
    feats = torch.as_tensor(ds.features, device=dev)
    # learnable labels: 2-hop aggregated feature signs (so the task is
    # actually coupled to the graph structure, not noise)
    a = ds.adj_norm.to_scipy()
    sig = np.asarray(a @ (a @ ds.features[:, : cfg.out_dim]))
    labels = torch.as_tensor(np.argmax(sig, axis=1), device=dev).long()

    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=20)
    state = {"params": params, "opt": adamw_init(params)}
    grad = value_and_grad(
        lambda p: gcn_loss(p, graph, feats, labels, cfg, device=dev))

    def step_fn(state, _batch):
        loss, grads = grad(state["params"])
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], state["params"])
        return ({"params": new_params, "opt": new_opt},
                {"loss": float(loss), **{k: float(v)
                                         for k, v in metrics.items()}})

    def batches():
        while True:
            yield None

    failure_hook = None
    if args.inject_failure:
        fired = {"done": False}

        def failure_hook(step):
            if step == 40 and not fired["done"]:
                fired["done"] = True
                raise StepFailure("injected node loss")

    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=25,
        log_every=25,
    )
    state, report = run(tcfg, state, step_fn, batches(),
                        failure_hook=failure_hook)

    with torch.no_grad():
        acc = gcn_accuracy(state["params"], graph, feats, labels, cfg,
                           device=dev)
    print(f"\ndone: steps={report.steps_done} restarts={report.restarts} "
          f"stragglers={report.stragglers}")
    print(f"final loss={report.losses[-1]:.4f}  train acc={float(acc):.3f}")
    assert report.losses[-1] < report.losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
