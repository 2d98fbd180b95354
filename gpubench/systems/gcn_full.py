"""Full-graph GCN inference through the port's registry step.

Set-up reads (or, in a checkout's first run, synthesizes) the
configuration's normalized graph, has the program's
``ArtifactRegistry`` load (or build and store) its preprocessed operand
from a cache directory inside the checkout, and binds the full-graph
step ``registry.forward_step(adj, cfg, plan=..., precision=...)``.  The
weights (He-normal, zero biases) and the feature sets (standard normal,
the configuration's share of entries zeroed) are drawn on the device
from ``--seed``.  Inference ``i`` runs the step on feature set
``i % feature_sets``, so no call can reuse the previous one's result.

The check holds the last logits the window produced for each feature
set against ``gpubench/reference/gcn.py`` run on the same CSR, features
and weights once the program's state is freed.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import torch

from gpubench import graphgen
from gpubench.reference import gcn as reference


class System:
    """One cell's system under test: set up in the constructor."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, cache_dir: str, log) -> None:
        self.config, self.traffic, self.device = config, traffic, device
        graph = config["graph"]
        t0 = time.perf_counter()
        self.csr, cached = graphgen.load_or_make(graph, cache_dir)
        self.setup = {"csr_s": time.perf_counter() - t0, "csr_cached": cached}
        n = graph["nodes"]
        self.n_nodes, self.nnz = n, int(self.csr[1].size)
        self.dims = [(a, b) for a, b in zip(config["widths"][:-1],
                                            config["widths"][1:])]

        from repro_torch.core.sparse_formats import CSRMatrix
        from repro_torch.exec.plan import SpmmPlan
        from repro_torch.models.gcn import GCNConfig
        from repro_torch.serve.registry import ArtifactRegistry

        model = config["model"]
        plan = traffic["plan"]
        widths = config["widths"]
        adj = CSRMatrix(indptr=self.csr[0], indices=self.csr[1],
                        data=self.csr[2], shape=(n, n))
        cfg = GCNConfig(
            in_dim=widths[0], hidden_dim=widths[1], out_dim=widths[-1],
            n_layers=len(widths) - 1, tau=model["tau"],
            tile_rows=model["tile_rows"], edge_cut=model["edge_cut"],
            spmm_impl=plan["impl"], block_rows=model["block_rows"],
            block_k=model["block_k"], block_f=model["block_f"])
        self.registry = ArtifactRegistry(
            cache_dir=os.path.join(cache_dir, "registry"))
        t0 = time.perf_counter()
        self.registry.get_or_build(adj, cfg, persist=True)
        self.setup["graph_load_s"] = time.perf_counter() - t0
        stats = self.registry.stats
        self.setup.update(builds=stats.builds, disk_hits=stats.disk_hits)
        log(f"registry: builds {stats.builds} disk_hits {stats.disk_hits} "
            f"graph_load_s {self.setup['graph_load_s']:.3f} csr_s "
            f"{self.setup['csr_s']:.3f} csr_cached {cached}")
        self.step = self.registry.forward_step(
            adj, cfg,
            plan=SpmmPlan(impl=plan["impl"], block_rows=model["block_rows"],
                          block_k=model["block_k"], block_f=model["block_f"],
                          fused=plan["fused"]),
            precision=traffic["precision"], device=device)
        self.kept: Dict[int, torch.Tensor] = {}
        self._ref_csr = None
        self.draw(seed)

    # -- inputs ---------------------------------------------------------

    def draw(self, seed: int) -> None:
        """Weights, then each feature set, from one generator on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = {}
        for i, (f_in, f_out) in enumerate(self.dims):
            w = torch.randn(f_in, f_out, generator=gen, device=self.device)
            self.params[f"layer_{i}"] = {
                "w": w.mul_(math.sqrt(2.0 / f_in)),
                "b": torch.zeros(f_out, device=self.device)}
        sparsity = self.config["feature_sparsity"]
        self.features: List[torch.Tensor] = []
        for _ in range(self.traffic["feature_sets"]):
            x = torch.randn(self.n_nodes, self.dims[0][0], generator=gen,
                            device=self.device)
            drop = torch.rand(x.shape, generator=gen, device=self.device)
            self.features.append(x.masked_fill_(drop < sparsity, 0.0))
            del drop
        self.kept = {}

    # -- the timed path -------------------------------------------------

    def call(self, i: int) -> torch.Tensor:
        return self.step(self.params, self.features[i % len(self.features)])

    def keep(self, i: int, out: torch.Tensor) -> None:
        self.kept[i % len(self.features)] = out

    def warm(self) -> None:
        for i in range(self.traffic["warm_rounds"] * len(self.features)):
            self.keep(i, self.call(i))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the check ------------------------------------------------------

    def release(self) -> None:
        """Drop the program's state: its step, operand and registry."""
        self.step = self.registry = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, s: int, tf32: bool = False) -> torch.Tensor:
        if self._ref_csr is None:
            self._ref_csr = (
                torch.as_tensor(self.csr[0], device=self.device),
                torch.as_tensor(self.csr[1], device=self.device).long(),
                torch.as_tensor(self.csr[2], device=self.device))
        csr = self._ref_csr
        layers = [(self.params[f"layer_{i}"]["w"], self.params[f"layer_{i}"]["b"])
                  for i in range(len(self.dims))]
        return reference.gcn_logits(csr, self.features[s], layers, tf32=tf32)

    def check(self) -> Dict[str, float]:
        """The compared number of the kept logits: ``logit_err``, the
        largest ``|program - reference|`` over the largest ``|reference|``,
        of the worst feature set; infinite for a missing or misshapen
        output or an entry that is not finite."""
        err = 0.0
        self.checked = len(self.features)
        for s in range(len(self.features)):
            got = self.kept.get(s)
            want = self.reference_logits(s)
            if (got is None or tuple(got.shape) != tuple(want.shape)
                    or got.dtype != torch.float32):
                err = math.inf
                continue
            gap = (got - want).abs().nan_to_num(nan=math.inf).max()
            err = max(err, float(gap) / float(want.abs().max()))
        return {"logit_err": err}

    def control(self) -> Dict[str, float]:
        """The check's numbers for the reference computed in TF32 in the
        program's place (the control that has to fail)."""
        err = 0.0
        for s in range(len(self.features)):
            want = self.reference_logits(s)
            got = self.reference_logits(s, tf32=True)
            err = max(err, float((got - want).abs().max())
                      / float(want.abs().max()))
        return {"logit_err": err}

    def counts(self) -> dict:
        """What the metric readers count the work from."""
        return {"nodes": self.n_nodes, "nnz": self.nnz, "dims": self.dims,
                "precision": self.traffic["precision"]}
