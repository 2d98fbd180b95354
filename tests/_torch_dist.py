"""Spawn gloo ranks on the CPU for the port's sharded tests (torch only).

:func:`run_ranks` starts ``world`` processes (the ``spawn`` start method),
each joining one gloo process group through a ``FileStore`` in a fresh
directory (no port to collide with other test workers), runs
``module.function(rank, world, *args)`` and pickles what it returns.  The
parent polls: a rank that exits non-zero fails the run at once, its peers
are terminated (a peer blocked in a collective would wait forever), and
the whole spawn has a time limit of its own.  Each rank's traceback comes
back in the failure message.

:func:`port_rank` is the rank function of ``tests/test_torch_sharded.py``:
it runs every case of ``_sharded_cases.port_cases(world)`` on the port
and returns each case's assembled global output (rank 0), this rank's
ledger and its collective calls.
"""

import datetime
import importlib
import os
import pickle
import tempfile
import time
import traceback

import numpy as np

#: Seconds a spawn may take in all, its ranks' torch import included.
SPAWN_SECONDS = 300


def _entry(module, function, rank, world, directory, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(directory, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=SPAWN_SECONDS))
        out = getattr(importlib.import_module(module), function)(
            rank, world, *args)
        with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        if dist.is_initialized():     # the function may have torn it down
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)


def run_ranks(module: str, function: str, world: int, args=(),
              timeout: float = SPAWN_SECONDS):
    """Every rank's return value of ``module.function(rank, world,
    *args)``, run in ``world`` spawned gloo ranks; raises
    ``AssertionError`` with the ranks' errors if one fails or the spawn
    outlives ``timeout`` seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_ranks_") as directory:
        procs = [ctx.Process(target=_entry,
                             args=(module, function, r, world, directory,
                                   args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        while True:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(5)
            if p.exitcode is None:
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(directory, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out:
            errors.insert(0, f"the spawn outlived its {timeout:.0f} s limit")
        if errors:
            raise AssertionError("\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


# -- the sharded cases, on the port -------------------------------------------


def failing_rank(rank, world, hang: bool):
    """Rank 1 fails (or, with ``hang``, sleeps past any limit) while
    rank 0 waits in a collective for it: what the launcher must survive."""
    import torch
    import torch.distributed as dist

    if rank == 1:
        if hang:
            time.sleep(3600)
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(4))
    return rank


def _meshes(world):
    import _sharded_cases as C
    from repro_torch.launch.mesh import make_data_mesh

    return {name: make_data_mesh(d, feature=f, device="cpu")
            for name, (d, f) in C.MESHES.items() if d * f == world}


def _row_slice(a, plan):
    """This rank's slice of the rows of ``a``, padded to the mesh."""
    import torch

    n = plan.n_shards
    per = -(-a.shape[0] // n)
    d = plan.mesh.get_local_rank(plan.data_axis)
    pad = per * n - a.shape[0]
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    return a[d * per:(d + 1) * per]


def port_rank(rank, world, params):
    """Every ``port_cases(world)`` case on this rank: ``{case: {"out":
    global output (rank 0 only, else None), "ledger": this rank's
    snapshot, "calls": its collective calls}}``."""
    import dataclasses

    import torch

    import _sharded_cases as C
    from repro_torch.core.preprocessing import preprocess
    from repro_torch.core.sparse_formats import random_power_law_csr
    from repro_torch.dist import collectives as coll
    from repro_torch.exec import SpmmOperands, SpmmPlan, execute, execute_layer
    from repro_torch.exec.pipeline import static_pipeline
    from repro_torch.models import gcn
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.plan.cost import TPU_V5E

    meshes = _meshes(world)
    s, g = C.SPMM, C.GCN
    res = preprocess(random_power_law_csr(s["n"], s["n"], s["nnz"], seed=0),
                     tau=s["tau"], tile_rows=s["tile_rows"], edge_cut="rcm",
                     pad_rows_to=s["block"])
    ops = SpmmOperands.from_ell(res.ell, "cpu")
    dense, x, w, b = (torch.as_tensor(a) for a in C.spmm_inputs())
    layer = {"w": w, "b": b}
    cfg = gcn.GCNConfig(in_dim=g["in_dim"], hidden_dim=g["hidden_dim"],
                        out_dim=g["out_dim"], tau=g["tau"],
                        block_rows=g["block"], block_k=g["block"],
                        block_f=g["block"])
    graph = gcn.GCNGraph.build(
        random_power_law_csr(g["n"], g["n"], g["nnz"], alpha=g["alpha"],
                             seed=0), cfg)
    tparams = params_from_numpy(params, "cpu")
    feats = C.gcn_features()
    blocks = dict(block_rows=s["block"], block_k=s["block"],
                  block_f=s["block"])
    out = {}
    for case in C.port_cases(world):
        coll.LEDGER.reset()
        coll.reset_collective_calls()
        kind, mesh = case[0], meshes[case[1]]
        if kind in ("spmm", "fused"):
            _, _, impl, prec, out_l, dense_l = case
            plan = SpmmPlan(
                impl=impl, mesh=mesh, precision=prec, out_layout=out_l,
                dense_layout=dense_l,
                feature_axis="feature" if C.MESHES[case[1]][1] > 1 else None,
                fused=kind == "fused", **blocks)
            operand = dense if kind == "spmm" else x
            if dense_l == "row_sharded":
                operand = _row_slice(operand, plan)
            y = (execute(plan, ops, operand) if kind == "spmm"
                 else execute_layer(plan, ops, operand, layer))
            calls = dict(coll.COLLECTIVE_CALLS)
            glob = coll.assemble(y, plan, n_cols=dense.shape[1])
        elif kind == "gcn":
            _, _, impl, fused, prec, chain = case
            if chain == "pipelined":
                plan = static_pipeline(cfg, mesh, impl=impl, precision=prec,
                                       fused=fused)
            else:
                rows = "row_sharded" if chain == "row_all" else "replicated"
                plan = SpmmPlan(
                    impl=impl, mesh=mesh, precision=prec, fused=fused,
                    block_rows=g["block"], block_k=g["block"],
                    block_f=g["block"], dense_layout=rows, out_layout=rows,
                    feature_axis="feature" if chain == "feature" else None)
            out_l = "row_sharded" if chain == "row_out" else "replicated"
            y = gcn.gcn_forward(tparams, graph, feats, cfg, plan=plan,
                                out_layout=out_l, precision=prec,
                                device="cpu")
            calls = dict(coll.COLLECTIVE_CALLS)
            glob = coll.assemble(y, plan if chain == "pipelined" else
                                 dataclasses.replace(plan, out_layout=out_l),
                                 n_cols=g["out_dim"])
        else:  # auto
            prec = case[2]
            from repro_torch.exec.pipeline import plan_pipeline

            pp = plan_pipeline(cfg, graph.pre.ell, mesh=mesh,
                               n_layers=len(tparams), precision=prec,
                               device=TPU_V5E)
            out[("plan",) + case[1:]] = [
                (lp.spmm.impl, lp.spmm.block_rows, lp.spmm.block_k,
                 lp.spmm.block_f, lp.spmm.fused, lp.in_layout,
                 lp.out_layout) for lp in pp.layers]
            y = gcn.gcn_forward(tparams, graph, feats, cfg, plan="auto",
                                mesh=mesh, precision=prec, device="cpu",
                                device_model=TPU_V5E)
            calls = dict(coll.COLLECTIVE_CALLS)
            glob = y
        out[case] = {
            "out": glob.float().numpy() if rank == 0 else None,
            "shard_shape": tuple(y.shape),
            "ledger": coll.LEDGER.snapshot(),
            "calls": calls,
        }
    return out


def sharded_launches(rank, world, wrapper_launches, device="cpu"):
    """The torch ops one sharded ``execute_layer`` runs on this rank (each
    kernel wrapper taken as its CUDA branch's launches, each collective
    as one launch, as NCCL runs it) beside the H100 model's launches, per
    (impl, precision, fused, dense layout, out layout) at 2 ranks:
    ``{case: (counted, modeled)}``.  ``device="cuda"`` puts the ranks on
    the cards (``rank % device_count``), where the wrappers launch their
    kernels."""
    import torch

    from _torch_ops import CountOps
    from repro_torch.dist import collectives as coll
    from repro_torch.exec import SpmmPlan, execute_layer, quant
    from repro_torch.exec import sharded as tsharded
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.models.gcn import GCNConfig, GCNGraph, init_params
    from repro_torch.plan import cost as tcost

    counter = CountOps()

    def as_one_launch(name, fn, n):
        def run(*args, **kw):
            counter.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                counter.paused -= 1
                counter.names += [name] * n
        return run

    for name, fn in list(fv.KERNELS.items()):
        fv.KERNELS[name] = as_one_launch(
            name, fn, wrapper_launches[name.removesuffix("_scaled")])
    for name in ("all_reduce", "reduce_scatter_rows", "all_gather_rows"):
        wrapped = as_one_launch(name, getattr(coll, name), 1)
        setattr(coll, name, wrapped)
        if hasattr(tsharded, name):
            setattr(tsharded, name, wrapped)

    from repro_torch.launch.mesh import make_data_mesh, mesh_device

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        mesh = make_data_mesh(world)
    else:
        mesh = make_data_mesh(world, device=device)
    dev = mesh_device(mesh)
    nodes, f_in, f_out = 250, 20, 16
    spec = DatasetSpec("toy", nodes=nodes, edges=5 * nodes,
                       feature_dim=f_in, classes=f_out)
    cfg = GCNConfig(in_dim=f_in, hidden_dim=f_out, out_dim=f_out, tau=6,
                    spmm_impl="cuda", block_rows=16, block_k=16, block_f=16)
    graph = GCNGraph.build(gcn_normalize(synthesize_adjacency(spec, seed=1)),
                           cfg)
    operands, perm, _ = graph.on_device(dev)
    x = torch.randn(nodes, f_in,
                    generator=torch.Generator().manual_seed(0)).to(dev)[perm]
    layer = init_params(cfg, device=dev)["layer_0"]
    stats = tcost.graph_stats_from_ell(graph.pre.ell)
    out = {}
    for impl in ("reference", "cuda", "cuda_sparse"):
        for precision in ("f32", "bf16", "int8"):
            for fused in (False, True):
                for dense_l in ("replicated", "row_sharded"):
                    for out_l in ("replicated", "row_sharded"):
                        plan = SpmmPlan(impl=impl, block_rows=16, block_k=16,
                                        block_f=16, precision=precision,
                                        fused=fused, mesh=mesh,
                                        dense_layout=dense_l,
                                        out_layout=out_l)
                        xin = _row_slice(x, plan) if dense_l != "replicated" \
                            else x
                        p = quant.quantize_params({"l": layer}, precision,
                                                  16)["l"]
                        execute_layer(plan, operands, xin, p, w_block_rows=16)
                        counter.names = []
                        with counter:
                            execute_layer(plan, operands, xin, p,
                                          w_block_rows=16)
                        kw = dict(impl=impl, block_rows=16, block_k=16,
                                  precision=precision, n_shards=2)
                        k = (-(-nodes // 2) * 2 if dense_l == "row_sharded"
                             else nodes)
                        n_coll = 1 + (dense_l == "row_sharded")
                        if fused and impl != "reference":
                            want = tcost.cuda_fused_work(
                                stats, f_in, f_out, block_f=16, dense_rows=k,
                                **kw)["launches"]
                        else:
                            want = (tcost.cuda_spmm_work(
                                        stats, f_out, dense_rows=k,
                                        **kw)["launches"]
                                    + tcost.cuda_combination_work(
                                        xin.shape[0], f_in, f_out,
                                        precision)["launches"])
                        out[(impl, precision, fused, dense_l, out_l)] = (
                            list(counter.names), want + n_coll)
    return out
