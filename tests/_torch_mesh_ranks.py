"""Rank functions of the LM-under-a-mesh tests (torch only).

``lm_mesh_rank`` runs in each of ``tests/_torch_dist.run_ranks``' gloo
ranks on the CPU: the ranks lay themselves out as a ``(data, model)``
``make_production_mesh``, place each case's weights (the reference's,
carried across as numpy) by ``ShardingPlan``, and run the sharded
prefill, ``DECODE_STEPS`` cached decode steps, the gradient of the train
step and one train step.  It returns each output whole
(``full_tensor()``), as numpy, with the layouts it checked on the way.

``constrain_rank`` holds ``dist.policy.constrain`` / ``constrain_ranked``
under a live mesh: the placements each gives, and that a plain tensor is
sliced without traffic.
"""

import numpy as np

DECODE_STEPS = 3


def _whole(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def lm_mesh_rank(rank, world, shape, cases):
    """``cases``: {label: (serve weights, serve tokens, train weights, train
    tokens, fsdp)}, weights as numpy trees; a label is an arch, or an arch
    and a tag after ``@`` (``qwen3-8b@fsdp``).  Returns {label: {"prefill",
    "decode": [...], "loss", "grads": [(path, grad)], "train_loss",
    "grad_norm", the layout and update checks, "seconds"}}."""
    import time

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.dist.sharding import (ShardingPlan, distribute_cache,
                                           distribute_params)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import dp_axes, make_production_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.tree import flatten_with_paths, leaves

    mesh = make_production_mesh(data=shape[0], model=shape[1], device="cpu")
    out = {}
    for label, (serve_np, serve_tok, train_np, train_tok, fsdp) in \
            cases.items():
        t0 = time.perf_counter()
        cfg = reduced(get_config(label.split("@")[0]))
        plan = ShardingPlan(mesh, fsdp=fsdp)

        def placed(tree):
            return distribute_params(
                lm_params_from_numpy(tree, device="cpu"), plan)

        params = placed(serve_np)
        res = {"prefill": _whole(steps.build_prefill_step(cfg, mesh=mesh)(
            params, serve_tok))}
        cache = distribute_cache(
            lm.init_cache(cfg, serve_tok.shape[0], 8, device="cpu"), plan,
            dp_axes(mesh))
        layouts = [tuple(t.placements) for t in leaves(cache)]
        serve = steps.build_serve_step(cfg, mesh=mesh)
        res["decode"] = []
        for t in range(DECODE_STEPS):
            logits, cache = serve(params, cache, serve_tok[:, t:t + 1], t)
            res["decode"].append(_whole(logits))
        res["cache_layouts_kept"] = layouts == [
            tuple(t.placements) for t in leaves(cache)]
        t1 = time.perf_counter()

        params = placed(train_np)
        loss, grads = steps.build_grad_step(cfg, mesh=mesh)(params, train_tok)
        res["loss"] = float(_whole(loss))
        res["grads"] = [(k, _whole(g)) for k, g in flatten_with_paths(grads)]
        res["grad_layouts_kept"] = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(leaves(grads), leaves(params)))
        t2 = time.perf_counter()

        before = [t.to_local().clone() for t in leaves(params)]
        ids = [id(t) for t in leaves(params)]
        layouts = [tuple(t.placements) for t in leaves(params)]
        step = steps.build_train_step(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=1), mesh=mesh)
        new, opt, metrics = step(params, adamw_init(params), train_tok)
        res["train_loss"] = float(_whole(metrics["loss"]))
        res["grad_norm"] = float(_whole(metrics["grad_norm"]))
        res["in_place"] = [id(t) for t in leaves(new)] == ids
        res["layouts_kept"] = layouts == [tuple(t.placements)
                                          for t in leaves(new)] == [
            tuple(t.placements) for t in leaves(opt.mu)]
        res["moved"] = any(not torch.equal(a, b.to_local())
                           for a, b in zip(before, leaves(new)))
        res["seconds"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        out[label] = res
    return out


def constrain_rank(rank, world):
    """Placements ``constrain`` / ``constrain_ranked`` give on a (1, 2)
    mesh, the local shard of a plain tensor, a DTensor moved from one
    layout to another, and the identity outside a policy."""
    import torch

    from repro_torch.dist import policy
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(data=1, model=2, device="cpu")
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    out = {"outside": policy.constrain(x, [(None, "model")]) is x}
    with policy.sharding_policy(mesh):
        a = policy.constrain(x, [("pod", None), (None, "model"),
                                 ("model", None)])
        b = policy.constrain_ranked(x, [(None, None), ("model", None)])
        c = policy.constrain(a, [("model", None)])
        none = policy.constrain(x, [(None, "data2")])
    out.update(
        a=(str(a.placements), a.to_local().numpy(), a.full_tensor().numpy()),
        b=(str(b.placements), b.to_local().numpy()),
        c=(str(c.placements), c.to_local().numpy(), c.full_tensor().numpy()),
        unfit=none is x)
    return out



def moe_mesh_rank(rank, world, shape, cases, step_arch):
    """``cases``: {label: (MoEConfig, layer weights as numpy, input x
    (B, S, D) as numpy)}.  On a ``(data, model)`` mesh, laid out by
    ``ShardingPlan`` with the batch over ``data``: each case's
    ``moe_layer`` output (whole), the slots of this rank's token shard
    (``layers.token_shard_slots``) with its shard index, and the
    collectives of the layer's forward and backward (calls, bytes and the
    largest result's elements per kind, ``CollectiveCounter``).  Then one
    gradient step of the reduced ``step_arch`` under FSDP with a counter
    around each call of ``moe_layer`` (its forward and its recomputation
    in the backward): under "step", those collectives' largest result and
    the buffer's elements."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, reduced
    from repro_torch.dist.policy import sharding_policy
    from repro_torch.dist.sharding import (ShardingPlan, distribute,
                                           distribute_params)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import layers, lm
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.roofline.analysis import CollectiveCounter
    from repro_torch.train.tree import leaves

    mesh = make_production_mesh(data=shape[0], model=shape[1], device="cpu")
    shard = mesh.get_coordinate()[0]
    out = {}
    for label, (moe, weights, x_np) in cases.items():
        p = distribute_params({"ffn": lm_params_from_numpy(
            weights, device="cpu")}, ShardingPlan(mesh))["ffn"]
        x = distribute(torch.as_tensor(x_np).bfloat16(), mesh,
                       ("data", None, None))
        for t in leaves(p):
            t.requires_grad_(True)
        counter = CollectiveCounter()
        with sharding_policy(mesh), implicit_replication():
            with counter:
                y = layers.moe_layer(p, x, moe)
                y.float().sum().backward()
            local = x.to_local().reshape(-1, x.shape[-1])
            _, eids = layers._route(local, p["router"].full_tensor(),
                                    moe.top_k)
            slots = layers.token_shard_slots(
                eids.reshape(-1), moe.n_experts, mesh, [0], shard)
        out[label] = {
            "out": _whole(y), "slots": slots.numpy(), "shard": shard,
            "capacity": layers.moe_capacity(x.shape[0] * x.shape[1], moe),
            "calls": dict(counter.calls), "bytes": dict(counter.bytes),
            "largest": dict(counter.largest),
            "grads": [_whole(t.grad) for t in leaves(p)]}

    cfg = reduced(get_config(step_arch))
    counter = CollectiveCounter()
    inner = layers.moe_layer

    def counted(p, x, moe):
        with counter:
            return inner(p, x, moe)

    params = distribute_params(
        lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu"),
        ShardingPlan(mesh, fsdp=True))
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    layers.moe_layer = counted
    try:
        steps.build_grad_step(cfg, mesh=mesh)(params, tokens)
    finally:
        layers.moe_layer = inner
    n = tokens.numel()
    out["step"] = {"calls": dict(counter.calls),
                   "largest": dict(counter.largest),
                   "buffer": cfg.moe.n_experts * cfg.d_model
                   * layers.moe_capacity(n, cfg.moe)}
    return out
