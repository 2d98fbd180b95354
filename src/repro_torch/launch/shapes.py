"""Input-shape sets for the assigned architectures (40 cells).

The port of ``repro.launch.shapes``.  Every shape resolves to records of
(shape, dtype, spec) per leaf, as the reference's sharded
``ShapeDtypeStruct`` stand-ins carry, for the step function the shape
exercises:

  train_4k     (seq 4096,   gbs 256) -> train_step   (fwd+bwd+AdamW)
  prefill_32k  (seq 32768,  gbs 32)  -> prefill_step (full-seq forward)
  decode_32k   (seq 32768,  gbs 128) -> serve_step   (1 token + KV cache)
  long_500k    (seq 524288, gbs 1)   -> serve_step, sub-quadratic archs only

:func:`input_specs` allocates nothing: the trees come from ``init_lm``,
``init_cache`` and ``adamw_init`` run under a ``FakeTensorMode`` (tensors
with a shape, a dtype and no storage), the specs from ``ShardingPlan`` and
``batch_spec`` over any mesh form (an abstract mesh plans as well as a
``DeviceMesh``).  :func:`materialize` turns the records into DTensors on
a ``DeviceMesh`` (each rank's shard, empty): under a ``FakeTensorMode``
and a fake process group they are the dry run's inputs
(``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (ShardingPlan, batch_spec, leaf_paths,
                                       map_with_paths)
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWState, adamw_init


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


class TensorSpec(NamedTuple):
    """One input leaf: its global shape, dtype and partition spec (a
    tuple of entries, ``()`` replicated; ``dist.sharding``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """Cells that are architecturally undefined (recorded, not silently
    dropped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return (f"{cfg.name} is pure full-attention: a 512k-token KV cache "
                "is unbounded (no SWA window / recurrent state); skipped "
                "per assignment")
    return None


def opt_dtype_for(cfg: ArchConfig) -> torch.dtype:
    """bf16 optimizer state for >=100B params (memory)."""
    return torch.bfloat16 if cfg.param_count() >= 100e9 else torch.float32


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _specs(tree, spec_of) -> Any:
    return map_with_paths(
        lambda path, t: TensorSpec(tuple(t.shape), t.dtype,
                                   spec_of(path, t)), tree)


def input_specs(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    plan: Optional[ShardingPlan] = None,
) -> Dict[str, Any]:
    """TensorSpec trees for the step of this cell: ``params``, ``tokens``
    and by kind ``opt_state`` (an ``AdamWState``), ``cache`` and
    ``pos``, and ``memory`` for frontend archs."""
    plan = plan or ShardingPlan(mesh)
    dp = dp_axes(mesh)
    bspec = batch_spec(mesh, shape.global_batch)
    b, s = shape.global_batch, shape.seq_len

    with _fake_mode():
        params = lm.init_lm(cfg, torch.Generator(), device="cpu")
        opt = (adamw_init(params, dtype=opt_dtype_for(cfg))
               if shape.kind == "train" else None)
        cache = (lm.init_cache(cfg, b, s, device="cpu")
                 if shape.kind == "decode" else None)

    def param_spec(path, t):
        return plan.param_spec(path, tuple(t.shape), t.dtype)

    out: Dict[str, Any] = {"params": _specs(params, param_spec)}
    if shape.kind == "train":
        out["tokens"] = TensorSpec((b, s), torch.int32, bspec)
        out["opt_state"] = _opt_specs(opt, params, plan)
    elif shape.kind == "prefill":
        out["tokens"] = TensorSpec((b, s), torch.int32, bspec)
    else:  # decode
        out["cache"] = _specs(cache, lambda path, t: plan.cache_spec(
            path, tuple(t.shape), dp, t.dtype))
        out["tokens"] = TensorSpec((b, 1), torch.int32, bspec)
        out["pos"] = TensorSpec((), torch.int32, ())
    if cfg.frontend_tokens and shape.kind in ("train", "prefill"):
        out["memory"] = TensorSpec((b, cfg.frontend_tokens, cfg.d_model),
                                   torch.bfloat16, bspec)
    return out


def _opt_specs(opt: AdamWState, params, plan: ShardingPlan) -> AdamWState:
    """Optimizer state mirrors the parameter specs (mu/nu, in the
    moments' dtype), the scalar step replicated."""
    spec = {path: plan.param_spec(path, tuple(t.shape), t.dtype)
            for path, t in leaf_paths(params)}

    def moments(tree):
        return _specs(tree, lambda path, t: spec[path])

    return AdamWState(
        step=TensorSpec(tuple(opt.step.shape), opt.step.dtype, ()),
        mu=moments(opt.mu), nu=moments(opt.nu))


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def spec_leaves(tree) -> list:
    """(path, TensorSpec) of every record of an :func:`input_specs` tree."""
    out = []

    def walk(t, path):
        if _is_spec(t):
            out.append(("/".join(path), t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            names = getattr(t, "_fields", None)
            for i, v in enumerate(t):
                walk(v, path + (names[i] if names else f"[{i}]",))

    walk(tree, ())
    return out


def materialize(specs, mesh):
    """Every record of ``specs`` as an empty DTensor on ``mesh`` laid out
    by its spec: each rank holds only its own shard (run under a
    ``FakeTensorMode`` for the dry run, where no shard has storage).  A
    0-d record (``pos``) stays a plain tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import placements
    from repro_torch.launch.mesh import mesh_device

    dev = mesh_device(mesh)

    def one(rec: TensorSpec):
        if not rec.shape:
            return torch.zeros((), dtype=rec.dtype, device=dev)
        place = placements(mesh, rec.spec)
        local = list(rec.shape)
        for i, pl in enumerate(place):
            if pl.is_shard():      # every planned spec divides its dim
                local[pl.dim] //= mesh.size(i)
        t = torch.empty(tuple(local), dtype=rec.dtype, device=dev)
        return DTensor.from_local(t, mesh, place, run_check=False,
                                  shape=torch.Size(rec.shape),
                                  stride=_contiguous_stride(rec.shape))

    def walk(t):
        if _is_spec(t):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(specs)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
