"""Dry run of the LM under a production mesh: one (arch x shape x mesh)
cell's step on fake ranks, with its per-device FLOPs, bytes, collectives
and memory.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell on 512 placeholder XLA devices; the port runs it in one
process over a ``fake`` process group of ``chips`` ranks (no devices,
no traffic: every collective returns at once) and
``launch.mesh.make_production_mesh``.  The step of the cell
(``launch.steps``) runs once under a ``FakeTensorMode`` on the empty
DTensors ``launch.shapes.materialize`` makes from ``input_specs``:
every op has a shape and a dtype and no storage, so the 256- or
512-rank production cells run on a laptop.  What the one rank the
process plays does is what every rank does (SPMD).

* **FLOPs and bytes** per device: ``roofline.analysis.CollectiveCounter``
  counts the local ops the rank runs below DTensor (each on its shard;
  ``torch.utils.flop_counter``'s formulas), not the global ops above it,
  and the bytes each non-view local op reads and writes.
* **Collective bytes** per device: the same counter, over the
  ``_c10d_functional`` collectives DTensor issues.
* **Memory**: ``memory_per_device.peak_bytes_est`` is the peak of the
  fake tensors alive at once on the rank (``torch.distributed._tools.
  mem_tracker.MemTracker``), the inputs included.
* **No scan correction.** The port's loops run every period and every
  time step as ops of their own, so the reference's correction of XLA's
  once-counted loop bodies does not apply: ``ssm_time_scan_fix_per_device``
  is recorded as 0 and ``flops_per_device_raw`` is what the run counted.
* **Depth.** Running every period of a 36-layer train step takes
  minutes (DTensor plans each op in Python).  With ``body_correction``
  (the default) the step runs at 1 and 2 body periods instead, and every
  count is extrapolated linearly to the real depth from their
  difference (``body_per_period``), as the reference's body correction
  extrapolates its compiles; the counts of a period do not depend on its
  place in the stack, so the extrapolation is exact for FLOPs, bytes and
  collectives (``tests/test_torch_roofline.py`` holds it against a
  full-depth run) and an estimate for the peak.  ``--no-body-correction``
  runs the real depth once.

Record keys are the reference's.  ``lower_s`` is the seconds to build
the inputs, ``compile_s`` the step's run, ``hlo_lines`` the number of
local ops it dispatched (the port has no HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

RESULT_DIR = os.environ.get("REPRO_DRYRUN_DIR", "results/dryrun")

# The reference's bound on a planned mesh (its 512 placeholder devices).
MAX_VIRTUAL_CHIPS = 512
POD_FACTOR = 2  # multi-pod runs replicate the planned pod over this many pods
WARM_RUNS = 2   # uncounted runs of a step before the counted one


def planned_mesh_shape(chips: int, model_parallel: int,
                       multi_pod: bool) -> tuple:
    """Mesh shape for one dry-run cell: the widest model axis of
    ``dist.topology.viable_mesh_shapes`` that divides the chip count, so
    awkward slices degrade instead of failing."""
    from repro_torch.dist.topology import viable_mesh_shapes

    total = chips * (POD_FACTOR if multi_pod else 1)
    if total > MAX_VIRTUAL_CHIPS:
        raise ValueError(
            f"{total} chips exceed the {MAX_VIRTUAL_CHIPS} virtual devices "
            f"a dry-run mesh may use")
    data, model = viable_mesh_shapes(chips, model_parallel)[0]
    return (POD_FACTOR, data, model) if multi_pod else (data, model)


def mesh_label(shape: tuple) -> str:
    return "x".join(str(s) for s in shape)


@contextlib.contextmanager
def fake_world(ranks: int):
    """A ``fake`` default process group of ``ranks`` ranks (this process
    is rank 0) for the duration; torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process of its own: a "
                           "default process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_offsets_on_host():
    """DTensor computes the offsets of a strided shard (a sharded dim
    split by a reshape, as einsum's batching does) with a tensor it reads
    back; under a ``FakeTensorMode`` that tensor would be fake and
    unreadable.  This runs that arithmetic on real (tiny) host tensors
    for the duration."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def on_host(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _call(step, kind: str, args: Dict):
    if kind == "train":
        extra = (args["memory"],) if "memory" in args else ()
        return step(args["params"], args["opt_state"], args["tokens"],
                    *extra)
    if kind == "prefill":
        extra = (args["memory"],) if "memory" in args else ()
        return step(args["params"], args["tokens"], *extra)
    return step(args["params"], args["cache"], args["tokens"], args["pos"])


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import leaves

    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _run_step(cfg, shape, mesh, plan, donate: bool = True) -> Dict:
    """One step of (cfg, shape) on fake DTensors: its counts.  Under
    ``donate`` the bytes the step updates in place count as aliased, as
    the reference's donated buffers do."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import steps
    from repro_torch.launch.shapes import input_specs, materialize
    from repro_torch.roofline.analysis import (CollectiveCounter,
                                               collective_bytes)

    t0 = time.time()
    specs = input_specs(cfg, shape, mesh, plan)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _strided_offsets_on_host():
        args = materialize(specs, mesh)
        if shape.kind == "train":
            # the loss has no value to check on the host
            step = steps.build_train_step(cfg, mesh=mesh, guard_finite=False)
        else:
            step = steps.step_for(cfg, shape.kind, mesh=mesh)
        arg_bytes = _local_bytes(args)
        t1 = time.time()
        # DTensor plans an op by running it at its global shape, which
        # the counters would take for the rank's own work; its caches hold
        # every plan only from the third run of a step on
        for _ in range(WARM_RUNS):
            _call(step, shape.kind, args)
        t2 = time.time()
        tracker = MemTracker()
        tracker.track_external(args)
        counter = CollectiveCounter()
        with tracker, counter:
            out = _call(step, shape.kind, args)
        peak = sum(v["Total"] for v in
                   tracker.get_tracker_snapshot("peak").values())
        # the train step updates params and moments in place
        alias = (_local_bytes((args["params"], args["opt_state"]))
                 if shape.kind == "train" and donate else 0)
        out_bytes = _local_bytes(out)
    return {
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "run_s": round(time.time() - t2, 2),
        "flops": float(counter.flops),
        "bytes": float(counter.bytes_accessed),
        "coll": collective_bytes(counter),
        "hlo_lines": counter.ops,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "alias_bytes": alias, "peak_bytes_est": int(peak)},
    }


def _reduced_depth(cfg, periods: int):
    """Same config with ``periods`` repetitions of its pattern (and as
    many encoder layers for enc-dec archs)."""
    first = cfg.moe.first_dense if cfg.moe else 0
    enc = periods if cfg.encoder_layers else 0
    return dataclasses.replace(cfg, n_layers=first + periods * len(cfg.pattern),
                               encoder_layers=enc)


def _extrapolate(r1: Dict, r2: Dict, periods: int) -> Dict:
    """The counts of ``periods`` body periods from runs at 1 and 2."""
    def lin(a: float, b: float) -> float:
        return a + (periods - 1) * (b - a)

    coll = {k: lin(r1["coll"][k], r2["coll"][k])
            for k in r1["coll"] if k != "op_counts"}
    coll["op_counts"] = {k: int(lin(r1["coll"]["op_counts"][k],
                                    r2["coll"]["op_counts"][k]))
                         for k in r1["coll"]["op_counts"]}
    mem = {k: int(lin(r1["memory"][k], r2["memory"][k]))
           for k in r1["memory"]}
    return {"flops": lin(r1["flops"], r2["flops"]),
            "bytes": lin(r1["bytes"], r2["bytes"]), "coll": coll,
            "hlo_lines": int(lin(r1["hlo_lines"], r2["hlo_lines"])),
            "memory": mem}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: Optional[bool] = None, donate: bool = True,
             body_correction: bool = True, chips: int = 256,
             model_parallel: int = 16, device: str = "cuda") -> Dict:
    """The record of one cell.  ``device`` is the type of the fake
    tensors (``"cuda"`` plans the card's collectives, ``"cpu"`` gloo's,
    which has no all-to-all).

    ``donate`` is the reference's buffer donation.  PyTorch has no buffer
    donation: the train step updates its params and moments in place
    either way, so ``donate`` changes nothing that runs.  The record
    carries it as the reference's does, in ``memory_per_device``'s
    ``alias_bytes``: the bytes the step updates in place under ``donate``,
    0 without it (the reference's decode donates its cache, which the
    port's decode step copies, so it aliases nothing)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, skip_reason
    from repro_torch.models.lm import n_body_periods
    from repro_torch.roofline.analysis import active_param_count, model_flops

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_shape = planned_mesh_shape(chips, model_parallel, multi_pod)
    data_w, model_w = mesh_shape[-2], mesh_shape[-1]
    record: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_label(mesh_shape),
        "chips": int(math.prod(mesh_shape)),
        "kind": shape.kind,
        "params_total": cfg.param_count(),
        "params_active": active_param_count(cfg),
        "device": device,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        record["skipped"] = reason
        return record
    # FSDP for multi-B models; tiny models stay pure TP+DP.
    if fsdp is None:
        fsdp = cfg.param_count() > 4e9
    record["fsdp"] = fsdp
    t_periods = n_body_periods(cfg)

    with fake_world(record["chips"]):
        mesh = make_production_mesh(multi_pod=multi_pod, data=data_w,
                                    model=model_w, pods=POD_FACTOR,
                                    device=device)
        plan = ShardingPlan(mesh, fsdp=fsdp)
        if body_correction and t_periods > 2:
            r1 = _run_step(_reduced_depth(cfg, 1), shape, mesh, plan, donate)
            r2 = _run_step(_reduced_depth(cfg, 2), shape, mesh, plan, donate)
            main = _extrapolate(r1, r2, t_periods)
            main.update(lower_s=r1["lower_s"] + r2["lower_s"],
                        compile_s=r1["compile_s"] + r2["compile_s"])
            record["periods_run"] = [1, 2]
            record["body_per_period"] = {
                "flops": r2["flops"] - r1["flops"],
                "bytes": r2["bytes"] - r1["bytes"],
                "coll": r2["coll"]["total"] - r1["coll"]["total"],
            }
        else:
            main = _run_step(cfg, shape, mesh, plan, donate)
            record["periods_run"] = [t_periods]
    record.update(lower_s=round(main["lower_s"], 2),
                  compile_s=round(main["compile_s"], 2),
                  hlo_lines=main["hlo_lines"])
    mem = main["memory"]
    record["memory_per_device"] = {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
        "temp_bytes": max(mem["peak_bytes_est"] - mem["argument_bytes"], 0),
        "alias_bytes": mem["alias_bytes"],
        "peak_bytes_est": mem["peak_bytes_est"],
    }
    record["collectives"] = dict(main["coll"])
    record["cost_analysis"] = {
        "flops_per_device_raw": main["flops"],
        "flops_per_device": main["flops"],
        "bytes_per_device": main["bytes"],
        "collective_bytes_per_device": main["coll"]["total"],
        "ssm_time_scan_fix_per_device": 0.0,
        "scan_periods": t_periods,
    }
    record["model_flops"] = model_flops(cfg, shape)
    return record


def roofline_of(record: Dict, device=None) -> Dict:
    """The roofline terms of a record (``roofline.analysis``; the H100
    unless ``device`` is given) as a dict."""
    from repro_torch.roofline.analysis import roofline_terms

    ca = record["cost_analysis"]
    terms = roofline_terms(ca["flops_per_device"], ca["bytes_per_device"],
                           ca["collective_bytes_per_device"],
                           record["chips"], record["model_flops"],
                           device=device)
    return dict(dataclasses.asdict(terms), bound_s=terms.bound())


def cell_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(RESULT_DIR, f"{arch}__{shape}__{mesh}.json")


def drive_all(mesh_mode: str, archs, shapes, timeout: int,
              workers: int = 2, chips: int = 256,
              model_parallel: int = 16, device: str = "cuda") -> None:
    """Every cell in a subprocess of its own (a fake group per process),
    ``workers`` at a time; cells with a record on disk are skipped."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import list_archs
    from repro_torch.launch.shapes import SHAPES

    archs = archs or list_archs()
    shapes = shapes or list(SHAPES.keys())
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[mesh_mode]
    os.makedirs(RESULT_DIR, exist_ok=True)
    todo = [(a, s, mp) for mp in meshes for a in archs for s in shapes]
    counts = {"ok": 0, "failed": 0}

    def one(cell):
        arch, shp, mp = cell
        mesh_name = mesh_label(planned_mesh_shape(chips, model_parallel, mp))
        out = cell_path(arch, shp, mesh_name)
        if os.path.exists(out):
            counts["ok"] += 1
            return
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shp, "--out", out,
               "--chips", str(chips), "--model-parallel",
               str(model_parallel), "--device", device]
        if mp:
            cmd += ["--multi-pod"]
        print(f"[dryrun] {arch} x {shp} x {mesh_name} ...", flush=True)
        try:
            r = subprocess.run(cmd, timeout=timeout, capture_output=True,
                               text=True)
            if r.returncode != 0:
                counts["failed"] += 1
                with open(out + ".err", "w") as f:
                    f.write(r.stderr or "")
                tail = (r.stderr or "").strip().splitlines()[-2:]
                print(f"[dryrun]   FAILED {arch}x{shp}x{mesh_name}: "
                      f"{' | '.join(tail)}", flush=True)
            else:
                counts["ok"] += 1
                print(f"[dryrun]   ok {arch}x{shp}x{mesh_name}", flush=True)
        except subprocess.TimeoutExpired:
            counts["failed"] += 1
            with open(out + ".err", "w") as f:
                f.write(f"timeout after {timeout}s")
            print(f"[dryrun]   TIMEOUT {arch}x{shp}x{mesh_name}", flush=True)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, todo))
    print(f"[dryrun] complete: {counts['ok']} ok, "
          f"{counts['failed']} failed of {len(todo)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--archs", help="comma list (with --all)")
    ap.add_argument("--shapes", help="comma list (with --all)")
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-body-correction", action="store_true",
                    help="run every body period instead of extrapolating "
                         "from 1 and 2 (exact, and minutes per cell)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--chips", type=int, default=256,
                    help="chips per pod; the (data, model) factorization "
                         "comes from dist.topology.viable_mesh_shapes")
    ap.add_argument("--model-parallel", type=int, default=16,
                    help="upper bound on the model axis width (degrades "
                         "downward until it divides --chips)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="type of the fake tensors (no tensor goes on a "
                         "card; the backward of CUDA fakes needs a CUDA "
                         "device context): "
                         "cuda plans the card's collectives, cpu gloo's")
    args = ap.parse_args(argv)

    if args.all:
        drive_all(args.mesh,
                  args.archs.split(",") if args.archs else None,
                  args.shapes.split(",") if args.shapes else None,
                  args.timeout, workers=args.workers, chips=args.chips,
                  model_parallel=args.model_parallel, device=args.device)
        return

    record = run_cell(args.arch, args.shape, args.multi_pod,
                      fsdp=False if args.no_fsdp else None,
                      body_correction=not args.no_body_correction,
                      chips=args.chips, model_parallel=args.model_parallel,
                      device=args.device)
    if "skipped" not in record:
        record["roofline_h100"] = roofline_of(record)
    text = json.dumps(record, indent=2, default=str)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
