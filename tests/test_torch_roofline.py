"""The port's shapes, roofline and dry run (``repro_torch.launch.shapes``,
``roofline.analysis``, ``launch.dryrun``) against the reference.

* ``SHAPES``, ``skip_reason``, ``model_flops``, ``active_param_count`` and
  ``ssm_time_scan_flops`` for all 40 (arch x shape) cells, and
  ``roofline_terms(device=TPU_V5E)``, equal the reference's.
* ``input_specs``: every leaf's shape, dtype and spec equal the
  reference's ``ShapeDtypeStruct``s for each arch at ``train_4k`` and
  ``decode_32k`` on an abstract (16, 16) mesh with FSDP.
* ``planned_mesh_shape`` at 256, 250, 7 and 512 chips, one pod and two,
  equals the reference's.  The reference's module forces 512 XLA host
  devices when imported, so its values come from a subprocess.
* ``CollectiveCounter`` counts each collective kind's per-device result
  bytes as the analytic sizes say, over a fake process group.
* ``run_cell`` at reduced depth on a fake (4, 2) mesh: its record has the
  reference's keys, the reference's parameter counts and model FLOPs,
  the per-device FLOPs of a hand count of internlm2's matrix products,
  a peak memory above the rank's parameter bytes, and the same counts
  extrapolated from 1 and 2 periods as run at full depth.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.dist.sharding import ShardingPlan as JPlan
from repro.dist.topology import abstract_mesh as j_abstract_mesh
from repro.launch.shapes import SHAPES as J_SHAPES
from repro.launch.shapes import input_specs as j_input_specs
from repro.launch.shapes import skip_reason as j_skip_reason
from repro.roofline import analysis as JA

from repro_torch.configs import get_config as t_get_config
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.dist.topology import abstract_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.shapes import SHAPES, input_specs, skip_reason
from repro_torch.launch.shapes import spec_leaves
from repro_torch.plan.cost import TPU_V5E
from repro_torch.roofline import analysis as TA

ARCHS = j_list_archs()
CELLS = [(a, s) for a in ARCHS for s in J_SHAPES]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shapes_are_the_references():
    assert list(SHAPES) == list(J_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_counts_match_reference(arch, shape):
    """``skip_reason``, ``model_flops``, ``active_param_count`` and
    ``ssm_time_scan_flops`` of every cell."""
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    js, ts = J_SHAPES[shape], SHAPES[shape]
    assert skip_reason(tcfg, ts) == j_skip_reason(jcfg, js)
    assert TA.active_param_count(tcfg) == JA.active_param_count(jcfg)
    assert TA.model_flops(tcfg, ts) == JA.model_flops(jcfg, js)
    assert TA.ssm_time_scan_flops(tcfg, ts) == JA.ssm_time_scan_flops(jcfg,
                                                                      js)


@pytest.mark.parametrize("counts", [(1e12, 5e10, 2e9, 256, 3e14),
                                    (4e9, 9e11, 0.0, 16, 1e12),
                                    (0.0, 0.0, 0.0, 1, 0.0)])
def test_roofline_terms_on_the_tpu_model_are_the_references(counts):
    want = dataclasses.asdict(JA.roofline_terms(*counts))
    got = dataclasses.asdict(TA.roofline_terms(*counts, device=TPU_V5E))
    assert got == want


def test_roofline_defaults_to_the_h100():
    """Without ``device`` the terms are the H100 model's peaks."""
    t = TA.roofline_terms(989e12, 3.35e12, 450e9, 8, 989e12 * 8)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.useful_flops_ratio == pytest.approx(1.0)


def _ref_name(path) -> str:
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(f"[{k.idx}]")
    return "/".join(parts)


def _ref_records(specs):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = () if leaf.sharding is None else tuple(leaf.sharding.spec)
        out.append((_ref_name(path), tuple(leaf.shape),
                    np.dtype(leaf.dtype).name, spec))
    return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every leaf of the step's inputs: the reference's path, shape, dtype
    and spec (16 x 16, FSDP)."""
    jmesh = j_abstract_mesh((16, 16), ("data", "model"))
    tmesh = abstract_mesh((16, 16), ("data", "model"))
    want = _ref_records(j_input_specs(j_get_config(arch), J_SHAPES[shape],
                                      jmesh, JPlan(jmesh, fsdp=True)))
    got = [(path, rec.shape, str(rec.dtype).removeprefix("torch."),
            rec.spec)
           for path, rec in spec_leaves(input_specs(
               t_get_config(arch), SHAPES[shape], tmesh,
               ShardingPlan(tmesh, fsdp=True)))]
    assert got == want


_PLANNED = [(256, False), (250, False), (7, False), (512, False),
            (256, True), (250, True), (7, True), (512, True)]


def test_planned_mesh_shape_matches_reference():
    """The reference's values, computed in a subprocess of their own."""
    code = (
        "import json, sys\n"
        "from repro.launch.dryrun import planned_mesh_shape\n"
        "out = []\n"
        f"for chips, pod in {_PLANNED!r}:\n"
        "    try:\n"
        "        out.append(list(planned_mesh_shape(chips, 16, pod)))\n"
        "    except ValueError:\n"
        "        out.append('raises')\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    got = []
    for chips, pod in _PLANNED:
        try:
            got.append(list(D.planned_mesh_shape(chips, 16, pod)))
        except ValueError:
            got.append("raises")
    assert got == want
    assert "raises" in got and [25, 10] in got


# ---------------------------------------------------------------------------
# the collective counter and the dry run, over a fake process group
# ---------------------------------------------------------------------------


def test_collective_counter_counts_result_bytes():
    """Each collective DTensor (or a caller) issues, by kind: the bytes of
    its per-device result and one call."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_production_mesh

    with D.fake_world(8):
        mesh = make_production_mesh(data=4, model=2, device="cpu")
        local = torch.zeros(8, 6)               # 192 bytes a rank
        counter = TA.CollectiveCounter()
        with counter:
            d = DTensor.from_local(local, mesh, [Replicate(), Shard(0)],
                                   run_check=False)
            d.redistribute(mesh, [Replicate(), Replicate()])   # all-gather
            p = DTensor.from_local(local, mesh, [Replicate(), Partial()],
                                   run_check=False)
            p.redistribute(mesh, [Replicate(), Replicate()])   # all-reduce
            p.redistribute(mesh, [Replicate(), Shard(0)])      # reduce-scatter
            funcol.all_to_all_single(local, None, None,
                                     mesh.get_group("model")).wait()
        got = counter.summary()
    assert got["all-gather"] == 2 * 192
    assert got["all-reduce"] == 192
    assert got["reduce-scatter"] == 192 // 2
    assert got["all-to-all"] == 192
    assert got["collective-permute"] == 0
    assert got["total"] == 192 * 4.5
    assert got["op_counts"] == {"all-gather": 1, "all-reduce": 1,
                                "reduce-scatter": 1, "all-to-all": 1,
                                "collective-permute": 0}


# The keys the reference's ``run_cell`` writes (src/repro/launch/dryrun.py,
# run_cell and its ``memory_per_device`` / ``cost_analysis`` records).
REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "params_total",
            "params_active", "fsdp", "lower_s", "compile_s", "hlo_lines",
            "memory_per_device", "collectives", "cost_analysis",
            "model_flops"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "peak_bytes_est"}
REF_COST_KEYS = {"flops_per_device_raw", "flops_per_device",
                 "bytes_per_device", "collective_bytes_per_device",
                 "ssm_time_scan_fix_per_device", "scan_periods"}
REF_COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all", "collective-permute", "total",
                       "op_counts"}


def _cut_cell(periods: int, **kw) -> dict:
    """internlm2-1.8b x decode_32k cut to ``periods`` body periods (its
    ``get_config`` patched) on a fake (4, 2) mesh."""
    import repro_torch.configs as C

    full = C.get_config
    C.get_config = lambda name: D._reduced_depth(full(name), periods)
    try:
        return D.run_cell("internlm2-1.8b", "decode_32k", False, chips=8,
                          model_parallel=2, device="cpu", **kw)
    finally:
        C.get_config = full


@pytest.fixture(scope="module")
def decode_cell():
    """The one-period cell: (record, the reference's config cut alike)."""
    return (_cut_cell(1),
            D._reduced_depth(j_get_config("internlm2-1.8b"), 1))


def test_run_cell_record_has_the_references_keys(decode_cell):
    rec, jcfg = decode_cell
    assert REF_KEYS <= set(rec)
    assert REF_MEMORY_KEYS <= set(rec["memory_per_device"])
    assert REF_COST_KEYS <= set(rec["cost_analysis"])
    assert REF_COLLECTIVE_KEYS <= set(rec["collectives"])
    assert rec["mesh"] == "4x2" and rec["chips"] == 8
    assert rec["cost_analysis"]["ssm_time_scan_fix_per_device"] == 0.0
    assert rec["params_total"] == jcfg.param_count()
    assert rec["params_active"] == JA.active_param_count(jcfg)
    assert rec["model_flops"] == JA.model_flops(jcfg, J_SHAPES["decode_32k"])


def test_run_cell_flops_are_a_hand_count(decode_cell):
    """Per device: 32 sequences (128 over 4 data ranks), half of every
    head and column (2 model ranks), one token against a 32,768-long
    cache: the q/k/v/o, FFN and head products and the attention's two."""
    rec, _ = decode_cell
    b, d, h, kv, hd, ff, vocab, s, m = 32, 2048, 16, 8, 128, 8192, 92544, \
        32768, 2
    hand = (2 * b * d * (h * hd // m) + 2 * 2 * b * d * (kv * hd // m)
            + 2 * 2 * b * (h // m) * s * hd + 2 * b * (h * hd // m) * d
            + 2 * 2 * b * d * (ff // m) + 2 * b * (ff // m) * d
            + 2 * b * d * (vocab // m))
    got = rec["cost_analysis"]["flops_per_device"]
    assert abs(got - hand) <= 0.01 * hand


def test_run_cell_peak_holds_the_ranks_parameters(decode_cell):
    rec, _ = decode_cell
    tcfg = D._reduced_depth(t_get_config("internlm2-1.8b"), 1)
    # every parameter is split over the 2 model ranks at most
    assert rec["memory_per_device"]["peak_bytes_est"] >= \
        tcfg.param_count() * 2 / 2
    assert rec["memory_per_device"]["peak_bytes_est"] >= \
        rec["memory_per_device"]["argument_bytes"] > 0


def test_run_cell_extrapolation_is_the_full_depth_count():
    """Counts extrapolated from 1 and 2 periods equal a 3-period run's."""
    ext = _cut_cell(3)
    full = _cut_cell(3, body_correction=False)
    assert ext["periods_run"] == [1, 2] and full["periods_run"] == [3]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device"):
        assert ext["cost_analysis"][key] == full["cost_analysis"][key], key
    assert ext["collectives"]["op_counts"] == full["collectives"]["op_counts"]
    assert ext["hlo_lines"] == full["hlo_lines"]


def test_dryrun_cli_writes_a_record(tmp_path):
    """``main`` with the reference's flags (and ``--device cpu``) writes
    the record and its H100 roofline terms."""
    out = tmp_path / "cell.json"
    D.main(["--arch", "internlm2-1.8b", "--shape", "long_500k", "--chips",
            "8", "--model-parallel", "2", "--device", "cpu", "--out",
            str(out)])
    rec = json.loads(out.read_text())
    assert "skipped" in rec and rec["shape"] == "long_500k"
    D.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--chips", "8",
            "--model-parallel", "2", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    terms = rec["roofline_h100"]
    assert terms["bound_s"] > 0 and terms["dominant"] in (
        "compute", "memory", "collective")
    assert rec["cost_analysis"]["flops_per_device"] > 0
