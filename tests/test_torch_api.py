"""The port's public surface against the reference's.

Every module of ``repro`` has a ``repro_torch`` module of the same path,
and that module has each of the reference module's public names: those
in its ``__all__``, or else every public function and class it defines.
Each of those that is a function or a class takes every parameter name
the reference's takes, but for the deliberate departures written out in
:data:`DEPARTURES`.  The walk runs in a subprocess, because
``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported.
"""

import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

import repro

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# Public names of the reference that the port may lack.  Empty: the port
# has them all.
EXCEPTIONS = ()

_GROUP = ("a named mesh axis that the reference's collectives run over "
          "inside shard_map or vmap; the port runs one process per rank and "
          "takes the torch.distributed process group")
_AXIS_SIZES = ("the reference reads the axis sizes off a jax Mesh; the port "
               "takes them as a dict ({axis: size}), which both a DeviceMesh "
               "and an abstract planning mesh give (dist.topology.axis_sizes)")
_BITMAPS = ("the TPU kernel's scalar-prefetched (row block, k-tile, first) "
            "steps; the CUDA kernel takes the same schedule as one k-tile "
            "bitmap per row block, built once per graph "
            "(schedule_tile_bitmaps)")
_OPERANDS = ("the reference passes the ELL columns and the host TiledELL "
             "apart; the port passes the SpmmOperands that hold both and "
             "memoize the schedules built from them")
_SCAN = ("the reference's scan takes the stacked inputs and the axis its "
         "outputs stack on; the port's loop takes the sequence length s and "
         "its step indexes the inputs itself")

#: Reference parameters the port renames or drops on purpose: for each
#: callable (``module.qualname`` where the reference defines it; ``*`` for
#: every callable), each such parameter, the port's parameters that take
#: its place (empty: dropped), and the reason.
DEPARTURES = {
    "*": {
        "interpret": ((), "Pallas' interpret mode; the port runs a kernel's "
                          "plain PyTorch version on CPU tensors instead"),
        "key": (("generator", "gen"), "a jax.random key; the port draws "
                                      "from a torch.Generator"),
        "axis": (("group",), _GROUP),
        "axis_name": (("group",), _GROUP),
    },
    "repro.plan.cost.spec_shard_factor": {"mesh": (("axis_sizes",),
                                                   _AXIS_SIZES)},
    "repro.plan.cost.grad_sync_bytes": {"mesh": (("axis_sizes",),
                                                 _AXIS_SIZES)},
    "repro.plan.cost.rank_specs": {"mesh": (("axis_sizes",), _AXIS_SIZES)},
    "repro.roofline.analysis.collective_bytes": {
        "hlo_text": (("counted",), "the reference parses compiled HLO text; "
                                   "the port has no HLO and reads the "
                                   "collectives a CollectiveCounter "
                                   "counted"),
    },
    "repro.models.ssm.chunked_scan": {"xs": (("s",), _SCAN),
                                      "ys_time_axis": (("s",), _SCAN)},
    "repro.kernels.flexvector_spmm.spmm_ell_sparse_grid": {
        "rb_ids": (("tile_bitmaps",), _BITMAPS),
        "kb_ids": (("tile_bitmaps",), _BITMAPS),
        "first": (("tile_bitmaps",), _BITMAPS),
    },
    "repro.exec.dispatch.sub_row_products": {
        "cols": (("operands",), _OPERANDS),
        "ell": (("operands",), _OPERANDS),
    },
}

REFERENCE_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro.__path__, "repro."))

_WALK = textwrap.dedent(f"""
    import importlib, inspect, json, sys
    sys.path.insert(0, {SRC!r})

    def _params(o):
        # parameter names, *args / **kwargs left out; None where the
        # callable has no signature to read
        try:
            sig = inspect.signature(o)
        except (TypeError, ValueError):
            return None
        return [p.name for p in sig.parameters.values()
                if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]

    out = {{}}
    for name in json.loads(sys.argv[1]):
        mod = importlib.import_module(name)
        if hasattr(mod, "__all__"):
            names = list(mod.__all__)
        else:
            names = [n for n, o in vars(mod).items()
                     if not n.startswith("_")
                     and (inspect.isfunction(o) or inspect.isclass(o))
                     and o.__module__ == name]
        port = "repro_torch" + name[len("repro"):]
        try:
            tmod = importlib.import_module(port)
        except ImportError as e:
            out[name] = {{"module": port, "missing": None, "error": str(e),
                          "names": len(names)}}
            continue
        params = {{}}
        for n in names:
            o, t = getattr(mod, n, None), getattr(tmod, n, None)
            if t is None or not (inspect.isfunction(o)
                                 or inspect.isclass(o)):
                continue
            params[n] = {{"defined": o.__module__ + "." + o.__qualname__,
                          "reference": _params(o), "port": _params(t)}}
        out[name] = {{"module": port, "names": len(names),
                      "missing": sorted(n for n in names
                                        if not hasattr(tmod, n)),
                      "params": params}}
    print(json.dumps(out))
""")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def surface():
    proc = subprocess.run(
        [sys.executable, "-c", _WALK, json.dumps(REFERENCE_MODULES)],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_walk_covers_the_reference(surface):
    assert len(REFERENCE_MODULES) >= 90
    assert sorted(surface) == REFERENCE_MODULES
    # the walk reads names, not only modules: most modules export some
    assert sum(1 for v in surface.values() if v["names"]) >= 80


@pytest.mark.parametrize("name", REFERENCE_MODULES)
def test_port_module_has_every_public_name(surface, name):
    entry = surface[name]
    assert entry["missing"] is not None, (
        f"{entry['module']} does not import: {entry.get('error')}")
    missing = [n for n in entry["missing"]
               if f"{entry['module']}.{n}" not in EXCEPTIONS]
    assert not missing, f"{entry['module']} lacks {missing}"


def _lacking(entry) -> dict:
    """``{callable: [reference parameters the port lacks]}`` of one
    module's walk, the :data:`DEPARTURES` taken out where the port has a
    parameter in the departed one's place (or none is named)."""
    lacking = {}
    for n, p in sorted(entry["params"].items()):
        if p["reference"] is None or p["port"] is None:
            continue
        named = {**DEPARTURES["*"], **DEPARTURES.get(p["defined"], {})}
        gone = [a for a in p["reference"] if a not in p["port"] and not (
            a in named and (not named[a][0]
                            or set(named[a][0]) & set(p["port"])))]
        if gone:
            lacking[n] = gone
    return lacking


@pytest.mark.parametrize("name", REFERENCE_MODULES)
def test_port_callables_take_the_reference_parameters(surface, name):
    """Each public function and class of the module takes every parameter
    name the reference's takes (a dataclass: its fields), but for the
    written departures."""
    entry = surface[name]
    assert entry["missing"] is not None, (
        f"{entry['module']} does not import: {entry.get('error')}")
    lacking = _lacking(entry)
    assert not lacking, f"{entry['module']} lacks parameters {lacking}"


def test_every_departure_is_still_a_departure(surface):
    """Each callable's departure names a reference parameter the port's
    callable of that name lacks, and each ``*`` departure is taken by some
    callable: no entry hides a parameter the port has meanwhile taken."""
    seen = {}
    for entry in surface.values():
        for p in (entry.get("params") or {}).values():
            if p["reference"] is None or p["port"] is None:
                continue
            for key in ("*", p["defined"]):
                for a in DEPARTURES.get(key, {}):
                    if a in p["reference"] and a not in p["port"]:
                        seen.setdefault(key, set()).add(a)
    for key, named in DEPARTURES.items():
        assert set(named) == seen.get(key, set()), (
            f"{key}: departures {sorted(set(named) - seen.get(key, set()))} "
            "name no parameter the port lacks")
        for a, (instead, reason) in named.items():
            assert reason, f"{key}.{a} has no reason"


def test_every_port_module_and_export_imports_neither_jax_nor_repro():
    """Every module of the port, then every name of every port package's
    ``__all__`` (the lazy ones of ``repro_torch.dist`` included), leaves
    no ``jax`` or ``repro`` module loaded."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {SRC!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, 'repro_torch.')]
        n_exports = 0
        for name in names:
            mod = importlib.import_module(name)
            for export in getattr(mod, '__all__', ()):
                getattr(mod, export)
                n_exports += 1
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        assert not bad, bad
        print(len(names), n_exports)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules, n_exports = map(int, proc.stdout.split())
    assert n_modules >= 90 and n_exports >= 200


def test_importing_dist_loads_none_of_its_modules():
    """``repro_torch.dist``'s names load on first access."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {SRC!r})
        import repro_torch.dist as d
        before = sorted(m for m in sys.modules
                        if m.startswith('repro_torch.dist.')
                        or m.startswith('torch.distributed.tensor'))
        plan = d.ShardingPlan
        after = 'repro_torch.dist.sharding' in sys.modules
        print(before, after, plan.__module__, 'LEDGER' in dir(d))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["[]", "True", "repro_torch.dist.sharding",
                                   "True"]


@pytest.mark.parametrize("first", [
    "repro_torch.core.spmm", "repro_torch.exec", "repro_torch.exec.pipeline",
    "repro_torch.models", "repro_torch.plan.autoplan", "repro_torch.dist",
    "repro_torch.roofline.analysis", "repro_torch.serve",
])
def test_each_package_imports_first(first):
    """The re-exports leave the import graph acyclic: each package (or
    the module that closes a cycle) can be the first one imported."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {SRC!r})
        importlib.import_module({first!r})
        import repro_torch.core, repro_torch.exec, repro_torch.models
        import repro_torch.dist
        assert repro_torch.exec.plan_pipeline.__module__ == (
            'repro_torch.exec.pipeline')
        assert repro_torch.core.spmm_dense_oracle.__module__ == (
            'repro_torch.core.spmm')
        assert repro_torch.dist.viable_mesh_shapes.__module__ == (
            'repro_torch.dist.topology')
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
