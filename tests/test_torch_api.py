"""The port's public surface against the reference's.

Every module of ``repro`` has a ``repro_torch`` module of the same path,
and that module has each of the reference module's public names: those
in its ``__all__``, or else every public function and class it defines.
The walk runs in a subprocess, because ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported.
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

REFERENCE_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro.__path__, "repro."))

_WALK = textwrap.dedent(f"""
    import importlib, inspect, json, sys
    sys.path.insert(0, {SRC!r})
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
        out[name] = {{"module": port, "names": len(names),
                      "missing": sorted(n for n in names
                                        if not hasattr(tmod, n))}}
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
