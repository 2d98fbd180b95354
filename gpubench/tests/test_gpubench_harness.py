"""The harness on the CPU, at a tiny size, in a temporary copy of the
benchmark: cells found by name, the result line's schema, faults planted
under the timed path that the check must catch, and the exits without a
card, without the program or with JAX loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench import bench

REPO = os.path.dirname(bench.BENCH_DIR)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
CELLS = {"tiny-full": "full-unfused", "tiny-full-fused": "full-fused"}


def make_copy(root: str) -> str:
    """``BENCHMARK.json`` and ``gpubench/`` under ``root``, with a tiny
    configuration and its cells (held to reddit-full's limits) added as
    files and entries; the copy's ``gpubench`` directory."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(bench.BENCH_DIR, os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    bench_dir = os.path.join(root, "gpubench")
    with open(os.path.join(bench_dir, "configs", "gcn-reddit.json")) as f:
        cfg = json.load(f)
    cfg.update(name="gcn-tiny", widths=[24, 16, 5])
    cfg["graph"].update(dataset="tiny", nodes=3000, edges=15000)
    write(os.path.join(bench_dir, "configs", "gcn-tiny.json"), cfg)
    spec = load(os.path.join(root, "BENCHMARK.json"))
    limits = load(os.path.join(bench_dir, "workloads", "reddit-full.json"))
    for name, traffic in CELLS.items():
        spec["workloads"].append({"name": name, "config": "gcn-tiny",
                                  "traffic": traffic, "chips": 1, "why": "t"})
        write(os.path.join(bench_dir, "workloads", name + ".json"), limits)
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c, t in CELLS.items()
                               if (m["name"] == "ell_fused_roofline")
                               == (t == "full-fused")]
    write(os.path.join(root, "BENCHMARK.json"), spec)
    return bench_dir


def load(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("bench")))


def run_cell(bench_dir, cell, trace=False, seconds=0.3):
    return bench.run(cell, SEED, seconds, trace, CPU, bench_dir=bench_dir,
                     log=lambda msg: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_result_line(copy, cell, trace):
    result = run_cell(copy, cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    spec = load(os.path.join(os.path.dirname(copy), "BENCHMARK.json"))
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    want = ({"graph_load_s", "enqueue_ms"} if trace else
            {"forward_ms", "forward_p95_ms", "setup_s"})   # no card: no peak
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert result["device"]["platform"] == "cpu"
    assert set(result["check"]) == {"logit_err"}
    for c in result["check"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result, allow_nan=False)
    assert bench.check_lines(result)[0].startswith("check logit_err ")


def test_parts_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files and entries, with no file of the benchmark edited."""
    bench_dir = make_copy(str(tmp_path))
    cfg = load(os.path.join(bench_dir, "configs", "gcn-tiny.json"))
    cfg.update(name="gcn-tiny2", widths=[20, 8, 3])
    write(os.path.join(bench_dir, "configs", "gcn-tiny2.json"), cfg)
    traffic = load(os.path.join(bench_dir, "traffic", "full-unfused.json"))
    traffic.update(feature_sets=3, warm_rounds=1)
    write(os.path.join(bench_dir, "traffic", "three-sets.json"), traffic)
    write(os.path.join(bench_dir, "workloads", "tiny2-three.json"),
          load(os.path.join(bench_dir, "workloads", "tiny-full.json")))
    with open(os.path.join(bench_dir, "metrics", "forwards_per_s.py"), "w") as f:
        f.write("def read(record):\n"
                "    w = record['window']\n"
                "    return w['forwards'] / w['seconds']\n")
    spec_path = os.path.join(tmp_path, "BENCHMARK.json")
    spec = load(spec_path)
    spec["workloads"].append({"name": "tiny2-three", "config": "gcn-tiny2",
                              "traffic": "three-sets", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "forwards_per_s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step", "moves": "forward_ms",
                              "workloads": ["tiny2-three"]})
    write(spec_path, spec)
    result = run_cell(bench_dir, "tiny2-three", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["forwards_per_s"]["value"] > 0
    assert "forwards_per_s" not in run_cell(bench_dir, "tiny-full", True)["metrics"]


def _stale(monkeypatch):
    import repro_torch.serve.registry as registry

    real, first = registry.gcn_forward, []

    def forward(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]

    monkeypatch.setattr(registry, "gcn_forward", forward)


def _half(monkeypatch):
    import repro_torch.exec.dispatch as dispatch

    real = dispatch.segment_accumulate

    def fold(sub, row_map, n_out_rows):
        out = real(sub, row_map, n_out_rows)
        out[n_out_rows // 2:] = 0.0
        return out

    monkeypatch.setattr(dispatch, "segment_accumulate", fold)
    monkeypatch.setattr("repro_torch.exec.fused.segment_accumulate", fold)


def _altered(monkeypatch, value=None):
    import repro_torch.serve.registry as registry

    real = registry.gcn_forward

    def forward(*a, **kw):
        out = real(*a, **kw)
        out[17, 2] = (out[17, 2] + 1e-3 * out.abs().max()
                      if value is None else value)
        return out

    monkeypatch.setattr(registry, "gcn_forward", forward)


FAULTS = {
    "stale": _stale,
    "half": _half,
    "altered": _altered,
    "nan": lambda mp: _altered(mp, float("nan")),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(copy, monkeypatch,
                                                     fault, cell):
    FAULTS[fault](monkeypatch)
    result = run_cell(copy, cell)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(line.endswith("FAILED") for line in bench.check_lines(result))
    json.dumps(result, allow_nan=False)


def _script(bench_dir: str, body: str) -> list:
    return [sys.executable, "-c",
            f"import sys; sys.path[:0] = [{os.path.dirname(bench_dir)!r}, "
            f"{os.path.join(REPO, 'src')!r}]\n" + body]


def test_no_jax_or_repro_after_a_run(copy):
    body = (
        "import torch\n"
        "from gpubench import bench\n"
        f"r = bench.run('tiny-full-fused', 5, 0.2, True, torch.device('cpu'),"
        f" bench_dir={copy!r}, log=lambda m: None)\n"
        "assert r['correct']\n"
        "import gpubench.run as run\n"
        "print(run.forbidden_modules())\n"
        "sys.modules['repro'] = sys.modules['gpubench']\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(_script(copy, body), capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "['repro']"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the exit without one")
    out = subprocess.run(
        [sys.executable, os.path.join(bench.BENCH_DIR, "run.py"), "--workload",
         "reddit-full", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(bench.BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "reddit-full",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
