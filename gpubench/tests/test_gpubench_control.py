"""The control at a size a test run holds: the reference computed with
TF32 in the program's place must fail every cell's limit, where the
program's own logits hold it.  On the CPU TF32 is emulated by rounding
the products' inputs; on the card (``cuda`` marker) it is the card's."""

import os

import pytest
import torch

from gpubench import bench
from test_gpubench_harness import load, make_copy

REAL_CELLS = [c["name"] for c in load(os.path.join(
    os.path.dirname(bench.BENCH_DIR), "BENCHMARK.json"))["workloads"]]


def readings(bench_dir, device, seeds=(3, 4, 5)):
    spec = load(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    cell = bench.Cell(bench_dir, spec, "tiny-full")
    loop = cell.module("loops", cell.traffic["loop"])
    system = cell.module("systems", cell.traffic["system"]).System(
        cell.config, cell.traffic, seeds[0], device,
        os.path.join(bench_dir, bench.CACHE), lambda msg: None)
    program, control = [], []
    for seed in seeds:
        system.draw(seed)
        system.warm()
        loop.run(system, 0.1, device)
        program.append(system.check()["logit_err"])
        control.append(system.control()["logit_err"])
    return program, control


def hold(bench_dir, device):
    program, control = readings(bench_dir, device)
    for name in REAL_CELLS:
        limit = load(os.path.join(bench.BENCH_DIR, "workloads",
                                  name + ".json"))["limits"]["logit_err"]
        assert max(program) <= limit, (name, program, limit)
        assert min(control) > limit, (name, control, limit)


def test_control_fails_every_limit_on_the_cpu(tmp_path):
    hold(make_copy(str(tmp_path)), torch.device("cpu"))


@pytest.mark.cuda
def test_control_fails_every_limit_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 is the card's")
    hold(make_copy(str(tmp_path)), torch.device("cuda", 0))


def test_the_cells_limits_have_their_readings():
    """Each limit lies above the program's largest reading and below the
    control's smallest, as the cell's file records them."""
    for name in REAL_CELLS:
        own = load(os.path.join(bench.BENCH_DIR, "workloads", name + ".json"))
        for key, limit in own["limits"].items():
            r = own["readings"][key]
            assert r["program_max"] <= limit, (name, key)
            assert limit < r["control_min"], (name, key)
