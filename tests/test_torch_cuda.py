"""The port's CUDA kernels on a card (marked ``cuda``; they skip elsewhere).

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports the JAX
package, out; this file imports nothing else from ``tests``.)  Each
kernel is held against its plain PyTorch version on the same card, and
the forward pass on the card against the plain forward on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparse_formats import random_power_law_csr
from repro_torch.exec.plan import SpmmPlan
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.gcn import GCNConfig, GCNGraph, gcn_forward

# Aggregation: the same tau products, FMA contraction only.  Fused: the
# kernel re-associates to (sum_t v X[c]) W, F_in-long dot products in
# another f32 order.
TOL = {"spmm_ell_dense_grid": 1e-5, "spmm_ell_sparse_grid": 1e-5,
       "spmm_ell_fused_dense_grid": 1e-4, "spmm_ell_fused_sparse_grid": 1e-4}


def rel_max_err(out, ref) -> float:
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_case(seed, r=96, tau=5, k=64, f=40, f_in=37, br=16, bk=16, bf=8):
    """Ragged shapes, an empty row block, a shuffled schedule with a row
    block visited twice (its last run counts) and -1-padded kb_ids."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, k, (r, tau)).astype(np.int32)
    cols[rng.random((r, tau)) < 0.3] = -1
    cols[br:2 * br] = -1
    vals = rng.standard_normal((r, tau)).astype(np.float32)
    n_rb, n_kb = r // br, k // bk
    steps = [(rb, kb) for rb in range(n_rb) for kb in rng.permutation(n_kb)
             if rng.random() < 0.7]
    steps += [(2, 0), (2, 1)]
    rb_ids = np.array([s[0] for s in steps], np.int32)
    kb_ids = np.array([s[1] for s in steps], np.int32)
    first = np.r_[1, (rb_ids[1:] != rb_ids[:-1])].astype(np.int32)
    kb_f = np.r_[rng.permutation(n_kb)[:n_kb - 1], [-1, -1]].astype(np.int32)
    return dict(
        cols=cols, vals=vals, dense=rng.standard_normal((k, f)),
        x=rng.standard_normal((k, f_in)), w=rng.standard_normal((f_in, f)),
        b=rng.standard_normal((1, f)), rb_ids=rb_ids, kb_ids=kb_ids,
        first=first, kb_f=kb_f, kw=dict(block_rows=br, block_k=bk, block_f=bf),
        k_real=k - 5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_kernels_match_plain_versions(cuda_device, seed):
    c = _random_case(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda_device)

    cols, vals = t(c["cols"], torch.int32), t(c["vals"])
    x, w, b = t(c["x"]), t(c["w"]), t(c["b"])
    kw = c["kw"]
    bitmaps = t(fv.schedule_tile_bitmaps(
        c["rb_ids"], c["kb_ids"], c["first"],
        c["cols"].shape[0] // kw["block_rows"],
        c["dense"].shape[0] // kw["block_k"]), torch.int32)
    calls = {
        "spmm_ell_dense_grid": ((cols, vals, t(c["dense"])), {}),
        "spmm_ell_sparse_grid": ((cols, vals, t(c["dense"]), bitmaps), {}),
        "spmm_ell_fused_dense_grid": ((cols, vals, x, w, b),
                                      {"k_real": c["k_real"]}),
        "spmm_ell_fused_sparse_grid": (
            (cols, vals, x, w, b, t(c["kb_f"], torch.int32)),
            {"k_real": c["k_real"]}),
    }
    for name, (args, extra) in calls.items():
        before = fv.LAUNCHES[name]
        out = getattr(fv, name)(*args, **kw, **extra)
        ref = fv.PLAIN[name](*args, **kw, **extra)
        torch.cuda.synchronize()
        assert fv.LAUNCHES[name] == before + 1
        assert rel_max_err(out, ref) <= TOL[name], name


@pytest.mark.cuda
def test_cuda_wrapper_refuses_mixed_devices(cuda_device):
    cols = torch.zeros(16, 2, dtype=torch.int32, device=cuda_device)
    vals = torch.zeros(16, 2, device=cuda_device)
    with pytest.raises(ValueError, match="expected cuda"):
        fv.spmm_ell_dense_grid(cols, vals, torch.zeros(16, 16), block_rows=16,
                               block_k=16, block_f=16)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
def test_cuda_forward_matches_cpu(cuda_device, impl, fused):
    n = 320
    adj = random_power_law_csr(n, n, 5000, alpha=2.8, seed=0)
    cfg = GCNConfig(in_dim=24, hidden_dim=32, out_dim=5, block_rows=32,
                    block_k=32, block_f=32)
    graph = GCNGraph.build(adj, cfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((n, 24)).astype(np.float32)
    params = {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                             "b": rng.standard_normal(s[1]).astype(np.float32)}
              for i, s in enumerate([(24, 32), (32, 5)])}
    ref = gcn_forward(params_from_numpy(params, "cpu"), graph, feats, cfg,
                      device="cpu")
    plan = SpmmPlan(impl=impl, block_rows=32, block_k=32, block_f=32,
                    fused=fused)
    before = dict(fv.LAUNCHES)
    out = gcn_forward(params_from_numpy(params, cuda_device), graph, feats,
                      cfg, plan=plan, device=cuda_device)
    assert fv.LAUNCHES != before          # the forward went through a kernel
    assert rel_max_err(out, ref) <= 1e-4
