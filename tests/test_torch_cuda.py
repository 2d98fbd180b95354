"""The port's CUDA kernels on a card (marked ``cuda``; they skip elsewhere).

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports the JAX
package, out; this file imports nothing else from ``tests`` but
``tests/_torch_ops.py`` and ``tests/_torch_dist.py``, which import only
torch and numpy.)  Each
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

# Aggregation: the same tau products, FMA contraction only.  Fused: each
# element of X W + b is an F_in-long dot product in another f32 order, and
# the atomics add the terms of an output row in run-dependent order.
TOL = {"spmm_ell_dense_grid": 1e-5, "spmm_ell_sparse_grid": 1e-5,
       "spmm_ell_fused_dense_grid": 1e-4, "spmm_ell_fused_sparse_grid": 1e-4}
# bf16/int8 fused: X W + b is summed in another f32 order than the plain
# version's matmul before its bf16 rounding, so an element near a rounding
# boundary can land one bf16 ulp (2^-8 of itself) away.  Such flips are
# rare: at most FLIP_SHARE of the elements may be off by more than 1e-5
# of the scale, where a missing rounding moves most of them.
QUANT_FUSED_TOL = 8e-3
FLIP_SHARE = 1e-2
# bf16/int8 forward vs the CPU: each layer rounds X W + b to bf16 after f32
# sums taken in another order (and index_add_ adds with atomics), so a
# flip moves the few logits that aggregate it (at most
# FORWARD_FLIP_SHARE of them); an f32 forward in its place moves most of
# them by ~2e-3 or more.
QUANT_FORWARD_TOL = 2e-3
FORWARD_FLIP_SHARE = 5e-2


def rel_max_err(out, ref) -> float:
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def flip_share(out, ref) -> float:
    """Share of elements off by more than 1e-5 of max|ref|."""
    out, ref = out.double().cpu(), ref.double().cpu()
    return float(((out - ref).abs() > 1e-5 * ref.abs().max()).double().mean())


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_case(seed, r=96, tau=5, k=64, f=40, f_in=37, br=16, bk=16, bf=8,
                 hub=False):
    """Ragged shapes, an empty row block, a shuffled schedule with a row
    block visited twice (its last run counts) and -1-padded kb_ids.  With
    ``hub``, two thirds of the rows share column 5 in three of their slots."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, k, (r, tau)).astype(np.int32)
    if hub:
        cols[:2 * r // 3, :3] = 5
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


# Output widths per seed: 40; 136, whose first f-tile has more than 64
# live columns (the fused scatter's whole-warp walkers) and whose second
# has 8; 38, no multiple of 4 (the kernels' scalar paths).
WIDTHS = {0: {}, 1: {"f": 136}, 2: {"f": 38, "bf": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_kernels_match_plain_versions(cuda_device, seed):
    c = _random_case(seed, **WIDTHS[seed])

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
    slots = tuple(t(a, torch.int32)
                  for a in fv.column_slots(c["cols"], c["dense"].shape[0]))
    fkw = {"k_real": c["k_real"], "slots": slots}
    with pytest.raises(ValueError, match="need slots="):
        fv.spmm_ell_fused_dense_grid(cols, vals, x, w, b, **kw,
                                     k_real=c["k_real"])
    calls = {
        "spmm_ell_dense_grid": ((cols, vals, t(c["dense"])), {}),
        "spmm_ell_sparse_grid": ((cols, vals, t(c["dense"]), bitmaps), {}),
        "spmm_ell_fused_dense_grid": ((cols, vals, x, w, b), fkw),
        "spmm_ell_fused_sparse_grid": (
            (cols, vals, x, w, b, t(c["kb_f"], torch.int32)), fkw),
    }
    for name, (args, extra) in calls.items():
        before = fv.LAUNCHES[name]
        out = getattr(fv, name)(*args, **kw, **extra)
        ref = fv.PLAIN[name](*args, **kw, **extra)
        torch.cuda.synchronize()
        assert fv.LAUNCHES[name] == before + 1
        assert rel_max_err(out, ref) <= TOL[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_quant_kernels_match_plain_versions(cuda_device, seed, precision):
    """The bf16 instantiations of the four kernels and their int8
    ``_scaled`` variants against their plain versions on the card, at the
    widths of :data:`WIDTHS`.  A hub column makes its group's slots span
    several CTAs."""
    c = _random_case(seed, r=768, k=640, bk=64, hub=True, **WIDTHS[seed])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda_device)

    kw = c["kw"]
    cols = t(c["cols"], torch.int32)
    vals32 = t(c["vals"])
    extra = {}
    if precision == "int8":
        n_rb = c["cols"].shape[0] // kw["block_rows"]
        scales = t(np.random.default_rng(seed).uniform(0.01, 0.1, n_rb - 1))
        vals = t(np.clip(np.rint(c["vals"] * 40), -127, 127), torch.int8)
        extra["scales"] = scales    # one short: the last block takes 1.0
    else:
        vals = vals32.to(torch.bfloat16)
    dense = t(c["dense"]).to(torch.bfloat16)
    x, w = t(c["x"]).to(torch.bfloat16), t(c["w"]).to(torch.bfloat16)
    b = t(c["b"])
    bitmaps = t(fv.schedule_tile_bitmaps(
        c["rb_ids"], c["kb_ids"], c["first"],
        c["cols"].shape[0] // kw["block_rows"],
        c["dense"].shape[0] // kw["block_k"]), torch.int32)
    group, start, ids = fv.column_slots(c["cols"], c["dense"].shape[0])
    assert len(set(group.tolist())) < len(group)   # a group in >1 chunk
    slots = tuple(t(a, torch.int32) for a in (group, start, ids))
    fkw = dict(extra, k_real=c["k_real"], cast_xw=torch.bfloat16,
               slots=slots)
    with pytest.raises(ValueError, match="need slots="):
        fv.spmm_ell_fused_dense_grid(cols, vals, x, w, b, **kw,
                                     **dict(fkw, slots=None))
    suffix = "_scaled" if precision == "int8" else ""
    calls = {
        "spmm_ell_dense_grid": ((cols, vals, dense), extra),
        "spmm_ell_sparse_grid": ((cols, vals, dense, bitmaps), extra),
        "spmm_ell_fused_dense_grid": ((cols, vals, x, w, b), fkw),
        "spmm_ell_fused_sparse_grid": (
            (cols, vals, x, w, b, t(c["kb_f"], torch.int32)), fkw),
    }
    for name, (args, more) in calls.items():
        before = fv.LAUNCHES[name + suffix]
        out = fv.KERNELS[name + suffix](*args, **kw, **more)
        ref = fv.PLAIN[name + suffix](*args, **kw, **more)
        torch.cuda.synchronize()
        assert fv.LAUNCHES[name + suffix] == before + 1
        tol = TOL[name] if "fused" not in name else QUANT_FUSED_TOL
        assert rel_max_err(out, ref) <= tol, (name, precision)
        assert flip_share(out, ref) <= FLIP_SHARE, (name, precision)


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


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
def test_cuda_spmm_ell_arrays_matches_cpu(cuda_device, impl, int8):
    """The array-level entry point launches the dense-grid kernel (a
    sparse plan degrades: no host ELL) and agrees with its CPU run."""
    import warnings

    from repro_torch.core.preprocessing import preprocess
    from repro_torch.core.spmm import spmm_ell_arrays
    from repro_torch.exec import quant

    ell = preprocess(random_power_law_csr(320, 320, 5000, alpha=2.8, seed=2),
                     tau=6, tile_rows=32, pad_rows_to=32).ell
    dense = np.random.default_rng(3).standard_normal((320, 40)).astype(
        np.float32)
    vals, scales = ell.vals, None
    if int8:
        q, sc = quant.quantize_values(torch.as_tensor(ell.vals), 32)
        vals, scales = q.numpy(), sc.numpy()
    kw = dict(impl=impl, block_rows=32, block_k=32, block_f=32,
              scales=scales)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = spmm_ell_arrays(ell.cols, vals, ell.row_map, dense,
                              ell.n_orig_rows, device="cpu", **kw)
        fv.reset_launches()
        out = spmm_ell_arrays(ell.cols, vals, ell.row_map, dense,
                              ell.n_orig_rows, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == ref.shape
    assert {k for k, n in fv.LAUNCHES.items() if n} == {"spmm_ell_dense_grid"}
    assert rel_max_err(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
def test_cuda_quant_forward_matches_cpu(cuda_device, impl, fused, precision):
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
    plan = SpmmPlan(impl=impl, block_rows=32, block_k=32, block_f=32,
                    fused=fused)
    ref = gcn_forward(params_from_numpy(params, "cpu"), graph, feats, cfg,
                      plan=plan, precision=precision, device="cpu")
    scaled = "spmm_ell_dense_grid_scaled" if impl == "cuda" else \
        "spmm_ell_sparse_grid_scaled"
    if fused:
        scaled = scaled.replace("spmm_ell_", "spmm_ell_fused_")
    before = dict(fv.LAUNCHES)
    by_precision = dict(fv.PRECISION_LAUNCHES)
    out = gcn_forward(params_from_numpy(params, cuda_device), graph, feats,
                      cfg, plan=plan, precision=precision, device=cuda_device)
    launched = {k for k in fv.LAUNCHES if fv.LAUNCHES[k] != before[k]}
    assert (scaled in launched) == (precision == "int8"), launched
    # every launch ran on values of this precision (the blocks align the
    # int8 scales with the row blocks, so none falls back to bf16)
    at = {k for k in fv.PRECISION_LAUNCHES
          if fv.PRECISION_LAUNCHES[k] != by_precision[k]}
    assert at and all(k.endswith(f"@{precision}") for k in at), at
    assert rel_max_err(out, ref) <= QUANT_FORWARD_TOL
    assert flip_share(out, ref) <= FORWARD_FLIP_SHARE


# B1/B2 column extents: f32 one piece (4), three (12), the dispatcher's
# 41 -> 44, a 64-wide layer and more than 32 pieces (136, whose lanes loop
# over the row); bf16 (and int8's bf16 operand) one piece (8), 48 and 64.
AGG_WIDTHS = ([("f32", f) for f in (4, 12, 44, 64, 136)]
              + [(p, f) for p in ("bf16", "int8") for f in (8, 48, 64)])


def _aggregation_calls(c, precision, device, f):
    """B1 and B2 of ``c`` at ``precision`` on the card, as (name, args,
    kwargs) with ``block_f = f`` (the whole width, as the dispatcher
    passes it)."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    kw = dict(c["kw"], block_f=f)
    cols = t(c["cols"], torch.int32)
    vals, dense = t(c["vals"]), t(c["dense"])
    if precision != "f32":
        vals, dense = vals.to(torch.bfloat16), dense.to(torch.bfloat16)
    suffix = ""
    if precision == "int8":
        n_rb = c["cols"].shape[0] // kw["block_rows"]
        vals = t(np.clip(np.rint(c["vals"] * 40), -127, 127), torch.int8)
        kw["scales"] = t(np.random.default_rng(3).uniform(0.01, 0.1, n_rb))
        suffix = "_scaled"
    bitmaps = t(fv.schedule_tile_bitmaps(
        c["rb_ids"], c["kb_ids"], c["first"],
        c["cols"].shape[0] // kw["block_rows"],
        c["dense"].shape[0] // kw["block_k"]), torch.int32)
    return [("spmm_ell_dense_grid" + suffix, (cols, vals, dense), kw),
            ("spmm_ell_sparse_grid" + suffix, (cols, vals, dense, bitmaps),
             kw)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision, f", AGG_WIDTHS)
def test_cuda_aggregation_widths_match_plain_versions(cuda_device, precision,
                                                      f):
    """B1/B2 at the real-width column extents, on the ragged case (an
    empty row block, a schedule that visits a row block twice), with
    k-tiles of 64 and 80 columns (the sparse grid's tile by a shift and by
    a division)."""
    for bk in (64, 80):
        c = _random_case(4, r=768, k=640, bk=bk, f=f)
        for name, args, kw in _aggregation_calls(c, precision, cuda_device,
                                                 f):
            before = fv.LAUNCHES[name]
            out = fv.KERNELS[name](*args, **kw)
            ref = fv.PLAIN[name](*args, **kw)
            torch.cuda.synchronize()
            assert fv.LAUNCHES[name] == before + 1
            assert out.shape == ref.shape == (768, f)
            assert rel_max_err(out, ref) <= TOL[name.replace("_scaled", "")], \
                (name, bk)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_aggregation_multi_slab(cuda_device, precision):
    """A dense operand larger than the L2 (300,032 rows, 2,344 k-tiles of
    128: 77 MB at 64 f32 or 128 bf16 columns) takes two or more column
    slabs, and B1/B2 still equal their plain versions."""
    k, f = 300_032, 64 if precision == "f32" else 128
    c = _random_case(5, r=4096, tau=6, k=k, bk=128, br=128, f=f)
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    width = fv.slab_width(k, f, dtype)
    per_slab = fv.L2_SLAB_BYTES // (k * 16)          # 16-byte pieces
    pieces = f * torch.empty(0, dtype=dtype).element_size() // 16
    n_slabs = -(-f // width)
    assert n_slabs == -(-pieces // per_slab) >= 2
    for name, args, kw in _aggregation_calls(c, precision, cuda_device, f):
        out = fv.KERNELS[name](*args, **kw)
        ref = fv.PLAIN[name](*args, **kw)
        torch.cuda.synchronize()
        assert rel_max_err(out, ref) <= TOL[name.replace("_scaled", "")], name


def _store_calls(c, store, device, f):
    """B1 and B2 of ``c`` with one of the aggregation kernels' other
    stores (``fv.STORE_PRECISIONS``): ``f32->bf16``, ``bf16->bf16``,
    ``int8->bf16`` (scaled int8 values) or ``int8->int32`` (int8 values
    and an int8 operand, no scales), as (name, args, kwargs)."""
    precision, out = store.split("->")
    if store == "int8->int32":
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        rng = np.random.default_rng(6)
        kw = dict(c["kw"], block_f=f)
        cols = t(c["cols"], torch.int32)
        q = t(np.clip(np.rint(c["vals"] * 40), -127, 127), torch.int8)
        d8 = t(rng.integers(-128, 128, c["dense"].shape), torch.int8)
        bitmaps = t(fv.schedule_tile_bitmaps(
            c["rb_ids"], c["kb_ids"], c["first"],
            c["cols"].shape[0] // kw["block_rows"],
            c["dense"].shape[0] // kw["block_k"]), torch.int32)
        calls = [("spmm_ell_dense_grid", (cols, q, d8), kw),
                 ("spmm_ell_sparse_grid", (cols, q, d8, bitmaps), kw)]
    else:
        calls = _aggregation_calls(c, precision, device, f)
    return [(name, args, dict(kw, out_dtype=getattr(torch, {
        "bf16": "bfloat16", "int32": "int32"}[out])))
        for name, args, kw in calls]


def within_one_bf16_ulp(out, ref, f32_tol=1e-5) -> bool:
    """Every element of bf16 ``out`` within one bf16 ulp of bf16 ``ref``
    (the larger magnitude's: 2^-7 of its power of two), beyond the f32
    sums' own difference.  Kernel and plain version round f32 sums that
    differ by FMA contraction only, at most ``f32_tol`` of max|ref| (the
    f32 store's bar, :data:`TOL`); rounding each to bf16 adds at most half
    an ulp apiece, so where a sum cancels its terms the difference stays
    that of the f32 sums, however many ulps of the small result it is."""
    out, ref = out.double().cpu(), ref.double().cpu()
    mag = torch.maximum(out.abs(), ref.abs()).clamp(min=2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    slack = f32_tol * float(ref.abs().max())
    return bool(((out - ref).abs() <= ulp + slack).all())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [41, 64, 100])
@pytest.mark.parametrize("store", list(fv.STORE_PRECISIONS))
def test_cuda_aggregation_stores_match_plain_versions(cuda_device, store, f):
    """B1/B2's bf16 stores (each f32 sum rounded once) within one bf16 ulp
    of their plain versions (the plain f32 sum rounded to bf16) beyond the
    f32 sums' own difference (:func:`within_one_bf16_ulp`), and the
    int8 x int8 -> int32 instantiation equal to its plain version, at the
    main path's widths (41 int8 columns padded to 48, 64, and Yelp's 100),
    on the ragged case; each launch counted under its store's key."""
    c = _random_case(4, r=768, k=640, bk=64, f=f)
    for name, args, kw in _store_calls(c, store, cuda_device, f):
        key = f"{name}@{store}"
        before = (fv.LAUNCHES[name], fv.PRECISION_LAUNCHES[key])
        out = fv.KERNELS[name](*args, **kw)
        ref = fv.PLAIN[name](*args, **kw)
        torch.cuda.synchronize()
        assert (fv.LAUNCHES[name], fv.PRECISION_LAUNCHES[key]) == (
            before[0] + 1, before[1] + 1), key
        assert out.dtype == ref.dtype == kw["out_dtype"], key
        assert out.shape == ref.shape == (768, f), key
        if store == "int8->int32":
            assert torch.equal(out, ref), key
        else:
            assert within_one_bf16_ulp(out, ref), key


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
def test_cuda_int8_exact_spmm_ell_equals_the_reference_impl(cuda_device,
                                                            impl):
    """``spmm_ell`` over an ELL of int8 values with an int8 operand of 41
    columns: the kernels' int32 answer on the card equal to the reference
    impl's, exactly."""
    import dataclasses

    from repro_torch.core.preprocessing import preprocess
    from repro_torch.core.spmm import spmm_ell

    ell = preprocess(random_power_law_csr(320, 320, 5000, alpha=2.8, seed=2),
                     tau=6, tile_rows=32, pad_rows_to=32).ell
    q = np.clip(np.rint(ell.vals * 40), -127, 127).astype(np.int8)
    ell8 = dataclasses.replace(ell, vals=q)
    dense = np.random.default_rng(3).integers(-128, 128, (320, 41)).astype(
        np.int8)
    d = torch.as_tensor(dense, device=cuda_device)
    kw = dict(block_rows=32, block_k=32, block_f=32, device=cuda_device)
    want = spmm_ell(ell8, d, impl="reference", **kw)
    fv.reset_launches()
    got = spmm_ell(ell8, d, impl=impl, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    name = "spmm_ell_dense_grid" if impl == "cuda" else "spmm_ell_sparse_grid"
    assert {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n} == {
        f"{name}@int8->int32": 1}


# -- serving: the micro-batcher's CUDA graphs --------------------------------


def _serve_engines(device, cache_dir, precision="f32", fused=None, seed=1):
    """A serving engine on the card and one on the CPU (plain versions)
    over the toy graph of ``tests/test_serve.py``, with the same random
    parameters (from ``seed``) and one registry persisting to
    ``cache_dir``; fanout 4, rungs of 128 and 512 nodes."""
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.serve import ArtifactRegistry, ServeEngine

    spec = DatasetSpec("toy", nodes=400, edges=1_600, feature_dim=32,
                       classes=5)
    adj = gcn_normalize(synthesize_adjacency(spec, seed=7))
    feats = np.random.default_rng(7).standard_normal((400, 32)).astype(
        np.float32)
    cfg = GCNConfig(in_dim=32, hidden_dim=8, out_dim=5, spmm_impl="cuda")
    params = _serve_params(seed)
    registry = ArtifactRegistry(cache_dir=str(cache_dir))
    kw = dict(fanout=4, max_seeds=4, max_batch=4, base_bucket_nodes=64,
              precision=precision, fused=fused, registry=registry)
    return (ServeEngine(adj, feats, cfg, params=params_from_numpy(params, device),
                        device=device, **kw),
            ServeEngine(adj, feats, cfg, params=params_from_numpy(params, "cpu"),
                        device="cpu", **kw))


def _serve_params(seed):
    rng = np.random.default_rng(seed)
    return {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                           "b": rng.standard_normal(s[1]).astype(np.float32)}
            for i, s in enumerate([(32, 8), (8, 5)])}


def _serve_requests(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.choice(400, size=int(rng.integers(1, 5)), replace=False)
            for _ in range(n)]


def _assert_answers_agree(got, want, precision):
    got = torch.as_tensor(np.concatenate(got))
    want = torch.as_tensor(np.concatenate(want))
    if precision == "f32":
        assert rel_max_err(got, want) <= 1e-4
    else:
        assert rel_max_err(got, want) <= QUANT_FORWARD_TOL
        assert flip_share(got, want) <= FORWARD_FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_serve_captures_and_replays(cuda_device, tmp_path, precision,
                                        fused):
    """Warmup captures one CUDA graph per (rung, batch); queries and
    batches then replay them (no capture after warmup) and answer as the
    same engine on the CPU does."""
    from repro_torch.serve.batcher import _CapturedForward

    card, cpu = _serve_engines(cuda_device, tmp_path, precision, fused)
    built = card.warmup()
    assert built == len(card.batcher._executables) > 0
    assert all(isinstance(e, _CapturedForward) and
               isinstance(e.graph, torch.cuda.CUDAGraph)
               for e in card.batcher._executables.values())
    reqs = _serve_requests(24)
    got = [card.query(s) for s in reqs[:8]] + card.query_batch(reqs[8:])
    want = [cpu.query(s) for s in reqs[:8]] + cpu.query_batch(reqs[8:])
    assert card.compile_count == built
    _assert_answers_agree(got, want, precision)
    # each graph keeps one forward's launches; every run replayed one
    exes = card.batcher._executables.values()
    kernel = "spmm_ell_fused_dense_grid" if fused else "spmm_ell_dense_grid"
    kernel += ("_scaled" if precision == "int8" else "") + f"@{precision}"
    assert all(e.launches.get(kernel, 0) > 0 for e in exes)
    assert sum(e.replays for e in exes) == card.batcher.calls > 0
    assert card.batcher.clear_executables() == built


@pytest.mark.cuda
def test_cuda_serve_replays_the_callers_parameters(cuda_device, tmp_path):
    """Parameters are inputs of a captured rung, not constants: two
    parameter sets through one warmed rung give two outputs, each equal
    to the eager forward with its parameters."""
    card, cpu = _serve_engines(cuda_device, tmp_path)
    card.warmup()
    seeds = _serve_requests(1)[0]
    other = _serve_params(seed=9)
    first = card.query(seeds)
    card.params = params_from_numpy(other, cuda_device)
    cpu_other = params_from_numpy(other, "cpu")
    second = card.query(seeds)
    assert card.compile_count == len(card.batcher._executables)
    _assert_answers_agree([first], [cpu.query(seeds)], "f32")
    cpu.params = cpu_other
    _assert_answers_agree([second], [cpu.query(seeds)], "f32")
    assert rel_max_err(torch.as_tensor(second), torch.as_tensor(first)) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_cuda_serve_fused_rungs_pad_slots_with_empty_chunks(cuda_device,
                                                            tmp_path,
                                                            precision):
    """A fused rung's slot buffers hold the rung's chunk bound; the chunks
    past the requests' are empty (start == next start) and add nothing,
    at every batch fill from one request to a full batch."""
    card, cpu = _serve_engines(cuda_device, tmp_path, precision, fused=True)
    card.warmup()
    reqs = _serve_requests(16, seed=5)
    batcher = card.batcher
    for n in (1, 2, 3, 4):
        bucket = card._prepare(reqs[0]).bucket
        group = [s for s in reqs if card._prepare(s).bucket == bucket][:n]
        same = [card._prepare(s) for s in group]
        batch = batcher.pad_batch(len(same))
        assert sum(p.slots[0].size for p in same) < \
            batch * batcher.chunk_bound(bucket)
        got = batcher.run(card.params, same)
        want = cpu.batcher.run(cpu.params, [cpu._prepare(s) for s in group])
        _assert_answers_agree(got, want, precision)
    assert card.compile_count == len(batcher._executables)


@pytest.mark.cuda
def test_cuda_serve_replay_answers_the_new_request(cuda_device, tmp_path):
    """A replay fed a second request returns that request's logits, not
    the first's (the static inputs are refilled on every run)."""
    card, cpu = _serve_engines(cuda_device, tmp_path)
    card.warmup()
    reqs = _serve_requests(12, seed=11)
    bucket = card._prepare(reqs[0]).bucket
    second = next(s for s in reqs[1:] if set(s) != set(reqs[0])
                  and card._prepare(s).bucket == bucket)
    a, b = card.query(reqs[0]), card.query(second)
    assert b.shape == (len(second), 5)
    _assert_answers_agree([a], [cpu.query(reqs[0])], "f32")
    _assert_answers_agree([b], [cpu.query(second)], "f32")


# -- planning: autoplanned rungs -----------------------------------------------


def _mixed_planner(monkeypatch, first_rows=32, second_rows=64):
    """Make the pipeline planner answer every rung with a fused first
    layer and an unfused second one, at ``first_rows`` and
    ``second_rows`` block rows (the config's are 128)."""
    import dataclasses

    from repro_torch.exec import pipeline

    real = pipeline.plan_pipeline

    def mixed(cfg, graph, **kw):
        pp = real(cfg, graph, **kw)
        plans = (dataclasses.replace(pp.layers[0].spmm, impl="cuda",
                                     fused=True, block_rows=first_rows),
                 dataclasses.replace(pp.layers[1].spmm, impl="cuda",
                                     fused=False, block_rows=second_rows))
        return dataclasses.replace(pp, layers=tuple(
            dataclasses.replace(lp, spmm=p)
            for lp, p in zip(pp.layers, plans)))

    monkeypatch.setattr(pipeline, "plan_pipeline", mixed)


def _planned_engines(device, cache_dir, precision):
    """``_serve_engines`` with ``autoplan=True`` (growth 4, so the rungs
    are the static engines')."""
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.serve import ArtifactRegistry, ServeEngine

    spec = DatasetSpec("toy", nodes=400, edges=1_600, feature_dim=32,
                       classes=5)
    adj = gcn_normalize(synthesize_adjacency(spec, seed=7))
    feats = np.random.default_rng(7).standard_normal((400, 32)).astype(
        np.float32)
    cfg = GCNConfig(in_dim=32, hidden_dim=8, out_dim=5, spmm_impl="cuda")
    params = _serve_params(1)
    registry = ArtifactRegistry(cache_dir=str(cache_dir))
    kw = dict(fanout=4, max_seeds=4, max_batch=4, base_bucket_nodes=64,
              precision=precision, registry=registry, autoplan=True,
              ladder_growth=4)
    return (ServeEngine(adj, feats, cfg, params=params_from_numpy(params, device),
                        device=device, **kw),
            ServeEngine(adj, feats, cfg, params=params_from_numpy(params, "cpu"),
                        device="cpu", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_plan_mixed_rung_captures_and_replays(cuda_device, tmp_path,
                                                   monkeypatch, precision):
    """An autoplanned rung whose first layer is fused and second unfused
    captures one CUDA graph per (rung, batch) holding both kernels, and
    its replays answer as the same engine on the CPU does."""
    from repro_torch.serve.batcher import _CapturedForward

    _mixed_planner(monkeypatch)
    card, cpu = _planned_engines(cuda_device, tmp_path, precision)
    built = card.warmup()
    cpu.warmup()
    exes = card.batcher._executables.values()
    assert built == len(exes) > 0
    assert all(isinstance(e, _CapturedForward) for e in exes)
    tag = ("_scaled" if precision == "int8" else "") + f"@{precision}"
    for e in exes:
        assert e.launches.get(f"spmm_ell_fused_dense_grid{tag}", 0) == 1
        assert e.launches.get(f"spmm_ell_dense_grid{tag}", 0) == 1
    reqs = _serve_requests(24)
    got = [card.query(s) for s in reqs[:8]] + card.query_batch(reqs[8:])
    want = [cpu.query(s) for s in reqs[:8]] + cpu.query_batch(reqs[8:])
    assert card.compile_count == built
    _assert_answers_agree(got, want, precision)


@pytest.mark.cuda
def test_cuda_plan_int8_rung_other_block_rows_gives_eager_answer(
        cuda_device, tmp_path, monkeypatch):
    """An int8 rung whose layer plans take 32 and 64 block rows (the
    config's are 128) re-blocks the requests' scales per plan
    (``SpmmOperands.values_for``) inside the capture: the scaled kernels
    run, and the answers are the CPU engine's and the eager forwards'."""
    from repro_torch.models.gcn import gcn_forward

    _mixed_planner(monkeypatch)
    card, cpu = _planned_engines(cuda_device, tmp_path, "int8")
    built = card.warmup()
    reqs = _serve_requests(12, seed=4)
    got = card.query_batch(reqs)
    assert card.compile_count == built
    plans = card.batcher.layer_plans_for_bucket(card._prepare(reqs[0]).bucket,
                                                32)
    assert [p.block_rows for p in plans] == [32, 64]
    _assert_answers_agree(got, cpu.query_batch(reqs), "int8")
    eager = []
    for seeds in reqs:
        sub = card.sampler.extract(seeds)
        logits = gcn_forward(card.params, sub.graph, card.features[sub.nodes],
                             card.cfg, precision="int8", device=cuda_device)
        eager.append(logits[torch.as_tensor(sub.seed_local,
                                            device=cuda_device)].cpu().numpy())
    _assert_answers_agree(got, eager, "int8")
    assert any(e.launches.get("spmm_ell_dense_grid_scaled@int8", 0)
               for e in card.batcher._executables.values())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
def test_cuda_plan_launches_are_the_ops_dispatch_runs(cuda_device, impl,
                                                      precision, fused):
    """On the card, the torch ops ``execute_layer`` runs (wrappers
    included) plus its kernel launches are the H100 model's launches for
    the layer, padded and unpadded (``tests/test_torch_plan.py`` checks
    the same on the CPU with each wrapper taken as these launches)."""
    from _torch_ops import CountOps

    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import execute_layer
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.models.gcn import init_params
    from repro_torch.plan import cost

    for nodes, f_in, f_out in ((300, 20, 16), (256, 24, 32), (250, 3, 5)):
        spec = DatasetSpec("toy", nodes=nodes, edges=5 * nodes,
                           feature_dim=f_in, classes=f_out)
        cfg = GCNConfig(in_dim=f_in, hidden_dim=f_out, out_dim=f_out, tau=6,
                        spmm_impl="cuda", block_rows=16, block_k=16,
                        block_f=16)
        graph = GCNGraph.build(
            gcn_normalize(synthesize_adjacency(spec, seed=1)), cfg)
        stats = cost.graph_stats_from_ell(graph.pre.ell)
        operands, perm, _ = graph.on_device(cuda_device)
        x = torch.randn(nodes, f_in, device=cuda_device)[perm]
        layer = init_params(cfg, device=cuda_device)["layer_0"]
        for br, bk, bf in ((16, 16, 16), (32, 64, 8), (64, 16, 32)):
            plan = SpmmPlan(impl=impl, block_rows=br, block_k=bk, block_f=bf,
                            precision=precision, fused=fused)
            p = quant.quantize_params({"l": layer}, precision, br)["l"]
            execute_layer(plan, operands, x, p, w_block_rows=br)
            torch.cuda.synchronize()
            kernels = sum(fv.LAUNCHES.values())
            with CountOps() as ops:
                execute_layer(plan, operands, x, p, w_block_rows=br)
            torch.cuda.synchronize()
            counted = len(ops.names) + sum(fv.LAUNCHES.values()) - kernels
            blocks = dict(impl=impl, block_rows=br, block_k=bk,
                          precision=precision)
            if fused:
                want = cost.cuda_fused_work(stats, f_in, f_out, block_f=bf,
                                            **blocks)["launches"]
            else:
                want = (cost.cuda_spmm_work(stats, f_out, **blocks)["launches"]
                        + cost.cuda_combination_work(
                            stats.n_dense_rows, f_in, f_out,
                            precision)["launches"])
            assert counted == want, (nodes, br, bk, bf, ops.names)


@pytest.mark.cuda
def test_cuda_sharded_launches_are_the_ops_dispatch_runs(cuda_device):
    """Two gloo ranks on the card (``tests/test_torch_sharded.py`` runs the
    same count on the CPU): the torch ops one sharded ``execute_layer``
    runs on each rank, each wrapper taken as its kernel launches and each
    collective as one launch, are the H100 model's launches for it at
    every impl, precision, fusion and layout pair."""
    from _torch_dist import run_ranks
    from _torch_ops import WRAPPER_LAUNCHES

    ranks = run_ranks("_torch_dist", "sharded_launches", 2,
                      args=(WRAPPER_LAUNCHES, "cuda"))
    for rank in ranks:
        for case, (names, want) in rank.items():
            assert len(names) == want, (case, names)


# -- the async runtime: replays from the worker thread, spans -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fused", [("f32", None), ("int8", True)],
                         ids=["f32", "int8-fused"])
def test_cuda_runtime_worker_replays_the_captured_graphs(cuda_device,
                                                         tmp_path, precision,
                                                         fused):
    """A threaded ``ServeRuntime`` replays the rungs' CUDA graphs from its
    worker thread: every answer equals the same engine's on the CPU, no
    graph is captured after warmup, the replays ran off the caller's
    thread, and each traced request has its spans and ledger events."""
    import threading

    from repro_torch.obs import PlanFeedback, Tracer

    card, cpu = _serve_engines(cuda_device, tmp_path, precision, fused)
    built = card.warmup()
    reqs = _serve_requests(24, seed=13)
    want = [cpu.query(s) for s in reqs]
    threads = set()
    run = card.batcher.run

    def logged_run(params, padded):
        threads.add(threading.current_thread().name)
        return run(params, padded)

    card.batcher.run = logged_run
    calls0 = card.batcher.calls
    replays0 = sum(e.replays for e in card.batcher._executables.values())
    tracer, fb = Tracer(), PlanFeedback()
    with card.runtime(capacity=64, tracer=tracer, feedback=fb) as rt:
        subs = [rt.submit(s, deadline_s=5.0) for s in reqs]
        got = [r.future.result(timeout=120.0) for r in subs]
    _assert_answers_agree(got, want, precision)
    assert card.compile_count == built
    assert threads == {rt.loop.name}
    replays = sum(e.replays for e in card.batcher._executables.values())
    assert replays - replays0 == card.batcher.calls - calls0 > 0
    m = rt.metrics.snapshot()["counters"]
    assert m["completed"] == 24 and m["failed"] == 0
    traces = tracer.drain()
    assert len(traces) == 24 and {t.status for t in traces} == {"ok"}
    for trace in traces:
        [ex] = trace.find("execute")
        assert len(trace.find("execute_layer")) == card.cfg.n_layers
        assert {e.attributes["kind"] for e in ex.events} >= {"spmm_dram"}
    assert len(fb) >= 1


@pytest.mark.cuda
def test_cuda_runtime_capture_under_span_opens_no_span(cuda_device, tmp_path):
    """An eager forward on the card under an active span opens one
    ``execute_layer`` span per layer with its ledger events; a capture of
    the rung's forward inside the span opens none and captures without
    error, and its replay answers as the eager pass did."""
    from repro_torch.obs import Tracer, use_span
    from repro_torch.runtime import VirtualClock
    from repro_torch.serve.batcher import _CapturedForward

    card, _ = _serve_engines(cuda_device, tmp_path)
    batcher = card.batcher
    padded = card._prepare(_serve_requests(1)[0])
    fdim = padded.feats.shape[1]
    fwd = batcher._make_forward(padded.bucket, fdim)
    specs = batcher.input_specs(padded.bucket, 1, fdim)
    inputs = {name: torch.as_tensor(getattr(padded, name))[None].to(
        cuda_device) for name in specs}
    tracer = Tracer(clock=VirtualClock())
    trace = tracer.trace("eager")
    with use_span(trace.root):
        eager = fwd(card.params, inputs)
        torch.cuda.synchronize()
    layers = trace.find("execute_layer")
    assert len(layers) == card.cfg.n_layers
    assert all(any(e.name == "ledger" for e in s.events) for s in layers)
    exe = _CapturedForward(fwd, card.params, specs, cuda_device,
                           torch.cuda.graph_pool_handle())
    with use_span(trace.root):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fwd(exe.params, exe.inputs)
    assert len(trace.find("execute_layer")) == card.cfg.n_layers
    replayed = exe(card.params, {k: v.cpu() for k, v in inputs.items()})
    assert rel_max_err(torch.as_tensor(replayed), eager) <= 1e-5


def _fleet_engines(device, tmp_path):
    """Two servables on the card over the toy graph (f32 unfused, and
    fused int8 with other weights), each with its CPU twin."""
    f32 = _serve_engines(device, tmp_path / "a", "f32", None, seed=1)
    int8 = _serve_engines(device, tmp_path / "b", "int8", True, seed=2)
    return {"f32": f32, "int8": int8}


def _counted_loads(manager, loads):
    """Wrap each servable's ``load`` to log (key, thread, graphs built)."""
    import threading

    for key in manager.keys():
        sv = manager.servable(key)
        load = sv.load

        def counted(sv=sv, load=load, key=key):
            before = sv.engine.compile_count
            load()
            loads.append((key, threading.current_thread().name,
                          sv.engine.compile_count - before))

        sv.load = counted


@pytest.mark.cuda
def test_cuda_fleet_reloads_on_the_worker_while_submitting(cuda_device,
                                                           tmp_path):
    """Capacity for one of two servables and two submitting threads: the
    servables unload and reload (capturing their grids) on the submitting
    threads and on the worker, which replays the other servable's graphs
    meanwhile.  Every answer agrees with the CPU engine's, every capture
    happens inside a load (each load captures its whole grid), and no
    batch fails."""
    import threading

    from repro_torch.fleet import FleetManager, FleetRuntime

    engines = _fleet_engines(cuda_device, tmp_path)
    mgr = FleetManager(capacity_units=1.0)
    for key, (card, _) in engines.items():
        mgr.register(card.servable(key=key))
    loads = []
    _counted_loads(mgr, loads)
    reqs = _serve_requests(32, seed=17)
    want = {k: [cpu.query(s) for s in reqs] for k, (_, cpu) in
            engines.items()}
    subs = {}
    with FleetRuntime(mgr, capacity=128) as rt:
        def submit(part):
            for i in part:
                for key in ("f32", "int8") if i % 2 else ("int8", "f32"):
                    subs[(key, i)] = rt.submit(key, reqs[i])

        threads = [threading.Thread(target=submit, args=(range(k, 32, 2),),
                                    name=f"submit-{k}") for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
            assert not t.is_alive()
        got = {k: r.future.result(timeout=300.0) for k, r in subs.items()}
        worker = rt.loop.name
    for key, (card, _) in engines.items():
        _assert_answers_agree([got[(key, i)] for i in range(32)],
                              want[key], key)
        grids = [n for k, _, n in loads if k == key]
        assert len(set(grids)) == 1 and grids[0] > 0
        assert card.compile_count == sum(grids)
    assert {name for _, name, _ in loads} >= {worker}
    assert mgr.loads == len(loads) >= 4 and mgr.unloads >= 3
    m = rt.metrics.snapshot()["counters"]
    assert m["completed"] == 64 and m["failed"] == 0


@pytest.mark.cuda
def test_cuda_fleet_unload_returns_graph_memory(cuda_device, tmp_path):
    """Three unload/reload cycles of one servable: after each unload the
    device memory held is back within 16 MiB of the first unload's level,
    and each reload answers as before."""
    import gc

    card, cpu = _serve_engines(cuda_device, tmp_path, "f32", None)
    sv = card.servable(key="toy")
    reqs = _serve_requests(8, seed=5)
    want = [cpu.query(s) for s in reqs]
    levels = []
    for _ in range(3):
        sv.load()
        _assert_answers_agree([card.query(s) for s in reqs], want, "f32")
        sv.unload()
        gc.collect()
        torch.cuda.synchronize()
        levels.append(torch.cuda.memory_allocated(cuda_device))
    assert abs(levels[2] - levels[0]) <= 16 * 2 ** 20, levels


@pytest.mark.cuda
def test_cuda_fleet_two_servables_graphs_alive_together(cuda_device,
                                                        tmp_path):
    """Room for both: two servables' graphs stay captured side by side,
    batches alternate between them through one runtime, both replay, and
    nothing unloads or captures after the loads."""
    from repro_torch.fleet import FleetManager, FleetRuntime
    from repro_torch.runtime import VirtualClock

    engines = _fleet_engines(cuda_device, tmp_path)
    mgr = FleetManager(capacity_units=2.0)
    for key, (card, _) in engines.items():
        mgr.register(card.servable(key=key))
        mgr.resolve(key)
    built = {k: card.compile_count for k, (card, _) in engines.items()}
    replays0 = {k: sum(e.replays for e in card.batcher._executables.values())
                for k, (card, _) in engines.items()}
    reqs = _serve_requests(16, seed=23)
    rt = FleetRuntime(mgr, capacity=64, clock=VirtualClock())
    subs = [(key, i, rt.submit(key, s)) for i, s in enumerate(reqs)
            for key in ("f32", "int8")]
    rt.drain()
    for key, (card, cpu) in engines.items():
        got = [r.future.result(timeout=0) for k, _, r in subs if k == key]
        _assert_answers_agree(got, [cpu.query(s) for s in reqs], key)
        replays = sum(e.replays for e in card.batcher._executables.values())
        assert replays > replays0[key]
        assert card.compile_count == built[key]
    assert mgr.loads == 2 and mgr.unloads == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_cuda_lm_forward_and_decode_match_the_cpu(cuda_device, arch):
    """A reduced LM on the card: forward logits and 4 decode steps within
    the CPU parity tests' bars of the CPU's, from the same weights."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm

    bars = {"jamba-1.5-large-398b": 4e-2, "xlstm-1.3b": 1e-1}
    cfg = reduced(get_config(arch))
    p_cpu = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    p_dev = lm.tree_map(lambda t: t.to(cuda_device), p_cpu)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    bar = bars.get(arch, 2e-2)
    assert rel_max_err(lm.forward(p_dev, cfg, tokens.to(cuda_device)),
                       lm.forward(p_cpu, cfg, tokens)) <= bar
    c_cpu = lm.init_cache(cfg, 2, 8, device="cpu")
    c_dev = lm.init_cache(cfg, 2, 8, device=cuda_device)
    for t in range(4):
        want, c_cpu = lm.decode_step(p_cpu, cfg, c_cpu, tokens[:, t:t + 1], t)
        got, c_dev = lm.decode_step(p_dev, cfg, c_dev,
                                    tokens[:, t:t + 1].to(cuda_device), t)
        assert rel_max_err(got, want) <= bar


@pytest.mark.cuda
def test_cuda_lm_servable_captures_and_replays(cuda_device):
    """``LmServable.load`` captures one CUDA graph per (bucket, batch);
    replays answer as eager forwards on the card do, across a reload, and
    nothing is captured outside ``load``."""
    from repro_torch.fleet import LmServable
    from repro_torch.models import lm as tlm

    sv = LmServable("internlm2-1.8b", seq_buckets=(8, 16), max_batch=4,
                    device=cuda_device)
    sv.load()
    grid = sv.compiles
    assert grid == 6
    rng = np.random.default_rng(1)
    payloads = [list(rng.integers(0, sv.cfg.vocab, size=n))
                for n in (3, 8, 12, 16, 5)]
    for cycle in range(2):
        for seq in (8, 16):
            group = [sv.prepare(p) for p in payloads
                     if sv.prepare(p).bucket.seq == seq]
            outs = sv.run_batch(group)
            for p, out in zip(group, outs):
                toks = torch.as_tensor(p.tokens[None], device=cuda_device)
                want = tlm.forward(sv.params, sv.cfg, toks.long())
                np.testing.assert_allclose(
                    out, want[0, p.n_tokens - 1].cpu().numpy(),
                    rtol=1e-3, atol=1e-3)
        assert sv.compiles == grid * (cycle + 1)
        assert sum(e.replays for e in sv._executables.values()) == 2
        sv.unload()
        assert not sv._executables
        sv.load()


# -- training (repro_torch.train, launch.steps.build_train_step) ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-8b"])
def test_cuda_train_step_matches_the_cpu_and_lowers_the_loss(cuda_device,
                                                             arch):
    """A reduced LM's loss and gradients (``lm_loss(remat=True)``) on the
    card within 2e-2 of each leaf's max|CPU grad| (1e-3 on the loss), from
    the same weights; four in-place AdamW steps lower the loss."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, adamw_init, value_and_grad
    from repro_torch.train.tree import flatten_with_paths

    cfg = reduced(get_config(arch))
    p_cpu = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    p_dev = lm.tree_map(lambda t: t.to(cuda_device), p_cpu)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    grads = {}
    for key, p, d in (("cpu", p_cpu, "cpu"), ("card", p_dev, cuda_device)):
        grads[key] = value_and_grad(lambda q: lm.lm_loss(
            q, cfg, tokens.to(d), remat=True))(p)
    (want_loss, want), (got_loss, got) = grads["cpu"], grads["card"]
    assert abs(float(got_loss) - float(want_loss)) <= 1e-3 * float(want_loss)
    for (k, g), (_, w) in zip(flatten_with_paths(got),
                              flatten_with_paths(want)):
        assert g.device.type == "cuda"
        assert rel_max_err(g, w) <= 2e-2, k
    step = build_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=1,
                                             total_steps=10))
    opt = adamw_init(p_dev)
    assert opt.step.device.type == "cuda"
    losses = []
    for _ in range(4):
        p_dev, opt, m = step(p_dev, opt, tokens)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_cuda_checkpoint_snapshot_and_bf16_roundtrip(cuda_device, tmp_path):
    """``save_async`` of card tensors (bf16, f32, int32, an AdamWState)
    copies them to the host before it returns: an in-place update right
    after does not reach the file, and ``restore`` puts the saved bits
    back on the card."""
    from repro_torch.train import AdamWState
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import flatten_with_paths

    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn(64, 32, generator=g, device=cuda_device)
    tree = {"params": {"w": w.to(torch.bfloat16), "b": w[0].clone()},
            "opt": AdamWState(torch.tensor(3, dtype=torch.int32,
                                           device=cuda_device),
                              {"w": w.clone()}, {"w": w.abs()})}
    want = [t.clone() for _, t in flatten_with_paths(tree)]
    thread = ckpt.save_async(str(tmp_path), 3, tree, shards=2)
    for _, t in flatten_with_paths(tree):
        t.add_(1)
    thread.join()
    ckpt.wait_pending()
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 3
    for (_, got), w0 in zip(flatten_with_paths(restored), want):
        assert got.device.type == "cuda" and got.dtype == w0.dtype
        assert torch.equal(got, w0)


@pytest.mark.cuda
def test_cuda_kernel_impls_refuse_gradients(cuda_device):
    """A GCN layer through a kernel impl raises when gradients are
    required (the kernels have no backward); ``impl="reference"`` trains
    on the card."""
    import dataclasses

    from repro_torch.models.gcn import gcn_loss, init_params, plan_for_config
    from repro_torch.train import value_and_grad

    adj = random_power_law_csr(256, 256, 2000, alpha=2.8, seed=0)
    feats = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 16)).astype(np.float32), device=cuda_device)
    labels = torch.as_tensor(np.arange(256) % 4, device=cuda_device)
    for impl, fused in (("cuda", False), ("cuda_sparse", False),
                        ("cuda", True)):
        cfg = GCNConfig(in_dim=16, hidden_dim=8, out_dim=4, spmm_impl=impl)
        graph = GCNGraph.build(adj, cfg)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             cuda_device)
        plan = dataclasses.replace(plan_for_config(cfg), fused=fused)
        with pytest.raises(RuntimeError, match="has no backward"):
            value_and_grad(lambda p: gcn_loss(p, graph, feats, labels, cfg,
                                              plan=plan))(params)
    cfg = GCNConfig(in_dim=16, hidden_dim=8, out_dim=4)
    graph = GCNGraph.build(adj, cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    loss, grads = value_and_grad(lambda p: gcn_loss(p, graph, feats, labels,
                                                    cfg))(params)
    assert np.isfinite(float(loss))
    assert grads["layer_0"]["w"].device.type == "cuda"


# -- the simulator and flexvector_spmm on the card ------------------------------

SIM_STATS = ("nz_block", "nz_col_rank", "nz_col", "nz_rb", "br_start",
             "br_block", "br_rnz", "b_start", "b_nnz_start", "b_nnz",
             "b_ncols", "b_nrows")
SIM_GRAPHS = [(200, 1500, 2.1, 0), (500, 6000, 2.6, 3), (64, 40, 2.1, 7),
              "cora"]


def _sim_graph(case):
    if case == "cora":
        from repro_torch.graphs.datasets import load_dataset

        ds = load_dataset("cora", seed=0, with_features=False)
        return ds.adj_norm, ds.spec.feature_dim
    n, nnz, alpha, seed = case
    return random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed), 64


def _sim_stats_equal(card, cpu):
    for name in ("tile", "n_rows", "n_cols", "nnz", "n_blocks"):
        assert getattr(card, name) == getattr(cpu, name), name
    assert card.device.type == "cuda"
    for name in SIM_STATS:
        a, b = getattr(card, name), getattr(cpu, name)
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


def _sim_results_equal(card, cpu):
    import dataclasses

    for f in dataclasses.fields(cpu):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SIM_GRAPHS, ids=str)
def test_cuda_label_propagation_matches_cpu(cuda_device, case):
    from repro_torch.graphs.partition import label_propagation_permutation

    adj, _ = _sim_graph(case)
    for iters in (1, 5):
        np.testing.assert_array_equal(
            label_propagation_permutation(adj, iters, device=cuda_device),
            label_propagation_permutation(adj, iters, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("case", SIM_GRAPHS, ids=str)
def test_cuda_block_stats_and_alg2_match_cpu(cuda_device, case, tile):
    from repro_torch.sim import alg2_best_k, compute_block_stats

    adj, _ = _sim_graph(case)
    card = compute_block_stats(adj, tile, device=cuda_device)
    cpu = compute_block_stats(adj, tile, device="cpu")
    _sim_stats_equal(card, cpu)
    for mode in ("single", "double"):
        for tau, depth, pct in ((6, 12, 0.5), (4, 8, 1.0), (6, 32, 0.25)):
            a = alg2_best_k(card, tau, depth, mode=mode, pct=pct)
            b = alg2_best_k(cpu, tau, depth, mode=mode, pct=pct)
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    for g in (1, 6, 10_000):
        assert card.unique_group_loads(g) == cpu.unique_group_loads(g)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [dict(), dict(m=1), dict(double_vrf=False),
                                dict(flexible_k=False),
                                dict(vertex_cut=False)], ids=str)
@pytest.mark.parametrize("case", SIM_GRAPHS, ids=str)
def test_cuda_simulators_match_cpu(cuda_device, case, hw):
    from repro_torch.sim import (GROWConfig, HWConfig, compute_block_stats,
                                 simulate_flexvector, simulate_grow)

    adj, fdim = _sim_graph(case)
    card = compute_block_stats(adj, 16, device=cuda_device)
    cpu = compute_block_stats(adj, 16, device="cpu")
    _sim_results_equal(
        simulate_flexvector(adj, fdim, HWConfig(**hw), stats=card),
        simulate_flexvector(adj, fdim, HWConfig(**hw), stats=cpu))
    for stats in (True, False):
        _sim_results_equal(
            simulate_grow(adj, fdim, GROWConfig(m=hw.get("m", 6)),
                          stats=card if stats else None, device=cuda_device),
            simulate_grow(adj, fdim, GROWConfig(m=hw.get("m", 6)),
                          stats=cpu if stats else None, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("skip_empty", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_flexvector_spmm_matches_plain_version(cuda_device, precision,
                                                    skip_empty):
    """The wrapper launches its own kernel once at its own precision, and
    agrees with the same call on the CPU (the plain version) within the
    aggregation kernels' 1e-5."""
    from repro_torch.core.preprocessing import preprocess
    from repro_torch.kernels.ops import flexvector_spmm

    ell = preprocess(random_power_law_csr(300, 300, 3000, alpha=2.4, seed=2),
                     tau=6, tile_rows=16, pad_rows_to=128).ell
    dense = np.random.default_rng(1).standard_normal(
        (ell.n_dense_rows, 40)).astype(np.float32)
    name = "spmm_ell_sparse_grid" if skip_empty else "spmm_ell_dense_grid"
    if precision == "int8":
        name += "_scaled"
    fv.reset_launches()
    out = flexvector_spmm(ell, dense, skip_empty=skip_empty,
                          precision=precision, device=cuda_device)
    torch.cuda.synchronize()
    assert {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n} == {
        f"{name}@{precision}": 1}
    ref = flexvector_spmm(ell, dense, skip_empty=skip_empty,
                          precision=precision, device="cpu")
    assert rel_max_err(out, ref) <= 1e-5
