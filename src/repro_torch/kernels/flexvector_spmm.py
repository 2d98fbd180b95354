"""The FlexVector SpMM kernels: wrappers, plain versions, launch counts.

Each public kernel function keeps the contract of its TPU counterpart in
``repro.kernels.flexvector_spmm`` (same arguments, operands padded to
block multiples, ``PAD_COL = -1`` slots dropping out, ``scales=`` for
int8 values dequantized on load, ``cast_xw`` for the fused layer's bf16
rounding of ``X W + b``):

* :func:`spmm_ell_dense_grid`  — aggregation over every k-tile;
* :func:`spmm_ell_sparse_grid` — aggregation over the scheduled
  (row block, k-tile) pairs of ``plan_kernel_grid``, passed as one k-tile
  bitmap per row block (:func:`schedule_tile_bitmaps`, built once per
  graph) instead of the TPU kernel's ``(rb_ids, kb_ids, first)`` steps;
* :func:`spmm_ell_fused_dense_grid`  — one GCN layer ``A (X W + b)``;
* :func:`spmm_ell_fused_sparse_grid` — the fused layer over the k-tiles
  listed in ``kb_ids`` (``plan_fused_k_schedule``; ``-1`` = no-op step).

Storage types, as ``repro.exec`` produces them (any other combination
raises, naming it):

* f32 values, f32 dense (or f32 ``x``/``w``); the aggregation kernels
  also take a bf16 dense operand beside f32 values, which the wrapper
  widens to f32 (exact) before it launches the f32 instantiation;
* bf16 values, bf16 dense (bf16 ``x``/``w``, ``cast_xw=torch.bfloat16``);
* int8 values with one f32 scale per row block (``scales``), bf16 dense
  (bf16 ``x``/``w``, ``cast_xw=torch.bfloat16``);
* aggregation only: int8 values without scales, int8 dense, summed and
  stored in int32 with integer arithmetic, so the answer is exact (the
  reference's integer accumulator, ``_acc_dtype``).

``out_dtype`` is the reference's accumulator override.  Its default is
int32 beside an int8 dense operand, else f32.  The aggregation kernels
store f32 or bf16 beside float operands (bf16 rounds each finished f32
sum once, in the kernel) and int32 beside int8 ones.  The fused kernels
sum into f32 with atomics, so under ``out_dtype=torch.bfloat16`` their
wrappers round the finished f32 output to bf16 once.  Biases are f32 and
every float sum is f32.  An int8 launch with scales counts under the
kernel's name with ``_scaled`` appended (the TPU kernels' ``_scaled``
variants); a bf16 or an exact int8 launch counts under the kernel's own
name.  :data:`PRECISION_LAUNCHES` counts them apart by the values'
precision, with ``->bf16`` or ``->int32`` appended for a store other
than f32 (``spmm_ell_dense_grid@int8->int32``).

On CUDA tensors a wrapper launches its kernel from
``csrc/flexvector_spmm.cu`` (built at first use) and counts the launch in
:data:`LAUNCHES`; a failed launch raises.  On CPU tensors it runs the
plain PyTorch version beside it (``*_plain``), which the tests hold
against the JAX kernels and ``chip_smoke.py`` holds against the CUDA
kernels.  The plain versions also accept CUDA tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import PAD_COL, dequantize_rows, spmm_ell_ref

#: Launches of each CUDA kernel in this process, bumped only where a
#: wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {
    "spmm_ell_dense_grid": 0,
    "spmm_ell_sparse_grid": 0,
    "spmm_ell_fused_dense_grid": 0,
    "spmm_ell_fused_sparse_grid": 0,
    "spmm_ell_dense_grid_scaled": 0,
    "spmm_ell_sparse_grid_scaled": 0,
    "spmm_ell_fused_dense_grid_scaled": 0,
    "spmm_ell_fused_sparse_grid_scaled": 0,
}

# Value types of the C interface by (values, dense operand or x / w)
# dtype: the code and the precision's name.  Code 2 takes scales, code 3
# none.
_VTYPE = {
    (torch.float32, torch.float32): (0, "f32"),
    (torch.bfloat16, torch.bfloat16): (1, "bf16"),
    (torch.int8, torch.bfloat16): (2, "int8"),
    (torch.int8, torch.int8): (3, "int8"),
}
# Store types of the aggregation kernels' output: the C interface's code.
_OTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_STORE_NAME = {torch.bfloat16: "bf16", torch.int32: "int32"}

#: The aggregation kernels' instantiations beyond each precision's f32
#: store, by :data:`PRECISION_LAUNCHES` suffix and the name they count
#: under: the bf16 store of f32, bf16 and scaled int8 values, and the
#: exact int8 x int8 -> int32 product.
STORE_PRECISIONS = {
    "f32->bf16": "", "bf16->bf16": "", "int8->bf16": "_scaled",
    "int8->int32": "",
}

#: The same launches by the precision of the values, ``"<name>@<precision>"``
#: (a bf16 launch counts under the f32 kernel's name in :data:`LAUNCHES`
#: and apart from it only here), ``->bf16`` / ``->int32`` appended for the
#: aggregation kernels' other stores.
PRECISION_LAUNCHES: Dict[str, int] = {
    f"{name}@{precision}": 0
    for name in LAUNCHES
    for precision in (("int8",) if name.endswith("_scaled")
                      else ("f32", "bf16"))
}
PRECISION_LAUNCHES.update({
    f"{base}{suffix}@{precision}": 0
    for base in ("spmm_ell_dense_grid", "spmm_ell_sparse_grid")
    for precision, suffix in STORE_PRECISIONS.items()
})

#: Rows of ``X W + b`` one CTA of the fused kernels forms; the fused slot
#: lists (:func:`column_slots`) group ELL slots by it.  Must equal
#: ``kXwRows`` in ``csrc/flexvector_spmm.cu``.
XW_TILE_ROWS = 64

#: The rest of a fused CTA's tile: output columns (``kXwCols``), the depth
#: of one chunk of ``F_in`` (``kXwDepth``) and the chunks in flight
#: (``kStages``) in ``csrc/flexvector_spmm.cu``.
XW_TILE_COLS = 128
XW_CHUNK_DEPTH = 32
XW_STAGES = 3

#: The kernels load rows of ``x``, ``w`` and the dense operand in 16-byte
#: pieces, so each row must start on a 16-byte boundary.
_ROW_ALIGN_BYTES = 16

#: Bytes of the dense operand one aggregation slab may hold
#: (:func:`slab_width`): most of the H100's 50 MB L2, the rest left to the
#: ELL table and the output streaming through.  Chosen by measurement
#: (``scripts/aggregation_slabs.py``, ``PERF.md``): at Reddit a 41 MB slab
#: of 44 f32 columns beat two of 22 MB, and two 30 MB slabs of 32 columns
#: beat one of 60 MB and four of 15 MB; narrower slabs gather fewer bytes
#: per request, which costs more than the L2 misses they save.
L2_SLAB_BYTES = 44 * 2 ** 20


def reset_launches() -> None:
    for counts in (LAUNCHES, PRECISION_LAUNCHES):
        for key in counts:
            counts[key] = 0


# -- library binding ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # cols, vals, scales, dense, out, R, tau, K, F, BR, BK, slab_cols, vtype,
    # otype, stream
    "fv_spmm_dense_grid": [_P] * 5 + [_I] * 9 + [_P],
    # cols, vals, scales, dense, out, tile_bitmaps,
    # R, tau, K, F, BR, BK, slab_cols, vtype, otype, stream
    "fv_spmm_sparse_grid": [_P] * 6 + [_I] * 9 + [_P],
    # cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
    # n_chunks, tau, K, F_in, F_out, ldw, k_real, BR, BK, vtype, stream
    "fv_fused_dense_grid": [_P] * 10 + [_I] * 10 + [_P],
    # cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
    # n_chunks, kb_ids, n_steps,
    # tau, K, F_in, F_out, ldw, k_real, BR, BK, vtype, stream
    "fv_fused_sparse_grid": [_P] * 10 + [_I, _P] + [_I] * 10 + [_P],
}
_BOUND: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _BOUND
    if _BOUND is None:
        lib = _build.load_library()
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fv_error_string.argtypes = [ctypes.c_int]
        lib.fv_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _launch(name: str, precision: str, fn: str, device: torch.device,
            *args) -> None:
    """Call C function ``fn`` on ``device``'s current stream with ``args``
    (type codes included); count it under kernel ``name`` and under
    ``name@precision``."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]   # None passes as a null pointer
        rc = getattr(lib, fn)(*ptrs, stream)
    if rc != 0:
        msg = lib.fv_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1
    PRECISION_LAUNCHES[f"{name}@{precision}"] += 1


def _value_type(vals: torch.Tensor, operand: torch.Tensor) -> Tuple[int, str,
                                                                    str]:
    """``(code, name suffix, precision)`` of values beside a dense operand
    (or fused ``x``) of ``operand``'s dtype: ``_scaled`` for int8 values
    with scales."""
    code, precision = _VTYPE[(vals.dtype, operand.dtype)]
    return code, "_scaled" if code == 2 else "", precision


# -- argument checks -----------------------------------------------------------


def _check_tensor(name: str, t: torch.Tensor, dtype, ndim: int,
                  device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _no_autograd(name: str, *tensors) -> None:
    """Refuse operands that need a gradient: the kernels have no backward
    (nor do the reference's Pallas kernels), and on the CPU the plain
    versions would differentiate silently where the card could not."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: the kernel impls ('cuda', "
            f"'cuda_sparse', fused layers) run without autograd on every "
            f"device; differentiate through impl='reference', or call it "
            f"under torch.no_grad()")


def _check_ell(cols, vals, scales, dense=None) -> torch.device:
    """ELL table + int8 scales; returns the device.  ``scales`` goes with
    int8 values, and int8 values need them unless ``dense`` (the
    aggregation's operand) is int8 too."""
    dev = cols.device if isinstance(cols, torch.Tensor) else None
    _check_tensor("cols", cols, torch.int32, 2, dev)
    _check_tensor("vals", vals, (torch.float32, torch.bfloat16, torch.int8),
                  2, dev)
    if vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != cols {tuple(cols.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    exact = isinstance(dense, torch.Tensor) and dense.dtype == torch.int8
    if vals.dtype == torch.int8 and not exact:
        if scales is None:
            raise TypeError("int8 vals need scales= (one f32 per row block), "
                            "or an int8 dense operand for the exact int32 "
                            "product")
        _check_tensor("scales", scales, torch.float32, 1, dev)
    elif scales is not None:
        raise TypeError(f"scales= goes with int8 vals beside a bf16 operand, "
                        f"not {vals.dtype} vals beside "
                        f"{getattr(dense, 'dtype', 'x / w')}")
    return dev


def _operand_dtype(vals: torch.Tensor, scales=None) -> torch.dtype:
    """The dense operand's (or fused ``x``/``w``'s) dtype for these values:
    f32 beside f32 values, bf16 beside bf16 or scaled int8 values, int8
    beside int8 values without scales."""
    if vals.dtype == torch.int8 and scales is None:
        return torch.int8
    return torch.float32 if vals.dtype == torch.float32 else torch.bfloat16


def _dense_operand(vals: torch.Tensor, scales, dense,
                   dev: torch.device) -> torch.Tensor:
    """The aggregation's dense operand as its kernel takes it beside
    ``vals``: a bf16 operand beside f32 values is widened to f32 here
    (exact: every bf16 is an f32), so it runs the f32 instantiation, as the
    reference's kernels widen it to their f32 accumulator on load; any
    other dtype must be :func:`_operand_dtype`'s."""
    if (vals.dtype == torch.float32 and isinstance(dense, torch.Tensor)
            and dense.dtype == torch.bfloat16):
        dense = dense.float()
    _check_tensor("dense", dense, _operand_dtype(vals, scales), 2, dev)
    return dense


def _aggregation_store(name: str, dense: torch.Tensor,
                       out_dtype) -> torch.dtype:
    """The aggregation kernels' output dtype for ``out_dtype`` beside
    ``dense``: int32 beside an int8 operand (the only store it has), f32
    (the default) or bf16 beside a float one; anything else raises."""
    integer = not dense.dtype.is_floating_point
    default = torch.int32 if integer else torch.float32
    allowed = (torch.int32,) if integer else (torch.float32, torch.bfloat16)
    store = default if out_dtype is None else out_dtype
    if store not in allowed:
        raise TypeError(
            f"{name}: out_dtype={out_dtype} is not computed beside a "
            f"{dense.dtype} dense operand; its kernel stores "
            f"{', '.join(map(str, allowed))}")
    return store


def _fused_store(name: str, out_dtype) -> Optional[torch.dtype]:
    """``None`` for the fused kernels' f32 output, bf16 where the wrapper
    rounds the finished f32 output once; anything else raises."""
    if out_dtype in (None, torch.float32):
        return None
    if out_dtype == torch.bfloat16:
        return out_dtype
    raise TypeError(
        f"{name}: out_dtype={out_dtype} is not computed: the fused kernels "
        "sum into f32 with atomics and store f32, or bf16 by rounding the "
        "finished f32 output once")


def _check_padded(r: int, k: int, f: int, block_rows: int, block_k: int,
                  block_f: int) -> None:
    if r % block_rows or k % block_k or f % block_f:
        raise ValueError("operands must be padded to block multiples")


def _check_fused(cols, vals, x, w, b, block_rows, block_k, block_f, k_real,
                 scales, cast_xw):
    dev = _check_ell(cols, vals, scales)
    want = _operand_dtype(vals, scales)
    _check_tensor("x", x, want, 2, dev)
    _check_tensor("w", w, want, 2, dev)
    _check_tensor("b", b, torch.float32, 2, dev)
    want_cast = None if want == torch.float32 else torch.bfloat16
    if cast_xw != want_cast:
        raise TypeError(f"{vals.dtype} values take cast_xw={want_cast}, "
                        f"got {cast_xw}")
    k, f_in = x.shape
    f_out = w.shape[1]
    if w.shape[0] != f_in or tuple(b.shape) != (1, f_out):
        raise ValueError(
            f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} do "
            "not chain: expected w (F_in, F_out) and b (1, F_out)"
        )
    _check_padded(cols.shape[0], k, f_out, block_rows, block_k, block_f)
    k_real = k if k_real is None else int(k_real)
    if not 0 <= k_real <= k:
        raise ValueError(f"k_real={k_real} outside [0, {k}]")
    return dev, k_real


def _block_scales(scales: torch.Tensor, r: int,
                  block_rows: int) -> torch.Tensor:
    """One scale per row block of the padded table: trailing all-padding
    row blocks get 1.0 (their values are zero), extra scales are cut."""
    n_rb = r // block_rows
    if scales.shape[0] < n_rb:
        scales = torch.cat([scales, scales.new_ones(n_rb - scales.shape[0])])
    return scales[:n_rb].contiguous()


# -- row widths and column slabs ------------------------------------------------


def _piece_cols(dtype: torch.dtype) -> int:
    """Columns of ``dtype`` in one 16-byte piece."""
    return _ROW_ALIGN_BYTES // torch.empty(0, dtype=dtype).element_size()


def aligned_width(n: int, dtype: torch.dtype) -> int:
    """``n`` columns of ``dtype`` rounded up to whole 16-byte pieces."""
    per = _piece_cols(dtype)
    return -(-n // per) * per


def _zero_padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` as a contiguous (rows, cols) tensor on a 16-byte boundary: as
    it is where it already is one, else a fresh zero-padded copy."""
    if (tuple(t.shape) == (rows, cols) and t.is_contiguous()
            and t.data_ptr() % _ROW_ALIGN_BYTES == 0):
        return t
    out = t.new_zeros(rows, cols)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def slab_width(k: int, f: int, dtype: torch.dtype) -> int:
    """Columns per slab of the aggregation kernels' dense operand.

    The kernels walk the ``f`` columns of a ``(k, f)`` dense operand of
    ``dtype`` in slabs, one after the other, so that the rows they gather
    come from L2.  This takes the fewest slabs whose part of the operand
    (``k`` rows x slab width) fits :data:`L2_SLAB_BYTES`, and balances
    them: each is a whole number of 16-byte pieces, the last one may be
    narrower, and together they cover ``f`` exactly.  A slab is at least
    one piece wide, however large ``k``.
    """
    pieces = -(-f // _piece_cols(dtype))
    fit = max(1, L2_SLAB_BYTES // max(k * _ROW_ALIGN_BYTES, 1))
    n_slabs = max(1, -(-pieces // fit))
    return _piece_cols(dtype) * -(-pieces // n_slabs)


# -- shared masks ---------------------------------------------------------------


def _counted(cols: torch.Tensor, k: int) -> torch.Tensor:
    """ELL slots the dense grid counts: real columns inside [0, K)."""
    return (cols >= 0) & (cols < k)


def _tile_of(cols: torch.Tensor, block_k: int) -> torch.Tensor:
    return torch.where(cols >= 0, cols, 0).long() // block_k


def _bitmap_words(n_kb: int) -> int:
    return -(-n_kb // 32)


def schedule_tile_bitmaps(rb_ids, kb_ids, first, n_rb: int,
                          n_kb: int) -> np.ndarray:
    """The sparse-grid schedule as one k-tile bitmap per row block.

    ``(rb_ids, kb_ids, first)`` are the TPU kernel's steps
    (``plan_kernel_grid``'s ``pairs`` and ``first_k``), walked in order.  A
    run starts at a step with ``first != 0`` and lasts until the next such
    step.  A row block counts the k-tiles of the steps that name it inside
    the run of its last ``first`` step (the sum the TPU kernel leaves in
    the output); a row block with none counts nothing.  Bit ``kb % 32`` of
    word ``kb // 32`` in row ``rb`` is set for each counted tile.

    Host numpy, built once per graph.  Returns ``(n_rb, ceil(n_kb / 32))``
    int32.
    """
    rb = np.asarray(rb_ids, dtype=np.int64).ravel()
    kb = np.asarray(kb_ids, dtype=np.int64).ravel()
    is_first = np.asarray(first).ravel() != 0
    if not rb.shape == kb.shape == is_first.shape:
        raise ValueError("schedule arrays differ in length: "
                         f"{sorted({rb.size, kb.size, is_first.size})}")
    run = np.cumsum(is_first) - 1          # run of each step, -1 before any
    valid = (rb >= 0) & (rb < n_rb)
    last = np.full(n_rb, -1, dtype=np.int64)
    starts = np.flatnonzero(is_first & valid)
    np.maximum.at(last, rb[starts], run[starts])
    counted = valid & (kb >= 0) & (kb < n_kb) & (run >= 0)
    counted[counted] = run[counted] == last[rb[counted]]
    words = _bitmap_words(n_kb)
    listed = np.zeros((n_rb, words * 32), dtype=bool)
    listed[rb[counted], kb[counted]] = True
    packed = np.packbits(listed.reshape(n_rb, words, 32), axis=-1,
                         bitorder="little")
    return np.ascontiguousarray(
        packed.reshape(n_rb, words * 4).view("<i4").astype(np.int32))


def _tile_counted(tile_bitmaps: torch.Tensor, cols: torch.Tensor,
                  block_rows: int, block_k: int) -> torch.Tensor:
    """Per ELL slot: is its k-tile set in its row block's bitmap?"""
    n_kb = tile_bitmaps.shape[1] * 32
    tile = _tile_of(cols, block_k).clamp(max=max(n_kb - 1, 0))
    row_block = (torch.arange(cols.shape[0], device=cols.device)
                 // block_rows)[:, None]
    word = tile_bitmaps[row_block, tile >> 5].long()
    return ((word >> (tile & 31)) & 1) != 0


@contextlib.contextmanager
def full_f32_matmul():
    """Matmuls at full f32 (no TF32) inside, the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- fused slot lists --------------------------------------------------------------


#: The shortest chunk :func:`column_slots` cuts, unless the chunk ends its
#: group.
MIN_CHUNK_SLOTS = 256


def max_column_chunks(n_dense_rows: int, n_slots: int) -> int:
    """Most chunks :func:`column_slots` can cut from a table of ``n_slots``
    slots over ``n_dense_rows`` rows of ``X``: one per column group, plus
    one per :data:`MIN_CHUNK_SLOTS` slots."""
    return -(-n_dense_rows // XW_TILE_ROWS) + -(-n_slots // MIN_CHUNK_SLOTS)


def chunk_slots(counts: np.ndarray) -> int:
    """Most slots one chunk of :func:`column_slots` takes, given the slots
    of each column group (``counts``): 4x the mean per non-empty group,
    at least :data:`MIN_CHUNK_SLOTS`, a multiple of 32."""
    mean = int(counts.sum()) / max(int(np.count_nonzero(counts)), 1)
    return max(MIN_CHUNK_SLOTS, 32 * -(-int(4 * mean) // 32))


def fused_smem_bytes(dtype: torch.dtype, n_kb: int = 0) -> int:
    """Dynamic shared memory of one fused CTA for ``x`` / ``w`` of
    ``dtype``: the ring of :data:`XW_STAGES` (X chunk, W chunk) pairs or
    the (64, 128) tile of ``X W + b``, whichever is larger, rows padded by
    16 bytes (``FusedSmem`` in the CUDA source), plus the sparse grid's
    bitmap of ``n_kb`` k-tiles (0 for the dense grid)."""
    size = torch.empty(0, dtype=dtype).element_size()
    vec = _ROW_ALIGN_BYTES // size
    stage = (XW_TILE_ROWS * (XW_CHUNK_DEPTH + vec)
             + XW_CHUNK_DEPTH * (XW_TILE_COLS + vec))
    ring = XW_STAGES * stage * size
    tile = XW_TILE_ROWS * (XW_TILE_COLS + vec) * size
    return max(ring, tile) + 4 * _bitmap_words(n_kb)


def column_slots(cols, n_dense_rows: int):
    """The ELL table transposed by column group, for the fused kernels: one
    chunk of slots per CTA.

    Group ``g`` holds the slots whose column lies in rows ``[g * 64, (g +
    1) * 64)`` of ``X`` (:data:`XW_TILE_ROWS`, the kernel's tile height);
    PAD_COL slots and columns ``>= n_dense_rows`` are left out.  A group's
    slots (flat indices ``r * tau + t``, in flat order) are cut into chunks
    of at most 4x the mean per non-empty group (at least 256, a multiple
    of 32), so that a hub column's group does not leave one CTA walking
    most of the table; each chunk recomputes its group's tile of
    ``X W + b``.

    Host numpy, built once per graph.  Returns three int32 arrays:
    ``group`` (the group of each chunk), ``start`` (chunk ``i`` is
    ``ids[start[i]:start[i + 1]]``, one longer than ``group``) and ``ids``.
    """
    if isinstance(cols, torch.Tensor):
        cols = cols.cpu().numpy()
    c = np.asarray(cols).reshape(-1)
    if c.size >= 2 ** 31:
        raise ValueError("ELL table too large for int32 slot indices")
    ids = np.flatnonzero((c >= 0) & (c < n_dense_rows))
    group = c[ids] // XW_TILE_ROWS
    ids = ids[np.argsort(group, kind="stable")]
    counts = np.bincount(group, minlength=-(-n_dense_rows // XW_TILE_ROWS))
    max_chunk = chunk_slots(counts)
    per_group = -(-counts // max_chunk)                 # chunks per group
    chunk_group = np.repeat(np.arange(counts.size), per_group)
    # chunk j of group g starts at offset(g) + j * max_chunk
    first = np.concatenate([[0], np.cumsum(per_group)[:-1]])
    within = np.arange(chunk_group.size) - first[chunk_group]
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
    start = np.append(offset[chunk_group] + within * max_chunk, ids.size)
    return (chunk_group.astype(np.int32), start.astype(np.int32),
            ids.astype(np.int32))


# -- B1 / B1s: dense grid ---------------------------------------------------------


def _aggregate(name, fn, cols, vals, scales, dense, tile_bitmaps,
               block_rows, block_k, store) -> torch.Tensor:
    """Launch aggregation kernel ``fn`` over ``dense``'s columns in 16-byte
    pieces and L2-sized slabs; returns the (R, F) output in ``store``."""
    r, tau = cols.shape
    k, f = dense.shape
    fa = aligned_width(f, dense.dtype)
    dense = _zero_padded(dense, k, fa)
    out = torch.empty(r, fa, dtype=store, device=cols.device)
    if r and f:
        vtype, suffix, precision = _value_type(vals, dense)
        if store in _STORE_NAME:
            precision += "->" + _STORE_NAME[store]
        sched = () if tile_bitmaps is None else (tile_bitmaps,)
        _launch(name + suffix, precision, fn, cols.device, cols, vals,
                scales, dense, out, *sched, r, tau, k, fa, block_rows,
                block_k, slab_width(k, fa, dense.dtype), vtype,
                _OTYPE[store])
    return out if fa == f else out[:, :f]


def spmm_ell_dense_grid_plain(cols, vals, dense, *, block_rows=128,
                              block_k=128, block_f=128, scales=None,
                              out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_dense_grid`: int8 values with
    scales are dequantized (``float(q) * scale``); float operands are
    widened to f32 and summed there, then rounded to ``out_dtype`` once;
    int8 values beside an int8 operand are summed in int32, exactly."""
    if scales is not None:
        vals = dequantize_rows(vals, scales, block_rows)
    keep = _counted(cols, dense.shape[0])
    acc = torch.float32 if dense.dtype.is_floating_point else torch.int32
    out = spmm_ell_ref(torch.where(keep, cols, PAD_COL), vals, dense,
                       out_dtype=acc)
    return out if out_dtype is None else out.to(out_dtype)


def spmm_ell_dense_grid(
    cols: torch.Tensor,   # (R, tau) int32, PAD_COL = -1 padding
    vals: torch.Tensor,   # (R, tau) float32, bfloat16 or int8
    dense: torch.Tensor,  # (K, F) float32 / bfloat16 (f32 vals), bfloat16,
                          # or int8 (int8 vals without scales)
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    out_dtype: Optional[torch.dtype] = None,
    scales: Optional[torch.Tensor] = None,  # int8: (R / BR,) f32 per row block
) -> torch.Tensor:
    """Sub-row products ``out[r] = sum_t vals[r,t] dense[cols[r,t]]``, (R, F)
    in ``out_dtype``: f32 by default, or bf16 (each f32 sum rounded once);
    int32, exact, for int8 values beside an int8 operand.

    The kernel gathers and writes only ``dense``'s own ``F`` columns,
    rounded up to whole 16-byte pieces (:func:`aligned_width`; a row that
    is not one is padded in a copy and the output cut back to ``F``), in
    L2-sized column slabs (:func:`slab_width`).  ``block_f`` only checks
    the padding; the dispatcher passes the real width rounded to 16 bytes.
    A bf16 ``dense`` beside f32 values is widened to f32 first
    (:func:`_dense_operand`).
    """
    _no_autograd("spmm_ell_dense_grid", cols, vals, dense, scales)
    dev = _check_ell(cols, vals, scales, dense)
    dense = _dense_operand(vals, scales, dense, dev)
    store = _aggregation_store("spmm_ell_dense_grid", dense, out_dtype)
    r = cols.shape[0]
    k, f = dense.shape
    _check_padded(r, k, f, block_rows, block_k, block_f)
    if scales is not None:
        scales = _block_scales(scales, r, block_rows)
    if dev.type == "cpu":
        return spmm_ell_dense_grid_plain(cols, vals, dense,
                                         block_rows=block_rows, scales=scales,
                                         out_dtype=store)
    return _aggregate("spmm_ell_dense_grid", "fv_spmm_dense_grid", cols,
                      vals, scales, dense, None, block_rows, block_k, store)


# -- B2 / B2s: sparse grid --------------------------------------------------------


def spmm_ell_sparse_grid_plain(cols, vals, dense, tile_bitmaps, *,
                               block_rows=128, block_k=128,
                               block_f=128, scales=None,
                               out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_sparse_grid`: each row block counts
    only the ELL slots whose k-tile is set in its bitmap."""
    keep = _counted(cols, dense.shape[0]) & _tile_counted(
        tile_bitmaps, cols, block_rows, block_k)
    return spmm_ell_dense_grid_plain(torch.where(keep, cols, PAD_COL), vals,
                                     dense, block_rows=block_rows,
                                     scales=scales, out_dtype=out_dtype)


def spmm_ell_sparse_grid(
    cols: torch.Tensor,
    vals: torch.Tensor,
    dense: torch.Tensor,
    tile_bitmaps: torch.Tensor,   # (R / BR, ceil(K / BK / 32)) int32
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    out_dtype: Optional[torch.dtype] = None,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sub-row products over the (rb, kb) steps of a block-skipping schedule,
    given as :func:`schedule_tile_bitmaps` of its steps; the kernel reads
    the columns, and takes ``out_dtype`` and the operand's dtype, as
    :func:`spmm_ell_dense_grid`'s does."""
    _no_autograd("spmm_ell_sparse_grid", cols, vals, dense, scales)
    dev = _check_ell(cols, vals, scales, dense)
    dense = _dense_operand(vals, scales, dense, dev)
    store = _aggregation_store("spmm_ell_sparse_grid", dense, out_dtype)
    _check_tensor("tile_bitmaps", tile_bitmaps, torch.int32, 2, dev)
    r = cols.shape[0]
    k, f = dense.shape
    _check_padded(r, k, f, block_rows, block_k, block_f)
    want = (r // block_rows, _bitmap_words(k // block_k))
    if tuple(tile_bitmaps.shape) != want:
        raise ValueError(f"tile_bitmaps must be (R/BR, ceil(K/BK/32)) = "
                         f"{want}, got {tuple(tile_bitmaps.shape)}")
    if scales is not None:
        scales = _block_scales(scales, r, block_rows)
    if dev.type == "cpu":
        return spmm_ell_sparse_grid_plain(
            cols, vals, dense, tile_bitmaps, block_rows=block_rows,
            block_k=block_k, block_f=block_f, scales=scales, out_dtype=store)
    return _aggregate("spmm_ell_sparse_grid", "fv_spmm_sparse_grid", cols,
                      vals, scales, dense, tile_bitmaps, block_rows, block_k,
                      store)


# -- B3 / B3s: fused dense grid ---------------------------------------------------


def pad_fused_operands(x: torch.Tensor, w: torch.Tensor, k_rows: int = 0,
                       f_out: int = 0):
    """``(x, w)`` zero-padded as the fused kernels take them, in one copy
    each and only where needed: ``x`` to at least ``k_rows`` rows, ``w`` to
    at least ``f_out`` columns, and the ``F_in`` columns of ``x`` and rows
    of ``w`` to whole 16-byte pieces, so that every row of ``x`` starts on
    a 16-byte boundary.  The zero columns of ``x`` meet zero rows of ``w``
    and add exact zeros to every sum."""
    f_in = aligned_width(w.shape[0], x.dtype)
    return (_zero_padded(x, max(k_rows, x.shape[0]), f_in),
            _zero_padded(w, f_in, max(f_out, w.shape[1])))


def _fused_operands(x: torch.Tensor, w: torch.Tensor):
    """``(x, w, ldw)`` as the fused kernels load them: padded by
    :func:`pad_fused_operands` (a no-op on the dispatcher's operands),
    with ``w``'s rows at a stride of ``ldw`` >= F_out columns, a 16-byte
    multiple."""
    x, w = pad_fused_operands(x, w)
    ldw = aligned_width(w.shape[1], w.dtype)
    return x, _zero_padded(w, w.shape[0], ldw), ldw


def _fused_out(slots, r: int, f_out: int, dev: torch.device):
    """The fused kernels' zeroed output and slot-list arguments: the
    kernels add into the output through the caller's :func:`column_slots`
    tensors, passed on as ``(group, start, ids, n_chunks)``."""
    if slots is None:
        raise ValueError("the fused kernels need slots=: column_slots of "
                         "cols, on the device")
    group, start, ids = slots
    for i, t in enumerate(slots):
        _check_tensor(f"slots[{i}]", t, torch.int32, 1, dev)
    if start.shape[0] != group.shape[0] + 1:
        raise ValueError(f"slots[1] must hold one more offset than slots[0] "
                         f"has chunks: {start.shape[0]} vs {group.shape[0]}")
    return (torch.zeros(r, f_out, device=dev),
            (group, start, ids, group.shape[0]))


def spmm_ell_fused_dense_grid_plain(cols, vals, x, w, b, *, block_rows=128,
                                    block_k=128, block_f=128, k_real=None,
                                    out_dtype=None, scales=None, cast_xw=None,
                                    slots=None) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_fused_dense_grid`: materializes
    ``x @ w + b`` (operands widened to f32, full f32 product, no TF32),
    zeroes rows >= ``k_real``, rounds to ``cast_xw`` if given, gathers in
    f32 and rounds the result to ``out_dtype`` once.  ``slots`` (the
    kernel's slot lists) is not needed here."""
    k = x.shape[0]
    k_real = k if k_real is None else k_real
    with full_f32_matmul():
        xw = torch.matmul(x.float(), w.float()) + b
    xw[k_real:] = 0.0
    if cast_xw is not None:
        xw = xw.to(cast_xw)
    return spmm_ell_dense_grid_plain(
        torch.where(_counted(cols, k), cols, PAD_COL), vals, xw,
        block_rows=block_rows, scales=scales, out_dtype=out_dtype)


def spmm_ell_fused_dense_grid(
    cols: torch.Tensor,   # (R, tau) int32, PAD_COL = -1 padding
    vals: torch.Tensor,   # (R, tau) float32, bfloat16 or int8
    x: torch.Tensor,      # (K, F_in) layer input, K % block_k == 0
    w: torch.Tensor,      # (F_in, F_out) layer weight, F_out % block_f == 0
    b: torch.Tensor,      # (1, F_out) layer bias, float32
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    k_real: Optional[int] = None,   # rows of x that are real (rest padding)
    out_dtype: Optional[torch.dtype] = None,  # f32 (None) or bf16
    scales: Optional[torch.Tensor] = None,  # int8: (R / BR,) f32
    cast_xw: Optional[torch.dtype] = None,  # bf16 under bf16/int8 values
    slots: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """One GCN layer ``A round(x @ w + b)`` in one launch, (R, F_out) f32.

    Rows >= ``k_real`` of ``x @ w + b`` count as zero; ``cast_xw`` rounds
    it (bf16 under bf16/int8 values).  The intermediate ``x @ w + b`` is
    never written to device memory.  ``slots`` is :func:`column_slots` of
    ``cols`` as int32 tensors on the device, which the kernel needs on CUDA
    (the dispatcher builds it once per graph and ``K``).

    The kernel sums into an f32 output with atomics, so under
    ``out_dtype=torch.bfloat16`` this wrapper rounds the finished f32
    output to bf16 once (one extra pass over it).  The reference's kernel
    adds each k-tile's f32 dot into its bf16 output block instead, rounding
    at every k-tile, so this answer is the more exact of the two.
    """
    _no_autograd("spmm_ell_fused_dense_grid", cols, vals, x, w, b, scales)
    round_to = _fused_store("spmm_ell_fused_dense_grid", out_dtype)
    dev, k_real = _check_fused(cols, vals, x, w, b, block_rows, block_k,
                               block_f, k_real, scales, cast_xw)
    r, tau = cols.shape
    k = x.shape[0]
    f_out = w.shape[1]
    if scales is not None:
        scales = _block_scales(scales, r, block_rows)
    if dev.type == "cpu":
        return spmm_ell_fused_dense_grid_plain(
            cols, vals, x, w, b, block_rows=block_rows, k_real=k_real,
            scales=scales, cast_xw=cast_xw, out_dtype=round_to)
    out, slots = _fused_out(slots, r, f_out, dev)
    x, w, ldw = _fused_operands(x, w)
    if r and f_out:
        vtype, suffix, precision = _value_type(vals, x)
        _launch("spmm_ell_fused_dense_grid" + suffix, precision,
                "fv_fused_dense_grid", dev, cols, vals, scales, x, w, b, out,
                *slots, tau, k, x.shape[1], f_out, ldw, k_real, block_rows,
                block_k, vtype)
    return out if round_to is None else out.to(round_to)


# -- B4 / B4s: fused sparse grid --------------------------------------------------


def spmm_ell_fused_sparse_grid_plain(cols, vals, x, w, b, kb_ids, *,
                                     block_rows=128, block_k=128,
                                     block_f=128, k_real=None, out_dtype=None,
                                     scales=None, cast_xw=None,
                                     slots=None) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_fused_sparse_grid`: the fused layer
    counting only ELL slots whose k-tile is listed in ``kb_ids``."""
    k = x.shape[0]
    n_kb = k // block_k
    kb = kb_ids.long()
    listed = torch.zeros(n_kb + 1, dtype=torch.bool, device=cols.device)
    listed[torch.where((kb >= 0) & (kb < n_kb), kb, n_kb)] = True
    keep = _counted(cols, k) & listed[:n_kb][
        _tile_of(cols, block_k).clamp(max=max(n_kb - 1, 0))]
    return spmm_ell_fused_dense_grid_plain(
        torch.where(keep, cols, PAD_COL), vals, x, w, b,
        block_rows=block_rows, k_real=k_real, scales=scales, cast_xw=cast_xw,
        out_dtype=out_dtype)


def spmm_ell_fused_sparse_grid(
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    kb_ids: torch.Tensor,   # (n_steps,) int32 k-tile per step, -1 = no-op
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    k_real: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    scales: Optional[torch.Tensor] = None,
    cast_xw: Optional[torch.dtype] = None,
    slots: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """The fused layer over the k-tiles listed in ``kb_ids``.

    ``kb_ids`` comes from ``plan_fused_k_schedule``; ``-1`` entries are
    no-op steps (the sharded path pads per-shard schedules with them).
    ``out_dtype`` as :func:`spmm_ell_fused_dense_grid`'s: bf16 rounds the
    finished f32 output once, in this wrapper.
    """
    _no_autograd("spmm_ell_fused_sparse_grid", cols, vals, x, w, b, scales)
    round_to = _fused_store("spmm_ell_fused_sparse_grid", out_dtype)
    dev, k_real = _check_fused(cols, vals, x, w, b, block_rows, block_k,
                               block_f, k_real, scales, cast_xw)
    _check_tensor("kb_ids", kb_ids, torch.int32, 1, dev)
    n_steps = kb_ids.shape[0]
    r, tau = cols.shape
    k = x.shape[0]
    f_out = w.shape[1]
    if scales is not None:
        scales = _block_scales(scales, r, block_rows)
    if dev.type == "cpu":
        return spmm_ell_fused_sparse_grid_plain(
            cols, vals, x, w, b, kb_ids, block_rows=block_rows,
            block_k=block_k, block_f=block_f, k_real=k_real, scales=scales,
            cast_xw=cast_xw, out_dtype=round_to)
    out, slots = _fused_out(slots, r, f_out, dev)
    x, w, ldw = _fused_operands(x, w)
    if r and f_out:
        vtype, suffix, precision = _value_type(vals, x)
        _launch("spmm_ell_fused_sparse_grid" + suffix, precision,
                "fv_fused_sparse_grid", dev, cols, vals, scales, x, w, b, out,
                *slots, kb_ids, n_steps, tau, k, x.shape[1], f_out, ldw,
                k_real, block_rows, block_k, vtype)
    return out if round_to is None else out.to(round_to)


#: Each kernel's wrapper and plain PyTorch version, by the name it counts
#: under in :data:`LAUNCHES` (``*_scaled``: the same function, int8 values
#: with scales).
KERNELS = {
    "spmm_ell_dense_grid": spmm_ell_dense_grid,
    "spmm_ell_sparse_grid": spmm_ell_sparse_grid,
    "spmm_ell_fused_dense_grid": spmm_ell_fused_dense_grid,
    "spmm_ell_fused_sparse_grid": spmm_ell_fused_sparse_grid,
}
KERNELS.update({f"{name}_scaled": fn for name, fn in list(KERNELS.items())})
PLAIN = {
    "spmm_ell_dense_grid": spmm_ell_dense_grid_plain,
    "spmm_ell_sparse_grid": spmm_ell_sparse_grid_plain,
    "spmm_ell_fused_dense_grid": spmm_ell_fused_dense_grid_plain,
    "spmm_ell_fused_sparse_grid": spmm_ell_fused_sparse_grid_plain,
}
PLAIN.update({f"{name}_scaled": fn for name, fn in list(PLAIN.items())})


def pad_operands(
    cols: torch.Tensor,
    vals: torch.Tensor,
    dense: torch.Tensor,
    block_rows: int,
    block_k: int,
    block_f: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """Pad to block multiples; ELL pad slots use PAD_COL so they mask out.

    Returns ``(cols, vals, dense, (r, f))`` with the unpadded sizes.  An
    operand already at a block multiple is returned as it is.
    """
    r, tau = cols.shape
    k, f = dense.shape
    rp = -(-r // block_rows) * block_rows
    kp = -(-k // block_k) * block_k
    fp = -(-f // block_f) * block_f
    if rp != r:
        cols = torch.nn.functional.pad(cols, (0, 0, 0, rp - r), value=PAD_COL)
        vals = torch.nn.functional.pad(vals, (0, 0, 0, rp - r))
    if (kp, fp) != (k, f):
        dense = torch.nn.functional.pad(dense, (0, fp - f, 0, kp - k))
    return cols.contiguous(), vals.contiguous(), dense.contiguous(), (r, f)
