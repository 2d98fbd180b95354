"""The four FlexVector SpMM kernels: wrappers, plain versions, launch counts.

Each public kernel function keeps the contract of its TPU counterpart in
``repro.kernels.flexvector_spmm`` (same arguments, operands padded to
block multiples, ``PAD_COL = -1`` slots dropping out):

* :func:`spmm_ell_dense_grid`  — aggregation over every k-tile;
* :func:`spmm_ell_sparse_grid` — aggregation over the scheduled
  (row block, k-tile) pairs of ``plan_kernel_grid``, passed as one k-tile
  bitmap per row block (:func:`schedule_tile_bitmaps`, built once per
  graph) instead of the TPU kernel's ``(rb_ids, kb_ids, first)`` steps;
* :func:`spmm_ell_fused_dense_grid`  — one GCN layer ``A (X W + b)``;
* :func:`spmm_ell_fused_sparse_grid` — the fused layer over the k-tiles
  listed in ``kb_ids`` (``plan_fused_k_schedule``; ``-1`` = no-op step).

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
from repro_torch.kernels.ref import PAD_COL, spmm_ell_ref

#: Launches of each CUDA kernel in this process, bumped only where a
#: wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {
    "spmm_ell_dense_grid": 0,
    "spmm_ell_sparse_grid": 0,
    "spmm_ell_fused_dense_grid": 0,
    "spmm_ell_fused_sparse_grid": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- library binding ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # cols, vals, dense, out, R, tau, K, F, BR, BK, BF, stream
    "fv_spmm_dense_grid": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    # cols, vals, dense, out, tile_bitmaps, R, tau, K, F, BR, BK, BF, stream
    "fv_spmm_sparse_grid": [_P] * 5 + [_I] * 7 + [_P],
    # cols, vals, x, w, b, out, R, tau, K, F_in, F_out, k_real, BK, stream
    "fv_fused_dense_grid": [_P] * 6 + [_I] * 7 + [_P],
    # cols, vals, x, w, b, out, kb_ids, n_steps,
    # R, tau, K, F_in, F_out, k_real, BK, stream
    "fv_fused_sparse_grid": [_P] * 7 + [_I] * 8 + [_P],
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


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call C function ``fn`` on ``device``'s current stream; count it."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(lib, fn)(*ptrs, stream)
    if rc != 0:
        msg = lib.fv_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1


# -- argument checks -----------------------------------------------------------


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                  device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ell(cols, vals) -> torch.device:
    dev = cols.device if isinstance(cols, torch.Tensor) else None
    _check_tensor("cols", cols, torch.int32, 2, dev)
    _check_tensor("vals", vals, torch.float32, 2, dev)
    if vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != cols {tuple(cols.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_padded(r: int, k: int, f: int, block_rows: int, block_k: int,
                  block_f: int) -> None:
    if r % block_rows or k % block_k or f % block_f:
        raise ValueError("operands must be padded to block multiples")


def _check_fused(cols, vals, x, w, b, block_rows, block_k, block_f, k_real):
    dev = _check_ell(cols, vals)
    _check_tensor("x", x, torch.float32, 2, dev)
    _check_tensor("w", w, torch.float32, 2, dev)
    _check_tensor("b", b, torch.float32, 2, dev)
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
def _full_f32_matmul():
    """Matmuls at full f32 (no TF32) inside, the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- B1: dense grid ------------------------------------------------------------------


def spmm_ell_dense_grid_plain(cols, vals, dense, *, block_rows=128,
                              block_k=128, block_f=128) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_dense_grid` (block sizes unused)."""
    keep = _counted(cols, dense.shape[0])
    return spmm_ell_ref(torch.where(keep, cols, PAD_COL), vals, dense)


def spmm_ell_dense_grid(
    cols: torch.Tensor,   # (R, tau) int32, PAD_COL = -1 padding
    vals: torch.Tensor,   # (R, tau) float32
    dense: torch.Tensor,  # (K, F) float32
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
) -> torch.Tensor:
    """Sub-row products ``out[r] = sum_t vals[r,t] dense[cols[r,t]]``, (R, F)."""
    dev = _check_ell(cols, vals)
    _check_tensor("dense", dense, torch.float32, 2, dev)
    r, tau = cols.shape
    k, f = dense.shape
    _check_padded(r, k, f, block_rows, block_k, block_f)
    if dev.type == "cpu":
        return spmm_ell_dense_grid_plain(cols, vals, dense)
    out = torch.empty(r, f, dtype=torch.float32, device=dev)
    if r and f:
        _launch("spmm_ell_dense_grid", "fv_spmm_dense_grid", dev,
                cols, vals, dense, out, r, tau, k, f,
                block_rows, block_k, block_f)
    return out


# -- B2: sparse grid -----------------------------------------------------------------


def spmm_ell_sparse_grid_plain(cols, vals, dense, tile_bitmaps, *,
                               block_rows=128, block_k=128,
                               block_f=128) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_sparse_grid`: each row block counts
    only the ELL slots whose k-tile is set in its bitmap."""
    keep = _counted(cols, dense.shape[0]) & _tile_counted(
        tile_bitmaps, cols, block_rows, block_k)
    return spmm_ell_ref(torch.where(keep, cols, PAD_COL), vals, dense)


def spmm_ell_sparse_grid(
    cols: torch.Tensor,
    vals: torch.Tensor,
    dense: torch.Tensor,
    tile_bitmaps: torch.Tensor,   # (R / BR, ceil(K / BK / 32)) int32
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
) -> torch.Tensor:
    """Sub-row products over the (rb, kb) steps of a block-skipping schedule,
    given as :func:`schedule_tile_bitmaps` of its steps."""
    dev = _check_ell(cols, vals)
    _check_tensor("dense", dense, torch.float32, 2, dev)
    _check_tensor("tile_bitmaps", tile_bitmaps, torch.int32, 2, dev)
    r, tau = cols.shape
    k, f = dense.shape
    _check_padded(r, k, f, block_rows, block_k, block_f)
    want = (r // block_rows, _bitmap_words(k // block_k))
    if tuple(tile_bitmaps.shape) != want:
        raise ValueError(f"tile_bitmaps must be (R/BR, ceil(K/BK/32)) = "
                         f"{want}, got {tuple(tile_bitmaps.shape)}")
    kw = dict(block_rows=block_rows, block_k=block_k, block_f=block_f)
    if dev.type == "cpu":
        return spmm_ell_sparse_grid_plain(cols, vals, dense, tile_bitmaps,
                                          **kw)
    out = torch.empty(r, f, dtype=torch.float32, device=dev)
    if r and f:
        _launch("spmm_ell_sparse_grid", "fv_spmm_sparse_grid", dev,
                cols, vals, dense, out, tile_bitmaps, r, tau, k, f,
                block_rows, block_k, block_f)
    return out


# -- B3: fused dense grid -------------------------------------------------------------


def spmm_ell_fused_dense_grid_plain(cols, vals, x, w, b, *, block_rows=128,
                                    block_k=128, block_f=128,
                                    k_real=None) -> torch.Tensor:
    """Plain version of :func:`spmm_ell_fused_dense_grid`: materializes
    ``x @ w + b`` (full f32, no TF32), zeroes rows >= ``k_real``, gathers."""
    k = x.shape[0]
    k_real = k if k_real is None else k_real
    with _full_f32_matmul():
        xw = torch.matmul(x, w) + b
    xw[k_real:] = 0.0
    keep = _counted(cols, k)
    return spmm_ell_ref(torch.where(keep, cols, PAD_COL), vals, xw)


def spmm_ell_fused_dense_grid(
    cols: torch.Tensor,   # (R, tau) int32, PAD_COL = -1 padding
    vals: torch.Tensor,   # (R, tau) float32
    x: torch.Tensor,      # (K, F_in) layer input, K % block_k == 0
    w: torch.Tensor,      # (F_in, F_out) layer weight, F_out % block_f == 0
    b: torch.Tensor,      # (1, F_out) layer bias
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    k_real: Optional[int] = None,   # rows of x that are real (rest padding)
) -> torch.Tensor:
    """One GCN layer ``A (x @ w + b)`` in one launch, (R, F_out).

    Rows >= ``k_real`` of ``x @ w + b`` count as zero.  The intermediate
    ``x @ w + b`` is never written to device memory.
    """
    dev, k_real = _check_fused(cols, vals, x, w, b, block_rows, block_k,
                               block_f, k_real)
    r, tau = cols.shape
    k, f_in = x.shape
    f_out = w.shape[1]
    if dev.type == "cpu":
        return spmm_ell_fused_dense_grid_plain(cols, vals, x, w, b,
                                               k_real=k_real)
    out = torch.empty(r, f_out, dtype=torch.float32, device=dev)
    if r and f_out:
        _launch("spmm_ell_fused_dense_grid", "fv_fused_dense_grid", dev,
                cols, vals, x, w, b, out, r, tau, k, f_in, f_out, k_real,
                block_k)
    return out


# -- B4: fused sparse grid ------------------------------------------------------------


def spmm_ell_fused_sparse_grid_plain(cols, vals, x, w, b, kb_ids, *,
                                     block_rows=128, block_k=128,
                                     block_f=128, k_real=None) -> torch.Tensor:
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
        torch.where(keep, cols, PAD_COL), vals, x, w, b, k_real=k_real)


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
) -> torch.Tensor:
    """The fused layer over the k-tiles listed in ``kb_ids``.

    ``kb_ids`` comes from ``plan_fused_k_schedule``; ``-1`` entries are
    no-op steps (the sharded path pads per-shard schedules with them).
    """
    dev, k_real = _check_fused(cols, vals, x, w, b, block_rows, block_k,
                               block_f, k_real)
    _check_tensor("kb_ids", kb_ids, torch.int32, 1, dev)
    n_steps = kb_ids.shape[0]
    r, tau = cols.shape
    k, f_in = x.shape
    f_out = w.shape[1]
    if dev.type == "cpu":
        return spmm_ell_fused_sparse_grid_plain(
            cols, vals, x, w, b, kb_ids, block_rows=block_rows,
            block_k=block_k, block_f=block_f, k_real=k_real)
    out = torch.empty(r, f_out, dtype=torch.float32, device=dev)
    if r and f_out:
        _launch("spmm_ell_fused_sparse_grid", "fv_fused_sparse_grid", dev,
                cols, vals, x, w, b, out, kb_ids, n_steps, r, tau, k, f_in,
                f_out, k_real, block_k)
    return out


#: Each kernel's plain PyTorch version, by kernel name.
PLAIN = {
    "spmm_ell_dense_grid": spmm_ell_dense_grid_plain,
    "spmm_ell_sparse_grid": spmm_ell_sparse_grid_plain,
    "spmm_ell_fused_dense_grid": spmm_ell_fused_dense_grid_plain,
    "spmm_ell_fused_sparse_grid": spmm_ell_fused_sparse_grid_plain,
}


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
