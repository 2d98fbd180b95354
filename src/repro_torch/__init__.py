"""PyTorch + CUDA port of the FlexVector GCN system.

The layout mirrors the JAX package ``repro`` module for module
(``core``, ``graphs``, ``kernels``, ``exec``, ``dist``, ``models``), so
each port module sits where its reference counterpart does.  Host-side
preprocessing is numpy/scipy; tensors are ``torch``; the four FlexVector
SpMM kernels are CUDA C++ for Hopper (``csrc/flexvector_spmm.cu``),
built at first use and bound with ``ctypes``.

The port never imports ``jax`` or ``repro``.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``; on CPU tensors the
kernel wrappers run their plain PyTorch versions.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
