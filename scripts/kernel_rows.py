#!/usr/bin/env python3
"""The kernel rows of chip-run outputs, as PERF.md's table gives them.

    python3 scripts/kernel_rows.py pubmed.out reddit.out ...

Reads the ``{"kernels": [...]}`` line of ``chip_smoke.py``'s output (each
kernel with its bf16 instantiation nested) or the ``{"dev_kernels": ...}``
line of ``scripts/chip_phases.py``'s, and prints one line a kernel
instantiation: ms, bound_ms (and what bounds it), plain_ms and library_ms
per forward (both layers), launches on the path that drove it (where the
output has them) and the library call.
"""

import json
import sys


def rows(path: str) -> dict:
    """``{key: {ms, bound_ms, bound_by, plain_ms, library_ms, launches,
    library_call}}`` from one output file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith('{"kernels"'):
                for k in json.loads(line)["kernels"]:
                    out[k["name"]] = k
                    if "bf16" in k:
                        out[k["name"] + "@bf16"] = k["bf16"]
            elif line.startswith('{"dev_kernels"'):
                out.update(json.loads(line)["dev_kernels"])
    return out


def main(paths) -> None:
    for path in paths:
        print(f"# {path}")
        for key, r in rows(path).items():
            print(f"{key:45s} ms {r['ms']:.4f} bound {r['bound_ms']:.6f} "
                  f"({r.get('bound_by', '?')}) plain {r['plain_ms']:.3f} "
                  f"library {r['library_ms']:.4f} launches "
                  f"{r.get('launches', '-')} [{r.get('library_call', '')}]")


if __name__ == "__main__":
    main(sys.argv[1:])
