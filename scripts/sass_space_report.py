#!/usr/bin/env python3
"""Count, per kernel of one built library, the shared-memory accesses by
address space in its SASS.

    python3 scripts/sass_space_report.py [name] [--filter scan_i8]

Builds ``rag_challenge_2_tpu_torch/csrc/<name>.cu`` (default
``stream_topk``) and reads ``cuobjdump -sass`` of the library.  A kernel
whose shared-memory pointer kept its address space loads and stores with
``LDS`` / ``STS``; one that lost it (a pointer made by integer arithmetic)
uses generic ``LD`` / ``ST``, which are slower.  Prints one line per
kernel whose name contains ``--filter``: the counts of LDS, STS, generic
LD and generic ST, then one JSON line with all of them.  It takes the
package from the checkout it sits in and needs ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OPS = {"LDS": r"\bLDS(\.|\s)", "STS": r"\bSTS(\.|\s)",
       "LD": r"\bLD\.E", "ST": r"\bST\.E"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", default="stream_topk")
    ap.add_argument("--filter", default="scan_i8")
    args = ap.parse_args(argv)

    from rag_challenge_2_tpu_torch.utils import kernels

    kernels.build_all([args.name])
    lib = kernels.BUILD_DIR / f"lib{args.name}.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if args.filter in m.group(1) else None
            if name:
                out[name] = dict.fromkeys(OPS, 0)
        elif name:
            for op, pat in OPS.items():
                out[name][op] += bool(re.search(pat, line))
    for name, c in sorted(out.items()):
        print(f"{args.name} {name[:70]}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    print(json.dumps({"library": str(lib), "kernels": out}))


if __name__ == "__main__":
    main()
