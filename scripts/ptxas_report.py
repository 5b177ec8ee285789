#!/usr/bin/env python3
"""Build the port's CUDA kernels and print what ptxas reports for each
entry function: registers, spills and static shared memory.

    python3 scripts/ptxas_report.py [name ...]

Names are sources of ``rag_challenge_2_tpu_torch/csrc`` without ``.cu``
(all of them by default).  It needs ``nvcc``.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    from rag_challenge_2_tpu_torch.utils import kernels

    names = list(argv if argv is not None else sys.argv[1:]) or None
    kernels.build_all(names)
    for name, rep in sorted(kernels.build_logs.items()):
        entry = owner = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            f = re.search(r"Function properties for (\w+)", line)
            if m:
                entry = owner = m.group(1)
            elif f:
                owner = f.group(1)      # a device function's lines follow
            elif "registers" in line or ("spill" in line and owner == entry):
                print(f"{name} {entry}: {line.split(':', 1)[-1].strip()}")


if __name__ == "__main__":
    main()
