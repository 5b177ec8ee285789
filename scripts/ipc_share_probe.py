#!/usr/bin/env python3
"""Which CUDA IPC shares of ``chip_smoke.py`` are never released.

    python3 scripts/ipc_share_probe.py        # on the card; as long as the smoke

Runs ``chip_smoke.main()`` with every CUDA IPC share of this process
recorded: the ref counter each share gets (its shared-memory file and
offset) and the world (``parallel/launch.run_ranks``) whose start shared
it.  After each world ends, and again at the end of the run, the counters
are read from ``/dev/shm`` (reading adds no share) and the nonzero ones are
printed with their world and size: a counter still above zero after its
world ended is a mapping of this process's memory that a rank never
released, and it makes this process print "Producer process has been
terminated before all shared CUDA tensors released" when it exits.  The
counter layout (int64 slots of a shared-memory file) is PyTorch's own.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import rag_challenge_2_tpu_torch.parallel as par  # noqa: E402
import rag_challenge_2_tpu_torch.parallel.launch as launch  # noqa: E402
import rag_challenge_2_tpu_torch.parallel.pretrain as ppre  # noqa: E402

RUN_RANKS = launch.run_ranks
SHARE = torch.UntypedStorage._share_cuda_
WORLD = ["(no world)"]
SHARES = []                      # (world, bytes, counter file, slot)


def recorded_share(self, *a, **k):
    r = SHARE(self, *a, **k)
    SHARES.append((WORLD[0], self.nbytes(), r[4], r[5]))
    return r


def counter(handle, slot):
    name = handle.decode() if isinstance(handle, bytes) else handle
    try:
        with open("/dev/shm/" + name.lstrip("/"), "rb") as f:
            f.seek(8 * slot)
            return int.from_bytes(f.read(8), "little", signed=True)
    except FileNotFoundError:
        return None              # every slot of the file released


def report(tag, shares):
    held = [(w, n, c) for w, n, h, s in shares if (c := counter(h, s))]
    print(f"ipc_share_probe {tag}: {len(shares)} shares, {len(held)} held "
          f"(world, bytes, counter): {held[:30]}", flush=True)


def probed_run_ranks(fn, world, backend, device, args=(), timeout=900.0):
    WORLD[0] = fn.__name__
    first = len(SHARES)
    try:
        return RUN_RANKS(fn, world, backend, device, args, timeout)
    finally:
        report(f"after {fn.__name__} ({backend}, {world} ranks)", SHARES[first:])
        WORLD[0] = "(no world)"


def main() -> int:
    torch.UntypedStorage._share_cuda_ = recorded_share
    launch.run_ranks = par.run_ranks = ppre.run_ranks = probed_run_ranks
    import chip_smoke

    rc = chip_smoke.main([])
    report("at the end of the run", SHARES)
    return rc


if __name__ == "__main__":
    sys.exit(main())
