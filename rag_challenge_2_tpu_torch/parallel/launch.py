"""Start a world of ranks on one host and run a rank program in each.

The JAX package needs no launcher: ``jax.devices()`` is one process that
sees every device, and a ``shard_map`` body is a per-device program inside
it.  In PyTorch a per-device program is a process, a rank of a
``torch.distributed`` world; :func:`run_ranks` is how the port makes one.

It spawns ``world`` processes (the ``spawn`` start method: a CUDA context
does not survive ``fork``), initialises the process group through a
``file://`` store in a fresh temporary directory (no TCP port to pick, so
concurrent worlds never collide), runs ``fn(device, *args)`` in every rank
and returns rank 0's result.  The device of a rank is stated, never
guessed:

* ``backend="nccl"``, ``device="cuda"``: rank r computes on ``cuda:r``,
  one card per rank, the deployment form.  NCCL refuses two ranks on one
  card, so a world larger than the card count raises here.
* ``backend="gloo"``, ``device="cuda"`` or ``"cuda:i"``: every rank
  computes on that one card (ranks share it; gloo stages the collectives'
  CUDA tensors through host memory).
* ``backend="gloo"``, ``device="cpu"``: every rank on the CPU, one thread
  each (``torch.set_num_threads(1)``), as the tests run.

CUDA tensors in ``args`` reach the ranks through CUDA IPC: each rank maps
the caller's memory, so a store is never copied per rank.  The caller keeps
them alive until :func:`run_ranks` returns, which it does.  A rank drops
its mapping as soon as ``fn`` returns (multiprocessing keeps a rank's
process object, and with it the arguments it was started with, until the
interpreter exits; a mapping still held then is never released, and the
caller warns at its own exit that its shared tensors were not released).
Rank 0's result comes back pickled, so return host objects (numbers, numpy
arrays, CPU tensors).
"""

from __future__ import annotations

import gc
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    """The device rank ``rank`` computes on (the rules of the module
    docstring)."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda" or dev.index not in (None, 0):
            raise ValueError("an nccl world takes device='cuda': rank r runs on cuda:r")
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def check_world(world: int, backend: str, device: str) -> None:
    """Raise unless ``world`` ranks of ``backend`` can run on ``device``
    here: NCCL needs a card per rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world < 1:
        raise ValueError(f"a world has at least one rank, got {world}")
    dev = torch.device(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.type != "cuda":
            raise ValueError("an nccl world computes on cards: device='cuda'")
        if world > cards:
            raise ValueError(
                f"nccl gives each rank its own card: {world} ranks, {cards} "
                "card(s) here (several ranks on one card take backend='gloo')")
        if not dist.is_nccl_available():
            raise ValueError("this PyTorch build has no NCCL")
    elif not dist.is_gloo_available():
        raise ValueError("this PyTorch build has no gloo")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device {device!r} asked for, and there is no card")


def _rank_main(rank: int, world: int, backend: str, device: str, init: str,
               timeout_s: float, fn: Callable, box: list, out) -> None:
    # the arguments come in a one-item list: taken out of it, the process
    # object no longer refers to them, and they go when this frame drops them
    args = box.pop()
    try:
        dev = rank_device(rank, backend, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        # one host: the loopback interface carries the bootstrap
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            payload = pickle.dumps(result) if rank == 0 else None
            del args, result
            gc.collect()                        # unmaps the caller's memory
        finally:
            dist.destroy_process_group()
        out.put((rank, "result", payload))
    except BaseException:                       # reported, then the rank exits
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str, device: str,
              args: Sequence = (), timeout: float = 900.0) -> Any:
    """Run ``fn(rank_device, *args)`` on every rank of a new ``world``-rank
    ``backend`` world and return rank 0's result.

    ``fn`` must be importable by name (a module-level function): each rank
    is a fresh interpreter.  A rank that raises ends the world: the other
    ranks are terminated and a ``RuntimeError`` carries the rank's
    traceback.  ``timeout`` (seconds) bounds the whole world, its
    collectives included; past it the ranks are killed and
    ``TimeoutError`` is raised.  The caller's CUDA memory that the ranks
    mapped is released before the call returns."""
    check_world(world, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rc2_world_")
    init = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device, init, timeout, fn,
                               [tuple(args)], out))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    reported: dict = {}
    try:
        for p in procs:
            p.start()
        while len(reported) < world:
            try:
                rank, kind, payload = out.get(timeout=1.0)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode is not None]
                if gone:
                    raise RuntimeError(
                        f"rank {gone[0]} exited with code {procs[gone[0]].exitcode} "
                        "before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the {world}-rank {backend} world did not finish in "
                        f"{timeout:.0f} s")
                continue
            if kind == "error":
                raise RuntimeError(_failure(world, rank, payload, out))
            reported[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return pickle.loads(reported[0])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()            # memory the ranks mapped


def _failure(world: int, rank: int, tb: str, out, grace: float = 2.0) -> str:
    """The message of a failed world: the first rank's traceback, then
    those that arrive within ``grace`` seconds (a rank's failure breaks
    its peers' collectives, so the first report need not be the cause)."""
    msgs = [f"rank {rank} of {world} failed:\n{tb}"]
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            r, kind, payload = out.get(timeout=max(0.01, end - time.monotonic()))
        except queue.Empty:
            break
        if kind == "error":
            msgs.append(f"rank {r} of {world} failed:\n{payload}")
    return "\n".join(msgs)
