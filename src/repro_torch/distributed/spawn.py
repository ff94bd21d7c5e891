"""Run a function on every rank of a new process group, one spawned
process per rank (CUDA needs the ``spawn`` start method in children).

    results = run_ranks(fn, 2, init_file="/tmp/x/pg", args=(...))

Each child joins a ``torch.distributed`` group of ``world`` ranks through
``file://{init_file}`` (a path that does not exist yet: no TCP port to
collide with another run), calls ``fn(rank, *args)`` and sends its result
back; the parent returns the results in rank order.  If a rank raises, the
parent stops every child and raises with that rank's traceback (the other
ranks would wait in a collective); the group's own timeout is the same
``timeout``, so a rank stuck in a collective raises too.  ``fn`` must be
importable by name from a module that the children can import.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, Sequence

__all__ = ["run_ranks"]


def _rank_main(fn, rank: int, world: int, init_file: str, backend: str, threads: int,
               timeout: float, args: tuple, out) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, init_file: str, args: Sequence[Any] = (),
              backend: str = "gloo", threads: int = 0, timeout: float = 600.0) -> list:
    """``[fn(0, *args), …, fn(world - 1, *args)]``, each in its own process
    of one group (``threads``: torch's intra-op threads per child, 0 to
    leave the default)."""
    if os.path.exists(init_file):
        raise FileExistsError(f"init_file {init_file} exists: a process group needs a new path")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_file, backend, threads, timeout, tuple(args),
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive() and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with code(s) "
                                       f"{[procs[r].exitcode for r in dead]} without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world - len(results)} rank(s) gave no "
                                       f"result in {timeout:.0f}s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} raised:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in range(world)]
