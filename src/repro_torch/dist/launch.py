"""Run a function on N local ranks, one process each (the counterpart of
the reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
device pool).

    results = run(fn, world=4, args=(...,), timeout_s=300)

``fn(rank, world, *args)`` runs in a fresh ``spawn``ed process per rank,
inside a default process group made from a ``FileStore`` under
``store_dir`` (a new temporary directory by default), so concurrent
launches never race for a port.  Its return values come back in rank
order (they must pickle: numbers, lists, CPU tensors).  A
rank that raises stops the run: the other ranks are terminated and the
error is raised here with the rank's traceback; so does a run that
outlasts ``timeout_s``.  The group is always ``gloo``: the ranks may
share one card, which NCCL refuses, and the collectives stage through
the host whatever gloo does not take on a card.  Nothing here builds a
kernel: a caller that runs card kernels builds them first
(``repro_torch.kernels.cuda.build``), so that the ranks only load them.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional


class RankFailed(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _worker(rank: int, world: int, store_path: str, timeout_s: float,
            fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        # pickled here, into bytes: a tensor put on the queue as it is would
        # be handed over by a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except Exception:  # handed to the parent, which raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: Callable, world: int, args: tuple = (), *, timeout_s: float = 600.0,
        collective_timeout_s: float = 60.0, store_dir: Optional[str] = None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own rank process.  ``collective_timeout_s`` bounds one
    collective's wait for its peers; ``timeout_s`` the whole run."""
    ctx = mp.get_context("spawn")
    made = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="repro_torch_ranks_") if made else store_dir
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, store_path, collective_timeout_s,
                                               fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (None, 0)]
                if dead:
                    raise RankFailed(f"rank {dead[0]} died (exit {procs[dead[0]].exitcode}) "
                                     "without a result") from None
                if time.monotonic() > deadline:
                    raise RankFailed(f"{world - len(out)} of {world} ranks did not finish "
                                     f"within {timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RankFailed(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == world else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if made:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world)]
