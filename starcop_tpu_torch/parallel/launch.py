"""Start a world of ranks on this host and collect what each returns.

    results = run_world(fn, 2, backend="gloo", device="cpu", init_file=path)

``fn(mesh, *args)`` runs in each of ``n`` processes started with the
``spawn`` method (so ``fn`` and ``args`` must pickle: a module-level
function). Each process joins the world through ``initialize_multihost``
with a ``file://`` rendezvous (no port to collide with another world), gets
its ``make_mesh`` and returns a picklable value; ``run_world`` returns the
values by rank. A rank that raises, dies or outlives ``timeout_s`` fails the
whole world: every process is stopped and ``run_world`` raises.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from starcop_tpu_torch.device import DeviceLike


def _rank_main(fn, rank, n, backend, device, init_file, timeout_s, args, out):
    import torch.distributed as dist

    from starcop_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        initialize_multihost(f"file://{init_file}", n, rank, backend=backend, device=device,
                             timeout_s=timeout_s)
        result = fn(make_mesh(n, device), *args)
        # Pickled here by value: a tensor sent through a multiprocessing queue
        # would be a handle to this process's shared memory, gone at its exit.
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, n: int, *, backend: Optional[str] = None, device: DeviceLike = None,
              init_file: Optional[str] = None, timeout_s: float = 600.0,
              args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` ranks; returns their results by rank.

    ``device`` is every rank's device (``"cpu"``, or ``"cuda:0"`` for ranks
    sharing one card); None gives each rank its own card (``cuda:rank``).
    ``backend`` as ``initialize_multihost`` takes it (None: NCCL on the
    card, gloo on the CPU). ``init_file`` is the rendezvous file, which must
    not exist yet (default: a new name in a temporary directory).
    """
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, n, backend, device, init_file, timeout_s,
                                   tuple(args), out))
                 for rank in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = time.monotonic() + timeout_s
        try:
            # Drain the queue before joining: a child blocks on a full pipe.
            while len(results) + len(errors) < n:
                try:
                    rank, ok, payload = out.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in results and r not in errors]
                    if dead and out.empty():
                        raise RuntimeError(f"run_world: rank(s) {dead} exited without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_world: {n} ranks did not finish within "
                                           f"{timeout_s:.0f} s (done: {sorted(results)})")
                    continue
                if ok:
                    results[rank] = pickle.loads(payload)
                else:
                    errors[rank] = payload
                    break  # the other ranks may now wait in a collective forever
            if errors:
                rank, tb = next(iter(errors.items()))
                raise RuntimeError(f"run_world: rank {rank} of {n} failed:\n{tb}")
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [results[r] for r in range(n)]
