"""Run a function on every rank of a TP ring of local processes.

``run_ranks(fn, world, *args)`` starts ``world`` processes, joins each to
one TP group (:func:`repro_torch.sharding.init_tp_group`), calls
``fn(group, *args)`` there and returns the results in rank order; ``fn``
may factor ``group`` into a mesh (:func:`repro_torch.sharding.init_mesh`,
every rank alike). ``fn`` must be importable by name, and its arguments and
results picklable. A rank that raises makes ``run_ranks`` raise with that
rank's traceback.

The ranks come from a fork server that has imported torch once (the
``forkserver`` start method, torch preloaded): a rank starts without
importing torch again, which took each of four ranks starting together
9–15 s on the card's host. Nothing else of the parent's state is inherited
(the server holds no CUDA context), and each rank takes the parent's
environment as it is when ``run_ranks`` is called, as a spawned process
would.

All ranks run on this host, so the gloo transport is bound to the loopback
interface unless ``GLOO_SOCKET_IFNAME`` says otherwise, and each rank's CPU
kernels take an equal share of the host's cores.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional


def _rank_main(world, rank, init_method, backend, device, inbox, out):
    import torch

    from repro_torch import sharding

    # the parent's environment now, not the fork server's at its start
    env = inbox.recv()
    os.environ.clear()
    os.environ.update(env)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the ranks share this host's cores: no rank's CPU kernels take them all
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        fn, args = inbox.recv()
        inbox.close()
        group = sharding.init_tp_group(world, rank, init_method=init_method,
                                       backend=backend, device=device)
        try:
            out.put((rank, True, fn(group, *args)))
        finally:
            sharding.destroy_tp_group(group)
    except Exception:   # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args: Any,
              backend: Optional[str] = None, device=None,
              timeout: float = 600.0) -> List[Any]:
    """``[fn(group_r, *args) for r in range(world)]``, each on its own
    process. ``backend``/``device`` go to ``init_tp_group``. Raises
    ``RuntimeError`` naming the rank if a rank fails, dies, or does not
    answer within ``timeout`` seconds."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    tmp = tempfile.mkdtemp(prefix="tp_ranks_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    out = ctx.Queue()
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(world, r, init_method, backend, device,
                               pipes[r][0], out), daemon=True)
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        # fn and its arguments go to the ranks once every rank is starting:
        # sent with the process, a payload past the pipe's buffer would
        # hold each start until the rank before it had imported torch
        env = dict(os.environ)
        for inbox, send in pipes:
            inbox.close()
            send.send(env)
            send.send((fn, args))
            send.close()
        while len(results) < world:    # drain before joining
            try:
                rank, ok, value = out.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                raise RuntimeError(f"ranks {dead or 'all'} gave no result "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
