"""Start a mesh of processes and run one function on every rank: the
port's stand-in for the reference's ``shard_map`` over a device mesh.

    result = spmd.run(fn, args, sizes=(2, 2, 1), device="cpu")

starts ``prod(sizes)`` ranks with ``torch.multiprocessing`` (spawn), each
of which initialises its process group (``launch.mesh.init_mesh``: the
rendezvous ``init_method``, ``tcp://127.0.0.1:<free port>`` by default or a
``file://`` path, which tests keep under their own temporary directory so
that parallel test workers never race for a port), calls
``fn(mesh, *args)`` under ``sharding.use_mesh(mesh)``, and destroys the
group.  It returns rank 0's result (every rank's, in rank order, with
``all_ranks``), moved to the CPU and sent back through ``torch.save``.

A rank that raises fails the run: its traceback comes back in the
``RuntimeError`` raised here, and every other rank is stopped, whether it
has finished or waits in a collective.  So does a rank that dies without
a word, and a run that outlasts ``timeout_s``.  ``fn`` and ``args`` must
be picklable by reference (a module-level function; arrays, numbers), as
spawn requires.  Nothing here builds a kernel: a caller on the card
builds them before the spawn (``kernels._build.build_all``), so the ranks
load the same libraries instead of racing ``nvcc``.
"""
from __future__ import annotations

import io
import math
import os
import queue
import socket
import time
import traceback

from repro_torch.launch import mesh as mesh_mod


def free_tcp_init() -> str:
    """A ``tcp://127.0.0.1:<port>`` rendezvous on a free local port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _to_cpu(x):
    import torch
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank, world_size, fn, args, mesh_kw, threads, send, results):
    import torch
    from repro_torch.models import sharding as sh
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = mesh_mod.init_mesh(rank=rank, world_size=world_size,
                                  **mesh_kw)
        with sh.use_mesh(mesh):
            out = fn(mesh, *args)
        payload = None
        if send:
            buf = io.BytesIO()
            torch.save(_to_cpu(out), buf)
            payload = buf.getvalue()
        results.put((rank, True, payload))
        # no rank tears its connections down while another still reads
        torch.distributed.barrier()
    except Exception:               # the run's boundary: report and stop
        results.put((rank, False, traceback.format_exc()))
        return
    mesh_mod.close_mesh()


def run(fn, args=(), *, sizes=(2, 2, 1), axes=mesh_mod.FEDERATED_AXES,
        device: str = "cuda", backend: str | None = None,
        init_method: str | None = None, timeout_s: float = 600.0,
        group_timeout_s: float = mesh_mod.GROUP_TIMEOUT_S,
        threads: int | None = 1, all_ranks: bool = False, verbose=True):
    """Run ``fn(mesh, *args)`` on each rank of a ``sizes`` mesh over
    ``axes``; returns rank 0's result (a list of every rank's with
    ``all_ranks``).  ``threads``: each rank's ``torch.set_num_threads``
    (None leaves it)."""
    import torch
    import torch.multiprocessing as mp
    world = math.prod(sizes)
    backend = backend or mesh_mod.default_backend(world, device)
    init_method = init_method or free_tcp_init()
    if verbose:
        print(f"spmd: {world} ranks on a {dict(zip(axes, sizes))} mesh, "
              f"backend {backend}, devices "
              f"{mesh_mod.rank_devices(world, device)}", flush=True)
    mesh_kw = dict(init_method=init_method, sizes=tuple(sizes),
                   axes=tuple(axes), backend=backend, device=device,
                   timeout_s=group_timeout_s)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, args, mesh_kw, threads,
                               all_ranks or r == 0, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    # a rank's last message may still be in the pipe
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spmd: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"spmd: the ranks did not finish in "
                                       f"{timeout_s} s (done: {sorted(got)})")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"spmd: rank {rank} of {world} failed:\n"
                                   f"{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    out = [None if got[r] is None else torch.load(
        io.BytesIO(got[r]), weights_only=False) for r in range(world)]
    return out if all_ranks else out[0]


def init_file(directory) -> str:
    """A ``file://`` rendezvous under ``directory``, unique to this call."""
    path = os.path.join(str(directory), f"spmd_rdzv_{os.getpid()}_"
                        f"{time.monotonic_ns()}")
    return f"file://{path}"
