"""Collectives of the scale-out path on an explicit process group.

The reference runs its mesh in one process (``shard_map`` over the devices
of a ``Mesh``); the port runs one process a rank, each rank's shard on its
own device, joined by ``torch.distributed``. The reference's collectives
map so:

    psum        -> :func:`sum_`        (all_reduce SUM)
    pmin        -> :func:`min_`        (all_reduce MIN)
    all_to_all  -> :func:`all_to_all` (all_to_all_single)
    ppermute    -> :func:`halo`        (the ring's two neighbours)

``group=None`` is a world of one: every function returns its input and
launches nothing, so a one-device caller pays no collective. A group, even
of one rank, always runs its collective.

Backends: ``nccl`` on the card (one rank a card), ``gloo`` on the CPU (the
tests) and for several ranks that share one card (NCCL refuses two ranks
on one device). gloo carries all_reduce (SUM and MIN), all_gather and
all_to_all_single on CUDA tensors (torch 2.11, checked on an H100), so no
collective here copies to the host; its send / recv take CPU tensors only
(a CUDA tensor ends the process), so the halo is an all_reduce.

:func:`spawn` starts ``n`` ranks as processes that join a group through a
``FileStore`` (no TCP port: parallel test workers would collide on one),
run a function named by its module path and hand their numpy results
back. It imports nothing beyond torch and numpy, so a rank's process loads
no JAX.
"""

import importlib
import os
import traceback
import uuid

import torch
import torch.distributed as dist


def size(group) -> int:
    """The group's ranks (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in the group (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def _flag_dtype(t):
    """Flags cross as uint8 / int32, never bool (gloo has no bool sums)."""
    if t.dtype == torch.bool:
        raise ValueError("comm: move flags as uint8 or int32, not bool")


def sum_(t, group):
    """The reference's ``psum``: ``t`` summed over the ranks, in place;
    returns ``t``."""
    _flag_dtype(t)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def min_(t, group):
    """The reference's ``pmin``: the element-wise minimum over the ranks,
    in place; returns ``t``."""
    _flag_dtype(t)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def all_to_all(t, group):
    """The reference's ``all_to_all(split_axis=0, concat_axis=0)``: ``t``
    [n, ...] sends row j to rank j; returns [n, ...] whose row i came from
    rank i."""
    _flag_dtype(t)
    if group is None:
        return t
    n = size(group)
    if t.shape[0] != n:
        raise ValueError(f"comm.all_to_all: leading axis {t.shape[0]} != "
                         f"{n} ranks")
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def halo(first, last, group):
    """The ring exchange of the reference's two ``ppermute``s
    (``ct_ba.py:225-226``): returns (the previous rank's ``last``, the next
    rank's ``first``), wrapping around the ring. Built from one all_reduce
    of a [n, 2, W] buffer that holds each rank's pair in its own row and
    zeros elsewhere (x + 0 is x), so every backend carries it on the
    device. ``first`` and ``last`` are same-shape float tensors."""
    if group is None:
        return last, first
    n, r = size(group), rank(group)
    shape = first.shape
    buf = torch.zeros((n, 2, first.numel()), dtype=first.dtype,
                      device=first.device)
    buf[r, 0] = first.reshape(-1)
    buf[r, 1] = last.reshape(-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return (buf[(r - 1) % n, 1].reshape(shape),
            buf[(r + 1) % n, 0].reshape(shape))


# ----------------------------------------------------------------- spawn —

def _resolve(path: str):
    """``"package.module:function"`` -> the function."""
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)


def _rank_main(r, n, store_path, backend, fn_path, args, queue):
    # one CPU thread a rank: n ranks, and test workers beside them, share
    # the host's cores
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=r, world_size=n)
        try:
            out = _resolve(fn_path)(dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        queue.put((r, True, out))
    except BaseException:       # reported to the parent, which raises
        queue.put((r, False, traceback.format_exc()))


def spawn(fn_path: str, n: int, directory, args=(), backend: str = "gloo",
          timeout: float = 600.0):
    """Run ``fn_path`` (``"module:function"``, importable in a fresh
    process) on ``n`` ranks, each a spawned process that joins a
    ``backend`` group through a ``FileStore`` in ``directory`` (a fresh
    file each call) and calls ``function(group, *args)``. Returns the
    ranks' results (picklable: numpy arrays, ints, dicts) in rank order;
    raises with the rank's traceback if any rank failed, and leaves no
    process running. Each rank imports the caller's ``__main__`` module
    anew (the spawn start method): a calling script keeps its work under
    ``if __name__ == "__main__":``."""
    import multiprocessing as mp
    import queue as queue_mod

    os.makedirs(directory, exist_ok=True)
    store_path = os.path.join(directory, f"store-{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, store_path, backend, fn_path, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(n):
            r, ok, out = q.get(timeout=timeout)
            if ok:
                results[r] = out
            else:
                errors.append(f"rank {r}:\n{out}")
                break
    except queue_mod.Empty:
        errors.append(f"comm.spawn: no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store_path):
            os.remove(store_path)
    if errors:
        raise RuntimeError(f"comm.spawn({fn_path}, n={n}) failed: "
                           + "\n".join(errors))
    return [results[r] for r in range(n)]
