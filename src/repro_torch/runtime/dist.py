"""The collectives of the port's multi-process training, and the launcher
of its local worlds.

The reference is single-controller: one process sees every device and
XLA partitions the arithmetic. The port is multi-controller: one process
a mesh position, in a ``torch.distributed`` world (``launch/mesh.py``
maps positions to ranks).

The backend is gloo, and every collective here copies CUDA tensors to
host memory, exchanges them there and copies the result back to the
tensor's device. One card carries every rank on the card machine (one
H100): one NCCL communicator cannot hold two ranks on the same GPU, and
the CPU box the tests run on has gloo and no NCCL. The ranks compute on
their own device; only the exchange crosses the host.

Every reduction is an all-gather in rank order followed by a sum from
0.0 in rank order (as ``optim/grad_compress.py::pod_mean`` sums the
pods), so its bits never depend on the order gloo would reduce in. No
``all_reduce`` is used.

A group is a :class:`RankGroup` (``Mesh.group``): the ``torch.distributed``
process groups ("lanes") of one slice of the mesh, its ranks in row-major
order and this process's index among them. A large all-gather is cut
into a piece a lane, all broadcast at once. A group of one process needs
no collective: each function returns its input.

:func:`launch` runs a function on N local processes (a ``file://`` store
in a temporary directory, so concurrent worlds never race for a port),
each with a timeout; a child that fails fails the launch with its
stderr.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch


# process groups over each slice's ranks: a large all-gather is cut into
# this many pieces, one a group, all in flight. Four ranks on one H100
# host take a step of gemma3-1b's first repeat 1.17-1.75x faster so than
# over one group (tools/lanes_ab.py)
LANES = 4
_LANE_BYTES = 1 << 20           # a tensor below this takes one lane


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One slice of a rank mesh: `lanes` the process groups over its ranks
    (LANES of them; none for a group of one), `ranks` its global ranks in
    row-major mesh order, `index` this process's place among them;
    `pinned` its page-locked host buffers for staging CUDA tensors, kept
    from call to call."""
    lanes: tuple
    ranks: tuple
    index: int
    pinned: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def pg(self):
        """The first lane: the group of the small exchanges."""
        return self.lanes[0] if self.lanes else None


# Seconds this process spent in the collectives since collect_stats():
# `staging` the copies between the device and the host, `exchange` the
# gloo calls; `bytes` the bytes it sent. Off by default (no cost then).
STATS = {"on": False, "staging_s": 0.0, "exchange_s": 0.0, "bytes": 0,
         "calls": 0}


def collect_stats(on: bool = True) -> None:
    """Zero :data:`STATS` and turn the timing on or off. While on, a
    CUDA tensor's pending work is synced before its copy to the host is
    timed, and the copy back is synced, so the staging seconds hold the
    copies alone."""
    STATS.update(on=on, staging_s=0.0, exchange_s=0.0, bytes=0, calls=0)


def _sync(t: torch.Tensor) -> None:
    if STATS["on"] and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(key: str, fn):
    if not STATS["on"]:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    STATS[key] += time.perf_counter() - t0
    return out


def _buffer(group: RankGroup, slot: int, t: torch.Tensor):
    """The group's page-locked host buffer `slot` as a tensor of t's shape
    and dtype (grown when too small)."""
    n = t.numel() * t.element_size()
    buf = group.pinned.get(slot)
    if buf is None or buf.numel() < n:
        buf = group.pinned[slot] = torch.empty(
            max(n, 1), dtype=torch.uint8, pin_memory=True)
    return buf[:n].view(t.dtype).view(t.shape)


def _host(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """`t` in host memory: a CUDA tensor copied into the group's
    page-locked buffer of this member's slot, a CPU tensor as it is."""
    _sync(t)

    def copy():
        if not t.is_cuda:
            return t.detach().contiguous()
        return _buffer(group, group.index, t).copy_(t.detach())
    h = _timed("staging_s", copy)
    if STATS["on"]:
        STATS["bytes"] += h.numel() * h.element_size()
        STATS["calls"] += 1
    return h


def _back(parts: List[torch.Tensor], device) -> List[torch.Tensor]:
    def copy():
        out = [p.to(device) for p in parts]
        if out:
            _sync(out[0])
        return out
    return _timed("staging_s", copy)


def all_gather(t: torch.Tensor, group: RankGroup) -> List[torch.Tensor]:
    """Every member's `t` (same shape and dtype on each), in rank order,
    on `t`'s device. Broadcasts from each member, all in flight at once,
    a large tensor cut into a piece a lane (:data:`LANES`). CUDA
    tensors are staged through page-locked buffers."""
    if group.size == 1:
        return [t]
    import torch.distributed as dist
    h = _host(t, group)
    parts = [h if i == group.index else _buffer(group, i, h) if t.is_cuda
             else torch.empty_like(h) for i in range(group.size)]

    lanes = group.lanes if h.numel() * h.element_size() >= _LANE_BYTES \
        else group.lanes[:1]

    def exchange():
        works = [dist.broadcast(piece, src, group=lane, async_op=True)
                 for i, src in enumerate(group.ranks)
                 for piece, lane in zip(parts[i].view(-1).chunk(len(lanes)),
                                        lanes)]
        for w in works:
            w.wait()
    _timed("exchange_s", exchange)
    if not t.is_cuda:
        return parts
    others = iter(_back([p for i, p in enumerate(parts)
                         if i != group.index], t.device))
    return [t if i == group.index else next(others)
            for i in range(group.size)]


def gather_cat(t: torch.Tensor, group: RankGroup, dim: int = 0):
    """The members' `t` concatenated along `dim` in rank order."""
    if group.size == 1:
        return t
    return torch.cat(all_gather(t, group), dim=dim)


def sum_ranks(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The members' `t` added from 0.0 in rank order (a fixed order on
    every member, whatever the backend would choose)."""
    if group.size == 1:
        return t
    acc = torch.zeros_like(t)
    for p in all_gather(t, group):
        acc = acc + p
    return acc


def mean_ranks(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """:func:`sum_ranks` divided by the group's size."""
    if group.size == 1:
        return t
    return sum_ranks(t, group) / group.size


def send_recv(t: torch.Tensor, dst: int, src: int,
              group: RankGroup) -> torch.Tensor:
    """Send `t` to the member of index `dst` while receiving a tensor of
    `t`'s shape and dtype from the member of index `src` -> the received
    tensor on `t`'s device. Both directions are posted before either is
    waited on, so a ring of hops cannot deadlock."""
    if group.size == 1:
        return t
    import torch.distributed as dist
    h = _host(t, group)
    buf = _buffer(group, group.size, h) if t.is_cuda else torch.empty_like(h)

    def hop():
        reqs = [dist.isend(h, group.ranks[dst], group=group.pg),
                dist.irecv(buf, group.ranks[src], group=group.pg)]
        for r in reqs:
            r.wait()
    _timed("exchange_s", hop)
    return _back([buf], t.device)[0]


def all_gather_object(obj, group: RankGroup) -> list:
    """Every member's picklable `obj`, in rank order."""
    if group.size == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * group.size
    _timed("exchange_s",
           lambda: dist.all_gather_object(out, obj, group=group.pg))
    return out


def barrier(group: RankGroup) -> None:
    if group.size > 1:
        import torch.distributed as dist
        dist.barrier(group=group.pg)


# ---------------------------------------------------------------------------
# autograd through the collectives
# ---------------------------------------------------------------------------

class _Sum(torch.autograd.Function):
    """Forward: the sum over the group in rank order. Backward: each
    member's cotangent passes unchanged (every member computes the same
    loss from the same sum)."""

    @staticmethod
    def forward(ctx, t, group):
        return sum_ranks(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    """Forward: the mean over the group. Backward: the cotangent passes
    unchanged; the caller's later mean of the members' gradients over
    the group supplies the 1/n."""

    @staticmethod
    def forward(ctx, t, group):
        return mean_ranks(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward: the identity on a tensor every member holds alike.
    Backward: the members' cotangents summed in rank order (each member
    used the tensor for its own part of the work)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_ranks(g.contiguous(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Forward: the members' rows concatenated in rank order. Backward:
    the members' cotangents of the whole summed in rank order, this
    member's rows of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return gather_cat(t.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        g = sum_ranks(g.contiguous(), ctx.group)
        i = ctx.group.index
        return g[i * ctx.n:(i + 1) * ctx.n], None


def group_sum(t, group: RankGroup):
    return t if group.size == 1 else _Sum.apply(t, group)


def group_mean(t, group: RankGroup):
    return t if group.size == 1 else _Mean.apply(t, group)


def group_copy(t, group: RankGroup):
    return t if group.size == 1 else _Copy.apply(t, group)


def gather_rows(t, group: RankGroup):
    return t if group.size == 1 else _GatherRows.apply(t, group)


# ---------------------------------------------------------------------------
# the launcher: N local processes on a file:// store
# ---------------------------------------------------------------------------

class ChildFailed(RuntimeError):
    pass


@dataclasses.dataclass
class RankResult:
    """What one child returned: `result` the target's return value,
    `launches` its kernel launch counts, `max_memory` its
    ``torch.cuda.max_memory_allocated`` (0 without a card), `stdout`."""
    rank: int
    result: Any
    launches: dict
    max_memory: int
    seconds: float
    stdout: str


def _target_name(target) -> str:
    """"module:qualname", or "path.py::qualname" for a function of the
    script being run (its module is __main__)."""
    if isinstance(target, str):
        return target
    if target.__module__ == "__main__":
        path = os.path.abspath(sys.modules["__main__"].__file__)
        return f"{path}::{target.__qualname__}"
    return f"{target.__module__}:{target.__qualname__}"


def _resolve(name: str) -> Callable:
    if "::" in name:             # a script's function: load the file under
        path, qual = name.split("::")   # another name, so its main guard
        spec = importlib.util.spec_from_file_location("_rank_script", path)
        obj = importlib.util.module_from_spec(spec)
        sys.modules["_rank_script"] = obj
        spec.loader.exec_module(obj)
    else:
        mod, _, qual = name.partition(":")
        obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def launch(target, world: int, args: Sequence = (), timeout: float = 600,
           threads: Optional[int] = None, echo: bool = False
           ) -> List[RankResult]:
    """Run ``target(rank, *args)`` in `world` new processes of one gloo
    world -> their :class:`RankResult`s in rank order.

    `target` is a module-level function or a "module:function" name; the
    children import it with this process's ``sys.path``. Each child
    initialises the world on a ``file://`` store in a fresh temporary
    directory, sets its kernel launch counts to 0 before the target and
    reads them after. `threads`: each child's ``torch.set_num_threads``
    (default: the cores shared out). A child
    that exits non-zero fails the launch with its stderr, and the other
    children are stopped; so does the `timeout` (seconds, the whole
    launch). With `echo`, each child's output is printed after the run."""
    tmp = tempfile.mkdtemp(prefix="rank_world_")
    try:
        threads = threads or max(1, (os.cpu_count() or 1) // world)
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump({"target": _target_name(target), "args": tuple(args),
                         "world": world, "path": list(sys.path),
                         "timeout": timeout, "threads": threads}, f)
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = str(threads)
        env["PYTHONFAULTHANDLER"] = "1"
        env["PYTHONUNBUFFERED"] = "1"
        procs = []
        for r in range(world):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", __name__, tmp, str(r)], env=env,
                stdout=out, stderr=err), out, err))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p, _, _ in procs]
            if any(c not in (None, 0) for c in codes):
                failed = "a rank exited non-zero"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"timeout after {timeout} s"
                break
            time.sleep(0.05)
        if failed is not None:      # the others' collectives fail in turn
            grace = time.monotonic() + 10
            while time.monotonic() < grace and any(
                    p.poll() is None for p, _, _ in procs):
                time.sleep(0.05)
        codes = []
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            codes.append(p.wait())
            out.close()
            err.close()

        def text(r, kind):
            path = os.path.join(tmp, f"rank{r}.{kind}")
            if not os.path.exists(path):
                return ""
            with open(path) as f:
                return f.read()
        if failed is not None:
            bad = [r for r, c in enumerate(codes) if c != 0]
            msg = "\n".join(
                f"--- rank {r} (exit code {codes[r]}) stdout (tail):\n"
                f"{text(r, 'out')[-2000:]}\n--- rank {r} stderr (tail):\n"
                f"{text(r, 'err')[-6000:]}\n--- rank {r} exception and "
                f"exit:\n{text(r, 'exc')[-3000:]}{text(r, 'fault')[-3000:]}"
                for r in bad)
            raise ChildFailed(f"rank world of {world}: {failed}; ranks "
                              f"{bad} failed\n{msg}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                rec = pickle.load(f)
            results.append(RankResult(rank=r, stdout=text(r, "out"), **rec))
            if echo and results[-1].stdout:
                for line in results[-1].stdout.splitlines():
                    print(f"[rank {r}] {line}")
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _child(tmp: str, rank: int) -> None:
    import atexit
    import faulthandler
    import traceback
    # a crash's stacks, an exception's traceback and the interpreter's
    # exit go to files of their own, whatever happens to stderr
    fault = open(os.path.join(tmp, f"rank{rank}.fault"), "w")
    faulthandler.enable(fault)
    atexit.register(lambda: (fault.write("the interpreter exited\n"),
                             fault.flush()))
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    sys.path[:0] = [p for p in job["path"] if p not in sys.path]
    torch.set_num_threads(job["threads"])
    import torch.distributed as dist
    from ..kernels import dispatch
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        try:
            return _run(job, rank, dist, dispatch, tmp)
        except BaseException:
            with open(os.path.join(tmp, f"rank{rank}.exc"), "w") as f:
                f.write(traceback.format_exc())
            raise
    finally:
        dist.destroy_process_group()


def _run(job, rank, dist, dispatch, tmp):
    """The target with the launch counts set to 0 before it and read
    after; its record written to rank<r>.pkl."""
    fn = _resolve(job["target"])
    dispatch.reset_launches()
    t0 = time.perf_counter()
    out = fn(rank, *job["args"])
    seconds = time.perf_counter() - t0
    launches = dispatch.launches()
    mem = (torch.cuda.max_memory_allocated()
           if torch.cuda.is_available() and torch.cuda.is_initialized()
           else 0)
    dist.barrier()
    part = os.path.join(tmp, f"rank{rank}.pkl.tmp")
    with open(part, "wb") as f:
        pickle.dump({"result": out, "launches": launches, "max_memory": mem,
                     "seconds": seconds}, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
