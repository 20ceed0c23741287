"""Grids of ranks and the collectives of the parallel layer (port of
`hsd_tpu/parallel/mesh.py`).

The JAX package builds one `jax.sharding.Mesh` over ("data", "model") and
runs one SPMD program on it. Here each rank is a process of its own, under
`torch.distributed`: `make_mesh(data, model)` lays the world's ranks out
as a (data, model) grid, rank = d * model + m, creates one process group
for every row and every column of the grid, and gives this rank an `Axis`
per grid axis (its group, its size, its index), so that
`transformer.forward(tp_axis=mesh[MODEL_AXIS])` reads as the JAX code does.

The collectives the JAX code issues (`psum`, the gather of vocab shards,
`ppermute`, the masked-psum broadcast, `axis_index`, `axis_size`) are one
function each below, built from `all_reduce` and `broadcast` only: those
two take CUDA tensors on both NCCL and gloo, and gloo is what ranks that
share one card must use (NCCL refuses two ranks on one device). So an
all-gather is an all_reduce over a zero-padded buffer (exact: each element
has one nonzero term) and a ppermute a broadcast from each source. Each
call adds one to its kind in a per-process counter (`collective_counts`).

`run_ranks` starts the ranks of a world as spawned processes and returns
each rank's result: the tests run it with gloo on the CPU, `chip_smoke.py`
with gloo on the one card. Under `torchrun` each process calls
`initialize_multihost` instead.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_COUNTS = {"psum": 0, "all_gather": 0, "ppermute": 0, "broadcast": 0}


def collective_counts() -> Dict[str, int]:
    """This process's collectives by kind since the last reset."""
    return dict(_COUNTS)


def reset_collectives() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a grid of ranks, as this rank sees it: the ranks along
    it in index order, this rank's index among them, and their process
    group (None for an axis of size 1, whose collectives are identities)."""

    name: str
    ranks: Tuple[int, ...]
    index: int
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A grid of ranks with named axes: `mesh[name]` is this rank's Axis,
    `mesh.shape` maps each name to its size (in the grid's order)."""

    def __init__(self, axes: Sequence[Axis]):
        self.axes = {a.name: a for a in axes}

    def __getitem__(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def shape(self) -> Dict[str, int]:
        return {n: a.size for n, a in self.axes.items()}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_grid(shape: Sequence[int], names: Sequence[str]) -> Mesh:
    """Lay the world's ranks out row-major over `shape` (every process of
    the world must call this, with the same arguments: each row and column
    of the grid becomes a process group, created in one order everywhere).
    A grid of one rank needs no process group."""
    need = math.prod(shape)
    if need == 1:
        return Mesh([Axis(n, (0,), 0) for n in names])
    if not dist.is_initialized():
        raise RuntimeError(f"a grid of {need} ranks needs torch.distributed "
                           "initialized (run_ranks or initialize_multihost)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != need:
        raise ValueError(f"grid {tuple(shape)} needs {need} ranks, the "
                         f"world has {world}")
    axes = []
    for a, name in enumerate(names):
        mine = None
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            ranks = []
            for j in range(shape[a]):
                c = list(rest)
                c.insert(a, j)
                ranks.append(_ravel(c, shape))
            # every rank creates every group, in the same order
            group = dist.new_group(ranks) if shape[a] > 1 else None
            if rank in ranks:
                mine = Axis(name, tuple(ranks), ranks.index(rank), group)
        axes.append(mine)
    return Mesh(axes)


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) grid of `MeshConfig`: data-parallel requests or
    batches on DATA_AXIS, tensor-parallel shards on MODEL_AXIS."""
    return make_grid((data, model), (DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)


def initialize_multihost(backend: Optional[str] = None) -> int:
    """Multi-process bring-up under torchrun: `init_process_group` from
    its environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), binding the process to card
    LOCAL_RANK % device_count when CUDA is available. A no-op in a single
    process (no WORLD_SIZE, or 1) or when already initialized. Returns
    this process's rank."""
    if dist.is_initialized():
        return dist.get_rank()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 0
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if backend == "nccl":
        # the ranks of THIS host share its cards; other hosts have their own
        _check_nccl(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank()


def _check_nccl(local_world: int) -> None:
    n = torch.cuda.device_count()
    if local_world > n:
        raise ValueError(f"NCCL needs a card per rank: {local_world} ranks "
                         f"on this host, {n} cards (ranks that share a card "
                         "need backend='gloo')")


def make_global_mesh(model: int = 1) -> Mesh:
    """A grid over every rank of the world: `model` innermost (the ranks of
    one host), the rest of the world on `data`."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"world {n} does not divide into model={model}")
    return make_mesh(data=n // model, model=model)


def shard_for_process(items: Sequence, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> list:
    """Data-parallel eval fan-out: this process's contiguous slice of the
    items (the reference's Ray chunking)."""
    init = dist.is_initialized()
    i = (dist.get_rank() if init else 0) if process_index is None \
        else process_index
    n = (dist.get_world_size() if init else 1) if process_count is None \
        else process_count
    per = (len(items) + n - 1) // n
    return list(items[i * per:(i + 1) * per])


# ---------------------------------------------------------------------------
# collectives: each one function, each counted once a call
# ---------------------------------------------------------------------------

def axis_index(axis: Optional[Axis]) -> int:
    return 0 if axis is None else axis.index


def axis_size(axis: Optional[Axis]) -> int:
    return 1 if axis is None else axis.size


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of x over the ranks of `axis`, in x's dtype (a new tensor;
    x unchanged). Every rank gets the same bits: the reduction's result is
    computed once and copied (checked by the tests and on the card)."""
    if axis is None or axis.size == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=axis.group)
    _COUNTS["psum"] += 1
    return y


def all_gather(x: torch.Tensor, axis: Optional[Axis],
               dim: int = -1) -> torch.Tensor:
    """The ranks' equal shards of `dim` concatenated in index order: an
    all_reduce of a zero buffer holding this rank's shard at its offset,
    exact because every element sums one value and zeros."""
    if axis is None or axis.size == 1:
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, axis.index * n, n).copy_(x)
    dist.all_reduce(buf, group=axis.group)
    _COUNTS["all_gather"] += 1
    return buf


def ppermute(xs, axis: Optional[Axis], perm: Sequence[Tuple[int, int]]):
    """`lax.ppermute`: for every (src, dst) pair of axis indices, dst
    receives src's tensors; a rank that receives nothing gets zeros. xs is
    one tensor or a tuple of them. One broadcast from each source: gloo
    takes no CUDA tensor in send / recv."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    if axis is None or axis.size == 1:
        out = tuple(x if (0, 0) in perm else torch.zeros_like(x)
                    for x in xs)
        return out[0] if single else out
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        for i, x in enumerate(xs):
            buf = (x.contiguous().clone() if axis.index == src
                   else torch.empty_like(x))
            dist.broadcast(buf, src=axis.ranks[src], group=axis.group)
            if axis.index == dst:
                out[i] = buf
    _COUNTS["ppermute"] += 1
    return out[0] if single else tuple(out)


def broadcast_from(x: torch.Tensor, axis: Optional[Axis],
                   src: int) -> torch.Tensor:
    """Rank `src`'s x on every rank of `axis` (the JAX code's masked psum,
    `psum(where(axis_index == src, x, 0))`, which is exact: one nonzero
    term). Every rank passes a tensor of x's shape and dtype."""
    if axis is None or axis.size == 1:
        return x
    buf = x.contiguous().clone()
    dist.broadcast(buf, src=axis.ranks[src], group=axis.group)
    _COUNTS["broadcast"] += 1
    return buf


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, tuple):                      # NamedTuple
        return type(obj)(*(_to_cpu(v) for v in obj))
    return obj


def _rank_main(fn, rank, world, backend, device, tmp, args, pg_timeout):
    torch.set_num_threads(1)
    if device == "cuda":
        idx = rank % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    else:
        dev = torch.device(device)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=pg_timeout))
        payload = ("ok", _to_cpu(fn(dev, *args)))
    except BaseException:           # reported to the parent, then re-raised
        payload = ("err", traceback.format_exc())
    torch.save(payload, out + ".part")
    os.replace(out + ".part", out)
    if dist.is_initialized():
        dist.destroy_process_group()
    if payload[0] == "err":
        raise SystemExit(1)


def run_ranks(fn: Callable, world: int, *args, backend: Optional[str] = None,
              device: Optional[str] = None, timeout: float = 600.0,
              pg_timeout: float = 120.0) -> List[Any]:
    """Run `fn(device, *args)` in `world` spawned processes, one a rank, in
    one process group; return each rank's result (CUDA tensors come back
    on the CPU).

    device: "cuda" (the default; rank r on card r % device_count) or
    "cpu". backend: "nccl" for CUDA and "gloo" for the CPU by default.
    NCCL with fewer cards than ranks raises: ranks that share a card must
    ask for gloo. The ranks rendezvous through a file store in a fresh
    temporary directory (no port), each with `pg_timeout` seconds for a
    collective; if any rank fails or the whole run outlasts `timeout`, the
    others are killed and the first failure is raised. `fn` must be
    importable by name (spawn, never fork: the parent may hold a CUDA
    context)."""
    device = "cuda" if device is None else str(device)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl":
        _check_nccl(world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hsd_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, tmp, args,
                                   pg_timeout), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            if not os.path.exists(path):
                results.append(None)
                errors.append((r, f"exit code {procs[r].exitcode}, no result"))
                continue
            kind, val = torch.load(path, weights_only=False)
            results.append(val if kind == "ok" else None)
            if kind == "err":
                errors.insert(0, (r, val))
    if timed_out:
        raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} "
                           f"outlasted {timeout}s; killed")
    if errors:
        raise RuntimeError("\n".join(f"rank {r} of {world} failed:\n{msg}"
                                     for r, msg in errors))
    return results
