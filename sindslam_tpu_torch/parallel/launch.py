"""One process per device over a ``torch.distributed`` group: the port's
counterpart of what ``jax.sharding.Mesh`` gives the JAX package
(``sindslam_tpu/parallel/batch_frontend.py::make_mesh``).

The JAX package shards an array over a device mesh inside one process and
GSPMD inserts the collectives. The port runs one process per device, the
form multi-GPU PyTorch takes, and the only one that scales a front-end
bound by the host's launch rate: ``spawn(fn, n)`` starts n processes,
joins them into one group (NCCL on CUDA, gloo when the caller passes
``device="cpu"``) and calls ``fn(mesh, *args)`` in each. A sharded path
calls ``all_reduce_sum`` and ``all_gather_lanes`` where GSPMD inserts an
all-reduce or an all-gather.

- ``make_mesh(n_devices=None, device=None)`` checks that the host has the
  devices and returns a ``Mesh`` not yet joined. A one-device mesh works as
  it stands, in the caller's process: the helpers are then the identity, so
  a path given it computes what it computes with no mesh, bit for bit.
- ``fn`` is pickled by its qualified name, so rank functions live in a
  module, never in a test or a script's ``__main__``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sindslam_tpu_torch import resolve_device

# a collective that waits longer than this fails the run: a rank that died
# between collectives must not leave the others waiting for ever
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a group and this process's place in it: rank r runs
    on ``devices[r]``. ``group`` is None until ``spawn`` joins it."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    group: Optional[Any] = None

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def shard(self, n_rows: int) -> slice:
        """This rank's rows ``[r n/w, (r+1) n/w)`` of ``n_rows``; raises
        when they do not divide over the mesh, as a sharded JAX array's
        leading dimension must."""
        w = self.world_size
        if n_rows % w:
            raise ValueError(f"{n_rows} rows (lanes) do not divide over a "
                             f"mesh of {w} devices")
        per = n_rows // w
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` devices (all of the host's CUDA devices when
    None). CUDA unless ``device`` says otherwise: with no CUDA device and no
    explicit ``"cpu"`` it raises, and on CUDA it raises when the host has
    fewer devices than asked for (NCCL puts one rank on a device); it never
    falls back to the CPU. On the CPU every rank is a process of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(
                f"make_mesh({n}) requested but only {have} CUDA device(s) "
                f"visible; a process group puts one rank on each device, so "
                f"run on a host with {n} or pass device='cpu' for gloo "
                f"ranks on the CPU")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    elif dev.type == "cpu":
        n = n_devices or 1
        devices = (torch.device("cpu"),) * n
    else:
        raise ValueError(f"make_mesh: no process group backend for "
                         f"{dev.type!r} devices")
    if n < 1:
        raise ValueError(f"make_mesh({n_devices}): a mesh needs a device")
    return Mesh(devices)


def _joined(mesh: Mesh) -> Any:
    if mesh.group is None:
        raise RuntimeError(
            f"a mesh of {mesh.world_size} devices is not joined: run the "
            f"sharded path under spawn(fn, {mesh.world_size})")
    return mesh.group


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place, the same bits on every
    rank (each element is reduced in one place and then broadcast); the
    identity on a mesh of one device or none."""
    if mesh is None or mesh.world_size == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_joined(mesh))
    return x


def all_gather_lanes(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dimension 0 in rank order: the
    lanes rank r computed land at ``mesh.shard(B)``. The identity on a mesh
    of one device or none."""
    if mesh is None or mesh.world_size == 1:
        return x
    src = x.contiguous()
    if src.dtype == torch.bool:            # the same bytes; gloo takes uint8
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=_joined(mesh))
    out = torch.cat(parts)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def _map_tensors(obj, f):
    if isinstance(obj, torch.Tensor):
        return f(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):      # NamedTuple
        return type(obj)(*(_map_tensors(v, f) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, f) for v in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, f) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, devices, tmp: str, fn: Callable, args: tuple,
               deterministic: Tuple[bool, bool], n_threads: int) -> None:
    torch.set_num_threads(n_threads)
    torch.use_deterministic_algorithms(deterministic[0],
                                       warn_only=deterministic[1])
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), len(devices)),
        rank=rank, world_size=len(devices), timeout=COLLECTIVE_TIMEOUT)
    try:
        out = fn(Mesh(devices, rank, dist.group.WORLD), *args)
        if rank == 0:
            torch.save(_map_tensors(out, lambda t: t.cpu()),
                       os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_devices: Optional[int], *args, device=None):
    """``fn(mesh, *args)`` on every rank of a mesh of ``n_devices`` devices
    (``make_mesh``'s rule), one process each, started with the ``spawn``
    method; returns rank 0's result with every tensor in it on the CPU.

    The group meets through a ``FileStore`` in a fresh temporary directory
    (no TCP port, so many groups can run on one host at once); on CUDA rank
    r runs on device r. The kernels are built here, once, before the ranks
    start; each rank takes the caller's thread count and deterministic-
    algorithms setting. Tensors in ``args`` are sent as CPU copies. A rank
    that raises ends the others and the call raises."""
    mesh = make_mesh(n_devices, device)
    if mesh.device.type == "cuda":
        from sindslam_tpu_torch.ops import _build
        _build.build()
    args = _map_tensors(args, lambda t: t.cpu())
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    with tempfile.TemporaryDirectory(prefix="sindslam_mesh_") as tmp:
        mp.start_processes(
            _rank_main, args=(mesh.devices, tmp, fn, args, det,
                              torch.get_num_threads()),
            nprocs=mesh.world_size, join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


def measured(mesh: Mesh, calls: Sequence[Tuple[Callable, tuple]]) -> list:
    """Rank function: each ``(fn, args)`` of ``calls`` in turn as
    ``fn(mesh, *args)``, the kernels' launch counters zeroed before each
    and read after, its host seconds taken from one device synchronisation
    to the next. Returns ``[(result, launches, seconds), ...]``: several
    paths in one group pay for one start of the ranks."""
    from sindslam_tpu_torch.ops import cuda_kernels as ck

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    out = []
    for fn, args in calls:
        sync()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(mesh, *args)
        sync()
        out.append((res, dict(ck.LAUNCHES), time.perf_counter() - t0))
    return out
