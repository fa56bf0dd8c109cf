"""Device meshes: ``youtu_rag_tpu/parallel/mesh.py`` on ``torch.distributed``.

A mesh names axes over devices, as JAX's ``jax.sharding.Mesh`` does: a 1-D
``db`` axis shards an index's rows (``parallel.sharded_index``), ``dp`` ×
``tp`` splits a batch and a model's heads (``models.decoder``). It comes
in one of two forms, the two forms of ``parallel/sequence_parallel.py``'s
ring:

- a **local mesh**, in one process: an ndarray of ``torch.device`` and its
  axis names. A device may repeat, so one card holds S shards (the
  counterpart of the 8 host devices JAX's tests run on). Collectives are
  tensor operations across the shards;
- a **group mesh**, built once ``torch.distributed`` is initialized
  (``init_distributed``): every process contributes its devices, and an
  axis that crosses processes reduces through a process group of
  ``torch.distributed`` (NCCL between cards, gloo on the CPU).
  ``get_hybrid_mesh`` puts its outer (``dcn``) axes across processes and
  its inner (``ici``) axes on each process's own devices.

Launch recipe (one process per card, the same program):

    MASTER_ADDR=host0 MASTER_PORT=29500 WORLD_SIZE=2 RANK=<i> python serve.py
    # in the program:
    from youtu_rag_tpu_torch.parallel.mesh import get_hybrid_mesh, init_distributed
    init_distributed()                                  # no-op in one process
    mesh = get_hybrid_mesh({"ici": -1}, {"dcn": -1})    # dcn = processes

Without ``devices`` a mesh takes the CUDA devices and raises on a host
without one (``utils.device.resolve_device``'s rule): the CPU is used only
when the caller names it.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Mesh:
    """Devices on named axes (the first axis varies slowest), with each
    slot's process (``process_index``; all 0 on a local mesh)."""

    def __init__(self, devices, axis_names, process_index=None, distributed: bool = False):
        self.devices = np.vectorize(torch.device, otypes=[object])(np.asarray(devices, object))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a {self.devices.ndim}-D mesh")
        shape = self.devices.shape
        self.process_index = (np.zeros(shape, np.int64) if process_index is None
                              else np.asarray(process_index, np.int64).reshape(shape))
        self.distributed = distributed
        self._groups: dict[tuple[str, ...], Any] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        form = "group" if self.distributed else "local"
        return f"Mesh({self.shape}, {form})"

    def layout(self, axes: tuple[str, ...]) -> tuple[np.ndarray, np.ndarray]:
        """(devices, process_index) with ``axes`` last and flattened: one row
        per coordinate of the other axes, in ``axes``' row-major order along
        each row (the order JAX shards ``P(axes)`` in)."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in mesh axes {self.axis_names}")
        other = [self.axis_names.index(a) for a in self.axis_names if a not in axes]
        perm = other + [self.axis_names.index(a) for a in axes]
        n = int(np.prod([self.shape[a] for a in axes]))
        return (self.devices.transpose(perm).reshape(-1, n),
                self.process_index.transpose(perm).reshape(-1, n))

    def group(self, axes: tuple[str, ...]):
        """The process group along ``axes`` that this process belongs to
        (``None`` on a local mesh). Every process makes every group, in the
        same order, the first time any asks (``new_group`` is collective)."""
        if not self.distributed:
            return None
        axes = tuple(axes)
        if axes not in self._groups:
            _, procs = self.layout(axes)
            me, world = dist.get_rank(), dist.get_world_size()
            mine = None
            for ranks in dict.fromkeys(tuple(sorted(set(row.tolist()))) for row in procs):
                g = (dist.group.WORLD if ranks == tuple(range(world))
                     else dist.new_group(list(ranks)))
                if me in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


def local_device_count() -> int:
    """CUDA devices this process sees (0 on a host without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str = "nccl", **kwargs) -> bool:
    """Join the process group of a multi-process run.

    Arguments fall back to ``MASTER_ADDR`` / ``MASTER_PORT`` (as
    ``tcp://ADDR:PORT``) / ``WORLD_SIZE`` / ``RANK``, the recipe above.
    Returns True when distributed mode is active; one process (no world
    size above 1, or no address) is a no-op returning False. Safe to call
    twice. ``backend`` is NCCL (the cards); pass ``"gloo"`` for CPU
    processes."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size <= 1 or not init_method:
        return False
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return True


def is_multi_process(mesh_or_devices=None) -> bool:
    """More than one process among a mesh's slots (``None``: the current
    run)."""
    if mesh_or_devices is None:
        return dist.is_initialized() and dist.get_world_size() > 1
    if isinstance(mesh_or_devices, Mesh):
        return len(set(mesh_or_devices.process_index.reshape(-1).tolist())) > 1
    return False  # a list of torch devices is one process's


def _default_devices() -> list[torch.device]:
    """This process's CUDA devices: all of them in one process, one in a
    process group (``LOCAL_RANK``, else the rank modulo the card count)."""
    resolve_device(None)  # raises on a host without CUDA
    n = torch.cuda.device_count()
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % n))
        return [torch.device("cuda", local)]
    return [torch.device("cuda", i) for i in range(n)]


def _global_devices(devices) -> tuple[list[torch.device], list[int], int]:
    """(every process's devices in process order, each one's process, the
    process count). In a process group each process passes its own
    devices; the lists travel by ``all_gather_object``."""
    local = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if not dist.is_initialized():
        return local, [0] * len(local), 1
    lists: list = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in local])
    flat = [torch.device(d) for lst in lists for d in lst]
    procs = [p for p, lst in enumerate(lists) for _ in lst]
    return flat, procs, len(lists)


def _infer(sizes: list[int], total: int) -> list[int]:
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = total // known
    return sizes


def get_hybrid_mesh(ici_axes: dict[str, int], dcn_axes: dict[str, int], devices=None) -> Mesh:
    """DCN×ICI mesh: ``dcn_axes`` (outer, slowest-varying) split across
    processes, so their collectives cross the network; ``ici_axes`` (inner)
    split within a process. ``-1`` infers: dcn against the process count,
    ici against the devices per process. In one process the same topology
    is emulated by reshaping its devices: the same program, whose
    collectives have no process boundary to cross. ``devices`` are this
    process's own."""
    flat, procs, n_proc = _global_devices(devices)
    per_proc = {p: [d for d, q in zip(flat, procs) if q == p] for p in range(n_proc)}
    n_local = len(per_proc[0])

    dcn_names, dcn_sizes = list(dcn_axes), _infer(list(dcn_axes.values()), n_proc)
    ici_names = list(ici_axes)
    ici_sizes = _infer(list(ici_axes.values()), len(flat) // int(np.prod(dcn_sizes)))
    n_dcn, n_ici = int(np.prod(dcn_sizes)), int(np.prod(ici_sizes))
    if dist.is_initialized():
        if n_dcn != n_proc:
            raise ValueError(f"dcn axes {dcn_axes} must span the {n_proc} processes exactly "
                             f"(got {n_dcn}): ici axes cannot cross a process boundary")
        if n_ici > n_local:
            raise ValueError(f"ici axes {ici_axes} need {n_ici} devices a process, have {n_local}")
        ordered = [d for p in range(n_proc) for d in per_proc[p][:n_ici]]
        owners = [p for p in range(n_proc) for _ in range(n_ici)]
    else:
        if n_dcn * n_ici > len(flat):
            raise ValueError(f"mesh {dcn_axes} x {ici_axes} needs {n_dcn * n_ici} devices, "
                             f"have {len(flat)}")
        ordered, owners = flat[: n_dcn * n_ici], [0] * (n_dcn * n_ici)
    shape = dcn_sizes + ici_sizes
    return Mesh(np.asarray(ordered, dtype=object).reshape(shape), dcn_names + ici_names,
                np.asarray(owners).reshape(shape), distributed=dist.is_initialized())


def get_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A mesh from an axis-name → size dict. ``None`` → 1-D ``{"db": all
    devices}``; one axis may be -1 (inferred). Axis order follows the
    dict's; the innermost axis maps to neighbouring devices. In a process
    group the devices are every process's, in process order."""
    flat, procs, _ = _global_devices(devices)
    n = len(flat)
    axes = {"db": n} if axes is None else axes
    sizes = _infer(list(axes.values()), n)
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    return Mesh(np.asarray(flat[:total], dtype=object).reshape(sizes), list(axes),
                np.asarray(procs[:total]).reshape(sizes), distributed=dist.is_initialized())
