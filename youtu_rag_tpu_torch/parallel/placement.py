"""A parameter tree placed on a mesh with a data-parallel and a model axis.

The port's counterpart of GSPMD's ``NamedSharding`` for the trainers: a
``("dp", "tp")`` or ``("dp", "ep")`` mesh (``parallel.mesh``) and a spec
tree (one tuple of axis names per tensor, ``None`` for a dimension that
does not split) say where each leaf lives. ``Placement.place`` turns a full
tree into this process's replicas:

- a **replica** is a run of consecutive dp rows whose model-axis slots sit
  on the same devices (on one card, every row: they run as one forward over
  their rows of the batch, as the data-parallel embedder runs the slices
  that share a device), or, on a group mesh, this process's one (dp, model)
  slot;
- in a replica's tree a leaf the spec splits over the model axis is a list
  of this process's shards of it (every shard on a local mesh, its own on a
  process group), each on its slot's device; every other leaf is one
  tensor on the replica's first device.

A step then computes the global loss in every replica (``gather_dp`` /
``reduce_dp``: the embeddings or the loss terms of every dp row, with the
backward of ``parallel.comm``), sums each gradient over the replicas
(``sync_grads``) and updates every replica alike, so the replicas stay bit
for bit equal. ``grad_norm_sq`` counts each split leaf's shards once and
each replicated leaf once, for the optimizer's global-norm clip.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .comm import GroupAxis, LocalAxis, sum_over


def resolve_spec(tree: dict, spec: dict, sizes: dict[str, int]) -> dict:
    """``spec`` shaped exactly like ``tree``: leaves it does not know, and
    leaves with a split dimension that ``sizes`` (axis → size) does not
    divide, replicate (JAX's ``sharding_spec_for`` rule)."""
    def divides(v, s) -> bool:
        return len(s) == v.dim() and all(
            a is None or v.shape[i] % sizes.get(a, 1) == 0 for i, a in enumerate(s))

    def walk(p, b):
        out = {}
        for k, v in p.items():
            s = b.get(k) if isinstance(b, dict) else None
            if isinstance(v, dict):
                out[k] = walk(v, s if isinstance(s, dict) else {})
            else:
                out[k] = s if isinstance(s, tuple) and divides(v, s) else (None,) * v.dim()
        return out

    return walk(tree, spec)


def _chunk(name: str, t: torch.Tensor, rank: int, n: int, dim: int) -> torch.Tensor:
    return t.chunk(n, dim=dim)[rank]


def _cat(name: str, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    return torch.cat(parts, dim)


@dataclass
class Replica:
    rows: tuple[int, int]  # its dp rows [first, end)
    axis: LocalAxis | GroupAxis  # the model axis' shards in this process

    @property
    def device(self) -> torch.device:
        return self.axis.devices[0]


class Placed(list):
    """The replicas' trees of a placed parameter tree (``Placement.place``);
    ``gather()`` gives the full tree back."""

    placement: "Placement"

    def gather(self, device=None) -> dict:
        return self.placement.gather(self, device)


class Placement:
    """Where a tree shaped like ``spec`` lives on ``mesh`` (module
    docstring). ``spec`` is resolved for the tree (``resolve_spec``; None
    for a placement that only names the replicas and their axes);
    ``slicer(name, t, rank, n, dim)`` cuts model-axis rank ``rank``'s part of
    a split leaf and ``joiner(name, parts, dim)`` joins the parts back
    (default: even chunks along the split dimension)."""

    def __init__(self, mesh, spec: dict | None, model_axis: str, slicer=None, joiner=None):
        shape = mesh.shape
        self.model_axis = model_axis
        self.spec = spec
        self.slicer = slicer or _chunk
        self.joiner = joiner or _cat
        self.dp = shape.get("dp", 1)
        self.n = shape.get(model_axis, 1)
        axes = tuple(a for a in ("dp", model_axis) if a in shape)
        devs, procs = mesh.layout(axes)
        if devs.shape[0] != 1:
            raise ValueError(f"mesh {shape}: axes other than {axes} must have size 1")
        devs, procs = devs[0].reshape(self.dp, self.n), procs[0].reshape(self.dp, self.n)
        if mesh.distributed:
            me = dist.get_rank()
            mine = [(i, j) for i in range(self.dp) for j in range(self.n) if procs[i, j] == me]
            if len(mine) != 1:
                raise ValueError("a group mesh holds one (dp, model) slot per process")
            (i, j), = mine
            model_group = mesh.group((model_axis,)) if model_axis in shape else None
            axis = (GroupAxis(model_group, devs[i, j]) if model_group is not None
                    else LocalAxis([devs[i, j]]))
            self.replicas = [Replica((i, i + 1), axis)]
            self.dp_group = mesh.group(("dp",)) if "dp" in shape else None
            self.model_group = model_group
        else:
            self.replicas = []
            for i in range(self.dp):
                row = [torch.device(d) for d in devs[i]]
                if self.replicas and self.replicas[-1].axis.devices == row:
                    self.replicas[-1].rows = (self.replicas[-1].rows[0], i + 1)
                else:
                    self.replicas.append(Replica((i, i + 1), LocalAxis(row)))
            self.dp_group = self.model_group = None

    # -- placing and gathering trees ----------------------------------------

    def _split_dim(self, s: tuple) -> int | None:
        return s.index(self.model_axis) if self.model_axis in s else None

    def place(self, tree: dict) -> Placed:
        """This process's replicas of the full tree ``tree`` (copies: a
        replica's tensors are its own)."""
        out = Placed(self._place_one(tree, self.spec, r) for r in self.replicas)
        out.placement = self
        return out

    def _place_one(self, tree: dict, spec: dict, r: Replica) -> dict:
        placed = {}
        for k, v in tree.items():
            s = spec[k]
            if isinstance(v, dict):
                placed[k] = self._place_one(v, s, r)
                continue
            v = v.detach()
            dim = self._split_dim(s)
            if dim is None:
                placed[k] = v.to(device=r.device, copy=True)
            else:
                placed[k] = [self.slicer(k, v, j, self.n, dim).to(device=d, copy=True)
                             .contiguous() for j, d in zip(r.axis.ranks, r.axis.devices)]
        return placed

    def gather(self, placed: list, device=None) -> dict:
        """The full tree of replica 0 (all gathered over the model axis'
        group on a group mesh: every rank takes part), on ``device``
        (default: the replica's first device)."""
        r = self.replicas[0]
        return self._gather_one(placed[0], self.spec, r, torch.device(device or r.device))

    def _gather_one(self, tree: dict, spec: dict, r: Replica, device) -> dict:
        out = {}
        for k, v in tree.items():
            s = spec[k]
            if isinstance(v, dict):
                out[k] = self._gather_one(v, s, r, device)
            elif not isinstance(v, list):
                out[k] = v.detach().to(device)
            else:
                parts = [p.detach() for p in v]
                if self.model_group is not None:
                    (p,) = parts
                    parts = [torch.empty_like(p) for _ in range(self.n)]
                    dist.all_gather(parts, p.contiguous(), group=self.model_group)
                out[k] = self.joiner(k, [p.to(device) for p in parts],
                                     self._split_dim(s)).contiguous()
        return out

    def gather_flat(self, placed: list, flat: list[torch.Tensor], device=None) -> dict:
        """``gather`` of the tree shaped like ``placed`` whose tensors are
        ``flat`` (in ``leaves`` order: a step's gradients)."""
        it = iter(flat)

        def rebuild(t):
            if isinstance(t, dict):
                return {k: rebuild(v) for k, v in t.items()}
            if isinstance(t, list):
                return [rebuild(v) for v in t]
            return next(it)

        return self.gather([rebuild(placed[0])], device)

    def place_opt_state(self, state: dict) -> dict:
        """A ``ChainedAdamW`` state of the full tree, placed as the
        parameters are."""
        return {"count": state["count"].clone(), "mu": self.place(state["mu"]),
                "nu": self.place(state["nu"])}

    def gather_opt_state(self, state: dict, device=None) -> dict:
        return {"count": state["count"].clone(), "mu": self.gather(state["mu"], device),
                "nu": self.gather(state["nu"], device)}

    # -- a step's collectives over dp ---------------------------------------

    def batch_rows(self, r: Replica, n: int) -> slice:
        """Replica ``r``'s rows of a global batch of ``n``."""
        if n % self.dp:
            raise ValueError(f"batch {n} does not split over dp = {self.dp}")
        per = n // self.dp
        return slice(r.rows[0] * per, r.rows[1] * per)

    def gather_dp(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every dp row's rows of a per-replica tensor, in row order, on the
        first replica's device (the backward keeps each replica's rows)."""
        if self.dp_group is not None:
            (p,) = parts
            return GroupAxis(self.dp_group, p.device).gather([p], 0)
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts])

    def reduce_dp(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The replicas' terms summed over every dp row (identity backward:
        each replica keeps its own term's gradient)."""
        if self.dp_group is not None:
            (p,) = parts
            return GroupAxis(self.dp_group, p.device).reduce([p])
        dev = parts[0].device
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(dev)
        return total

    def sum_dp(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """``reduce_dp`` of tensors that need no gradient (counts)."""
        if self.dp_group is not None:
            return sum_over(self.dp_group, [parts[0].detach()])[0]
        with torch.no_grad():
            return self.reduce_dp([p.detach() for p in parts])

    def sync_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """``grads`` in ``leaves(placed)`` order, each summed over the dp
        rows: over this process's replicas, then over the dp group."""
        m = len(grads) // len(self.replicas)
        if len(self.replicas) > 1:
            summed = []
            for i in range(m):
                total = grads[i]
                for r in range(1, len(self.replicas)):
                    total = total + grads[r * m + i].to(total.device)
                summed.append(total)
            grads = [summed[i].to(grads[r * m + i].device)
                     for r in range(len(self.replicas)) for i in range(m)]
        return sum_over(self.dp_group, grads)

    def split_flags(self, placed: list) -> list[bool]:
        """For each leaf of one replica's tree (``leaves`` order): whether it
        is a shard of a split leaf."""
        flags = []

        def walk(t):
            for v in t.values():
                if isinstance(v, dict):
                    walk(v)
                elif isinstance(v, list):
                    flags.extend([True] * len(v))
                else:
                    flags.append(False)

        walk(placed[0])
        return flags

    def grad_norm_sq(self, grads: list[torch.Tensor], placed: list) -> torch.Tensor:
        """The full gradient tree's squared norm from replica 0's leaves:
        each split leaf's shards (all-reduced over the model axis' group)
        and each replicated leaf once."""
        flags = self.split_flags(placed)
        dev = self.replicas[0].device
        split = torch.zeros((), dtype=torch.float32, device=dev)
        rep = torch.zeros((), dtype=torch.float32, device=dev)
        for g, f in zip(grads[: len(flags)], flags):
            sq = torch.sum(g.float() ** 2).to(dev)
            if f:
                split = split + sq
            else:
                rep = rep + sq
        if self.model_group is not None:
            split = sum_over(self.model_group, [split])[0]
        return rep + split
