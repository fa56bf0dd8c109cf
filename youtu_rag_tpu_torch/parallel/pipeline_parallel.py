"""Pipeline-parallel encoder: GPipe microbatches over a ``pp`` mesh axis.

The port's counterpart of ``youtu_rag_tpu/parallel/pipeline_parallel.py``.
The layers are stacked on a leading axis, so pipeline parallelism cuts that
axis: stage s holds layers [s·L/S, (s+1)·L/S) (``shard_params_pp``), and
microbatches hop from stage to stage. The schedule is JAX's fill-drain
loop: M microbatches through S stages in M + S - 1 ticks, stage s working
on microbatch t - s at tick t when that is in range, and the bubble is
(S - 1) / (M + S - 1) of each stage's ticks. Where JAX's stages compute
(and discard) a microbatch in the bubble ticks, here an idle stage does
nothing, so each stage runs each microbatch once: M·L layer forwards in
all.

The embedding lookup, the final LayerNorm and the pooling run outside the
pipeline, on the first stage's device; the pipeline moves only [mb, T, D]
activations. As in JAX, the pooling is ``pool_project``'s (never the
lexical pools). The mesh is one of ``parallel.mesh``'s two forms:

- a local mesh: every stage in this process, on its slot's device (a device
  may repeat); a hop hands the stage's output to the next stage's device;
- a group mesh: one stage per rank of the ``pp`` axis' process group; a hop
  is a send to the next rank and a receive from the previous one
  (``batch_isend_irecv``, as the ring's), and the last stage broadcasts the
  finished microbatches.

The forward is inference: it runs under ``torch.no_grad`` (with "pallas"
the layers at T >= 256 launch the blockwise kernel on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.encoder import (
    EncoderConfig,
    _layer_norm,
    _preln_layer,
    layer_views,
    masked_pool_sums,
    pool_project,
)


def _stages(mesh, pp_axis: str):
    """(S, [(stage, device)] of this process's stages, the pp group or None)."""
    devs, procs = mesh.layout((pp_axis,))
    if devs.shape[0] != 1:
        raise ValueError(f"mesh {mesh.shape}: axes other than {pp_axis!r} must have size 1")
    devs, procs = devs[0], procs[0]
    if not mesh.distributed:
        return len(devs), [(s, torch.device(d)) for s, d in enumerate(devs)], None
    me = dist.get_rank()
    mine = [(s, torch.device(d)) for s, d in enumerate(devs) if procs[s] == me]
    if len(mine) != 1:
        raise ValueError("a group mesh holds one pipeline stage per process")
    return len(devs), mine, mesh.group((pp_axis,))


def shard_params_pp(params: dict, mesh, pp_axis: str = "pp") -> dict:
    """Place the tree for the pipeline: ``layers`` becomes a list of this
    process's stages' layer slices (stage s's [L/S, ...] stacks on its
    device: all S on a local mesh, its own on a group mesh); every other
    leaf replicated on the first local stage's device."""
    n_stages, mine, _ = _stages(mesh, pp_axis)
    n_layers = next(iter(params["layers"].values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    per = n_layers // n_stages
    first = mine[0][1]
    out = {k: v.detach().to(first) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.detach()[s * per : (s + 1) * per].to(d)
                      for k, v in params["layers"].items()} for s, d in mine]
    return out


def make_pp_encoder(cfg: EncoderConfig, mesh, pp_axis: str = "pp", n_micro: int | None = None):
    """The pipeline forward over ``mesh``'s ``pp_axis`` with ``n_micro``
    microbatches (default: the stage count). Returns ``fn(params,
    token_ids, mask) -> (emb, cls)``, ``encode_tokens``' contract (the
    preln_rope arch), ``params`` from ``shard_params_pp``. The batch must
    divide into the microbatches and the layers into the stages; every rank
    of a group mesh returns the whole result."""
    n_stages, mine, group = _stages(mesh, pp_axis)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into {n_stages} stages")
    n_mb = n_micro or n_stages
    per = cfg.n_layers // n_stages

    def stage_forward(layers: dict, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for lp in layer_views(layers, per):
            x = _preln_layer(x, mask, lp, cfg)
        return x

    @torch.no_grad()
    def fn(params: dict, token_ids: torch.Tensor, mask: torch.Tensor):
        b, t = token_ids.shape
        if b % n_mb:
            raise ValueError(f"batch {b} must divide into {n_mb} microbatches")
        mb = b // n_mb
        dev = mine[0][1]
        ids, mask = token_ids.long().to(dev), mask.to(dev)
        xm = params["tok_emb"][ids].to(cfg.dtype).reshape(n_mb, mb, t, cfg.d_model)
        mm = mask.reshape(n_mb, mb, t)
        if group is None:
            y = _local_pipeline(params["layers"], xm, mm, mine, stage_forward)
        else:
            y = _group_pipeline(params["layers"][0], xm, mm, mine[0], n_stages, group,
                                stage_forward)
        y = _layer_norm(y.reshape(b, t, cfg.d_model), params["final_ln_scale"],
                        params["final_ln_bias"])
        return pool_project(params, *masked_pool_sums(y, mask)), y[:, 0, :].float()

    return fn


def _local_pipeline(stage_layers, xm, mm, stages, stage_forward):
    """The fill-drain ticks with every stage here: the finished microbatches
    [M, mb, T, D] on the first stage's device."""
    n_mb, n_stages = xm.shape[0], len(stages)
    held: list = [None] * n_stages  # the activation each stage got last tick
    outs: list = [None] * n_mb
    for tick in range(n_mb + n_stages - 1):
        handed: list = [None] * n_stages
        for s, dev in stages:
            m = tick - s
            if not 0 <= m < n_mb:
                continue
            x_in = xm[m].to(dev) if s == 0 else held[s]
            y = stage_forward(stage_layers[s], x_in, mm[m].to(dev))
            if s == n_stages - 1:
                outs[m] = y.to(xm.device)
            else:
                handed[s + 1] = y.to(stages[s + 1][1])  # the hop
        held = handed
    return torch.stack(outs)


def _hop(op, t: torch.Tensor, peer: int, group) -> None:
    """One side of a stage-to-stage hop through ``batch_isend_irecv`` (the
    ring's primitive), waited on."""
    for work in dist.batch_isend_irecv([dist.P2POp(op, t, peer, group)]):
        work.wait()


def _group_pipeline(layers, xm, mm, stage, n_stages, group, stage_forward):
    """The fill-drain ticks of this rank's stage: receive from the previous
    stage, run, send to the next; the last stage's outputs broadcast."""
    s, dev = stage
    n_mb = xm.shape[0]
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n_stages - 1 else None
    outs = torch.zeros_like(xm)
    for tick in range(n_mb + n_stages - 1):
        m = tick - s
        if not 0 <= m < n_mb:
            continue
        if prev is None:
            x_in = xm[m]
        else:
            x_in = torch.empty_like(xm[m])
            _hop(dist.irecv, x_in, prev, group)
        y = stage_forward(layers, x_in, mm[m])
        if nxt is None:
            outs[m] = y
        else:
            _hop(dist.isend, y.contiguous(), nxt, group)
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1), group=group)
    return outs
