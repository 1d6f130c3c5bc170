"""Logical-axis placement rules and the row-parallel commit GEMM.

PyTorch counterpart of ``repro.distributed.sharding``.  ``param_specs``
(``models.base``) names a logical axis for every tensor dim; this module
maps those names onto mesh axes per execution mode:

  * TRAIN: FSDP, weight ``embed`` dims over the data axes, tensor-parallel
    ``heads/ffn/vocab`` over ``model``, MoE ``experts`` over the data axes.
  * SERVE: weights replicated over data (decode batches go over data),
    tensor-parallel over ``model``; MoE experts over ``model`` (or, with
    ``moe_ep="data"``, over data with each expert's ffn over ``model``).

A *plan* is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of axis names, exactly the entries of the reference's
``PartitionSpec``.  Divisibility fallback: a dim that does not divide by
its axes' product drops axes right to left until it does, so every (arch x
shape x mesh) case gets a plan; a mesh axis is never used twice in one
plan, the first dim wins.  The rules read only a mesh's axis names and
sizes (``launch.mesh._axis_sizes``), so they run for the production
meshes, which no program here spans (``launch.mesh.Mesh``), as for a
``DeviceMesh``; ``param_shardings`` maps plans to DTensor placements and
``local_shape`` gives one rank's shard.

``tp_matmul`` realizes the commit path's pinned K tree across the ranks of
a ``model`` axis over ``torch.distributed`` (gloo on the CPU, NCCL with one
card a rank), bitwise equal to the logical ``core.determinism.matmul`` at
every split schedule; un-pinned, it all-reduces in ``combine_dtype``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core.determinism import (
    Schedule, VERIFY_SCHEDULE, matmul as sched_matmul, torch_dtype, tree_combine,
)
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant_partials
from repro_torch.kernels.gemm_splitk import gemm_splitk_partials
from repro_torch.launch.mesh import Mesh, _axis_sizes
from repro_torch.models.base import ModelConfig, param_specs
from repro_torch.models.transformer import cache_spec
from repro_torch.training.optimizer import tree_map

Axes = Tuple[str, ...]
Plan = Tuple[Any, ...]


def tp_rank_partial(x2: torch.Tensor, w: torch.Tensor, r: int, d: int,
                    schedule: Schedule) -> torch.Tensor:
    """Rank r's f32 local subtree of x2 (M, K) @ w (K, N) cut into
    ``schedule.tp_shards`` canonical chunks over d ranks: the K slice of its
    ``tp_shards / d`` chunks, each chunk's f32 value in one launch, summed by
    ``tree_combine``.  A chunk's value is the reference's per-device
    ``matmul`` under ``schedule._replace(tp_shards=1, tp_pinned=False)``:
    one f32 pass, or the chunk's ``splits`` f32 partials rounded through
    ``combine_dtype`` and folded in split order.  The launch is the partials
    entry of the library the logical GEMM runs (``kernels.ops``): the
    commit GEMM's (``gemm_batch_invariant_partials``) for the pinned
    schedule without splits, the split-K GEMM's (``gemm_splitk_partials``)
    for every other.  On the card both run the operands' own tile; on the
    CPU they are the plain versions on the views the logical path reads."""
    span = x2.shape[-1] // d
    lo, hi = r * span, (r + 1) * span
    chunks = schedule.tp_shards // d
    if schedule.tp_pinned and schedule.splits <= 1:
        parts = gemm_batch_invariant_partials(x2[:, lo:hi], w[lo:hi], chunks=chunks)
    else:
        parts = gemm_splitk_partials(x2[:, lo:hi], w[lo:hi], splits=schedule.splits,
                                     combine_dtype=schedule.combine_dtype,
                                     tp_shards=chunks)
    return tree_combine(list(parts.unbind(0)))


def tp_butterfly(acc: torch.Tensor, r: int, d: int, exchange) -> torch.Tensor:
    """The top log2(d) levels of the pinned tree on rank r: at ``step = 1, 2,
    ...`` below d, ``acc = acc + exchange(acc, r ^ step, step)``, where
    ``exchange`` returns the partner's value entering that level.  That is
    ``((p0+p1)+(p2+p3))`` at every d; IEEE addition commutes bitwise, so
    every rank's (mine + received) is the same sum."""
    step = 1
    while step < d:
        acc = acc + exchange(acc, r ^ step, step)
        step *= 2
    return acc


def p2p_exchange(mine: torch.Tensor, group: Any, coord: int) -> torch.Tensor:
    """Send ``mine`` to the rank at ``coord`` of ``group`` and return what it
    sends back: one ``batch_isend_irecv`` pair, a butterfly level's
    exchange."""
    import torch.distributed as dist

    peer = dist.get_global_rank(group, coord)
    got = torch.empty_like(mine)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer, group),
                                       dist.P2POp(dist.irecv, got, peer, group)]):
        req.wait()
    return got


def tp_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    mesh: Any,
    *,
    axis: str = "model",
    schedule: Schedule = VERIFY_SCHEDULE,
) -> torch.Tensor:
    """Row-parallel commit-path GEMM under the canonical mesh-reduction
    schedule.  Every rank passes the same global x (..., K) and w (K, N) and
    gets the full (..., N) product in x.dtype.

    The rank at coordinate r of the ``axis`` mesh dim (width d) takes its
    local subtree (``tp_rank_partial``: its chunks under the schedule's
    ``splits`` and ``combine_dtype``).  Pinned, a recursive-doubling
    butterfly over the axis's process group (``tp_butterfly``, the partner's
    value by ``p2p_exchange``) completes the tree in the reference's
    association, so the result equals ``matmul(x, w, schedule)`` bitwise
    for every power-of-two d dividing ``tp_shards``.  Un-pinned, the
    partials meet in an ``all_reduce`` in ``combine_dtype``: the fast-path
    hazard, whose result follows d.

    Falls back to the logical ``matmul`` when the axis is absent or 1 wide,
    ``tp_shards <= 1`` or ``> K``, d does not divide ``tp_shards``,
    ``tp_shards`` does not divide K, or d is not a power of two.  A ``Mesh``
    description spans no ranks, so past the fallback it is refused.  On a
    card, x must lie on the current device (``torch.cuda.set_device``, one
    card a rank): the kernels launch on the current device."""
    K = x.shape[-1]
    d = _axis_sizes(mesh).get(axis, 1)
    tp = schedule.tp_shards
    if (d <= 1 or tp <= 1 or tp > K
            or tp % d != 0 or K % tp != 0 or (d & (d - 1)) != 0):
        return sched_matmul(x, w, schedule)
    if isinstance(mesh, Mesh):
        raise TypeError("tp_matmul: a Mesh description spans no ranks; pass a "
                        "DeviceMesh (launch.mesh.make_host_mesh)")
    if x.is_cuda and x.device.index != torch.cuda.current_device():
        raise ValueError(f"tp_matmul: x on {x.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    import torch.distributed as dist

    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    acc = tp_rank_partial(x.reshape(-1, K).contiguous(), w, r, d, schedule)
    if schedule.tp_pinned:
        acc = tp_butterfly(acc, r, d, lambda mine, coord, _step: p2p_exchange(
            mine, group, coord))
    else:
        acc = acc.to(torch_dtype(schedule.combine_dtype))
        dist.all_reduce(acc, group=group)
    return acc.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


def _data_axes(mesh: Any) -> Axes:
    return ("pod", "data") if "pod" in _axis_sizes(mesh) else ("data",)


def rules_train(mesh: Any, *, fsdp: bool = True) -> Dict[str, Any]:
    """fsdp=False replicates weights over the data axes (pure DP x TP),
    trading memory for the per-layer all-gather traffic."""
    d = _data_axes(mesh)
    return {
        "embed": d if fsdp else None,
        "heads": "model", "kv": "model", "ffn": "model", "vocab": "model",
        "experts": d, "inner": "model", "state": None, "layers": None,
    }


def rules_serve(mesh: Any, *, moe_ep: str = "model") -> Dict[str, Any]:
    """moe_ep: the mesh axis of the MoE expert dim at serving time.
    ``"model"``: experts over ``model``, each expert's weights whole on its
    rank, 1/model of the expert weights a rank.  ``"data"``: experts over
    data and each expert's ffn over ``model`` (the ``ffn`` rule), 1/(data x
    model) a rank; a batch's token-to-expert dispatch then crosses the data
    axis."""
    return {
        "embed": None,
        "heads": "model", "kv": "model", "ffn": "model", "vocab": "model",
        "experts": moe_ep, "inner": "model", "state": None, "layers": None,
    }


def _normalize(entry) -> Axes:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_for(shape: Sequence[int], axes: Axes, rules: Dict[str, Any],
             mesh: Any) -> Plan:
    """The plan of one tensor, with the divisibility and reuse fallbacks."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        proposal = [a for a in _normalize(rules.get(ax)) if a not in used]
        # drop axes right to left until the dim divides
        while proposal:
            if dim % math.prod(sizes[a] for a in proposal) == 0:
                break
            proposal = proposal[:-1]
        if proposal:
            used.update(proposal)
            parts.append(tuple(proposal) if len(proposal) > 1 else proposal[0])
        else:
            parts.append(None)
    return tuple(parts)


def param_pspecs(cfg: ModelConfig, mesh: Any, rules: Dict[str, Any]) -> Any:
    """Plans of ``param_specs(cfg)``: the reference's parameter tree, at the
    published widths (``unembed_pspec`` plans the port's stored
    unembedding)."""
    return tree_map(lambda s: spec_for(s.shape, s.axes, rules, mesh), param_specs(cfg))


def unembed_pspec(cfg: ModelConfig, mesh: Any, rules: Dict[str, Any]) -> Plan:
    """The plan of a serving tree's ``unembed`` (``models.base.
    finish_unembedding``): a tied config's (d_model, vocab) copy of
    ``embed.T``, or an untied config's own leaf.  It is computed at the
    published vocabulary, as the reference plans ``unembed`` (an untied
    config's plan is the reference's), and applies unchanged to the stored
    width ``padded_vocab``: where the padding changes the width (seamless:
    256206 stored as 256208) the published width does not divide the model
    axis, so the vocab dim is replicated and the padded width needs no
    divisibility."""
    return spec_for((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), rules, mesh)


def placements(plan: Plan, mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of a plan, one per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim d is planned over, ``Replicate()`` elsewhere.
    A dim over two mesh axes (``("pod", "data")``) takes ``Shard(d)`` on
    both; DTensor then orders its shards with the earlier mesh dim major, as
    a ``PartitionSpec`` orders them with its first axis major, so the plan's
    axes must come in mesh order (the rules' ``("pod", "data")`` do)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(plan):
        idx = [names.index(a) for a in _normalize(entry)]
        if idx != sorted(idx):
            raise ValueError(f"plan {plan}: axes of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def param_shardings(cfg: ModelConfig, mesh: Any, rules: Dict[str, Any]) -> Any:
    """The tree of DTensor placements of ``param_pspecs``: the counterpart of
    the reference's ``NamedSharding`` tree, for ``distribute_tensor(t,
    mesh, placements)`` on a ``DeviceMesh``."""
    return tree_map(lambda p: placements(p, mesh), param_pspecs(cfg, mesh, rules))


def local_shape(shape: Sequence[int], plan: Plan, mesh: Any) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``plan``; raises where a planned dim does not divide."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        n = math.prod(sizes[a] for a in _normalize(plan[i] if i < len(plan) else None))
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide by {n} ({plan})")
        out.append(dim // n)
    return tuple(out)


def batch_pspec(mesh: Any) -> Plan:
    return (_data_axes(mesh),)


_SENTINEL_B, _SENTINEL_C = 1717, 1719


def cache_pspec_tree(
    cfg: ModelConfig, mesh: Any, batch: int, capacity: int,
    *, kv_policy: str = "feature_first",
) -> Any:
    """Plans of the serving cache tree (``models.transformer.cache_spec``).

    Batch dims go over the data axes.  The model-axis placement of KV
    leaves is a policy:

    * ``feature_first``: the first model-divisible non-batch dim past axis
      0 (kv_heads where they divide, else head_dim).
    * ``seq_first``: the cache's sequence dim over ``model`` (sequence-
      parallel decoding), else as ``feature_first``.

    Recurrent-state leaves shard their d_inner or head dim over ``model``.
    Batch and sequence dims are found through sentinel-sized template
    shapes (batch 1717, capacity 1719).

    The port's tree differs from the reference's in layout in two places,
    and the plans map one to one: the ``head_layers/{i}`` leaves and the
    cross cache's ``mask`` carry a leading layer axis of one here ((1, B,
    ...) against (B, ...); ``cross.mask`` (1, B, Se) against (B, Se)).
    That axis has size 1, so it is never sharded (and the feature rule
    never takes axis 0), and the port's plan is the reference's with a
    leading ``None``: the same tensor dims on the same mesh axes."""
    sizes = _axis_sizes(mesh)
    model = sizes.get("model", 1)
    d = _data_axes(mesh)
    dprod = math.prod(sizes[a] for a in d)

    template = cache_spec(cfg, _SENTINEL_B, _SENTINEL_C)
    real = cache_spec(cfg, batch, capacity)

    def leaf_spec(tshape: Tuple[int, ...], rshape: Tuple[int, ...]) -> Plan:
        parts: list = [None] * len(rshape)
        seq_axis = None
        for i, (td, rd) in enumerate(zip(tshape, rshape)):
            if td == _SENTINEL_B:  # batch axis
                if rd % dprod == 0:
                    parts[i] = tuple(d) if len(d) > 1 else d[0]
                elif len(d) > 1 and rd % sizes[d[-1]] == 0:
                    parts[i] = d[-1]
            elif td == _SENTINEL_C:
                seq_axis = i

        def try_seq() -> bool:
            if (seq_axis is not None and rshape[seq_axis] % model == 0
                    and parts[seq_axis] is None):
                parts[seq_axis] = "model"
                return True
            return False

        def try_feature() -> bool:
            cand = [
                i for i, (td, rd) in enumerate(zip(tshape, rshape))
                if td not in (_SENTINEL_B, _SENTINEL_C) and parts[i] is None
                and rd % model == 0 and rd >= model and i >= 1
            ]
            if cand:
                parts[cand[0]] = "model"
                return True
            return False

        if kv_policy == "seq_first" and seq_axis is not None:
            try_seq() or try_feature()
        else:
            try_feature() or try_seq()
        return tuple(parts)

    def walk(t: Any, r: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(t[k], r[k]) for k in t}
        return leaf_spec(t[0], r[0])  # (shape, dtype) leaves

    return walk(template, real)
