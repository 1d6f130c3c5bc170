"""Fixed-shape grouped verification pass (paper §4.2–4.3).

PyTorch counterpart of ``repro.core.verifier``: ``make_verify_body(cfg, G,
W, layout, paged=True)`` returns the function that replays G requests × W
tokens in ONE forward pass of a fixed (G, W) shape under
``VERIFY_SCHEDULE``.  Fixed shape + fixed schedule => every reduction is
shape-consistent => the replay is bitwise reproducible, which makes it the
deterministic reference execution.  On the card every GEMM of the pass runs
in the batch-invariant kernel (``kernels/csrc/gemm_batch_invariant.cu``).
Its K reduction is the canonical TP decomposition (``tp_shards`` f32
partials, balanced-tree f32 combine), which a width-d ``model`` mesh
realizes bitwise for every power-of-two d dividing ``tp_shards``
(``distributed.sharding.tp_matmul``): the fast path may run at any TP
width, the replay's partial-sum tree never follows it.

Per row:
  inputs  = [conditioning_token, cand_0, …, cand_{W-2}]    (padded to W)
  outputs = verifier tokens v_0 … v_{W-1}
  n_match = length of the leading run where v_j == cand_j among the row's
            real candidates
  commit  = cand_0 … cand_{n_match-1}  plus  v_{n_match}

The verifier's own KV writes overwrite the fast path's entries for all W
window positions (pointer-free rollback).  Unlike the JAX body, which
returns a new pool, the pool leaves are repaired in place.  Padding rows
carry an all-empty block table: their reads hit the null block and their
writes land in the scratch block.  ``paged=True`` reads and writes the
pool through the block tables; ``paged=False`` gathers per-row views,
replays on them and scatters them back (``serving.kv_cache.pool_forward``).
Both run the same universal schedule over views whose content is
position-for-position identical, so committed streams are bitwise equal
between them.  Slot leaves (sliding rings, recurrent state) are row-packed
by ``slots`` in either lane and written back after the replay.

Recurrent state (rwkv, mamba) cannot be truncated.  ``verify_recurrent``
replays from the state pool's anchor (``serving.statepool``), collects the
state after every window position, and routes two selections through the
pool: the state at index ``n_match`` (the window's commit checkpoint,
which the engine writes to a ring buffer) and the state before the last
real input (the anchor the next chained window starts from).  The live recurrent
state is written back unchanged: the fast path may be speculating past
the window right now.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.core.determinism import (
    CANONICAL_MESH_SCHEDULE, CANONICAL_TP_SHARDS, VERIFY_SCHEDULE,
)
from repro_torch.models.base import ModelConfig
from repro_torch.serving import statepool
from repro_torch.serving.blockpool import Layout
from repro_torch.models.layers import PagedView
from repro_torch.models.transformer import forward
from repro_torch.serving.kv_cache import pool_forward, pool_views, pool_writeback, slot_index
from repro_torch.serving.sampler import sample_window, top2_margin

# The commit path replays under the canonical mesh-reduction schedule.
assert VERIFY_SCHEDULE.tp_pinned, "verify schedule must pin the TP tree"
assert VERIFY_SCHEDULE.tp_shards == CANONICAL_TP_SHARDS
assert CANONICAL_MESH_SCHEDULE == VERIFY_SCHEDULE


def _match_and_commit(v_tokens: torch.Tensor, cand: torch.Tensor,
                      cand_len: torch.Tensor, W: int):
    """(n_match, commit_tok), each (G,).  ``n_match`` is the index of the
    first position that is not a matching real candidate (W - 1 if all
    match); the first-max ``argmax`` finds it without a scan."""
    G = v_tokens.shape[0]
    valid = torch.arange(W - 1, device=v_tokens.device)[None, :] < cand_len[:, None]
    ok = (v_tokens[:, : W - 1] == cand) & valid
    stop = torch.cat([~ok, torch.ones((G, 1), dtype=torch.bool,
                                      device=ok.device)], dim=1)
    n_match = stop.to(torch.int32).argmax(dim=1)
    commit_tok = torch.gather(v_tokens, 1, n_match[:, None].long())[:, 0]
    return n_match, commit_tok


# det: commit-path
def make_verify_body(
    cfg: ModelConfig, G: int, W: int, layout: Layout, paged: bool = True
):
    """The grouped-verification body for fixed (G, W).

    Returns ``verify_attn(params, pool, slots, tables, start_pos, inputs,
    cand, cand_len, seeds, temps, out_base, top_ks) -> (pool, n_match,
    commit_tok, v_tokens, margins)``: ``tables`` (G, nblk), ``start_pos``
    (G,), ``inputs`` (G, W), ``cand`` (G, W-1) with -1 pads and
    ``cand_len`` (G,) are device tensors; ``seeds``, ``temps``, ``out_base``
    and ``top_ks`` are host sequences or (G,) device tensors (each window
    position samples with its own counter).  ``slots`` names each row's
    slot (pad rows: the scratch slot), as a sequence or as the index tensor
    an engine program's host prep checked (``kv_cache.slot_index``): slot
    leaves (sliding rings) are row-packed by it and scattered back, paged
    leaves are repaired through ``tables``.  The engine runs this body as
    its ``("verify", G, W)`` program (``serving.programs``), the
    counterpart of the reference's ``make_verify_fn``.
    ``margins`` (G, W) is the audit log's top-1/top-2 margin per position,
    computed unconditionally so the device program does not depend on
    auditing.

    A config with recurrent state gets ``verify_recurrent(params, pool,
    anchor, slots, ...) -> (pool, anchor, commit_rows, n_match,
    commit_tok, v_tokens, margins)`` instead: ``anchor`` is the state
    pool's replay-anchor tree (advanced in place to each row's next
    chained start state), ``commit_rows`` each row's state at its commit
    index, for the state pool's ring."""
    if statepool.has_recurrent_state(cfg):
        return _verify_recurrent_body(cfg, W, layout, paged)

    def verify_attn(
        params: Dict,
        pool: Any,
        slots: Sequence[int],
        tables: torch.Tensor,
        start_pos: torch.Tensor,
        inputs: torch.Tensor,
        cand: torch.Tensor,
        cand_len: torch.Tensor,
        seeds: Sequence[int],
        temps: Sequence[float],
        out_base: Sequence[int],
        top_ks: Sequence[int],
    ):
        logits, pool = pool_forward(
            params, cfg, layout, pool, slots, tables, start_pos, VERIFY_SCHEDULE,
            paged=paged, tokens=inputs,
        )
        v_tokens = sample_window(logits, seeds, out_base, temps, top_ks)
        n_match, commit_tok = _match_and_commit(v_tokens, cand, cand_len, W)
        margins = top2_margin(logits)
        return pool, n_match, commit_tok, v_tokens, margins

    return verify_attn


def _verify_recurrent_body(cfg: ModelConfig, W: int, layout: Layout, paged: bool):
    pview = (PagedView(layout.block_size, layout.null_bid, layout.scratch_bid)
             if paged else None)

    def verify_recurrent(
        params: Dict,
        pool: Any,
        anchor: Any,  # state-pool replay-anchor tree
        slots: Sequence[int],
        tables: torch.Tensor,
        start_pos: torch.Tensor,
        inputs: torch.Tensor,
        cand: torch.Tensor,
        cand_len: torch.Tensor,
        seeds: Sequence[int],
        temps: Sequence[float],
        out_base: Sequence[int],
        top_ks: Sequence[int],
    ):
        idx = slot_index(pool, layout, slots, tables.device)
        cache = pool_views(pool, layout, idx, tables, paged=paged)
        live_rows = statepool.rows_from_cache(cache)
        # the replay starts from the anchor: the state after everything
        # preceding the window, minus its conditioning token (consumed first)
        cache = statepool.merge_rows(cache, statepool.gather_rows(anchor, idx))
        logits, cache, per_pos = forward(
            params, cfg, inputs, cache=cache, start_pos=start_pos,
            schedule=VERIFY_SCHEDULE, collect_states=True,
            tables=tables if paged else None, paged=pview)
        v_tokens = sample_window(logits, seeds, out_base, temps, top_ks)
        n_match, commit_tok = _match_and_commit(v_tokens, cand, cand_len, W)
        margins = top2_margin(logits)
        # per_pos[j] = state after consuming inputs[j]
        commit_rows = statepool.select_index(per_pos, n_match)
        resume_rows = statepool.select_index(per_pos, (cand_len - 1).clamp_min(0))
        anchor = statepool.scatter_rows(anchor, idx, resume_rows)
        # KV repair reaches the live pool; recurrent state does not: the
        # fast path may be speculating past this window right now
        cache = statepool.merge_rows(cache, live_rows)
        pool = pool_writeback(pool, layout, idx, tables, cache, paged=paged)
        return pool, anchor, commit_rows, n_match, commit_tok, v_tokens, margins

    return verify_recurrent
