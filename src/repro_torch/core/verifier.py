"""Fixed-shape grouped verification pass (paper §4.2–4.3), attention archs.

PyTorch counterpart of ``repro.core.verifier``: ``make_verify_body(cfg, G,
W, layout, paged=True)`` returns the function that replays G requests × W
tokens in ONE forward pass of a fixed (G, W) shape under
``VERIFY_SCHEDULE``.  Fixed shape + fixed schedule => every reduction is
shape-consistent => the replay is bitwise reproducible, which makes it the
deterministic reference execution.  On the card every GEMM of the pass runs
in the batch-invariant kernel (``kernels/csrc/gemm_batch_invariant.cu``).

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
between them.  Recurrent-state verification (``verify_recurrent``) waits
for a later slice.
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
from repro_torch.serving.kv_cache import pool_forward
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


def make_verify_body(
    cfg: ModelConfig, G: int, W: int, layout: Layout, paged: bool = True
):
    """The grouped-verification body for fixed (G, W).

    Returns ``verify_attn(params, pool, slots, tables, start_pos, inputs,
    cand, cand_len, seeds, temps, out_base, top_ks) -> (pool, n_match,
    commit_tok, v_tokens, margins)``: ``tables`` (G, nblk), ``start_pos``
    (G,), ``inputs`` (G, W), ``cand`` (G, W-1) with -1 pads and
    ``cand_len`` (G,) are device tensors; ``seeds``, ``temps``, ``out_base``
    and ``top_ks`` are host sequences (each window position samples with
    its own counter).  ``slots`` names each row's slot, which the dense
    family's pool does not index.
    ``margins`` (G, W) is the audit log's top-1/top-2 margin per position,
    computed unconditionally so the device program does not depend on
    auditing."""
    if statepool.has_recurrent_state(cfg):
        raise NotImplementedError(f"{cfg.name}: recurrent verify is not ported")

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
            params, cfg, layout, pool, tables, start_pos, VERIFY_SCHEDULE,
            paged=paged, tokens=inputs,
        )
        v_tokens = sample_window(logits, seeds, out_base, temps, top_ks)
        n_match, commit_tok = _match_and_commit(v_tokens, cand, cand_len, W)
        margins = top2_margin(logits)
        return pool, n_match, commit_tok, v_tokens, margins

    return verify_attn
