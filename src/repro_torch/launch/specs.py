"""Dry-run cases: (arch x input shape x mesh) -> a step function, its meta
arguments and their placement plans.

PyTorch counterpart of ``repro.launch.specs``.  The input shapes:

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (cache fill)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (one new token
                                                 against a full KV cache)
  long_500k    seq 524,288 global_batch 1     -> serve_step; only for archs
               with a sub-quadratic long-context variant
  verify_32k   (extra) one grouped-verification pass, G = 8 requests x W =
               64 tokens against 32k caches

Every argument is a meta tensor: nothing is allocated.  ``launch.dryrun``
runs each case's step once on the meta device, which proves the port's
step composes at production shapes and that every kernel call passes its
operand checks; the plans give each argument's per-rank bytes.  The steps
are the port's own: ``models.transformer.forward`` on the gathered lane
(dense per-row cache views), ``serving.sampler.sample_window`` and
``training.train.make_train_step``.  Arch ids are the port's dashed ids
(``tinyllama-1.1b``); ``configs.list_archs`` lists module names, which
``configs.get_config`` takes too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs as config_registry
from repro_torch.core.determinism import VERIFY_SCHEDULE
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Plan
from repro_torch.launch.mesh import _axis_sizes
from repro_torch.models.base import ModelConfig, abstract_params
from repro_torch.models.transformer import cache_spec, forward
from repro_torch.serving.sampler import sample_window
from repro_torch.training.optimizer import AdamWConfig, OptState, tree_map
from repro_torch.training.train import make_train_step, train_params

F32, I32 = torch.float32, torch.int32
META = torch.device("meta")

INPUT_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
    # extra: one grouped-verification pass (G = 8 requests x W = 64 window)
    # against 32k caches, the paper's own mechanism at production scale
    "verify_32k": dict(kind="verify", seq=32768, batch=8, window=64,
                       extra=True),
}

#: decode capacity padding beyond the context length
CAP_PAD = 128


@dataclasses.dataclass
class Case:
    arch: str
    shape: str
    cfg: Optional[ModelConfig]
    fn: Optional[Callable]
    args: Tuple[Any, ...]
    in_plans: Any
    out_plans: Any
    skipped: Optional[str] = None  # reason if (arch, shape) is inapplicable


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _maybe_batch_spec(batch: int, mesh: Any) -> Plan:
    """The batch dim's plan: the data axes that divide ``batch``, dropping
    ``pod`` first."""
    sizes = _axis_sizes(mesh)
    axes = list(("pod", "data") if "pod" in sizes else ("data",))
    while axes and batch % math.prod(sizes[a] for a in axes) != 0:
        axes.pop(0)  # drop pod first, keep data
    if not axes:
        return (None,)
    return (tuple(axes) if len(axes) > 1 else axes[0],)


def resolve_config(arch: str, shape: str) -> Tuple[Optional[ModelConfig], Optional[str]]:
    meta = INPUT_SHAPES[shape]
    if meta.get("long"):
        if not config_registry.supports_long(arch):
            return None, (
                f"{arch} is full-attention-only; long_500k requires a "
                "sub-quadratic variant (DESIGN.md long_500k skips)"
            )
        return config_registry.get_long_config(arch), None
    return config_registry.get_config(arch), None


def decode_capacity(cfg: ModelConfig, seq: int) -> int:
    if cfg.attn_kind == "sliding":
        return cfg.window + CAP_PAD  # ring slack (models/transformer.py)
    return seq + CAP_PAD


def serve_param_pspecs(cfg: ModelConfig, mesh: Any, params: Dict[str, Any]) -> Any:
    """Plans of a serving tree (``abstract_params``) under ``rules_serve``:
    ``param_pspecs`` plus the stored ``unembed``'s (``unembed_pspec``)."""
    rules = sharding.rules_serve(mesh)
    plans = sharding.param_pspecs(cfg, mesh, rules)
    if "unembed" in params:
        plans["unembed"] = sharding.unembed_pspec(cfg, mesh, rules)
    return plans


def build_case(arch: str, shape: str, mesh: Any) -> Case:
    cfg, skip = resolve_config(arch, shape)
    if skip:
        return Case(arch, shape, None, None, (), None, None, skipped=skip)
    meta = INPUT_SHAPES[shape]
    kind = meta["kind"]
    B, S = meta["batch"], meta["seq"]
    dtype = getattr(torch, cfg.dtype)
    bplan = _maybe_batch_spec(B, mesh)

    if kind == "train":
        return _train_case(arch, shape, cfg, mesh, B, S, bplan)

    # serving cases
    params = abstract_params(cfg)
    p_plans = serve_param_pspecs(cfg, mesh, params)
    cap = decode_capacity(cfg, S)
    cache = tree_map(lambda leaf: _meta(*leaf), cache_spec(cfg, B, cap))
    cache_plans = sharding.cache_pspec_tree(cfg, mesh, B, cap)

    if kind == "prefill":
        n_prefix = cfg.num_prefix_embeds
        S_tok = S - n_prefix  # total context (image tokens included) == S

        def prefill_step(params, cache, tokens, prefix_embeds, start_pos):
            embeds = None
            if n_prefix:
                tok_embeds = params["embed"][tokens.long()]
                embeds = torch.cat([prefix_embeds, tok_embeds], dim=1)
            logits, new_cache, _ = forward(
                params, cfg, None if n_prefix else tokens, inputs_embeds=embeds,
                cache=cache, start_pos=start_pos, schedule=VERIFY_SCHEDULE)
            tok = logits[:, -1].argmax(dim=-1).to(I32)
            return tok, new_cache

        args = (params, cache, _meta((B, S_tok), I32),
                _meta((B, n_prefix, cfg.d_model), dtype), _meta((B,), I32))
        in_plans = (p_plans, cache_plans, bplan, bplan, bplan)
        return Case(arch, shape, cfg, prefill_step, args, in_plans,
                    (bplan, cache_plans))

    if kind == "verify":
        G, W = B, meta["window"]

        def verify_step(params, cache, inputs, cand, cand_len, start_pos,
                        seeds, temps, out_base):
            logits, new_cache, _ = forward(
                params, cfg, inputs, cache=cache, start_pos=start_pos,
                schedule=VERIFY_SCHEDULE)
            v = sample_window(logits, seeds, out_base, temps)
            cmp = (v[:, : W - 1] == cand).to(I32)
            valid = (torch.arange(W - 1, device=v.device)[None]
                     < cand_len[:, None]).to(I32)
            n_match = torch.cumprod(cmp * valid, dim=1).sum(dim=1).to(I32)
            commit = v.gather(1, n_match[:, None].long())[:, 0]
            return n_match, commit, new_cache

        args = (params, cache, _meta((G, W), I32), _meta((G, W - 1), I32),
                _meta((G,), I32), _meta((G,), I32), _meta((G,), I32),
                _meta((G,), F32), _meta((G,), I32))
        in_plans = (p_plans, cache_plans) + (bplan,) * 7
        return Case(arch, shape, cfg, verify_step, args, in_plans,
                    (bplan, bplan, cache_plans))

    # decode: one new token against a cache of S tokens
    def serve_step(params, cache, tokens, start_pos):
        logits, new_cache, _ = forward(
            params, cfg, tokens, cache=cache, start_pos=start_pos,
            schedule=VERIFY_SCHEDULE)
        tok = logits[:, -1].argmax(dim=-1).to(I32)
        return tok, new_cache

    args = (params, cache, _meta((B, 1), I32), _meta((B,), I32))
    return Case(arch, shape, cfg, serve_step, args,
                (p_plans, cache_plans, bplan, bplan), (bplan, cache_plans))


def train_microbatches(batch: int) -> int:
    """Microbatches of 16 rows, the data axes' width: bounds the per-rank
    logits to about 1 row x S x V while staying shardable."""
    return max(batch // 16, 1)


def train_step(cfg: ModelConfig, num_microbatches: int) -> Callable:
    """The train case's step: AdamW at the reference's dry-run settings,
    ``num_microbatches`` microbatches, remat on."""
    return make_train_step(cfg, AdamWConfig(total_steps=1000),
                           num_microbatches=num_microbatches, remat=True)


def _train_case(arch, shape, cfg, mesh, B, S, bplan) -> Case:
    p_plans = sharding.param_pspecs(cfg, mesh, sharding.rules_train(mesh))
    params = train_params(cfg, abstract_params(cfg))  # the reference's tree
    dtype = getattr(torch, cfg.dtype)

    # optimizer state: f32 moments planned like the params, step replicated
    opt_state = OptState(step=_meta((), I32),
                         mu=tree_map(lambda t: _meta(t.shape, F32), params),
                         nu=tree_map(lambda t: _meta(t.shape, F32), params))
    opt_plans = OptState(step=(), mu=p_plans, nu=p_plans)

    batch: Dict[str, Any] = {
        "tokens": _meta((B, S), I32),
        "targets": _meta((B, S), I32),
        "loss_mask": _meta((B, S), F32),
    }
    if cfg.family == "encdec":
        batch["enc_embeds"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), dtype)
    b_plans = {k: bplan for k in batch}

    step = train_step(cfg, train_microbatches(B))
    metrics_plans = {k: () for k in ("loss", "aux_loss", "dropped_frac", "tokens",
                                      "grad_norm", "lr")}
    return Case(arch, shape, cfg, step, (params, opt_state, batch),
                (p_plans, opt_plans, b_plans), (p_plans, opt_plans, metrics_plans))
