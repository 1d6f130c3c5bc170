"""Model configs, parameter specs and the port's initializer (dense and MoE
families with full or sliding-window attention, ``first_k_dense`` head
layers, the recurrent ssm family: rwkv6, the hybrid family: jamba's
attention and mamba layers, the encoder-decoder family and prefix
embeddings).

PyTorch counterpart of ``repro.models.base``.  ``ModelConfig`` is the JAX
package's dataclass field for field, so configs read the same.  Parameters
are nested dicts of tensors with the JAX tree's keys and layouts: decoder
layers grouped into repeating blocks of ``cfg.block_period()`` layers,
block position p stacked along a leading ``layers`` dimension under
``params["blocks"][str(p)]`` (layer ``b * period + p`` is row b; every
config but jamba has period 1, so ``blocks/0`` holds them all), weights
stored ``(in, out)``; a MoE layer's ``moe`` leaves stack the experts after
the layer axis, ``(layers, experts, in, out)``; the ``first_k_dense`` head
layers are unstacked, ``params["head_layers"][str(i)]``, as in the JAX
tree; an rwkv layer's weights sit under ``rwkv`` (time and channel mixing), a
mamba layer's under ``mamba``; an attention layer of a ``use_bias`` config
adds ``bq``, ``bk`` and ``bv``; an
encoder-decoder config's decoder layers add ``cross_attn`` and a third
norm (``norm2``: self-attention, cross-attention and FFN each get one),
and its encoder stacks under ``enc_blocks/0`` with ``enc_final_norm``.
``models.convert.params_from_numpy`` turns the JAX package's tree into
this one; ``init_params`` makes random weights without JAX.

Both finish with ``finish_unembedding``.  A config with tied embeddings
gets ``unembed``: a (d_model, vocab) copy of ``embed.T``, made once where
params are made, so no forward transposes the embedding (at command-r's
width that would be a 4.2 GB copy per pass).  A vocabulary that is not a
multiple of ``UNEMBED_ALIGN`` gets zero columns up to the next multiple
(seamless-m4t's 256206 becomes 256208): the bf16 GEMMs read ``w`` through
TMA, which needs 16-byte rows, and ``models.transformer._unembed`` slices
the logits back to ``vocab_size``.  Neither the copy nor the padding is a
parameter: ``param_count`` counts the spec tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention
    attn_kind: str = "full"  # full | sliding
    window: int = 4096
    rope_theta: float = 10000.0
    use_bias: bool = False
    logit_softcap: float = 0.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    # hybrid (jamba)
    attn_every: int = 0
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    # encoder-decoder
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0
    # multimodal frontend stub
    num_prefix_embeds: int = 0
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    max_seq_len: int = 8192
    dtype: str = "float32"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv' for decoder layer i."""
        if self.family == "ssm":
            return "rwkv"
        if self.family == "hybrid" and self.attn_every > 0:
            return "attn" if (i % self.attn_every == 0) else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'dense' | 'moe' for decoder layer i."""
        if self.num_experts <= 0 or i < self.first_k_dense:
            return "dense"
        if i % self.moe_every != self.moe_offset:
            return "dense"
        return "moe"

    def block_period(self) -> int:
        """Smallest repeating period of (layer_kind, ffn_kind) patterns."""
        period = 1
        if self.family == "hybrid" and self.attn_every:
            period = self.attn_every
        if self.num_experts > 0 and self.moe_every > 1:
            period = period * self.moe_every // math.gcd(period, self.moe_every)
        return period

    def param_count(self) -> int:
        """Total parameter count."""
        return sum(math.prod(s.shape) for _, s in iter_specs(param_specs(self)))

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top_k experts count)."""
        total = 0
        for _, spec in iter_specs(param_specs(self)):
            n = math.prod(spec.shape)
            if "experts" in spec.axes and self.num_experts > 0:
                n = n * self.top_k // self.num_experts
            total += n
        return total


class ParamSpec:
    """Shape + logical axes + initializer for one parameter tensor."""

    __slots__ = ("shape", "axes", "init", "scale")

    def __init__(self, shape, axes, init="normal", scale=None):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        self.init = init
        self.scale = scale

    def __repr__(self):
        return f"ParamSpec({self.shape}, {self.axes})"


def check_ported(cfg: ModelConfig) -> None:
    """Raise on what the port does not serve: a family or attention kind
    the reference has no code for.  Every config of ``repro.configs``
    passes."""
    missing = []
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
        missing.append(f"the {cfg.family} family")
    if cfg.attn_kind not in ("full", "sliding"):
        missing.append(f"attn_kind {cfg.attn_kind!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}")


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv")),
        "wo": ParamSpec((h * hd, d), ("heads", "embed")),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((h * hd,), ("heads",), init="zeros")
        specs["bk"] = ParamSpec((kv * hd,), ("kv",), init="zeros")
        specs["bv"] = ParamSpec((kv * hd,), ("kv",), init="zeros")
    return specs


def dense_ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "ffn")),
        "wi_up": ParamSpec((d, f), ("embed", "ffn")),
        "wo": ParamSpec((f, d), ("ffn", "embed")),
    }


def moe_ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wo": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamSpec((dc, di), ("state", "inner"), scale=0.5),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((di, dt_rank + 2 * ds), ("inner", "state")),
        "dt_proj_w": ParamSpec((dt_rank, di), ("state", "inner")),
        "dt_proj_b": ParamSpec((di,), ("inner",), init="zeros"),
        "A_log": ParamSpec((di, ds), ("inner", "state"), init="ones"),
        "D": ParamSpec((di,), ("inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def rwkv_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    n_heads = d // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    return {
        # time mixing (attention analogue)
        "mu_r": ParamSpec((d,), ("embed",), scale=0.1),
        "mu_k": ParamSpec((d,), ("embed",), scale=0.1),
        "mu_v": ParamSpec((d,), ("embed",), scale=0.1),
        "mu_w": ParamSpec((d,), ("embed",), scale=0.1),
        "mu_g": ParamSpec((d,), ("embed",), scale=0.1),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "w_decay": ParamSpec((d,), ("embed",), scale=0.1),  # data-dep decay base
        "w_lora_a": ParamSpec((d, 64), ("embed", "state"), scale=0.02),
        "w_lora_b": ParamSpec((64, d), ("state", "embed"), scale=0.02),
        "u_bonus": ParamSpec((n_heads, hd), ("heads", "state"), scale=0.1),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "ln_x_scale": ParamSpec((d,), ("embed",), init="ones"),
        # channel mixing (FFN analogue)
        "cm_mu_k": ParamSpec((d,), ("embed",), scale=0.1),
        "cm_mu_r": ParamSpec((d,), ("embed",), scale=0.1),
        "cm_wk": ParamSpec((d, cfg.d_ff), ("embed", "ffn")),
        "cm_wv": ParamSpec((cfg.d_ff, d), ("ffn", "embed")),
        "cm_wr": ParamSpec((d, d), ("embed", "heads")),
    }


def layer_specs(cfg: ModelConfig, i: int, *, decoder: bool = True) -> Dict[str, Any]:
    """Specs of decoder layer ``i`` (an encoder layer with ``decoder=False``:
    bidirectional attention and a dense FFN): attention, mamba or rwkv
    mixing, an encoder-decoder decoder layer's ``cross_attn``, two norms
    (three with cross-attention), and the layer's dense or MoE FFN (rwkv's
    channel mixing is its FFN)."""
    kind = cfg.layer_kind(i) if decoder else "attn"
    mixers = {"attn": attn_specs, "mamba": mamba_specs, "rwkv": rwkv_specs}
    specs: Dict[str, Any] = {kind: mixers[kind](cfg)}
    cross = decoder and cfg.family == "encdec"
    if cross:
        specs["cross_attn"] = attn_specs(cfg)
    specs.update({f"norm{j}": ParamSpec((cfg.d_model,), ("embed",), init="ones")
                  for j in range(3 if cross else 2)})
    if kind == "rwkv":
        pass  # rwkv_specs already includes the channel-mix FFN
    elif not decoder:
        specs["ffn"] = dense_ffn_specs(cfg)
    elif cfg.ffn_kind(i) == "moe":
        specs["moe"] = moe_ffn_specs(cfg)
    else:
        specs["ffn"] = dense_ffn_specs(cfg)
    return specs


def _stack(tree: Any, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.init, tree.scale)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter spec tree (the JAX tree's keys) of a ported config."""
    check_ported(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    # first_k_dense head layers break homogeneity: unstacked, as in the JAX
    # tree; the rest stack by block position along their layer axis
    fkd = cfg.first_k_dense
    if fkd:
        specs["head_layers"] = {str(i): layer_specs(cfg, i) for i in range(fkd)}
    period = stack_period(cfg)
    specs["blocks"] = {str(p): _stack(layer_specs(cfg, fkd + p),
                                      (cfg.num_layers - fkd) // period)
                       for p in range(period)}
    if cfg.family == "encdec":
        specs["enc_blocks"] = {"0": _stack(layer_specs(cfg, 0, decoder=False),
                                           cfg.num_encoder_layers)}
        specs["enc_final_norm"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
    return specs


def stack_period(cfg: ModelConfig) -> int:
    """The period the decoder layers after the ``first_k_dense`` head
    layers stack by: ``cfg.block_period()``, or 1 where it does not divide
    their count (the reference's ``models.transformer._period``)."""
    period = cfg.block_period()
    return period if (cfg.num_layers - cfg.first_k_dense) % period == 0 else 1


def iter_specs(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], ParamSpec]]:
    """(path, spec) leaves in sorted-key order (the order JAX flattens)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_specs(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _fill(out: torch.Tensor, spec: ParamSpec, generator: torch.Generator) -> None:
    if spec.init == "zeros":
        out.zero_()
        return
    if spec.init == "ones":
        out.fill_(1.0)
        return
    # One matrix at a time, so no f32 copy of a whole stacked leaf exists.
    # The scale is the matrix's own fan-in (its row count); the JAX spec
    # reads the stacked leading dimension instead, which is the layer count.
    mats = out.reshape(-1, *out.shape[-2:]) if out.dim() >= 2 else out[None]
    fan_in = mats.shape[-2] if out.dim() >= 2 else max(out.shape[-1], 1)
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    for m in mats:
        noise = torch.randn(m.shape, generator=generator, device=m.device,
                            dtype=torch.float32)
        m.copy_(noise.mul_(scale))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random weights for ``cfg`` on ``device`` (default ``cuda``), drawn
    from ``generator`` (which must live on that device) leaf by leaf in
    sorted-key order, normal * fan_in^-0.5 (``embed``: * 0.02), norms ones.
    Not the JAX package's bits: parity tests share weights through
    ``models.convert.params_from_numpy`` instead."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {}
    for path, spec in iter_specs(param_specs(cfg)):
        t = torch.empty(spec.shape, dtype=dtype, device=dev)
        _fill(t, spec, generator)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return finish_unembedding(cfg, params)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The serving tree of ``cfg`` as meta tensors (shapes and dtypes,
    nothing allocated), for the dry run (``launch.dryrun``): the
    counterpart of the reference's ShapeDtypeStruct tree, with the port's
    ``finish_unembedding`` applied (a tied config's ``unembed`` copy, a
    padded vocabulary); ``training.train.train_params`` turns it into the
    reference's tree."""
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {}
    for path, spec in iter_specs(param_specs(cfg)):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(spec.shape, dtype=dtype, device="meta")
    return finish_unembedding(cfg, params)


#: the stored unembedding's column count is a multiple of this: a bf16 row
#: of w is then a multiple of 16 bytes, as TMA reads it (and a multiple of
#: 4 f32 columns, the f32 tile's vector loads)
UNEMBED_ALIGN = 8


def padded_vocab(cfg: ModelConfig) -> int:
    """``cfg.vocab_size`` rounded up to a multiple of ``UNEMBED_ALIGN``."""
    return -(-cfg.vocab_size // UNEMBED_ALIGN) * UNEMBED_ALIGN


def finish_unembedding(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Give a tied config its (d_model, vocab) ``unembed``, one contiguous
    copy of ``embed.T``, which the GEMMs read N-contiguous; then pad
    ``unembed`` with zero columns to ``padded_vocab`` (a no-op at every
    vocabulary that is a multiple of ``UNEMBED_ALIGN``).  Column tiles of
    the GEMMs are independent, so the real columns' bits do not change."""
    if cfg.tie_embeddings:
        params["unembed"] = params["embed"].t().contiguous()
    pad = padded_vocab(cfg) - cfg.vocab_size
    if pad:
        params["unembed"] = torch.nn.functional.pad(params["unembed"], (0, pad))
    return params
