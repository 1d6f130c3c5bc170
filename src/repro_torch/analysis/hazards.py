"""Hazard lint: nondeterminism-prone ops on the commit path's live programs.

The port's counterpart of ``repro.analysis.hazards``.  Walks the live nodes
the invariance prover recorded (``trace_utils.dce``) for each commit kind
and flags the aten ops and kernel nodes that can break the f32
fixed-schedule combine contract:

* ``scatter-add-overlap``    — a float ``index_put_(accumulate=True)``,
  ``index_add_``, ``scatter_add_`` or ``scatter_reduce_``: duplicate
  indices combine in the device's order, not a fixed schedule.
* ``scatter-set-overlap``    — a float ``index_put_``, ``scatter_`` or
  ``index_copy_``: with duplicate indices the winning value is the
  implementation's choice.  Torch has no ``unique_indices``, so every one
  is reported; the cache writes are unique by construction and carry that
  construction as an allowlist justification.
* ``batch-extent-reduction`` — a library float reduction (``sum``,
  ``mean``, ``prod``, ``cumsum``, ``cumprod``, ``logcumsumexp``,
  ``logsumexp``, ``_softmax``, ``_log_softmax``, ``var``, ``norm``) over an
  axis whose extent is a multiple of the batch: its combine tree grows with
  co-scheduled traffic.  Integer reductions are exact and exempt.
* ``dot-accum-dtype``        — an aten contraction whose output is narrower
  than f32, or a kernel node with a sub-f32 ``combine_dtype``.
* ``tf32-enabled``           — the CUDA counterpart of
  ``dot-default-precision``: an f32 contraction recorded while
  ``torch.backends.cuda.matmul.allow_tf32`` held or
  ``torch.get_float32_matmul_precision()`` was not ``"highest"`` (an f32
  convolution while ``torch.backends.cudnn.allow_tf32`` held: that switch
  governs cuDNN, which runs convolutions only).
* ``library-contraction``    — any aten ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` or ``matmul`` (and the other contractions) on inexact dtypes:
  cuBLAS picks its kernel by shape, so its rows can follow the batch.
* ``fast-kernel-on-commit-path`` — a ``gemm_splitk``,
  ``gemm_splitk_partials``, ``paged_attention_fast`` or
  ``decode_attention(kv_splits > 1)`` node.
* ``data-dependent-while``   — a host read of a tensor value
  (``aten._local_scalar_dense``, or ``nonzero``, whose output shape is
  one) inside the step: what follows can depend on the data, so the
  op sequence is not fixed by shape alone.

Findings are attributed to the source frame recorded with each node.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.report import Finding
from repro_torch.analysis.trace_utils import CONTRACTIONS, CONVOLUTIONS, Log, Node, Val

_REDUCTIONS = frozenset({"sum", "mean", "prod", "cumsum", "cumprod", "logcumsumexp",
                         "logsumexp", "_softmax", "_log_softmax", "var",
                         "linalg_vector_norm", "norm"})
_SCATTER_ADD = frozenset({"index_add", "index_add_", "scatter_add", "scatter_add_",
                          "scatter_reduce", "scatter_reduce_"})
_INDEX_PUT = frozenset({"index_put", "index_put_", "_index_put_impl", "_index_put_impl_"})
_SCATTER_SET = frozenset({"scatter", "scatter_", "index_copy", "index_copy_"})
_HOST_READS = frozenset({"_local_scalar_dense", "nonzero"})
_FAST_KERNELS = frozenset({"gemm_splitk", "gemm_splitk_partials", "paged_attention_fast"})


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point or dt.is_complex


def scan_trace(log: Log, batch: int, *, arch: str, kind: str) -> List[Finding]:
    """Lint one recorded commit-path program (already DCE'd)."""
    findings: List[Finding] = []
    seen: set = set()

    def emit(rule: str, node: Node, message: str) -> None:
        key = (rule, node.where, message)
        if key in seen:
            return
        seen.add(key)
        at = f" (line {node.line})" if node.line else ""
        findings.append(Finding(pass_name="hazards", rule=rule, where=node.where, arch=arch,
                                message=f"[{arch}:{kind}]{at} {message}"))

    def first_dtype(node: Node) -> torch.dtype:
        args, _ = node.args
        for a in args:
            if isinstance(a, Val):
                return log.values[a.vid].dtype
        return torch.int64

    for node in log.nodes:
        name = node.name
        if node.kernel:
            geo = node.geometry
            if name in _FAST_KERNELS or (name == "decode_attention"
                                         and geo.get("kv_splits", 1) > 1):
                emit("fast-kernel-on-commit-path", node,
                     f"{name}({', '.join(f'{k}={v}' for k, v in sorted(geo.items()))}) "
                     "on a commit kind: its reduction tree follows the fast "
                     "schedule")
            cd = geo.get("combine_dtype")
            if cd is not None and cd != "float32":
                emit("dot-accum-dtype", node,
                     f"{name} combines its partials in {cd}: the contract "
                     "requires an f32 combine on the commit path")
            continue
        if name in _SCATTER_ADD or (name in _INDEX_PUT and node.arg("accumulate", False)):
            dt = first_dtype(node)
            if _is_float(dt):
                emit("scatter-add-overlap", node,
                     f"{node.op} on {dt}: duplicate indices combine in the "
                     "device's order, not the fixed f32 schedule")
        elif name in _INDEX_PUT or name in _SCATTER_SET:
            dt = first_dtype(node)
            if _is_float(dt):
                emit("scatter-set-overlap", node,
                     f"{node.op} on {dt} (torch has no unique_indices): with "
                     "duplicate indices the winning value is implementation-defined")
        elif name in _REDUCTIONS:
            x = node.args[0][0] if node.args[0] else None
            if not isinstance(x, Val):
                continue
            val = log.values[x.vid]
            if not _is_float(val.dtype):
                continue
            dims = node.arg("dim")
            if dims is None or dims == [] or dims == ():
                dims = range(len(val.shape))
            elif isinstance(dims, int):
                dims = [dims]
            for d in dims:
                try:
                    extent = val.shape[int(d)]
                except (IndexError, TypeError, ValueError):
                    continue
                if extent >= batch and extent % batch == 0:
                    emit("batch-extent-reduction", node,
                         f"{node.op} over axis {d} of extent {extent} = "
                         f"{extent // batch} x batch({batch}) on {val.dtype}: the "
                         "combine tree grows with co-scheduled traffic")
        elif name in CONTRACTIONS or name in CONVOLUTIONS:
            dt = first_dtype(node)
            if not _is_float(dt):
                continue
            out = log.values[node.outs[0]].dtype if node.outs else dt
            if name in CONTRACTIONS:
                emit("library-contraction", node,
                     f"{node.op} on {dt}: the library picks its kernel by shape, "
                     "so a row's reduction can follow the batch")
            if _is_float(out) and out.itemsize < 4:
                emit("dot-accum-dtype", node,
                     f"{node.op} produces {out}: the contract requires an f32 "
                     "accumulation on the commit path")
            if dt == torch.float32 and node.tf32 is not None:
                cublas, cudnn, precision = node.tf32
                on = (cudnn if name in CONVOLUTIONS
                      else cublas or precision != "highest")
                if on:
                    emit("tf32-enabled", node,
                         f"f32 {node.op} with TF32 allowed (cuBLAS {cublas}, cuDNN "
                         f"{cudnn}, float32 matmul precision {precision!r}): "
                         "products round to 10 mantissa bits by the library's choice")
        elif name in _HOST_READS:
            emit("data-dependent-while", node,
                 f"{node.op}: a host read of a tensor value inside the step; the "
                 "op sequence after it can follow the data")
    return findings


def run_pass(arch_traces) -> List[Finding]:
    """Lint every commit-path program the invariance pass recorded, each at
    its smallest batch (the prover has shown the others identical)."""
    findings: List[Finding] = []
    merged: set = set()
    for tr in arch_traces:
        for kind in ("verify", "prefill_chunk", "decode_invariant"):
            per = tr.traces[kind]
            b = min(per)
            for f in scan_trace(per[b], b, arch=tr.arch, kind=kind):
                # one source line in several archs and kinds: reported once
                k = f.key() + (f.message.split("] ", 1)[-1],)
                if k in merged:
                    continue
                merged.add(k)
                findings.append(f)
    return findings
