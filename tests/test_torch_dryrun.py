"""The port's dry run on the CPU (``launch.specs``, ``launch.dryrun``).

* ``specs.build_case`` against the reference's ``build_case`` for every
  arch x input shape on the single-pod mesh: the arguments' shapes and
  dtypes leaf for leaf (the port's extra or padded ``unembed`` and the
  layer axis of one on ``head_layers`` and ``cross.mask`` mapped), the
  in and out plans against the ``NamedSharding`` specs, the skip reasons
  (arch ids: the port's dashed ones, the reference's module names).
* The kernel wrappers' meta branch: the card path's operand checks raise on
  meta tensors, and valid operands get a meta output of the kernel's shape
  (the GEMMs' and attentions' contractions visible to ``FlopCounterMode``).
* ``dryrun.run_case`` on smoke configs at small shapes, one arch a family:
  every case ``ok`` or skipped where the reference skips, nonzero FLOPs,
  per-rank bytes, the recurrent and microbatch cuts recorded; the CLI's
  records and exit code.
* ``sample_window``'s tensor path (the verify case's) equals its host path.
* ``launch.dryrun`` and ``distributed.sharding`` import with ``jax``
  unimportable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.gemm_batch_invariant import (
    gemm_batch_invariant, gemm_batch_invariant_partials,
)
from repro_torch.kernels.gemm_splitk import gemm_splitk
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.base import padded_vocab
from repro_torch.serving.sampler import sample_window

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
DASHED = {v: k for k, v in configs.DASHED.items()}
BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# build_case against the reference
# ---------------------------------------------------------------------------


def _port_leaves(tree, prefix=()):
    """{path: leaf} of a tree of dicts, named tuples and tuples of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = ((str(i), t) for i, t in enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, prefix + (k,)))
    return out


def _follow(tree, path):
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[int(k)]
    return tree


def _jax_leaves(tree, is_leaf=None):
    import jax

    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    return {tuple(key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _layer_axis_of_one(path, cache_at):
    """A cache leaf (at top-level index ``cache_at``) that the port stores
    with a layer axis of one."""
    return path[0] == cache_at and ("head_layers" in path or path[-2:] == ("cross", "mask"))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_case_matches_reference(arch):
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.launch import specs as jspecs

    jm = AbstractMesh((16, 16), ("data", "model"))
    m = make_production_mesh()
    is_ns = lambda x: isinstance(x, NamedSharding)  # noqa: E731
    for shape in specs.INPUT_SHAPES:
        want = jspecs.build_case(arch, shape, jm)
        got = specs.build_case(DASHED[arch], shape, m)
        if want.skipped:
            assert got.skipped == want.skipped.replace(arch, DASHED[arch])
            continue
        assert got.skipped is None
        cfg = got.cfg
        train = specs.INPUT_SHAPES[shape]["kind"] == "train"
        cache_in = None if train else "1"
        cache_out = None if train else str(len(got.out_plans) - 1)
        jargs = _jax_leaves(want.args)
        targs = _port_leaves(got.args)
        jin = _jax_leaves(want.in_shardings, is_ns)
        for path, t in targs.items():
            plan = _follow(got.in_plans, path)
            if path[-1] == "unembed" and cfg.tie_embeddings:
                assert tuple(t.shape) == (cfg.d_model, padded_vocab(cfg))  # port only
                continue
            j = jargs[path]
            jshape, jplan = tuple(j.shape), tuple(jin[path].spec)
            if path[-1] == "unembed" and not train:  # serving trees: padded
                jshape = (cfg.d_model, padded_vocab(cfg))
            if _layer_axis_of_one(path, cache_in):
                jshape, jplan = (1,) + jshape, (None,) + jplan
            assert tuple(t.shape) == jshape, (shape, path)
            assert str(t.dtype)[6:] == str(j.dtype), (shape, path)
            assert plan == jplan, (shape, path)
        assert set(jargs) <= set(targs), (shape, set(jargs) - set(targs))
        for path, ns in _jax_leaves(want.out_shardings, is_ns).items():
            jplan = tuple(ns.spec)
            if _layer_axis_of_one(path, cache_out):
                jplan = (None,) + jplan
            assert _follow(got.out_plans, path) == jplan, (shape, path)


# ---------------------------------------------------------------------------
# the wrappers' meta branch
# ---------------------------------------------------------------------------


def _m(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


REFUSED = {
    "gemm-bf16-K": (lambda: gemm_batch_invariant(_m(3, 12, dtype=BF16),
                                                 _m(12, 24, dtype=BF16), chunks=4), "K=12"),
    "gemm-bf16-N": (lambda: gemm_splitk(_m(3, 16, dtype=BF16), _m(16, 20, dtype=BF16),
                                        splits=2), "N=20"),
    "gemm-chunks": (lambda: gemm_batch_invariant(_m(3, 64), _m(64, 8), chunks=9), "chunks"),
    "partials-bf16-K": (lambda: gemm_batch_invariant_partials(
        _m(3, 12, dtype=BF16), _m(12, 24, dtype=BF16), chunks=2), "K=12"),
    "gemm-dtypes": (lambda: gemm_batch_invariant(_m(3, 16), _m(16, 8, dtype=BF16)), "dtypes"),
    "decode-D": (lambda: decode_attention(_m(2, 4, 120), _m(2, 16, 2, 120),
                                          _m(2, 16, 2, 120), _m(2, dtype=I32)), "D=120"),
    "decode-group": (lambda: decode_attention(_m(2, 16, 64), _m(2, 16, 1, 64),
                                              _m(2, 16, 1, 64), _m(2, dtype=I32)), "group"),
    "decode-lengths": (lambda: decode_attention(_m(2, 4, 64), _m(2, 16, 2, 64),
                                                _m(2, 16, 2, 64), _m(2, dtype=torch.int64)),
                       "int32"),
    "paged-D": (lambda: paged_attention(_m(2, 4, 8), _m(6, 4, 2, 8), _m(6, 4, 2, 8),
                                        _m(6, 4, dtype=I32), _m(2, 3, dtype=I32),
                                        _m(2, dtype=I32)), "shapes"),
    "paged-fast-splits": (lambda: paged_attention_fast(
        _m(2, 4, 64), _m(6, 4, 2, 64), _m(6, 4, 2, 64), _m(6, 4, dtype=I32),
        _m(2, 3, dtype=I32), _m(2, dtype=I32), kv_splits=2), "kv_splits"),
    "rmsnorm-D": (lambda: rmsnorm(_m(2, 40000), _m(40000)), "D=40000"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_meta_branch_refuses_what_the_card_refuses(case):
    call, match = REFUSED[case]
    with pytest.raises((ValueError, TypeError), match=match):
        call()


def test_meta_branch_outputs_and_flops():
    """Valid meta operands get the kernel's output shape and dtype on meta,
    at kimi-k2's head_dim 112 and seamless's padded LM head too; the
    contractions show their FLOPs to ``FlopCounterMode``; nothing counts as
    a launch."""
    from torch.utils.flop_counter import FlopCounterMode

    before = gemm_batch_invariant.launches
    with FlopCounterMode(display=False) as fc:
        out = gemm_batch_invariant(_m(8, 1024, dtype=BF16), _m(1024, 256208, dtype=BF16),
                                   chunks=4)
    assert (out.shape, out.dtype, out.device.type) == ((8, 256208), BF16, "meta")
    assert fc.get_total_flops() == 2 * 8 * 1024 * 256208
    part = gemm_batch_invariant_partials(_m(8, 64, dtype=BF16), _m(64, 16, dtype=BF16),
                                         chunks=2)
    assert (tuple(part.shape), part.dtype) == ((2, 8, 16), F32)
    assert gemm_splitk(_m(4, 64), _m(64, 8), splits=2, tp_shards=2).shape == (4, 8)
    with FlopCounterMode(display=False) as fc:
        o = decode_attention(_m(2, 8, 112, dtype=BF16), _m(2, 32, 1, 112, dtype=BF16),
                             _m(2, 32, 1, 112, dtype=BF16), _m(2, dtype=I32))
    assert (o.shape, o.dtype) == ((2, 8, 112), BF16)
    assert fc.get_total_flops() == 4 * 2 * 8 * 32 * 112
    args = (_m(2, 4, 64), _m(6, 4, 2, 64), _m(6, 4, 2, 64), _m(6, 4, dtype=I32),
            _m(2, 4, dtype=I32), _m(2, dtype=I32))
    assert paged_attention(*args).shape == (2, 4, 64)
    assert paged_attention_fast(*args, kv_splits=2).dtype == F32
    assert rmsnorm(_m(5, 4096, dtype=BF16), _m(4096)).shape == (5, 4096)
    assert gemm_batch_invariant.launches == before


# ---------------------------------------------------------------------------
# dryrun.run_case at smoke size
# ---------------------------------------------------------------------------

SMALL = {
    "train_4k": dict(kind="train", seq=24, batch=32),
    "prefill_32k": dict(kind="prefill", seq=40, batch=2),
    "decode_32k": dict(kind="decode", seq=40, batch=4),
    "long_500k": dict(kind="decode", seq=200, batch=1, long=True),
    "verify_32k": dict(kind="verify", seq=40, batch=2, window=8, extra=True),
}
MAX_POSITIONS = 16


@pytest.fixture
def smoke(monkeypatch):
    """Smoke configs (their long variants at a 32-token window) and the
    ``SMALL`` shapes in place of the production ones."""
    long_config = configs.get_long_config

    def smoke_long(name):
        full = long_config(name)
        return dataclasses.replace(configs.get_smoke_config(name),
                                   attn_kind=full.attn_kind, window=32)

    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    monkeypatch.setattr(configs, "get_long_config", smoke_long)
    monkeypatch.setattr(specs, "INPUT_SHAPES", SMALL)


@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b", "rwkv6-3b",
                                  "jamba-1.5-large-398b", "seamless-m4t-medium",
                                  "llava-next-mistral-7b", "phi3-mini-3.8b"])
def test_run_case_at_smoke_size(smoke, arch):
    for shape, meta in SMALL.items():
        recs = dryrun.run_case(arch, shape, (False, True), max_positions=MAX_POSITIONS)
        assert [r["mesh"] for r in recs] == ["pod_16x16", "multipod_2x16x16"]
        for rec in recs:
            if meta.get("long") and not configs.supports_long(arch):
                assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
                continue
            assert rec["status"] == "ok", rec.get("traceback")
            assert rec["flops"] > 0
            mem = rec["memory"]
            assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
            assert mem["temp_bytes"] is None and rec["collective_bytes"] is None
            recurrent = configs.get_smoke_config(arch).family in ("ssm", "hybrid")
            if meta["kind"] == "train":
                assert (rec["microbatches"], rec["microbatches_run"]) == (2, 1)
            if meta["kind"] in ("train", "prefill") and recurrent:
                assert (rec["seq"], rec["seq_run"]) == (meta["seq"], MAX_POSITIONS)
        # one run serves both meshes; a wider mesh holds no more a rank
        if recs[0]["status"] == "ok":
            assert recs[0]["flops"] == recs[1]["flops"]
            assert (recs[1]["memory"]["argument_bytes"]
                    <= recs[0]["memory"]["argument_bytes"])


def test_dryrun_cli_writes_records(smoke, tmp_path, capsys):
    out = tmp_path / "dr"
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "all", "--mesh", "single",
                 "--out", str(out)])
    text = capsys.readouterr().out
    assert "ok=3 skipped=1 fail=0" in text and "slowest:" in text
    names = sorted(p.name for p in out.iterdir())
    assert names == [f"tinyllama-1.1b_{s}_pod_16x16.json" for s in
                     sorted(k for k, v in SMALL.items() if not v.get("extra"))]
    rec = json.loads((out / "tinyllama-1.1b_decode_32k_pod_16x16.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["flops"] > 0


def test_dryrun_cli_exits_1_on_a_failed_case(smoke, monkeypatch, tmp_path, capsys):
    """A case whose kernel call fails its operand checks is a ``fail``."""
    def bad_rules(mesh, **kw):
        raise ValueError("no plan")

    monkeypatch.setattr(specs.sharding, "rules_serve", bad_rules)
    with pytest.raises(SystemExit) as ei:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh",
                     "single", "--out", str(tmp_path)])
    assert ei.value.code == 1 and "fail=1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the verify step's sampler, and imports
# ---------------------------------------------------------------------------


def test_sample_window_tensor_path_equals_host_path():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 3, 50, generator=gen)
    seeds, base = [1, 2, 3, 4], [0, 5, 9, 100]
    temps, top_ks = [0.0, 0.7, 1.0, 0.0], [0, 5, 0, 3]
    host = sample_window(logits, seeds, base, temps, top_ks)
    tens = sample_window(logits, torch.tensor(seeds, dtype=I32), torch.tensor(base, dtype=I32),
                         torch.tensor(temps), torch.tensor(top_ks, dtype=I32))
    assert torch.equal(host, tens)
    assert sample_window(_m(4, 3, 50), _m(4, dtype=I32), _m(4, dtype=I32),
                         _m(4)).shape == (4, 3)


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.launch.dryrun, repro_torch.distributed.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.specs; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
