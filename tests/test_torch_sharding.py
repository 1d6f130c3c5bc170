"""The port's distribution layer on the CPU (``distributed.sharding``,
``launch.mesh``).

* Placement plans against the reference's ``PartitionSpec`` entries,
  exactly, on both production meshes (the reference's built as a jax 0.9
  ``AbstractMesh``): parameter plans under ``rules_train`` (FSDP on and
  off) and ``rules_serve`` (``moe_ep`` "model" and "data") for every arch,
  and cache plans for every serving case of ``INPUT_SHAPES`` under both KV
  policies, the port's layer axis of one (``head_layers``, ``cross.mask``)
  mapped to a leading ``None``.
* The reference's invariants on the port alone: every planned dim divides
  by its axes' product, no axis twice in a plan; ``spec_for``'s cases from
  ``tests/test_sharding.py``; ``make_host_mesh``'s errors.
* Gloo ranks in spawned processes at d = 1, 2 and 4: ``tp_matmul`` bitwise
  equal to the port's logical ``matmul`` under ``VERIFY_SCHEDULE`` at
  (4, 64) @ (64, 32) and (8, 512) @ (512, 256) in bf16 and f32, and within
  the cross-framework tolerance of the reference's logical ``matmul`` on the
  same numpy inputs; the un-pinned schedule differs between d = 1 and
  d = 4; ``param_shardings``' DTensor placements of a smoke config round
  trip (``distribute_tensor`` ... ``full_tensor``) with ``local_shape``
  shards, and a dim over ``("pod", "data")`` holds the shard JAX puts on
  each rank (``pod`` major).
* The split schedules (splits 1, 2 and 8 x combine bf16 and f32, pinned
  and un-pinned, ``tp_shards`` 4) on the same gloo ranks, against the
  reference's own ``tp_matmul`` under ``shard_map`` on 8 host devices at
  d = 1, 2 and 4 (a subprocess, as ``tests/test_sharding.py`` runs it):
  within ``_tolerance`` at every rank, width and schedule.  The reference
  is bitwise across widths at every pinned schedule, and so is the port
  (bitwise its own logical ``matmul`` too); un-pinned, both follow the
  width.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.launch.specs import INPUT_SHAPES, decode_capacity, resolve_config
from repro_torch.models.base import iter_specs, param_specs
from repro_torch.models.transformer import cache_spec

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
RULES = [("train", {"fsdp": True}), ("train", {"fsdp": False}),
         ("serve", {"moe_ep": "model"}), ("serve", {"moe_ep": "data"})]
SERVE_SHAPES = [s for s, m in INPUT_SHAPES.items() if m["kind"] != "train"]
#: cross-framework tolerance of tp_matmul against the reference's matmul:
#: 2 bf16 ulps of max |ref| for bf16 outputs, this fraction of it for f32
F32_REL = 1e-6
#: the split schedules held against the reference's tp_matmul: (splits,
#: combine_dtype, tp_pinned), tp_shards 4
SPLIT_SCHEDULES = tuple((s, cd, p) for s in (1, 2, 8) for cd in ("bfloat16", "float32")
                        for p in (True, False))
#: bf16 ulps of max |ref| a split schedule with a bf16 rounding point inside
#: its sums (a bf16 combine) may differ by between two frameworks: their f32
#: partials differ in the last bits, so a partial or a running sum may round
#: to the neighbouring bf16 value, at up to splits x tp_shards points
SPLIT_BF16_ULPS = 4


def _tolerance(dt: str, cd: str, scale: float) -> float:
    """Cross-framework bound of a schedule's output against the
    reference's: a bf16 combine ``SPLIT_BF16_ULPS`` bf16 ulps of max |ref|,
    else as ``VERIFY_SCHEDULE``'s (2 bf16 ulps for bf16 outputs,
    ``F32_REL`` of max |ref| for f32)."""
    if cd == "bfloat16":
        return SPLIT_BF16_ULPS * scale * 2.0 ** -8
    return 2 * scale * 2.0 ** -8 if dt == "bfloat16" else F32_REL * scale


def _sched_key(splits: int, cd: str, pinned: bool) -> str:
    return f"s{splits}_{cd}_{'pinned' if pinned else 'unpinned'}"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_meshes():
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    return {False: AbstractMesh((16, 16), ("data", "model")),
            True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict of plans or specs."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _jax_flat(tree):
    import jax
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(k.key) for k in path): tuple(spec) for path, spec in leaves}


def _port_mapped(path, plan):
    """The reference's plan of a port leaf: the port's layer axis of one
    (head layers, the cross mask) dropped."""
    if path[0] == "head_layers" or path == ("cross", "mask"):
        assert plan[0] is None
        return plan[1:]
    return plan


@pytest.mark.parametrize("arch", ARCHS)
def test_param_plans_equal_reference(arch):
    from repro import configs as jconfigs
    from repro.distributed import sharding as jsharding

    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for multi, jm in _jax_meshes().items():
        m = make_production_mesh(multi_pod=multi)
        for kind, kw in RULES:
            got = _flat(sharding.param_pspecs(
                cfg, m, getattr(sharding, f"rules_{kind}")(m, **kw)))
            want = _jax_flat(jsharding.param_pspecs(
                jcfg, jm, getattr(jsharding, f"rules_{kind}")(jm, **kw)))
            assert got == want, (arch, multi, kind, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_plans_equal_reference(arch):
    from repro.distributed import sharding as jsharding
    from repro.launch import specs as jspecs

    for multi, jm in _jax_meshes().items():
        m = make_production_mesh(multi_pod=multi)
        for shape in SERVE_SHAPES:
            cfg, skip = resolve_config(arch, shape)
            jcfg, jskip = jspecs.resolve_config(arch, shape)
            assert (skip is None) == (jskip is None)
            if skip:
                continue
            meta = INPUT_SHAPES[shape]
            cap = decode_capacity(cfg, meta["seq"])
            assert cap == jspecs.decode_capacity(jcfg, meta["seq"])
            for policy in ("feature_first", "seq_first"):
                got = sharding.cache_pspec_tree(cfg, m, meta["batch"], cap,
                                                kv_policy=policy)
                want = _jax_flat(jsharding.cache_pspec_tree(
                    jcfg, jm, meta["batch"], cap, kv_policy=policy))
                got = {k: _port_mapped(k, v) for k, v in _flat(got).items()}
                assert got == want, (arch, multi, shape, policy)


def _assert_valid(shape, plan, sizes, what):
    used = set()
    for dim, part in zip(shape, plan):
        axes = sharding._normalize(part)
        assert dim % math.prod(sizes[a] for a in axes) == 0, (what, shape, plan)
        assert not used & set(axes), (what, plan)
        used.update(axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_plan_divides_and_uses_an_axis_once(arch):
    """The reference's invariants, on the port alone: parameter plans under
    every rule set and cache plans of every serving case, both meshes."""
    cfg = configs.get_config(arch)
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        sizes = m.shape
        for kind, kw in RULES:
            plans = sharding.param_pspecs(cfg, m, getattr(sharding, f"rules_{kind}")(m, **kw))
            for path, spec in iter_specs(param_specs(cfg)):
                _assert_valid(spec.shape, _flat(plans)[path], sizes, (arch, path))
        for shape in SERVE_SHAPES:
            c, skip = resolve_config(arch, shape)
            if skip:
                continue
            meta = INPUT_SHAPES[shape]
            cap = decode_capacity(c, meta["seq"])
            plans = _flat(sharding.cache_pspec_tree(c, m, meta["batch"], cap))
            for path, (leaf_shape, _) in _flat(cache_spec(c, meta["batch"], cap)).items():
                _assert_valid(leaf_shape, plans[path], sizes, (arch, shape, path))
                assert sharding.local_shape(leaf_shape, plans[path], m)


@pytest.mark.parametrize("shape,axes,kind,multi,want", [
    ((4096, 14336), ("embed", "ffn"), "serve", False, (None, "model")),
    ((4096, 14336), ("embed", "ffn"), "train", False, ("data", "model")),
    ((8,), ("kv",), "serve", False, (None,)),
    ((16, 4096, 8192), ("experts", "embed", "ffn"), "serve", False, ("model", None, None)),
    ((8192, 1024), ("embed", "ffn"), "train", True, (("pod", "data"), "model")),
    ((16,), ("embed",), "train", True, ("pod",)),
], ids=["basic-tp", "fsdp-train", "divisibility-fallback", "no-axis-reuse",
        "multipod-fsdp", "multipod-drops-right"])
def test_spec_for(shape, axes, kind, multi, want):
    """``tests/test_sharding.py::TestSpecFor`` on the port."""
    m = make_production_mesh(multi_pod=multi)
    assert sharding.spec_for(shape, axes, getattr(sharding, f"rules_{kind}")(m), m) == want


def test_mesh_descriptions_and_local_shape():
    m = make_production_mesh(multi_pod=True)
    assert m == Mesh(("pod", "data", "model"), (2, 16, 16)) and m.size == 512
    assert sharding.batch_pspec(m) == (("pod", "data"),)
    assert sharding.local_shape((64, 4096, 30), (("pod", "data"), "model"), m) == (2, 256, 30)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_shape((40, 8), ("model",), m)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharding.tp_matmul(torch.zeros(2, 64), torch.zeros(64, 8),
                           Mesh(("data", "model"), (1, 4)))


def test_make_host_mesh_errors(tmp_path):
    """The message names the world size and the remedy; a width of 0 is
    refused; a divisor builds the (data, model) mesh; no process group, no
    mesh."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(model=1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError) as ei:
            make_host_mesh(model=4)
        assert "world size 1" in str(ei.value) and "world_size" in str(ei.value)
        with pytest.raises(ValueError):
            make_host_mesh(model=0)
        m = make_host_mesh(model=1)
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
        x = torch.ones(3, 64)
        assert torch.equal(sharding.tp_matmul(x, torch.ones(64, 8), m),
                           torch.full((3, 8), 64.0))  # width 1: the logical path
    finally:
        dist.destroy_process_group()


RANKS = textwrap.dedent('''
    import os, socket, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    SHAPES = ((4, 64, 32), (8, 512, 256))
    SCHEDULES = tuple((s, cd, p) for s in (1, 2, 8) for cd in ("bfloat16", "float32")
                      for p in (True, False))


    def inputs(m, k, n):
        rng = np.random.default_rng(m * 1000 + k)
        return (rng.standard_normal((m, k)).astype(np.float32),
                rng.standard_normal((k, n)).astype(np.float32))


    def rank(r, d, port, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=d, rank=r)
        from repro_torch import configs
        from repro_torch.core.determinism import VERIFY_SCHEDULE, Schedule, matmul
        from repro_torch.distributed.sharding import (
            local_shape, param_pspecs, param_shardings, rules_train, tp_matmul)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.base import iter_specs, param_specs

        mesh = make_host_mesh(model=d)
        fast = Schedule(splits=1, combine_dtype="bfloat16", tp_shards=4, tp_pinned=False)
        res = {}
        for m, k, n in SHAPES:
            xn, wn = inputs(m, k, n)
            for dt in (torch.bfloat16, torch.float32):
                x, w = torch.from_numpy(xn).to(dt), torch.from_numpy(wn).to(dt)
                got = tp_matmul(x, w, mesh)
                key = f"{m}x{k}x{n}_{str(dt)[6:]}"
                res["pinned_" + key] = got.float().numpy()
                res["bitwise_" + key] = np.array(torch.equal(
                    got, matmul(x, w, VERIFY_SCHEDULE)))
                res["fast_" + key] = tp_matmul(x, w, mesh, schedule=fast).float().numpy()
                for splits, cd, pinned in SCHEDULES:
                    s = Schedule(splits=splits, combine_dtype=cd, tp_shards=4,
                                 tp_pinned=pinned)
                    got = tp_matmul(x, w, mesh, schedule=s)
                    skey = f"s{splits}_{cd}_{'pinned' if pinned else 'unpinned'}_{key}"
                    res["sched_" + skey] = got.float().numpy()
                    res["logical_" + skey] = np.array(torch.equal(got, matmul(x, w, s)))
        if d == 4:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import distribute_tensor

            cfg = configs.get_smoke_config("llama3-8b")
            ok = True
            for mesh2 in (make_host_mesh(model=2),
                          init_device_mesh("cpu", (2, 2, 1),
                                           mesh_dim_names=("pod", "data", "model"))):
                plans = param_pspecs(cfg, mesh2, rules_train(mesh2))
                places = param_shardings(cfg, mesh2, rules_train(mesh2))
                gen = torch.Generator().manual_seed(0)
                for path, spec in iter_specs(param_specs(cfg)):
                    plan, place = plans, places
                    for key in path:
                        plan, place = plan[key], place[key]
                    t = torch.randn(spec.shape, generator=gen)
                    dt = distribute_tensor(t, mesh2, list(place))
                    ok &= tuple(dt.to_local().shape) == local_shape(t.shape, plan, mesh2)
                    ok &= torch.equal(dt.full_tensor(), t)
                    for dim, entry in enumerate(plan):
                        if entry == ("pod", "data"):  # JAX's order: pod major
                            c = mesh2.get_coordinate()
                            want = t.chunk(4, dim=dim)[c[0] * 2 + c[1]]
                            ok &= torch.equal(dt.to_local(), want)
                            res["pod_data_seen"] = np.array(True)
            res["dtensor_ok"] = np.array(ok)
        np.savez(os.path.join(out, f"d{d}_r{r}.npz"), **res)
        dist.destroy_process_group()


    if __name__ == "__main__":
        out = sys.argv[1]
        for d in (1, 2, 4):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            mp.spawn(rank, args=(d, port, out), nprocs=d, join=True)
        print("RANKS-OK")
''')


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    script = out / "ranks.py"
    script.write_text(RANKS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(script), str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "RANKS-OK" in proc.stdout, proc.stderr[-3000:]
    return {p.stem: dict(np.load(p)) for p in out.glob("d*_r*.npz")}


def test_tp_matmul_gloo_bitwise_at_every_width(rank_results):
    """Every rank at d = 1, 2 and 4 gets the logical commit GEMM's bits."""
    assert sorted(rank_results) == ["d1_r0", "d2_r0", "d2_r1", "d4_r0", "d4_r1",
                                    "d4_r2", "d4_r3"]
    for name, res in rank_results.items():
        keys = [k for k in res if k.startswith("bitwise_")]
        assert len(keys) == 4 and all(bool(res[k]) for k in keys), name
        for k in keys:
            key = k[len("bitwise_"):]
            assert np.array_equal(res["pinned_" + key], rank_results["d1_r0"]["pinned_" + key])


REFERENCE_TP = textwrap.dedent('''
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core.determinism import Schedule
    from repro.distributed.sharding import tp_matmul
    from repro.launch.mesh import make_host_mesh

    SHAPES = ((4, 64, 32), (8, 512, 256))
    SCHEDULES = tuple((s, cd, p) for s in (1, 2, 8) for cd in ("bfloat16", "float32")
                      for p in (True, False))
    CASES = [(dt, s) for dt in ("bfloat16", "float32") for s in SCHEDULES]
    res = {}
    for m, k, n in SHAPES:
        rng = np.random.default_rng(m * 1000 + k)
        xn = rng.standard_normal((m, k)).astype(np.float32)
        wn = rng.standard_normal((k, n)).astype(np.float32)
        for d in (1, 2, 4):
            mesh = make_host_mesh(model=d)

            def every_case(x32, w32):
                return [tp_matmul(x32.astype(dt), w32.astype(dt), mesh, schedule=Schedule(
                    splits=splits, combine_dtype=cd, tp_shards=4, tp_pinned=pinned))
                    .astype(jnp.float32) for dt, (splits, cd, pinned) in CASES]

            outs = jax.jit(every_case)(jnp.asarray(xn), jnp.asarray(wn))
            for (dt, (splits, cd, pinned)), got in zip(CASES, outs):
                key = f"s{splits}_{cd}_{'pinned' if pinned else 'unpinned'}"
                res[f"d{d}_{key}_{m}x{k}x{n}_{dt}"] = np.asarray(got)
    np.savez(sys.argv[1], **res)
    print("REFERENCE-OK")
''')


@pytest.fixture(scope="module")
def reference_tp(tmp_path_factory):
    """The reference's ``tp_matmul`` at ``SPLIT_SCHEDULES`` x d = 1, 2, 4 on
    the rank script's inputs: ``shard_map`` on 8 host devices, in a
    subprocess (the device count is fixed before jax initializes).  Every
    case of a (shape, d) runs in one ``jax.jit`` (about 10 s in all, against
    minutes op by op) with ``--xla_allow_excess_precision=false``, so that
    XLA keeps each bf16 rounding of the combine; so run, the results equal
    the op-by-op ones bit for bit (checked at splits 8, both combines and
    operand dtypes, d = 1, 2 and 4)."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("reference") / "tp.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
                        " --xla_allow_excess_precision=false").strip()
    proc = subprocess.run([sys.executable, "-c", REFERENCE_TP, str(out)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "REFERENCE-OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(out))


def _split_cases():
    for m, k, n in ((4, 64, 32), (8, 512, 256)):
        for dt in ("bfloat16", "float32"):
            for splits, cd, pinned in SPLIT_SCHEDULES:
                yield f"{_sched_key(splits, cd, pinned)}_{m}x{k}x{n}_{dt}", dt, cd, pinned


def test_tp_matmul_refuses_splits_past_the_fallback(rank_results, reference_tp):
    """Past the fallback no split schedule is refused: every rank at d = 1,
    2 and 4 computes each of ``SPLIT_SCHEDULES`` as the reference's
    ``tp_matmul`` does at the same width (each rank's chunks under the
    schedule's splits and combine dtype, its local subtree, then the
    butterfly or the all-reduce in ``combine_dtype``), within
    ``_tolerance``."""
    worst = 0.0
    for key, dt, cd, _ in _split_cases():
        for name, res in rank_results.items():
            want = reference_tp[f"{name.split('_')[0]}_{key}"]
            tol = _tolerance(dt, cd, float(np.abs(want).max()))
            err = float(np.abs(res["sched_" + key] - want).max())
            assert err <= tol, (name, key, err, tol)
            worst = max(worst, err / tol)
    print(f"worst |port - reference| / tolerance: {worst:.3g}")


def test_tp_matmul_split_schedules_bitwise_where_the_reference_is(rank_results,
                                                                   reference_tp):
    """The reference's tp_matmul is bitwise across d = 1, 2 and 4 at every
    pinned schedule: so is the port's, on every rank, and each equals the
    port's logical ``matmul`` under the schedule.  Un-pinned (the all-reduce
    in ``combine_dtype``), the bf16 combine gives other bits at d = 4 than
    at d = 1, in the reference and in the port.  The un-pinned f32 combine
    of f32 operands is where the two part: the reference's d = 4 equals its
    d = 1 bit for bit, because XLA's host all-reduce adds the ranks in rank
    order, which is the logical fold's order at one chunk a rank; gloo's and
    NCCL's all-reduce add in their own order, so the port's d = 4 may differ
    in the last f32 bits (within ``_tolerance``, held above).  The
    reference's contract gives an un-pinned schedule no equality across
    widths (its ``Schedule.tp_pinned``), so the port keeps the all-reduce."""
    for key, dt, cd, pinned in _split_cases():
        refs = [reference_tp[f"d{d}_{key}"] for d in (1, 2, 4)]
        if pinned:
            assert all(np.array_equal(refs[0], r) for r in refs), key
            for name, res in rank_results.items():
                assert bool(res["logical_" + key]), (name, key)
                assert np.array_equal(res["sched_" + key],
                                      rank_results["d1_r0"]["sched_" + key]), (name, key)
        elif cd == "bfloat16":
            assert not np.array_equal(refs[0], refs[2]), key
            assert not np.array_equal(rank_results["d1_r0"]["sched_" + key],
                                      rank_results["d4_r0"]["sched_" + key]), key
        elif dt == "float32":
            assert np.array_equal(refs[0], refs[2]), key  # rank-order psum
        for r in range(4):  # every rank of d = 4 holds the same value
            assert np.array_equal(rank_results[f"d4_r{r}"]["sched_" + key],
                                  rank_results["d4_r0"]["sched_" + key]), (r, key)


def test_tp_matmul_gloo_matches_reference_matmul(rank_results):
    """Within the cross-framework tolerance of the reference's logical
    ``matmul`` under ``VERIFY_SCHEDULE``, on the same numpy inputs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import VERIFY_SCHEDULE as JVERIFY, matmul as jmatmul

    for m, k, n in ((4, 64, 32), (8, 512, 256)):
        rng = np.random.default_rng(m * 1000 + k)
        xn = rng.standard_normal((m, k)).astype(np.float32)
        wn = rng.standard_normal((k, n)).astype(np.float32)
        for dt in ("bfloat16", "float32"):
            want = np.asarray(jmatmul(jnp.asarray(xn).astype(dt), jnp.asarray(wn).astype(dt),
                                      JVERIFY).astype(jnp.float32))
            scale = float(np.abs(want).max())
            tol = 2 * scale * 2.0 ** -8 if dt == "bfloat16" else F32_REL * scale
            for name, res in rank_results.items():
                np.testing.assert_allclose(res[f"pinned_{m}x{k}x{n}_{dt}"], want,
                                           atol=tol, rtol=0, err_msg=name)


def test_tp_matmul_unpinned_follows_the_width(rank_results):
    """Negative control: the un-pinned schedule's all-reduce in bf16 gives
    other bits at d = 4 than the logical fold at d = 1."""
    for key in ("8x512x256_bfloat16", "8x512x256_float32"):
        a = rank_results["d1_r0"]["fast_" + key]
        b = rank_results["d4_r0"]["fast_" + key]
        assert not np.array_equal(a, b), key
        for r in range(4):  # every rank holds the same all-reduced value
            assert np.array_equal(rank_results[f"d4_r{r}"]["fast_" + key], b)


def test_param_shardings_round_trip_dtensor(rank_results):
    """A smoke config's parameters distributed by ``param_shardings``'
    placements come back whole, each shard of ``local_shape``; on a (pod,
    data, model) mesh a dim over ("pod", "data") holds JAX's shard."""
    for r in range(4):
        res = rank_results[f"d4_r{r}"]
        assert bool(res["dtensor_ok"])
        assert bool(res["pod_data_seen"])
