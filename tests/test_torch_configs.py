"""The configs the port serves, on the CPU.

* ``configs.get_config`` / ``get_smoke_config`` (and ``get_long_config``
  where a config has a sliding-window variant) serve every ported id,
  dashed and underscored, field for field the JAX package's configs, and
  ``param_count`` / ``active_param_count`` equal the JAX values exactly at
  full and smoke size.
* Each new config's smoke forward against the JAX forward on shared
  weights (``params_from_numpy``): a 12-token prefill under
  ``VERIFY_SCHEDULE`` and one decode token under a fast schedule, over a
  paged pool.  Tolerance ``LOGIT_TOL``: both sides compute the same
  reduction trees in f32, each in its own summation order (1.1e-6 to
  7.1e-5 measured on logits of magnitude 1.5-4.3; the bound of
  ``test_torch_model``).
* command-r's tied embeddings: ``unembed`` is one copy of ``embed.T`` made
  with the params, and the logits are bitwise those of an explicit untied
  ``unembed = embed.T``.
* Each new config's smoke engine: LLM42 streams identical alone and beside
  3 neighbours.
* The serve CLI with the costed clock, the ShareGPT workload and the
  trace, metrics and audit outputs.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import (
    REORDER_ONLY_POLICY, VERIFY_SCHEDULE, Mode, ReductionPolicy,
)
from repro_torch.models.base import init_params, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedView
from repro_torch.models.transformer import forward
from repro_torch.serving import kv_cache
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
#: the serve CLI's process runs with one intra-op thread, as this module's
#: own tests do: several test workers share the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
DENSE = list(configs.DASHED)
NEW = ["tinyllama-1.1b", "phi3-mini-3.8b", "internlm2-20b", "command-r-35b",
       "llama4-scout-17b-a16e"]
CAP, BS = 64, 16
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_param_counts_equal_jax(arch):
    pytest.importorskip("jax")
    from repro import configs as jconfigs

    module = configs.DASHED[arch]
    getters = [(configs.get_config, jconfigs.get_config),
               (configs.get_smoke_config, jconfigs.get_smoke_config)]
    assert configs.supports_long(arch) == jconfigs.supports_long(arch)
    if configs.supports_long(arch):
        getters.append((configs.get_long_config, jconfigs.get_long_config))
    else:
        with pytest.raises(ValueError, match="long-context"):
            configs.get_long_config(arch)
    for get, jget in getters:
        cfg, jcfg = get(arch), jget(arch)
        assert get(module) == cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.block_period() == jcfg.block_period()
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [jcfg.layer_kind(i) for i in range(cfg.num_layers)]
        assert [cfg.ffn_kind(i) for i in range(cfg.num_layers)] == \
            [jcfg.ffn_kind(i) for i in range(cfg.num_layers)]
        assert cfg.d_inner == jcfg.d_inner


def test_registry_refuses_unported_archs():
    """Every architecture of the reference is registered (``list_archs``
    equals JAX's, the paper's llama3-8b besides them); an unknown name
    raises."""
    jax_configs = pytest.importorskip("repro.configs")
    assert configs.list_archs() == jax_configs.list_archs()
    assert sorted(configs.ARCH_IDS) == sorted(configs.DASHED.values())
    assert set(configs.ARCH_IDS) == set(configs.list_archs()) | {"llama3_8b"}
    with pytest.raises(ValueError, match="no such architecture"):
        configs.get_config("jamba-2-mini")


def _shared(arch):
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import init_params as jax_init

    jcfg = jconfigs.get_smoke_config(arch)
    jp = jax_init(jcfg, jax.random.key(0))
    cfg = configs.get_smoke_config(arch)
    return cfg, jcfg, jp, params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", NEW)
def test_smoke_forward_matches_jax(arch):
    """A 12-token prefill of two rows under VERIFY_SCHEDULE, then one decode
    token under the fast schedule of B = 2 (kv_splits 4 over 4 blocks)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import (
        REORDER_ONLY_POLICY as JR, VERIFY_SCHEDULE as JV,
    )
    from repro.models.layers import PagedView as JPV
    from repro.models.transformer import forward as jforward
    from repro.serving import kv_cache as jkv

    cfg, jcfg, jp, tp = _shared(arch)
    jpool = jkv.CachePool(jcfg, 2, CAP, block_size=BS)
    tpool = kv_cache.CachePool(cfg, 2, CAP, block_size=BS, device=torch.device("cpu"))
    nb = 2 * (CAP // BS)  # the pools' null block; scratch follows it
    tables = np.full((2, CAP // BS), -1, np.int32)
    tables[0, :1], tables[1, :2] = [0], [3, 1]
    rng = np.random.default_rng(5)
    start = np.array([0, 3], np.int32)
    jcache, tcache = jpool.data, tpool.data
    for toks, jsched, tsched in (
            (rng.integers(0, cfg.vocab_size, (2, 12)), JV, VERIFY_SCHEDULE),
            (rng.integers(0, cfg.vocab_size, (2, 1)), JR.schedule_for(2),
             REORDER_ONLY_POLICY.schedule_for(2))):
        toks = toks.astype(np.int32)
        # jitted, as the reference's engine runs it (op by op every
        # primitive compiles on its own)
        jl, jcache, _ = jax.jit(lambda p, x, c, st, tb, sch=jsched: jforward(
            p, jcfg, x, cache=c, start_pos=st, schedule=sch, tables=tb,
            paged=JPV(BS, nb, nb + 1)))(jp, jnp.asarray(toks), jcache, jnp.asarray(start),
                                        jnp.asarray(tables))
        tl, _, _ = forward(tp, cfg, torch.from_numpy(toks), cache=tcache,
                           start_pos=torch.from_numpy(start), schedule=tsched,
                           tables=torch.from_numpy(tables), paged=PagedView(BS, nb, nb + 1))
        assert tl.shape == (2, toks.shape[1], cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
        start = start + toks.shape[1]


def test_tied_unembedding_is_one_copy_and_bitwise():
    cfg = configs.get_smoke_config("command-r-35b")
    assert cfg.tie_embeddings and "unembed" not in param_specs(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    emb, un = params["embed"], params["unembed"]
    assert un.shape == (cfg.d_model, cfg.vocab_size) and un.is_contiguous()
    assert un.data_ptr() != emb.data_ptr() and torch.equal(un, emb.t())
    explicit = dict(params, unembed=emb.t().contiguous())
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    toks = torch.tensor([[5, 9, 300, 7, 2, 41]], dtype=torch.int32)

    def logits(c, p):
        pool = kv_cache.CachePool(c, 1, CAP, block_size=BS, device=torch.device("cpu"))
        out, _, _ = forward(p, c, toks, cache=pool.data,
                            start_pos=torch.zeros(1, dtype=torch.int32),
                            tables=torch.tensor([[0, -1, -1, -1]], dtype=torch.int32),
                            paged=PagedView(BS, CAP // BS, CAP // BS + 1))
        return out

    assert torch.equal(logits(cfg, params), logits(untied, explicit))
    # params shared from numpy get the same copy
    np_tree = {k: (v if k == "blocks" else v.numpy()) for k, v in params.items()
               if k != "unembed"}
    np_tree["blocks"] = {"0": {k: ({kk: vv.numpy() for kk, vv in v.items()}
                                   if isinstance(v, dict) else v.numpy())
                               for k, v in params["blocks"]["0"].items()}}
    again = params_from_numpy(cfg, np_tree, "cpu")
    assert torch.equal(again["unembed"], un)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_engine_llm42_streams_identical_beside_neighbours(arch):
    cfg = configs.get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")

    def run(neighbours):
        eng = Engine(cfg, params, mode=Mode.LLM42, policy=policy, window=5,
                     group=2, max_batch=4, capacity=64)
        eng.submit(Request(rid=0, prompt=list(range(1, 10)), sampling=SamplingParams(
            max_new_tokens=12, is_deterministic=True, seed=3)))
        for i in range(neighbours):
            eng.submit(Request(rid=1 + i, prompt=[3 * i + k for k in range(6)],
                               sampling=SamplingParams(max_new_tokens=12)))
        return {r.rid: r.committed for r in eng.run()}[0]

    alone = run(0)
    assert len(alone) == 12 and run(3) == alone


def test_serve_cli_costed_clock_and_outputs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--workload", "sharegpt", "--requests", "4",
         "--max-new", "8", "--verify-latency-ms", "10",
         "--trace-out", str(tmp_path / "trace.json"),
         "--metrics-out", str(tmp_path / "metrics.json"),
         "--audit-out", str(tmp_path / "audit.jsonl")],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", **ONE_THREAD},
    )
    assert out.returncode == 0, out.stderr
    assert "arch=tinyllama-smoke" in out.stdout and "workload=sharegpt" in out.stdout
    assert "modeled H100 time of tinyllama-1.1b (cost model, not a measurement)" \
        in out.stdout
    assert "stream clocks: main" in out.stdout
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    metrics = json.loads((tmp_path / "metrics.json").read_text())["snapshot"]
    assert metrics["streams.makespan"] > 0 and metrics["streams.main_busy"] > 0
    audit = (tmp_path / "audit.jsonl").read_text().splitlines()
    assert len(audit) == metrics["tokens.committed"] > 0
