"""A CPU rehearsal of ``chip_smoke.py``'s four-card ``distribution4`` phase.

The phase's rank function, ``chip_smoke.distribution4_rank``, runs in 4
spawned gloo ranks on the CPU (the plain kernel versions) at small shapes:
the same checks as on four cards, with the same verdicts expected.  Every
rank's ``tp_matmul`` under ``VERIFY_SCHEDULE`` is bitwise the logical
commit GEMM at d = 1, 2 and 4 and every rank holds the same bits; the
pinned split schedules (splits 2 and 8 x combine bf16 and f32) are bitwise
the logical split-K GEMM at every d; the un-pinned bf16 all-reduce at d = 4
differs from d = 1 in at least one case; each call is one partials launch
(on the CPU the wrappers count nothing, so the rank script counts the plain
GEMM entries, one a wrapper call).  The phase itself refuses to run on fewer
than four cards, and a failing rank fails the spawn at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: the rehearsal's sizes: (K, N) x M, all-reduce tokens, timing repeats
SHAPES = ((512, 256), (256, 128))
MS = (1, 8)
TOKENS = (8, 32)
REPS = 3

RANKS = textwrap.dedent('''
    import json, socket, sys
    import torch.multiprocessing as mp

    import chip_smoke
    from repro_torch.kernels import gemm_batch_invariant as gbi, gemm_splitk as gsk, ref


    def counted(fn, owner):
        def call(*args, **kwargs):
            owner.launches += 1
            return fn(*args, **kwargs)
        return call


    def rank(r, fail_rank, *args):
        if r == fail_rank:
            raise RuntimeError(f"rank {r} fails on purpose")
        # one plain entry a wrapper call: the logical GEMMs' and the
        # partials entries' (ref.gemm_batch_invariant and ref.gemm_splitk
        # call these too)
        ref.gemm_partials = counted(ref.gemm_partials, gbi.gemm_batch_invariant)
        ref.gemm_splitk_partials = counted(ref.gemm_splitk_partials, gsk.gemm_splitk)
        chip_smoke.distribution4_rank(r, *args)


    if __name__ == "__main__":
        out, fail_rank, sizes = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(rank, nprocs=4, join=True, args=(
            fail_rank, 4, port, out, "cpu", [tuple(k) for k in sizes["shapes"]],
            tuple(sizes["ms"]), tuple(sizes["tokens"]), sizes["reps"]))
        print("RANKS-OK")
''')


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(tmp_path, fail_rank=-1):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS)
    sizes = json.dumps({"shapes": SHAPES, "ms": MS, "tokens": TOKENS, "reps": REPS})
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'src'}",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(script), str(tmp_path), str(fail_rank), sizes],
                          capture_output=True, text=True, env=env, timeout=300)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distribution4")
    proc = _spawn(out)
    assert proc.returncode == 0 and "RANKS-OK" in proc.stdout, proc.stderr[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


def test_rank_checks_pass_with_the_cards_verdicts(ranks):
    """Pinned bitwise across d (VERIFY_SCHEDULE and the split schedules),
    the un-pinned control differing, on rank 0's record."""
    cases = len(SHAPES) * len(MS)
    v = ranks[0]["verdicts"]
    assert v["pinned"] == cases * len(chip_smoke.D4_WIDTHS)
    assert v["splits"] == cases * len(chip_smoke.D4_WIDTHS) * len(chip_smoke.D4_SPLITS)
    assert 1 <= v["unpinned_differs"] <= cases and v["unpinned_max_diff"] > 0
    assert v["unpinned_repeat_equal"]  # gloo's all-reduce repeats its order


def test_rank_launches_one_partials_launch_a_call(ranks):
    """Each tp_matmul call is one launch (checked call by call in the rank),
    and the rank records those alone: VERIFY_SCHEDULE's calls on the commit
    GEMM, the split schedules' and the three un-pinned runs' on the split-K
    library."""
    cases = len(SHAPES) * len(MS)
    widths = len(chip_smoke.D4_WIDTHS)
    want = dict.fromkeys(chip_smoke.KERNELS, 0)
    want.update(gemm_batch_invariant=cases * widths,
                gemm_splitk=cases * (widths * len(chip_smoke.D4_SPLITS) + 3))
    for rk in ranks:
        assert rk["launches"] == want


def test_report_merges_ranks(ranks):
    """The parent's report: the maximum over ranks of every timing, the
    all-reduce rate by the cost model's formula, the launches recorded
    outside the main path's count."""
    results = {k: {"launches": 0, "launches_by_mode": {}} for k in chip_smoke.KERNELS}
    summary = {}
    chip_smoke.report_distribution4(ranks, "CPU rehearsal", results, summary)
    got = summary["distribution4"]
    assert set(got["timing"]) == {f"{k}x{n}" for k, n in SHAPES}
    for key, row in got["timing"].items():
        assert {"commit_ms", "partial_ms", "exchange_d2_step1_ms", "exchange_d4_step1_ms",
                "exchange_d4_step2_ms", "tp_matmul_d2_ms", "tp_matmul_d4_ms",
                "allreduce_d2_ms", "allreduce_d4_ms"} == set(row)
        for k, t in row.items():
            assert t == max(rk["timing"][key][k] for rk in ranks)
    rate = got["allreduce"]["tp4_tokens8"]
    assert rate["bytes"] == 8 * 4096 * 2
    assert rate["rate_bytes_per_s"] == pytest.approx(
        rate["bytes"] * 2 * 3 / 4 / (rate["ms"] * 1e-3))
    assert set(got["host_ms"]) == {k for row in got["timing"].values() for k in row
                                   if k not in ("commit_ms", "partial_ms")} | {
        f"allreduce_d{d}_tokens{n}_ms" for d in (2, 4) for n in TOKENS}
    assert got["held"]  # no card to hold: every CPU reading counts as held
    assert results["gemm_splitk"]["launches"] == 0
    assert results["gemm_splitk"]["launches_by_mode"]["distribution4/tp_matmul (4 ranks)"] \
        == sum(rk["launches"]["gemm_splitk"] for rk in ranks)


def test_phase_fails_on_fewer_than_four_cards():
    """No card here: the phase raises before it starts a rank (it never
    skips)."""
    with pytest.raises(AssertionError, match="needs 4"):
        chip_smoke.phase_distribution4(torch, {}, {})


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """Rank 2 raises at once: the spawn ends the others (no wait for
    NCCL's or gloo's timeout) and the command exits non-zero."""
    proc = _spawn(tmp_path, fail_rank=2)
    assert proc.returncode != 0 and "RANKS-OK" not in proc.stdout
    assert "rank 2 fails on purpose" in proc.stderr
