"""The training step as one program per batch shape
(``training.train.make_train_program``) on the CPU, at the smoke
tinyllama with one torch thread.

* Three program steps are bitwise three of ``make_train_step``'s eager
  steps (parameters, optimizer state with its step, metrics), with one and
  with two microbatches; the caller's trees are only read.
* One program per batch shape: three steps of one shape make one program
  (run once a step, no capture on the CPU), a batch of another shape gets
  its own, and its step is the eager step from the same state.
* A checkpoint saved from the program's trees and restored into a new
  program's (``checkpoint.restore_into``, or ``restore`` then ``load``)
  continues the uninterrupted run bitwise.
* The training driver prints the same losses on the program as under
  ``programs.eager()``.
* ``serving.programs``' pool bookkeeping: a pool is given up with its last
  graph, and a graph released during a capture is released after it.
* The module imports with ``jax`` unimportable.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train_launch
from repro_torch.models.base import init_params
from repro_torch.serving import programs
from repro_torch.training import checkpoint
from repro_torch.training.data import SyntheticTextStream
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
from repro_torch.training.train import make_train_program, make_train_step, train_params

ROOT = Path(__file__).resolve().parents[1]
CFG = get_smoke_config("tinyllama-1.1b")
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
STEPS = 3
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seq, n, seed=0):
    stream = iter(SyntheticTextStream(CFG.vocab_size, seq, B, seed=seed))
    return [train_launch.batch_on(CFG, next(stream), i, torch.device("cpu"))
            for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    """(params, a clone of them, the batches) at the smoke tinyllama."""
    params = train_params(CFG, init_params(CFG, torch.Generator().manual_seed(0), "cpu"))
    return params, [t.clone() for t in tree_leaves(params)], _batches(S, STEPS)


def _state(params, opt_state):
    return tree_leaves(params) + [opt_state.step] + tree_leaves(opt_state.mu) + tree_leaves(
        opt_state.nu)


@pytest.fixture(scope="module")
def runs(setup):
    """Per microbatch count: the eager steps' (state, metrics) and the
    program after the same steps with its metrics."""
    params, _, batches = setup
    out = {}
    for n in (1, 2):
        step = make_train_step(CFG, OPT, num_microbatches=n)
        p, o, hist = params, init_opt_state(params), []
        for b in batches:
            p, o, m = step(p, o, b)
            hist.append(m)
        prog = make_train_program(CFG, OPT, num_microbatches=n, device="cpu")
        prog.load(params)
        out[n] = (_state(p, o), hist, prog, [prog.step(b) for b in batches])
    return out


@pytest.mark.parametrize("n", [1, 2], ids=["one_microbatch", "two_microbatches"])
def test_program_steps_bitwise_eager(runs, n):
    state, hist, prog, got = runs[n]
    assert int(prog.opt_state.step) == STEPS
    held = _state(prog.params, prog.opt_state)
    assert len(held) == len(state)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(held, state))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got, hist) for k in b)
    assert got[0].keys() == hist[0].keys()


def test_callers_trees_untouched(setup, runs):
    params, before, _ = setup
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    _, _, prog, _ = runs[1]
    ptrs = {t.data_ptr() for t in tree_leaves(params)}
    assert not ptrs & {t.data_ptr() for t in tree_leaves(prog.params)}


def test_one_program_per_batch_shape(setup, runs):
    _, _, prog, _ = runs[1]
    assert list(prog.programs) == [("train", B, S, None)]
    (p,) = prog.programs.values()
    assert p.runs == STEPS and p.captures == 0 and p.replays == 0
    params, _, batches = setup
    prog = make_train_program(CFG, OPT, device="cpu")
    prog.load(params)
    prog.step(batches[0])
    (short,) = _batches(16, 1, seed=5)
    ptrs = [t.data_ptr() for t in tree_leaves(prog.params)]
    want = make_train_step(CFG, OPT)(
        _clone_tree(prog.params), _clone_opt(prog.opt_state), short)
    m = prog.step(short)
    assert set(prog.programs) == {("train", B, S, None), ("train", B, 16, None)}
    assert prog.programs[("train", B, 16, None)].runs == 1
    assert all(torch.equal(a, b) for a, b in zip(_state(prog.params, prog.opt_state),
                                                 _state(want[0], want[1])))
    assert all(torch.equal(m[k], want[2][k]) for k in m)
    # the held trees kept their addresses
    assert [t.data_ptr() for t in tree_leaves(prog.params)] == ptrs


def _clone_tree(tree):
    return {k: _clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.clone()


def _clone_opt(o):
    return type(o)(o.step.clone(), _clone_tree(o.mu), _clone_tree(o.nu))


def test_checkpoint_resume_continues_bitwise(setup, runs, tmp_path):
    params, _, batches = setup
    state, hist, _, _ = runs[1]
    first = make_train_program(CFG, OPT, device="cpu")
    first.load(params)
    first.step(batches[0])
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, first.params, first.opt_state, step=1)
    resumed = make_train_program(CFG, OPT, device="cpu")
    resumed.load(params)
    ptrs = [t.data_ptr() for t in tree_leaves(resumed.params)]
    assert checkpoint.restore_into(path, resumed.params, resumed.opt_state) == 1
    assert [t.data_ptr() for t in tree_leaves(resumed.params)] == ptrs
    # the archive's trees, loaded by copying, are the same state
    p1, o1, step = checkpoint.restore(path, params, init_opt_state(params))
    loaded = make_train_program(CFG, OPT, device="cpu")
    loaded.load(p1, o1)
    assert step == 1 and all(torch.equal(a, b) for a, b in zip(
        _state(loaded.params, loaded.opt_state), _state(resumed.params, resumed.opt_state)))
    got = [resumed.step(b) for b in batches[1:]]
    assert all(torch.equal(a, b) for a, b in zip(_state(resumed.params, resumed.opt_state),
                                                 state))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got, hist[1:]) for k in b)


def test_train_cli_on_the_program_equals_eager(capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "3",
            "--log-every", "1"]

    def losses():
        out = capsys.readouterr().out
        return [line.split("tok/s")[0].rsplit(None, 1)[0] for line in out.splitlines()
                if line.startswith("step")]

    train_launch.main(argv)
    on_program = losses()
    with programs.eager():
        train_launch.main(argv)
    assert len(on_program) == 3 and on_program == losses()


class _Graph:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_pool_given_up_with_its_last_graph(monkeypatch):
    returned = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: returned.append(1))
    pool = programs.Pool()
    pool.handle, pool.graphs = ("handle",), 2
    graphs, outs = [_Graph(), _Graph()], [[torch.ones(2)], [torch.ones(2)]]
    programs._release(pool, graphs[0], outs[0])
    assert graphs[0].resets == 1 and outs[0] == [] and pool.handle == ("handle",)
    assert returned == []
    monkeypatch.setattr(programs, "_capturing", 1)
    programs._release(pool, graphs[1], outs[1])  # inside a capture: deferred
    assert graphs[1].resets == 0 and outs[1] and pool.graphs == 1
    monkeypatch.setattr(programs, "_capturing", 0)
    while programs._deferred:
        programs._release(*programs._deferred.pop())
    assert graphs[1].resets == 1 and outs[1] == [] and pool.graphs == 0
    assert pool.handle is None and returned == [1]


def test_module_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.training import train\n"
            "from repro_torch.launch import train_launch\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
