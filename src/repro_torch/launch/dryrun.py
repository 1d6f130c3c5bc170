"""Production-shape dry run on the meta device.

PyTorch counterpart of ``repro.launch.dryrun``.  For every (architecture x
input shape) of ``launch.specs`` on the production meshes, 16x16 = 256
ranks single-pod and (2, 16, 16) = 512 multi-pod (``launch.mesh``,
descriptions only), it runs the case's step once on meta tensors inside
``torch.utils.flop_counter.FlopCounterMode``: nothing is allocated and no
device is touched.  The run proves that the port's step composes at the
shape and that every kernel call passes the card path's operand checks
(the wrappers' meta branches); a failure is reported with the case.  Only
the plans differ between the meshes, so one run serves both.

Each record (one JSON per case and mesh, the reference's file names) holds
``status`` (``ok``, ``skipped`` with the reason, ``fail`` with the error and
the traceback's tail), ``flops`` (what the run executed) and per-rank
``argument_bytes`` and ``output_bytes``: each leaf's bytes at
``sharding.local_shape`` under its plan, summed.  ``temp_bytes``,
``generated_code_bytes`` and ``collective_bytes`` are null: the port has
no SPMD compiler, so there is no partitioned program to read them from.

Two cuts keep ``--all`` near a quarter of an hour on a CPU, where a meta
elementwise op costs about 0.3 ms (PyTorch's Python meta kernels):

* the recurrent families (rwkv6, jamba) run at most ``--max-positions``
  positions of a prefill or training sequence (their per-position Python
  loop is 10-20 meta ops a position a layer); the record keeps ``seq`` and
  the ``seq_run`` that ran;
* a training step runs ``MAX_MICROBATCHES`` of its microbatches, each at
  its full (16, seq) shape; the record keeps ``microbatches`` and
  ``microbatches_run``.

FLOPs are those of the run, never extrapolated; the argument and output
bytes are the full case's.

  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k --mesh both
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Sequence

import torch

from repro_torch import configs as config_registry
from repro_torch.distributed.sharding import local_shape
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh

#: default cuts (see the module docstring)
MAX_POSITIONS = 128
MAX_MICROBATCHES = 1

MESHES = {False: "pod_16x16", True: "multipod_2x16x16"}
NOT_MEASURED = ("the port has no SPMD compiler: there is no partitioned "
                "program to read it from")


def tree_bytes(tree: Any, plans: Any, mesh: Any) -> int:
    """Per-rank bytes of a tree of tensors under its plan tree (a plan is a
    tuple, so the walk follows the tensors)."""
    if isinstance(tree, torch.Tensor):
        return math.prod(local_shape(tree.shape, plans, mesh)) * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(tree[k], plans[k], mesh) for k in tree)
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(t, p, mesh) for t, p in zip(tree, plans))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _cut(case: specs.Case, max_positions: int):
    """The step and arguments the run uses, and what it records: a
    recurrent family's sequence cut to ``max_positions``, a training step
    cut to ``MAX_MICROBATCHES`` microbatches of its own shape."""
    meta = specs.INPUT_SHAPES[case.shape]
    fn, args, info = case.fn, case.args, {}
    recurrent = case.cfg.family in ("ssm", "hybrid")
    if meta["kind"] == "train":
        params, opt, batch = args
        B, S = batch["tokens"].shape
        n = specs.train_microbatches(B)
        n_run = min(n, MAX_MICROBATCHES)
        s_run = min(S, max_positions) if recurrent else S
        rows = B // n * n_run
        batch = {k: (v[:rows, :s_run] if k != "enc_embeds" else v[:rows])
                 for k, v in batch.items()}
        fn, args = specs.train_step(case.cfg, n_run), (params, opt, batch)
        info = {"seq": S, "seq_run": s_run, "microbatches": n,
                "microbatches_run": n_run}
    elif meta["kind"] == "prefill" and recurrent:
        S = args[2].shape[1]
        s_run = min(S, max_positions)
        args = args[:2] + (args[2][:, :s_run],) + args[3:]
        info = {"seq": S, "seq_run": s_run}
    return fn, args, info


def execute(case: specs.Case, max_positions: int = MAX_POSITIONS) -> Dict[str, Any]:
    """Run a case once on the meta device under ``FlopCounterMode``:
    ``{"status", "run_s", "flops", "outputs", ...cut info}`` or ``{"status":
    "fail", "error", "traceback"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    try:
        fn, args, info = _cut(case, max_positions)
        with FlopCounterMode(display=False) as counter:
            outputs = fn(*args)
        return {"status": "ok", "run_s": time.perf_counter() - t0,
                "flops": int(counter.get_total_flops()), "outputs": outputs, **info}
    except Exception as e:  # a failure here is a composition or operand bug
        return {"status": "fail", "run_s": time.perf_counter() - t0,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _write(rec: Dict[str, Any], out_dir: str | None) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def run_case(arch: str, shape: str, multi_pods: Sequence[bool] = (False,),
             out_dir: str | None = None, *,
             max_positions: int = MAX_POSITIONS) -> List[Dict[str, Any]]:
    """One record per mesh of ``multi_pods`` for (arch, shape), from one run."""
    recs: List[Dict[str, Any]] = []
    run = None
    for mp in multi_pods:
        mesh = make_production_mesh(multi_pod=mp)
        rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": MESHES[mp],
                               "chips": mesh.size}
        try:
            case = specs.build_case(arch, shape, mesh)
        except Exception as e:
            case = None
            rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        if case is not None and case.skipped:
            rec.update(status="skipped", reason=case.skipped)
        elif case is not None:
            if run is None:
                run = execute(case, max_positions)
            rec.update({k: v for k, v in run.items() if k != "outputs"})
            if run["status"] == "ok":
                try:
                    rec["memory"] = {
                        "argument_bytes": tree_bytes(case.args, case.in_plans, mesh),
                        "output_bytes": tree_bytes(run["outputs"], case.out_plans, mesh),
                        "temp_bytes": None, "generated_code_bytes": None,
                    }
                    rec["collective_bytes"] = None
                    rec["not_measured"] = {k: NOT_MEASURED for k in (
                        "temp_bytes", "generated_code_bytes", "collective_bytes")}
                except Exception as e:  # a plan that does not fit its tensor
                    rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                               traceback=traceback.format_exc()[-2000:])
        _write(rec, out_dir)
        recs.append(rec)
    return recs


def _dashed(name: str) -> str:
    inv = {v: k for k, v in config_registry.DASHED.items()}
    return inv.get(name, name)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, choices=list(specs.INPUT_SHAPES) + ["all"])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--max-positions", type=int, default=MAX_POSITIONS,
                    help="positions a recurrent family's prefill or training run takes")
    args = ap.parse_args(argv)

    archs = ([_dashed(a) for a in config_registry.list_archs()]
             if (args.all or args.arch in (None, "all")) else [args.arch])
    shapes = ([k for k, v in specs.INPUT_SHAPES.items() if not v.get("extra")]
              if (args.all or args.shape in (None, "all")) else [args.shape])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    counts = {"ok": 0, "skipped": 0, "fail": 0}
    times = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for rec in run_case(arch, shape, meshes, args.out,
                                max_positions=args.max_positions):
                status = rec["status"]
                counts[status] += 1
                extra = ""
                if status == "ok":
                    gib = rec["memory"]["argument_bytes"] / 2 ** 30
                    extra = (f"run={rec['run_s']:.1f}s flops={rec['flops']:.3g} "
                             f"args/rank={gib:.3g}GiB")
                    if rec.get("seq_run", rec.get("seq")) != rec.get("seq"):
                        extra += f" seq_run={rec['seq_run']}"
                    if rec.get("microbatches_run") != rec.get("microbatches"):
                        extra += (f" microbatches_run={rec['microbatches_run']}"
                                  f"/{rec['microbatches']}")
                elif status == "fail":
                    extra = rec["error"][:160]
                print(f"[{status:7s}] {arch:26s} {shape:12s} "
                      f"{rec['mesh']:16s} {extra}", flush=True)
            if rec["status"] != "skipped":
                times.append((rec.get("run_s", 0.0), arch, shape))
    print(f"\nok={counts['ok']} skipped={counts['skipped']} fail={counts['fail']} "
          f"in {time.perf_counter() - t0:.1f}s")
    for s, arch, shape in sorted(times, reverse=True)[:5]:
        print(f"slowest: {arch} {shape} {s:.1f}s")
    if counts["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
