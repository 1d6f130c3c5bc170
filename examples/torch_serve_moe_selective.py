"""Serve a MoE model (kimi-k2 family, reduced) with mixed det/nondet
traffic on the PyTorch port — the family where router flips make DVR
matter most.  The port's copy of ``examples/serve_moe_selective.py``.

Runs on the GPU (the port's hand-written kernels) unless ``--device cpu``
is given (their plain versions).

Run:  PYTHONPATH=src python examples/torch_serve_moe_selective.py [--device cpu]
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, _ = ap.parse_known_args()
    sys.argv = [
        "serve", "--arch", "kimi-k2-1t-a32b", "--smoke", "--requests", "8",
        "--det-ratio", "0.25", "--max-new", "24", "--mode", "llm42",
        "--window", "6", "--group", "2",
    ] + (["--device", args.device] if args.device else [])
    serve_main()
