"""End-to-end training on the PyTorch port: the reduced TinyLlama-family
model for 200 steps on the synthetic pipeline (the JAX example runs 300),
with checkpointing.  The port's copy of ``examples/train_tinyllama.py``; the
checkpoint goes to ``build/torch_tinyllama.npz`` in the checkout.

Runs on the GPU (every GEMM in the port's commit GEMM) unless ``--device
cpu`` is given (its plain version).

Run:  PYTHONPATH=src python examples/torch_train_tinyllama.py [--steps 200] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

from repro_torch.launch.train_launch import main as train_main

CKPT = Path(__file__).resolve().parents[1] / "build" / "torch_tinyllama.npz"

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, _ = ap.parse_known_args()
    CKPT.parent.mkdir(parents=True, exist_ok=True)
    sys.argv = [
        "train", "--arch", "tinyllama-1.1b", "--smoke", "--steps", str(args.steps),
        "--batch", "8", "--seq", "128", "--lr", "1e-3",
        "--microbatches", "2", "--ckpt", str(CKPT), "--log-every", "20",
    ] + (["--device", args.device] if args.device else [])
    train_main()
