"""End-to-end training driver for the PyTorch port.

The counterpart of ``repro.launch.train_launch``, with the same flags plus
``--device`` and ``--smoke``, as the port's serve driver has them.  It
trains the full config (published widths, random weights from ``--seed``)
on ``cuda`` unless ``--smoke`` picks the reduced config, AdamW (peak
``--lr``: 1e-3 under ``--smoke``, 3e-4 for the full config) with a
linear warmup over a tenth of ``--steps`` and cosine decay, on
``training.data.SyntheticTextStream`` batches; it prints the step, loss,
gradient norm, learning rate and tokens/s every ``--log-every`` steps (and
at the first).  Every forward and backward GEMM runs in the commit GEMM on
the card (``kernels.ops.GemmGrad``), and the whole step under
``core.determinism.deterministic_torch``, so a step is repeatable bit for
bit.  An encoder-decoder config's batches carry stub audio frames
(``models.multimodal.audio_frames``, seeded by the step).

It trains through ``training.train.make_train_program``, as the
reference's driver trains through ``jax.jit(make_train_step(...))``: one
captured program per batch shape on the card, over parameters and
optimizer state the program holds (under ``serving.programs.eager()`` the
step runs directly, with the same bits).

``--resume`` restores params, optimizer state and step from an archive
that either package wrote into the program's trees
(``training.checkpoint.restore_into``) and skips the batches those steps
consumed, so a resumed run continues the uninterrupted one (the
reference's driver restarts its stream instead); ``--ckpt`` saves the
program's trees at the end.

  python -m repro_torch.launch.train_launch --smoke --device cpu --steps 5
  python -m repro_torch.launch.train_launch --steps 20 --batch 4 --seq 512   # on a GPU
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.models.base import init_params
from repro_torch.models.multimodal import audio_frames
from repro_torch.training.checkpoint import restore_into, save
from repro_torch.training.data import SyntheticTextStream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import make_train_program, train_params


def batch_on(cfg, b, step: int, device: torch.device) -> dict:
    """A ``TrainBatch`` as the train step's tensors on ``device``; an
    encoder-decoder config adds stub audio frames seeded by ``step``."""
    batch = {
        "tokens": torch.from_numpy(b.tokens).to(device),
        "targets": torch.from_numpy(b.targets).to(device),
        "loss_mask": torch.from_numpy(b.loss_mask).to(device),
    }
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(step)
        batch["enc_embeds"] = audio_frames(gen, b.tokens.shape[0], cfg.encoder_seq_len,
                                           cfg.d_model, getattr(torch, cfg.dtype), device)
    return batch


#: ``--lr`` defaults: ``repro.launch.train_launch``'s rate for the reduced
#: config it always trains, and a lower one for the full config, whose loss
#: that rate drove up (tinyllama-1.1b at 1e-3 read 15.18 at step 4 on an H100)
SMOKE_LR = 1e-3
FULL_LR = 3e-4


def parse_args(argv=None) -> argparse.Namespace:
    """The command-line flags; ``--lr`` left unset resolves to ``SMOKE_LR``
    under ``--smoke`` and to ``FULL_LR`` otherwise."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions of the kernels)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help=f"peak learning rate; default {SMOKE_LR:g} under --smoke "
                         f"(the JAX package's, which trains the reduced "
                         f"config) and {FULL_LR:g} for the full config (at "
                         f"{SMOKE_LR:g} the full tinyllama's loss diverged "
                         f"within 4 steps)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.lr is None:
        args.lr = SMOKE_LR if args.smoke else FULL_LR
    return args


def main(argv=None) -> None:
    args = parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    cfg = (config_registry.get_smoke_config(args.arch) if args.smoke
           else config_registry.get_config(args.arch))
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {device}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    prog = make_train_program(cfg, opt_cfg, num_microbatches=args.microbatches,
                              device=device)
    prog.load(train_params(cfg, init_params(cfg, gen, device)))
    start_step = 0
    if args.resume:
        start_step = restore_into(args.resume, prog.params, prog.opt_state)
        print(f"resumed from {args.resume} at step {start_step}")

    stream = iter(SyntheticTextStream(cfg.vocab_size, args.seq, args.batch))
    for _ in range(start_step):
        next(stream)

    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        m = prog.step(batch_on(cfg, next(stream), i, device))
        if (i + 1) % args.log_every == 0 or i == start_step:
            loss = float(m["loss"])  # waits for the step
            tps = (i + 1 - start_step) * args.batch * args.seq / (
                time.perf_counter() - t0)
            print(f"step {i + 1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  lr {float(m['lr']):.2e}  "
                  f"{tps:.0f} tok/s")
    if args.ckpt:
        save(args.ckpt, prog.params, prog.opt_state, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
