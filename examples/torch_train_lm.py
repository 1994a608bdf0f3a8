"""End-to-end driver on the PyTorch/CUDA port: train an LM for a few
hundred steps with checkpointing, then generate.

The counterpart of ``train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 120] [--arch mamba2-130m] [--full] [--device cpu]

Any configuration works via --arch: its smoke geometry widened to
d_model 256, four periods and a vocabulary of 8192 in float32 unless
--full, which trains the published configuration (mamba2-130m's ~130M
parameters fit one card).  ``main`` returns what it printed: the
configuration, the losses and the generated tokens.
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch import cluster
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.serve import generate


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="mamba2-130m")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--full", action="store_true",
                   help="use the full published config")
    p.add_argument("--device", default=None,
                   help="cuda (the default: raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = cluster.resolve_device(args.device)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
        # ~100M-class geometry for the end-to-end demo
        cfg = dataclasses.replace(cfg, d_model=256, n_layers=cfg.period * 4,
                                  vocab_size=8192,
                                  param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses = train(cfg, steps=args.steps, batch=args.batch,
                       seq=args.seq, ckpt_dir=ckpt_dir, ckpt_every=50,
                       lr=1e-3, device=dev)
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'LEARNING' if last < first - 0.1 else 'check config'})")

    # As the reference does, generate from freshly initialised weights
    # (seed 0), not from the trained ones: the demo shows the serving
    # path, not what the short run learned.
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    toks = generate(params, cfg, prompts, max_new_tokens=8, device=dev)
    print("generated token ids:", toks.tolist())
    return {"cfg": cfg, "losses": losses, "tokens": toks}


if __name__ == "__main__":
    main()
