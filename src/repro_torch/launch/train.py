"""End-to-end training CLI of the PyTorch port (the JAX package's
``launch/train.py``, with ``--device``): the synthetic Markov language
of ``data/pipeline.py``, AdamW with a cosine schedule, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --variant reduced --device cpu --steps 200 --batch 16 --seq 128

The device is CUDA unless ``--device cpu`` is given; without a CUDA
device the CLI exits with an error instead of running on the CPU. On
the card the step (``make_train_step``) is captured as one CUDA graph
at its second call and replayed after, as JAX's CLI jits it; on the CPU
it runs eagerly. It runs the flash-attention and RMSNorm kernels forward
and backward, and on an SSM or hybrid stack the SSD dual form and the
gated norm too (``--arch mamba2-780m --variant ""`` trains it at full
width; ``--arch qwen2-moe-a2.7b --variant reduced`` a MoE stack). It prints the JAX CLI's lines, writes its JSONL records
(``--metrics``) and, with ``--save``, a train state that
``training.checkpoints.load_train_state`` reads (and ``history.json``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.pipeline import MarkovLM, batches_for
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import build
from repro_torch.training.checkpoints import save_train_state
from repro_torch.training.metrics import MetricsLogger
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step, param_count)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--variant", default="reduced")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save", default="")
    ap.add_argument("--metrics", default="",
                    help="JSONL metrics path (machine-readable run log)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_arch(args.arch, variant=args.variant)
    model = build(cfg, device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    data = batches_for(cfg, args.batch, args.seq, seed=args.seed)

    state = init_train_state(model, opt, args.seed)
    n_params = param_count(state["params"])
    floor = MarkovLM(cfg.vocab).entropy_bound()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"devices=1 loss_floor~{floor:.3f}")

    mlog = MetricsLogger(args.metrics or None, run_name=cfg.name)
    step_fn = make_train_step(model, opt, microbatch=args.microbatch)
    t0 = time.perf_counter()
    history = []
    for i in range(args.steps):
        batch = next(data)
        state, metrics = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            wall = time.perf_counter() - t0
            tok_s = (i + 1) * args.batch * args.seq / wall
            print(f"step {i:5d} loss={m['loss']:.4f} "
                  f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"tok/s={tok_s:,.0f}")
            history.append({"step": i, **m, "wall_s": wall})
            mlog.log("train", step=i, tok_s=tok_s, **m)
    mlog.close()
    if args.save:
        save_train_state(args.save, args.steps, state["params"],
                         state["opt"])
        with open(Path(args.save) / "history.json", "w") as f:
            json.dump(history, f, indent=1)
        print(f"saved to {args.save}")
    return history


if __name__ == "__main__":
    main()
