"""End-to-end training example on the PyTorch port: train a reduced
model (llama3.2 unless ``--arch`` names another) on the synthetic Markov
language until its loss approaches the entropy floor, then publish the
trained backbone to the port's zoo as a service.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
      [--arch mamba2-780m] [--device cpu]

The device is CUDA unless ``--device cpu`` is given (on the card the
step is captured as one CUDA graph and replayed, and runs the
flash-attention and RMSNorm kernels forward and backward, and on an SSM
stack the SSD and gated-norm ones; on the CPU it runs eagerly).
"""
import argparse
import tempfile

from repro_torch.configs import get_arch
from repro_torch.core.registry import Registry
from repro_torch.core.zoo_builders import lm_service
from repro_torch.data.pipeline import MarkovLM, batches_for
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import build
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import train

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="llama3.2-1b")
ap.add_argument("--variant", default="reduced")
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_arch(args.arch, variant=args.variant)
model = build(cfg, resolve_device(args.device))
opt = AdamW(lr=cosine_schedule(3e-3, 20, args.steps))
data = batches_for(cfg, args.batch, args.seq)
floor = MarkovLM(cfg.vocab).entropy_bound()
print(f"training {cfg.name} on {model.device}; conditional-entropy floor "
      f"≈ {floor:.3f} nats")

state, hist = train(model, opt, data, steps=args.steps, log_every=25,
                    callback=lambda m: print(
                        f"  step {m['step']:4d} loss={m['loss']:.4f}"))
final = hist[-1]["loss"]
print(f"final loss {final:.3f} (floor {floor:.3f}, "
      f"gap {final - floor:.3f})")

# publish the trained model as a zoo service
svc = lm_service(args.arch, variant=args.variant).with_params(
    state["params"])
with tempfile.TemporaryDirectory() as zoo:
    reg = Registry(zoo)
    manifest = reg.publish(svc, builder="model.lm",
                           config={"arch": args.arch,
                                   "variant": args.variant})
    print(f"published {manifest['name']}@{manifest['version']} "
          f"params_hash={manifest['params_hash'][:12]}…")
