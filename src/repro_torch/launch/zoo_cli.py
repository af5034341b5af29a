"""Zoo command line of the PyTorch port: the paper's "deploy with one line
of command", with the JAX package's subcommands and flags plus
``--device``.

  python -m repro_torch.launch.zoo_cli --zoo build/zoo init-demo
  python -m repro_torch.launch.zoo_cli --zoo build/zoo list
  python -m repro_torch.launch.zoo_cli --zoo build/zoo pull --name <svc>
  python -m repro_torch.launch.zoo_cli --zoo build/zoo compose \\
        --stages classify_pixtral-12b,label_decoder --name my_pipeline
  python -m repro_torch.launch.zoo_cli --zoo build/zoo deploy \\
        --name my_pipeline [--placement local|remote|split:K] [--batch 4]

``--peer DIR`` / ``--repo DIR`` register transports (peers are tried
first, like the paper's edge-first pull). Weights are made and pulled on
``--device``: CUDA unless ``--device cpu`` is given; without a CUDA
device the CLI exits with an error instead of running on the CPU. A zoo
written by the JAX package's CLI is read by this one, and the other way
round.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

#: the checkout's git-ignored ``build/zoo``, beside the built kernels
DEFAULT_ZOO = Path(__file__).resolve().parents[3] / "build" / "zoo"


def _registry(args):
    from repro_torch.core.transport import (PeerTransport, RepoTransport,
                                            SyncedRegistry)
    from repro_torch.kernels.dispatch import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    transports = []
    for peer in args.peer or []:
        transports.append(PeerTransport(peer))
    for repo in args.repo or []:
        transports.append(RepoTransport(repo))
    return SyncedRegistry(Path(args.zoo), transports, device=device)


def cmd_init_demo(args):
    """Populate the zoo with the deployment-example services."""
    import repro_torch.core.zoo_builders as zb
    reg = _registry(args)
    clf = zb.classifier_service("pixtral-12b", n_classes=args.n_classes)
    clf = clf.with_params(clf.metadata["init_params"](args.seed,
                                                      reg.device))
    dec = zb.label_decoder(args.n_classes)
    reg.publish(clf, builder="model.classifier",
                config={"arch": "pixtral-12b",
                        "n_classes": args.n_classes}, overwrite=True)
    reg.publish(dec, builder="adapter.label_decoder",
                config={"n_classes": args.n_classes}, overwrite=True)
    print(f"published {clf.name}@{clf.version}, {dec.name}@{dec.version} "
          f"-> {args.zoo}")


def cmd_list(args):
    reg = _registry(args)
    rows = reg.local.list()
    for t in reg.transports:
        rows += [(n, v, f"[{t.kind}]") for n, v in t.list_remote()]
    for name, version, desc in rows:
        print(f"{name:45s} {version:8s} {desc}")


def cmd_pull(args):
    import repro_torch.core.zoo_builders  # noqa: F401  (registers builders)
    reg = _registry(args)
    svc, report = reg.pull(args.name, args.version or None)
    print(f"pulled {svc.name}@{svc.version} "
          f"({svc.n_params/1e6:.1f}M params)")
    if report and not report.cached:
        print(f"  via {report.source}: {report.nbytes/2**20:.1f} MiB, "
              f"modelled transfer {report.seconds:.2f}s")


def cmd_compose(args):
    import repro_torch.core.zoo_builders  # noqa: F401
    from repro_torch.core.compose import seq
    reg = _registry(args)
    stages = [reg.pull(s)[0] for s in args.stages.split(",")]
    svc = seq(*stages, name=args.name)
    reg.local.publish_composed(svc, stages, overwrite=True)
    print(f"composed {args.name} = {' >> '.join(s.name for s in stages)}; "
          f"signature checked and published")


def cmd_deploy(args):
    import repro_torch.core.zoo_builders  # noqa: F401
    from repro_torch.core.deploy import DeploymentPlan, deploy
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.core.service import torch_dtype
    reg = _registry(args)
    svc, _ = reg.pull(args.name)
    # reconstruct stages for placement (composed services carry refs)
    man = json.loads((Path(args.zoo) / svc.name / svc.version
                      / "manifest.json").read_text())
    stages = [reg.pull(r["name"], r.get("version"))[0]
              for r in man.get("stages", [])] or None

    if args.placement == "local":
        plan = DeploymentPlan.all_local(svc)
    elif args.placement == "remote":
        plan = DeploymentPlan.all_remote(svc)
    elif args.placement.startswith("split:"):
        plan = DeploymentPlan.split(svc, int(args.placement.split(":")[1]))
    else:
        raise SystemExit(f"unknown placement {args.placement}")
    deployed = deploy(svc, plan, stages=stages)

    # drive it with a demo batch derived from the input signature
    spec = tree_leaves(svc.signature.inputs)[0]
    shape = tuple(args.batch if d == -1 else d for d in spec.shape)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape) if "float" in spec.dtype else \
        rng.integers(0, 100, shape)
    x = torch.from_numpy(x).to(reg.device, torch_dtype(spec.dtype))
    inputs = tree_map(lambda s: x, svc.signature.inputs)
    out, tel = deployed.call(inputs)
    print(f"deployed {svc.name} [{args.placement}]")
    for s in tel.stages:
        print(f"  {s.stage:45s} @{s.endpoint:6s} "
              f"compute={s.compute_s*1e3:8.2f}ms "
              f"network={s.transfer_s*1e3:8.2f}ms")
    print(f"  total {tel.total_s*1e3:.2f}ms; outputs: "
          f"{tree_map(lambda y: tuple(y.shape), out)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zoo")
    ap.add_argument("--zoo", default=str(DEFAULT_ZOO),
                    help=f"zoo directory (default {DEFAULT_ZOO})")
    ap.add_argument("--peer", action="append", default=[])
    ap.add_argument("--repo", action="append", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("init-demo")
    p.add_argument("--n-classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    sub.add_parser("list")
    p = sub.add_parser("pull")
    p.add_argument("--name", required=True)
    p.add_argument("--version", default="")
    p = sub.add_parser("compose")
    p.add_argument("--stages", required=True)
    p.add_argument("--name", required=True)
    p = sub.add_parser("deploy")
    p.add_argument("--name", required=True)
    p.add_argument("--placement", default="local")
    p.add_argument("--batch", type=int, default=4)

    args = ap.parse_args(argv)
    return {"init-demo": cmd_init_demo, "list": cmd_list, "pull": cmd_pull,
            "compose": cmd_compose, "deploy": cmd_deploy}[args.cmd](args)


if __name__ == "__main__":
    main()
