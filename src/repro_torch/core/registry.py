"""The *zoo*: a content-addressed service repository (the port's copy of
the JAX package's ``core/registry.py``, on the same on-disk layout, so a
zoo written by one package is pulled by the other).

The paper pulls models from GitHub Gist and caches them locally; here the
repository is a directory tree (the transport is pluggable: a remote
repo is just another root), with:

  <root>/<name>/<version>/manifest.json      service metadata + signature
  <root>/<name>/<version>/params.npz/.json   weights (content-hashed)

Services are rebuilt on pull through registered **builders** (entry-point
strings -> constructor). Composed services store *references* to their
stages (recursively pulled and re-composed), so published compositions
deduplicate weights, and pulling re-runs compatibility checking, the
paper's "compatibility checking" feature.

Pulled weights land on the registry's device: CUDA unless the caller
names another (``kernels.dispatch.resolve_device``, resolved when a
pull loads weights, so listing or publishing needs no card).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.compat import CompositionError
from repro_torch.core.pytree import tree_map
from repro_torch.core.service import Service, Signature, TensorSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.training.checkpoints import (load_pytree, save_pytree,
                                              tree_hash)

BUILDERS: Dict[str, Callable[..., Service]] = {}


def register_builder(kind: str):
    def deco(fn):
        BUILDERS[kind] = fn
        return fn
    return deco


def _sig_to_json(sig: Signature):
    def enc(tree):
        return tree_map(lambda t: t.to_json(), tree)
    return {"inputs": enc(sig.inputs), "outputs": enc(sig.outputs)}


def _sig_from_json(d):
    def dec(tree):
        if isinstance(tree, dict) and set(tree) == {"shape", "dtype"}:
            return TensorSpec.from_json(tree)
        if isinstance(tree, dict):
            return {k: dec(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [dec(v) for v in tree]
        return tree
    return Signature(dec(d["inputs"]), dec(d["outputs"]))


def _sigs_equal(a: Signature, b: Signature) -> bool:
    return _sig_to_json(a) == _sig_to_json(b)


class Registry:
    def __init__(self, root, device=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = device        # where pulled weights land

    # ------------------------------------------------------------ #
    def _dir(self, name: str, version: str) -> Path:
        return self.root / name / version

    def list(self) -> List[Tuple[str, str, str]]:
        out = []
        for manifest in sorted(self.root.glob("*/*/manifest.json")):
            with open(manifest) as f:
                m = json.load(f)
            out.append((m["name"], m["version"], m.get("description", "")))
        return out

    def versions(self, name: str) -> List[str]:
        return sorted(p.name for p in (self.root / name).glob("*")
                      if (p / "manifest.json").exists())

    # ------------------------------------------------------------ #
    def publish(self, service: Service, *, builder: str,
                config: Optional[dict] = None,
                stage_refs: Optional[List[dict]] = None,
                overwrite: bool = False) -> dict:
        """Publish a service. Leaf services need ``builder`` + ``config``
        (how to rebuild ``fn``); composed services pass
        ``builder='composed.<combinator>'`` and stage_refs."""
        d = self._dir(service.name, service.version)
        if d.exists():
            if not overwrite:
                raise FileExistsError(f"{service.name}@{service.version} "
                                      f"already published")
            shutil.rmtree(d)
        d.mkdir(parents=True)
        manifest = {
            "name": service.name,
            "version": service.version,
            "description": service.description,
            "builder": builder,
            "config": config or {},
            "signature": _sig_to_json(service.signature),
            "metadata": {k: v for k, v in service.metadata.items()
                         if isinstance(v, (str, int, float, list, dict))},
        }
        if stage_refs is not None:
            manifest["stages"] = stage_refs
            manifest["params_hash"] = None   # weights live with the stages
        elif service.params is not None:
            manifest["params_hash"] = save_pytree(d / "params",
                                                  service.params)
        else:
            manifest["params_hash"] = None
        with open(d / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
        return manifest

    # ------------------------------------------------------------ #
    def pull(self, name: str, version: Optional[str] = None,
             *, verify: bool = True) -> Service:
        version = version or self.versions(name)[-1]
        d = self._dir(name, version)
        with open(d / "manifest.json") as f:
            m = json.load(f)

        if m["builder"].startswith("composed."):
            from repro_torch.core import compose
            kind = m["builder"].split(".", 1)[1]
            stages = [self.pull(r["name"], r.get("version"), verify=verify)
                      for r in m["stages"]]
            if kind == "seq":
                svc = compose.seq(*stages, name=m["name"])
            elif kind == "ensemble":
                svc = compose.ensemble(
                    stages, combine=m["config"].get("combine", "mean"),
                    name=m["name"])
            else:
                raise KeyError(f"unknown composed builder {kind}")
        else:
            if m["builder"] not in BUILDERS:
                raise KeyError(f"no builder registered for {m['builder']!r};"
                               f" import the module that defines it")
            svc = BUILDERS[m["builder"]](**m["config"])
            if m["params_hash"] is not None:
                params = load_pytree(d / "params", verify=verify,
                                     device=resolve_device(self.device))
                if verify and tree_hash(params) != m["params_hash"]:
                    raise IOError(f"{name}@{version}: params hash mismatch")
                svc = svc.with_params(params)

        # compatibility check: rebuilt signature must match the manifest
        if verify and not _sigs_equal(svc.signature,
                                      _sig_from_json(m["signature"])):
            raise CompositionError(
                f"{name}@{version}: rebuilt signature differs from "
                f"published signature — builder/config drift")
        return dataclasses.replace(svc, name=m["name"], version=m["version"],
                                   description=m.get("description", ""))

    # ------------------------------------------------------------ #
    def publish_composed(self, service: Service, stages: List[Service],
                         *, overwrite: bool = False) -> dict:
        """Publish a composition by reference; every stage must already
        be published (weights are stored with the stages, so they are
        deduplicated across compositions)."""
        comb = service.metadata.get("combinator")
        if comb not in ("seq", "ensemble"):
            raise ValueError(f"cannot publish combinator {comb!r} by ref")
        refs = []
        for s in stages:
            if s.version not in self.versions(s.name):
                raise FileNotFoundError(
                    f"stage {s.name}@{s.version} not published; publish it "
                    f"first (weights are stored with stages)")
            refs.append({"name": s.name, "version": s.version})
        cfg = {"combine": service.metadata.get("combine", "mean")} \
            if comb == "ensemble" else {}
        return self.publish(service, builder=f"composed.{comb}",
                            config=cfg, stage_refs=refs,
                            overwrite=overwrite)
