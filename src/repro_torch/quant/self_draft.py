"""Weight-sharing self-draft for speculative decoding: the port's copy of
the JAX package's ``quant/self_draft.py``.

The edge-deployment story rules out shipping a second draft checkpoint
to the device; the draft is derived from the target's own parameters:

* **precision**: ``int8`` / ``int4`` quantize the draft's projections
  (``quant.quantize_params``), so each proposed token streams a fraction
  of the target's weight bytes; ``fp`` keeps the target's precision.
* **depth**: ``@k`` keeps the first ``k`` stacked blocks (views
  ``t[:k]`` of the target's block leaves) with the shared embedding,
  ``ln_f`` and head, a truncated-stack self-speculative draft.

Spec grammar (``cfg.draft`` / ``Engine(draft=...)`` / ``--draft``):
``"<prec>[@<blocks>]"`` with prec in {fp, int8, int4}, e.g. ``"int8"``
(full depth, quantized) or ``"int8@1"`` (the first block, quantized).
No float weight is copied: every float leaf of the draft is a target
leaf or a view of one.
"""
from __future__ import annotations

from typing import Optional, Tuple

_PRECISIONS = ("fp", "int8", "int4")


def parse_draft_spec(spec: str) -> Tuple[str, Optional[int]]:
    """"int8@1" -> ("int8", 1); "fp" -> ("fp", None = full depth)."""
    prec, _, blocks = spec.partition("@")
    if prec == "ngram":
        # the prompt-lookup drafter has no self-draft parameters; the
        # engine takes it before this parser (serving/ngram_draft.py)
        raise ValueError(
            "draft spec 'ngram' selects the prompt-lookup drafter, "
            "which has no self-draft parameters — pass it to "
            "Engine(draft='ngram') / --draft ngram, not to "
            "make_self_draft")
    if prec not in _PRECISIONS:
        raise ValueError(f"draft precision {prec!r} not in {_PRECISIONS} "
                         f"(spec {spec!r})")
    nb = None
    if blocks:
        nb = int(blocks)
        if nb < 1:
            raise ValueError(f"draft depth must be >= 1, got {spec!r}")
    return prec, nb


def make_self_draft(model, params, spec: str = ""):
    """(draft_model, draft_params) from the target model and params, on
    the target's device. ``spec`` defaults to ``model.cfg.draft``. An
    already-quantized target passes its QTensor leaves through
    ``quantize_params`` unchanged."""
    from repro_torch.models.model import build
    from repro_torch.models.transformer import block_spec, n_blocks
    from repro_torch.quant.params import quantize_params

    cfg = model.cfg
    spec = spec or cfg.draft
    if not spec:
        raise ValueError("empty draft spec (set cfg.draft or pass spec=)")
    prec, nb = parse_draft_spec(spec)
    nb_total = n_blocks(cfg)
    nb = nb_total if nb is None else min(nb, nb_total)

    if nb < nb_total:
        dcfg = cfg.replace(name=f"{cfg.name}-draft-{spec}",
                           n_layers=nb * len(block_spec(cfg)),
                           draft="", spec_gamma=0)
        dparams = dict(params)
        dparams["blocks"] = _map(params["blocks"], lambda t: t[:nb])
    else:
        dcfg = cfg.replace(draft="", spec_gamma=0)
        dparams = params
    dmodel = build(dcfg, model.device)
    if prec in ("int8", "int4"):
        dparams = quantize_params(dparams, bits=8 if prec == "int8" else 4,
                                  group_size=cfg.quant_group)
    return dmodel, dparams


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)
