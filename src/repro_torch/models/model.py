"""Model facade: ``build(cfg, device)`` returns a ``Model`` with the
methods the serving engine and the tests call, for the decoder families
the port can build (dense so far)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as T


def lm_loss(logits, targets, mask=None):
    """Mean next-token cross entropy. logits: (B, L, V) f32."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    """Facade contract (what the serving engine relies on):

    * ``make_cache(batch, cache_len)`` leaves are ``[blocks, batch, ...]``
      with a per-row ``step``, so slots at different depths share one
      batched cache.
    * ``decode_step(params, token, cache)`` advances every row by one
      token; ``extend_into_cache(params, tokens, cache, lengths,
      last_only)`` advances row b by ``lengths[b]`` tokens (0 = row
      untouched). Both update ``cache`` in place and return it.
    """

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> Dict[str, Any]:
        return T.init_transformer(self.cfg, seed, self.device)

    def train_loss(self, params, batch):
        tokens = batch["tokens"]
        logits, aux = T.forward_train(params, self.cfg, tokens)
        loss = lm_loss(logits[:, :-1], tokens[:, 1:]) + aux
        return loss, {"lm_loss": loss - aux, "aux_loss": aux}

    def prefill(self, params, batch, cache):
        return T.prefill(params, self.cfg, batch["tokens"], cache,
                         length=batch.get("length"))

    def decode_step(self, params, token, cache):
        return T.decode_step(params, self.cfg, token, cache)

    def extend_into_cache(self, params, tokens, cache, lengths=None,
                          last_only=False):
        return T.extend_step(params, self.cfg, tokens, cache,
                             lengths=lengths, last_only=last_only)

    def make_cache(self, batch: int, cache_len: int, dtype=None):
        return T.make_cache(self.cfg, batch, cache_len, dtype, self.device)


def build(cfg: ModelConfig, device: Optional[Any] = None) -> Model:
    """The model on ``device`` (CUDA unless the caller names another;
    raises when CUDA is asked for and absent)."""
    T.block_spec(cfg)              # raises for families not ported yet
    return Model(cfg=cfg, device=resolve_device(device))
