"""Model facade: ``build(cfg, device)`` returns a ``Model`` with the
methods the serving engine and the tests call, for the decoder families
the port builds: dense (and the VLM's decoder), MoE, SSM and the
attention + SSM + MoE hybrid, each in full precision or with int8 / int4
weights (``cfg.quant``)."""
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
    * ``make_paged_cache(batch, cache_len, page_size=, num_pages=)``
      builds the paged layout the same two methods take (page pools
      shared by all slots, a block table per slot).
    * ``verify_step(params, tokens, cache)`` is extend with every row
      advanced by the full window T (the speculative verify pass), and
      ``rollback(cache, steps)`` moves every sub-cache back to the
      accepted depth in place: attention caches rewrite ``step`` (causal
      masking hides the speculated tail until it is rewritten), SSM
      sub-caches restore the checkpoint taken before the most recent
      advance, so when ``rollback_needs_replay`` holds the caller rolls
      back to the pre-verify depth and re-extends the accepted tokens.
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

    def verify_step(self, params, tokens, cache):
        return T.extend_step(params, self.cfg, tokens, cache)

    def rollback(self, cache, steps):
        return T.set_cache_steps(cache, steps)

    def cache_steps(self, cache):
        return T.cache_steps(cache)

    def make_cache(self, batch: int, cache_len: int, dtype=None):
        return T.make_cache(self.cfg, batch, cache_len, dtype, self.device)

    def make_paged_cache(self, batch: int, cache_len: int, *,
                         page_size: int, num_pages: int, dtype=None):
        return T.make_paged_cache(self.cfg, batch, cache_len,
                                  page_size=page_size, num_pages=num_pages,
                                  dtype=dtype, device=self.device)

    @property
    def supports_paged(self) -> bool:
        """Paged KV pools are attention-only: SSM recurrent state has no
        per-position storage to page."""
        return all(mixer == "attn" for mixer, _ in T.block_spec(self.cfg))

    @property
    def supports_speculative(self) -> bool:
        """Every family the port builds has ``verify_step`` and
        ``rollback``."""
        return True

    @property
    def rollback_needs_replay(self) -> bool:
        """True for stacks with recurrent (SSM) state: rollback restores
        the pre-advance checkpoint, so a speculative accept re-extends
        the accepted tokens instead of only rewinding ``step``."""
        return any(mixer == "ssm" for mixer, _ in T.block_spec(self.cfg))


def build(cfg: ModelConfig, device: Optional[Any] = None) -> Model:
    """The model on ``device`` (CUDA unless the caller names another;
    raises when CUDA is asked for and absent)."""
    T.block_spec(cfg)              # raises for families not ported yet
    return Model(cfg=cfg, device=resolve_device(device))
