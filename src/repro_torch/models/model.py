"""Model facade: ``build(cfg, device)`` returns a ``Model`` with the
methods the serving engine and the tests call, for every family the
port builds: the decoder stacks (dense, the VLM, MoE, SSM and the
attention + SSM + MoE hybrid; ``models/transformer.py``), or an
``EncDecModel`` for the encoder-decoder (``models/encdec.py``), each in
full precision or with int8 / int4 weights (``cfg.quant``)."""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


def lm_loss(logits, targets, mask=None):
    """Mean next-token cross entropy. logits: (B, L, V) f32."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _loss(logits, tokens, aux):
    """(loss, metrics) of next-token logits over ``tokens`` plus the
    auxiliary loss."""
    loss = lm_loss(logits[:, :-1], tokens[:, 1:]) + aux
    return loss, {"lm_loss": loss - aux, "aux_loss": aux}


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
    * Frontend embeddings: a VLM's ``prefill`` and ``train_loss`` take
      ``batch["embeddings"]`` (B, n_tokens, d_embed), projected and
      placed before the text (``prefill``'s ``length`` counts text
      tokens; the loss drops the prefix's positions), and
      ``extend_into_cache(..., embeddings=)`` runs the prefix as one
      chunk (tokens None). The encoder-decoder's (``EncDecModel``)
      take the frames its encoder reads instead.
    """

    cfg: ModelConfig
    device: torch.device

    #: the encoder-decoder's facade (``EncDecModel``) sets it
    is_encdec: ClassVar[bool] = False

    @property
    def frontend_prefix(self) -> int:
        """Positions a VLM's frontend prefix takes before the text (0
        for every other family)."""
        fe = self.cfg.frontend
        return fe.n_tokens if fe is not None and self.cfg.family == "vlm" \
            else 0

    def init(self, seed: int = 0) -> Dict[str, Any]:
        return T.init_transformer(self.cfg, seed, self.device)

    def cache_len(self, shape: ShapeConfig) -> int:
        """The cache a step at ``shape`` needs: the sequence, or the
        sliding window when the config has one."""
        if self.cfg.sliding_window:
            return min(shape.seq_len, self.cfg.sliding_window)
        return shape.seq_len

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Stand-ins for one step's inputs at ``shape``, as tensors on the
        ``meta`` device (the shapes and dtypes of the JAX package's
        ``ShapeDtypeStruct``s, no memory): train ``{"batch"}``, prefill
        ``{"batch", "cache"}``, decode ``{"token", "cache"}``. A
        frontend's embeddings join the batch; a VLM's prefix takes its
        positions out of the sequence."""
        cfg, B = self.cfg, shape.global_batch
        meta = dataclasses.replace(self, device=torch.device("meta"))

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        fe = cfg.frontend
        if shape.mode in ("train", "prefill"):
            batch = {"tokens": sds((B, shape.seq_len - self.frontend_prefix),
                                   torch.int32)}
            if fe is not None:
                batch["embeddings"] = sds((B, fe.n_tokens, fe.d_embed),
                                          cfg.act_dtype)
            if shape.mode == "train":
                return {"batch": batch}
            return {"batch": batch,
                    "cache": meta.make_cache(B, self.cache_len(shape))}
        return {"token": sds((B, 1), torch.int32),
                "cache": meta.make_cache(B, self.cache_len(shape))}

    def train_loss(self, params, batch):
        tokens = batch["tokens"]
        emb = batch.get("embeddings") \
            if self.cfg.frontend is not None else None
        logits, aux = T.forward_train(params, self.cfg, tokens, emb)
        return _loss(logits[:, self.frontend_prefix:], tokens, aux)

    def prefill(self, params, batch, cache):
        length = batch.get("length")
        emb = batch.get("embeddings") \
            if self.cfg.frontend is not None else None
        if length is not None and emb is not None:
            # length counts text tokens; the cache also holds the prefix
            length = length + self.frontend_prefix
        return T.prefill(params, self.cfg, batch["tokens"], cache, emb,
                         length=length)

    def decode_step(self, params, token, cache):
        return T.decode_step(params, self.cfg, token, cache)

    def extend_into_cache(self, params, tokens, cache, lengths=None,
                          last_only=False, embeddings=None):
        return T.extend_step(params, self.cfg, tokens, cache,
                             lengths=lengths, last_only=last_only,
                             embeddings=embeddings)

    def verify_step(self, params, tokens, cache):
        return self.extend_into_cache(params, tokens, cache)

    def encode_memory(self, params, frames):
        raise ValueError(f"family {self.cfg.family!r} has no encoder")

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


@dataclasses.dataclass(frozen=True)
class EncDecModel(Model):
    """The encoder-decoder's facade (``models/encdec.py``), the JAX
    package's ``_build_encdec``: ``prefill`` and ``train_loss`` take the
    frames the encoder reads, ``encode_memory(params, frames)`` returns
    the per-layer cross-attention K/V the engine writes into a slot at
    admission, and the cache has no paged layout (JAX leaves its
    ``make_paged_cache`` None)."""

    is_encdec: ClassVar[bool] = True

    def init(self, seed: int = 0) -> Dict[str, Any]:
        return T.init_transformer(self.cfg, seed, self.device,
                                  shapes=ED.param_shapes(self.cfg))

    def train_loss(self, params, batch):
        tokens = batch["tokens"]
        logits, aux = ED.forward_train(params, self.cfg, tokens,
                                       batch["embeddings"])
        return _loss(logits, tokens, aux)

    def prefill(self, params, batch, cache):
        return ED.prefill(params, self.cfg, batch["tokens"], cache,
                          batch["embeddings"], length=batch.get("length"))

    def decode_step(self, params, token, cache):
        return ED.decode_step(params, self.cfg, token, cache)

    def extend_into_cache(self, params, tokens, cache, lengths=None,
                          last_only=False, embeddings=None):
        if embeddings is not None:
            raise ValueError("an encoder-decoder's frames enter through "
                             "encode_memory, not extend_into_cache")
        return ED.extend_step(params, self.cfg, tokens, cache,
                              lengths=lengths, last_only=last_only)

    def encode_memory(self, params, frames):
        """The frames (B, T_src, d_embed) encoded once, as ``(xk, xv)``,
        each (n_layers, B, T_src, Hkv, hd)."""
        memory = ED.encode(params, self.cfg, frames)
        return ED.cross_kv_all(params, self.cfg, memory)

    def make_cache(self, batch: int, cache_len: int, dtype=None):
        return ED.make_encdec_cache(self.cfg, batch, cache_len,
                                    self.cfg.frontend.n_tokens, dtype,
                                    self.device)

    def make_paged_cache(self, batch: int, cache_len: int, *,
                         page_size: int, num_pages: int, dtype=None):
        raise NotImplementedError(
            "an encoder-decoder has no paged cache (as in JAX)")

    @property
    def supports_paged(self) -> bool:
        return False

    @property
    def rollback_needs_replay(self) -> bool:
        return False


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` as shapes: the decoder stacks'
    (``transformer.param_shapes``) or the encoder-decoder's
    (``encdec.param_shapes``)."""
    if cfg.family == "encdec":
        return ED.param_shapes(cfg)
    return T.param_shapes(cfg)


def build(cfg: ModelConfig, device: Optional[Any] = None) -> Model:
    """The model on ``device`` (CUDA unless the caller names another;
    raises when CUDA is asked for and absent)."""
    if cfg.family == "encdec":
        if cfg.encoder is None or cfg.frontend is None:
            raise NotImplementedError(
                f"{cfg.name!r}: family 'encdec' needs an encoder and a "
                f"frontend config; the port builds the encoder-decoders of "
                f"the JAX registry (ROADMAP section 1)")
        return EncDecModel(cfg=cfg, device=resolve_device(device))
    T.block_spec(cfg)              # raises for an unknown family
    return Model(cfg=cfg, device=resolve_device(device))
