"""Batched serving engine with continuous batching and chunked admission:
the port of the JAX package's ``serving/engine.py``, cut to its main
path.

A fixed number of batch *slots* share one batched KV cache; each slot
runs an independent sequence at its own per-row ``step`` offset. A
request is admitted into a free slot through chunked admission, the only
admission path: every engine step is either

* a **plain step** (no admission in flight): one decode token for every
  slot through ``Model.decode_step``, sampled on device; or
* a **mixed step**: every active slot decodes one token through a masked
  T=1 ``Model.extend_into_cache`` (the admitting and idle rows advance
  by 0), then the admitting slot's view ``cache[:, slot:slot+1]`` is
  advanced by up to ``prefill_chunk`` prompt tokens at batch 1, and one
  sampler call over each row's last-valid logits gives the decode rows
  their next token and, when the chunk completes the prompt, the
  admitting row its first token, arming the slot on device.

The cache is updated in place (where JAX donates it); the decode state
(``tokens``, ``remaining``, ``active``, ``eos``) and the per-step token
trace stay on the device and are read back only at the periodic poll,
every ``sync_every`` steps, which cuts each slot's stream at the same
stop condition the device applied. An on-device guard turns a row with
non-finite logits into :data:`ERR_TOKEN` and a ``finish_reason="error"``
finish while the rest of the batch continues.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item when asked for: paged KV caches, speculative decoding, the prefix
cache, tensor-parallel meshes, int8 KV, fault injection, lifecycle
tracing and profiling, deadlines, priorities and cancellation.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving import telemetry
from repro_torch.serving.request import Request, Response
from repro_torch.serving.sampler import Sampler

#: Sentinel "token" the fused steps emit for a slot whose sampler logits
#: were not finite: the device deactivates only that row and the host
#: harvest turns it into finish_reason "error" without appending it.
ERR_TOKEN = -2


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP section 1, item {item}")


def _guarded_sample(sampler, generator, logits):
    """NaN/inf containment at the sampler boundary: rows whose logits are
    not finite emit :data:`ERR_TOKEN`; finite rows sample exactly as an
    unguarded call would. Returns (tokens (B,) int64, bad (B,) bool)."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    nxt = sampler(generator, safe)
    return torch.where(bad, torch.full_like(nxt, ERR_TOKEN), nxt), bad


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class _Admission:
    """One in-flight chunked admission: ``tokens`` enter the slot
    ``prefill_chunk`` per mixed step, ``base`` of them so far."""
    req: Request
    slot: int
    base: int
    length: int
    tokens: np.ndarray


class Engine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 cache_len: int = 512, sampler: Optional[Sampler] = None,
                 seed: int = 0, sync_every: int = 8,
                 kv_cache_dtype: str = "", draft: Any = None,
                 spec_gamma: int = 0, prefill_chunk: Optional[int] = None,
                 prefix_cache_tokens: Optional[int] = None,
                 mesh: Any = None, paged: bool = False,
                 faults: Any = None, recorder: Any = None,
                 trace_dir: str = ""):
        """Arguments as in the JAX engine. ``params`` and the cache live
        on ``model.device``. ``prefill_chunk`` sizes chunked admission
        (None follows ``cfg.prefill_chunk``; 0 = the whole prompt in one
        chunk). The arguments of features not ported yet raise."""
        cfg = model.cfg
        if kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"unsupported kv_cache_dtype "
                             f"{kv_cache_dtype!r} (use '' or 'int8')")
        if kv_cache_dtype == "int8" or cfg.kv_quant:
            raise _not_ported("int8 KV cache", "8 (quantization)")
        if paged:
            raise _not_ported("paged=True", "4 (paged KV)")
        if draft is not None or spec_gamma or cfg.draft or cfg.spec_gamma:
            raise _not_ported("speculative decoding (draft/spec_gamma)",
                              "9 (speculative decoding)")
        pct = cfg.prefix_cache_tokens if prefix_cache_tokens is None \
            else prefix_cache_tokens
        if pct:
            raise _not_ported("prefix_cache_tokens > 0", "6 (prefix cache)")
        mesh_src = cfg.mesh if mesh is None else mesh
        if mesh_src not in ("", "none", "off", None):
            raise _not_ported("mesh (tensor-parallel serving)",
                              "13 (distribution)")
        if faults not in (None, False):
            raise _not_ported("faults", "5 (engine lifecycle)")
        if recorder or trace_dir:
            raise _not_ported("recorder/trace_dir",
                              "5 (engine lifecycle)")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.sampler = sampler or Sampler()
        self.sync_every = max(1, sync_every)
        self.kv_len = min(cache_len, cfg.sliding_window) \
            if cfg.sliding_window else cache_len
        chunk = cfg.prefill_chunk if prefill_chunk is None \
            else prefill_chunk
        # 0 / unset = one chunk of the whole ring: the prompt enters
        # through a single mixed step
        self.prefill_chunk = min(int(chunk), self.kv_len) if chunk \
            else self.kv_len

        # --- telemetry (host-side) ------------------------------------ #
        self.metrics = telemetry.MetricsRegistry()
        self._step_series = self.metrics.get_series("step_wall_s")
        self._kind_series = self.metrics.get_series("step_kind")
        self._c_admissions = self.metrics.counter("chunked_admissions")
        self._c_errors = self.metrics.counter("slot_errors")
        self._h_ttft = self.metrics.histogram("ttft_s")
        self._h_itl = self.metrics.histogram("itl_s")

        # --- host-side scheduling state ------------------------------- #
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.responses: Dict[int, Response] = {}
        self._admit: Optional[_Admission] = None

        # --- device-resident decode state ----------------------------- #
        dev = self.device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int64,
                                  device=dev)
        self.remaining = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=dev)
        self.active = torch.zeros((max_batch,), dtype=torch.bool,
                                  device=dev)
        self.eos = torch.full((max_batch,), -1, dtype=torch.int64,
                              device=dev)
        self._rows = torch.arange(max_batch, device=dev)
        self._ones = torch.ones((max_batch,), dtype=torch.int32,
                                device=dev)
        self.cache = model.make_cache(max_batch, cache_len)

        # per-step token trace on device: (tokens (B, 1), emit count (B,))
        # per step, harvested at the next poll
        self._trace: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._trace_base = 0                  # global step of _trace[0]
        self._slot_start = [0] * max_batch    # global step per slot
        self._steps = 0
        self._step_wall: List[float] = []     # per-step wall stamps (ITL)
        self._step_wall_base = 0
        self._await_first: List[Request] = []
        self._drop_compile_step = True        # step_times[0] is warm-up

    # ------------------------------------------------------------ #
    # host-side step series
    # ------------------------------------------------------------ #
    @property
    def step_times(self) -> List[float]:
        """Per-step wall clock, aligned with ``step_kinds``."""
        return self._step_series.values

    @property
    def step_kinds(self) -> List[str]:
        """"plain" | "mixed" per step, aligned with ``step_times``."""
        return self._kind_series.values

    def _record_step(self, kind: str) -> None:
        self._kind_series.append(kind)
        self._steps += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ #
    # fused steps (device work only, no host sync)
    # ------------------------------------------------------------ #
    def _decode(self) -> torch.Tensor:
        """Plain step: decode + sample + slot bookkeeping on device.
        Returns the sampled tokens (B,) for the trace."""
        logits, _ = self.model.decode_step(self.params, self.tokens,
                                           self.cache)
        nxt, bad = _guarded_sample(self.sampler, self.generator,
                                   logits[:, -1].float())
        active, remaining = self.active, self.remaining
        done = active & (bad | (remaining <= 1) | (nxt == self.eos))
        self.active = active & ~done
        self.remaining = torch.where(active, remaining - 1, remaining)
        # the next step embeds these: an ERR_TOKEN row (now inactive)
        # feeds a valid id instead, the trace keeps the sentinel
        self.tokens = nxt.clamp(min=0)[:, None]
        return nxt

    def _slot_extend(self, slot: int, chunk: np.ndarray, n: int):
        """Advance the admitting slot by the first ``n`` of the chunk's C
        tokens at batch 1, through the view ``cache[:, slot:slot+1]``
        (the writes land in the batched cache). Returns (1, 1, V)
        last-valid logits."""
        view = _tree_map(lambda t: t[:, slot:slot + 1], self.cache)
        toks = torch.from_numpy(chunk).to(self.device)[None]
        lengths = torch.full((1,), n, dtype=torch.int32, device=self.device)
        logits, _ = self.model.extend_into_cache(self.params, toks, view,
                                                 lengths, last_only=True)
        return logits

    def _mixed(self, adm: _Admission, chunk: np.ndarray, n: int,
               last: bool):
        """Mixed step: decode every active slot, push one chunk of the
        admitting slot, sample all rows at once and arm the admitting
        row when its prompt is complete. Returns (tokens, emit count)."""
        req = adm.req
        active, remaining, eos = self.active, self.remaining, self.eos
        is_admit = self._rows == adm.slot
        dec_logits, _ = self.model.extend_into_cache(
            self.params, self.tokens, self.cache, active.to(torch.int32),
            last_only=True)
        ch_logits = self._slot_extend(adm.slot, chunk, n)
        logits = torch.where(is_admit[:, None], ch_logits[0, 0][None],
                             dec_logits[:, 0])
        nxt, bad = _guarded_sample(self.sampler, self.generator,
                                   logits.float())
        a_rem = req.max_new_tokens
        a_eos = -1 if req.eos_id is None else int(req.eos_id)
        arm = is_admit & last
        emit = active | arm
        done = emit & (bad | (torch.where(arm, a_rem, remaining) <= 1)
                       | (nxt == torch.where(arm, a_eos, eos)))
        self.active = emit & ~done
        self.remaining = torch.where(
            arm, a_rem - 1, torch.where(active, remaining - 1, remaining))
        self.eos = torch.where(arm, a_eos, eos)
        self.tokens = torch.where(emit, nxt.clamp(min=0),
                                  self.tokens[:, 0])[:, None]
        return nxt[:, None], emit.to(torch.int32)

    def _reset_slot(self, b: int) -> None:
        """Erase slot ``b``: every position empty, depth 0, so a recycled
        slot keeps no stale keys from its previous occupant."""
        for sub in self.cache.values():
            sub["pos"][:, b] = -1
            sub["step"][:, b] = 0

    # ------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        """Validate and enqueue. Malformed requests raise ``ValueError``
        here, with the violated constraint spelled out."""
        self._validate(req)
        req.submitted_s = time.perf_counter()
        self.queue.append(req)
        self.responses[req.uid] = Response(uid=req.uid,
                                           prompt_len=len(req.prompt))

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"request {req.uid}: prompt must be a non-empty 1-D "
                f"token array, got shape {prompt.shape}")
        if prompt.dtype.kind not in "iu":
            raise ValueError(
                f"request {req.uid}: prompt must hold integer token "
                f"ids, got dtype {prompt.dtype}")
        if req.max_new_tokens <= 0:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be positive, "
                f"got {req.max_new_tokens}")
        if req.deadline_s is not None or req.priority:
            raise _not_ported("request deadlines and priorities",
                              "5 (engine lifecycle)")
        if req.embeddings is not None:
            raise _not_ported("frontend embeddings", "10 (other families)")
        old = self.responses.get(req.uid)
        if old is not None and not old.finished:
            raise ValueError(f"request uid {req.uid} is already in flight")
        if prompt.size > self.kv_len and not self.model.cfg.sliding_window:
            # a sliding-window ring serves longer prompts (the window
            # mask hides overwritten context); full attention cannot
            raise ValueError(
                f"request {req.uid}: prompt of {prompt.size} tokens "
                f"exceeds the KV capacity of {self.kv_len} (cache_len="
                f"{self.cache_len}); raise cache_len or shorten the prompt")

    def _free_slot(self) -> Optional[int]:
        admitting = self._admit.slot if self._admit is not None else -1
        for b in range(self.max_batch):
            if self.slots[b] is None and b != admitting:
                return b
        return None

    def _fill_free_slots(self) -> None:
        """FIFO admission: the head of the queue starts a chunked
        admission when a slot is free (at most one in flight)."""
        while self.queue and self._admit is None:
            b = self._free_slot()
            if b is None:
                return
            self._start_chunked(self.queue.popleft(), b)

    def _start_chunked(self, req: Request, b: int) -> None:
        req.started_s = req.started_s or time.perf_counter()
        toks = np.asarray(req.prompt, np.int64)
        self._reset_slot(b)
        self._admit = _Admission(req=req, slot=b, base=0,
                                 length=len(toks), tokens=toks)

    # ------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------ #
    def step(self) -> None:
        """One engine step (plain or mixed): device work only; tokens,
        finish flags and counters stay on the device."""
        t0 = time.perf_counter()
        n0 = self._steps
        if self._admit is None and self.queue:
            # pipeline the next admission mid-burst
            b = self._free_slot()
            if b is not None:
                self._start_chunked(self.queue.popleft(), b)
        if self._admit is not None:
            self._step_mixed(self._admit)
        else:
            self._step_plain()
        made = self._steps - n0
        dt = (time.perf_counter() - t0) / max(made, 1)
        for _ in range(made):
            self.step_times.append(dt)

    def _step_plain(self) -> None:
        self._trace.append((self._decode()[:, None], self._ones))
        self._record_step("plain")

    def _chunk_args(self, adm: _Admission) -> Tuple[np.ndarray, int, bool]:
        C = self.prefill_chunk
        n = min(C, adm.length - adm.base)
        chunk = np.zeros((C,), np.int64)
        chunk[:n] = adm.tokens[adm.base:adm.base + n]
        return chunk, n, adm.base + n >= adm.length

    def _step_mixed(self, adm: _Admission) -> None:
        chunk, n, last = self._chunk_args(adm)
        self._trace.append(self._mixed(adm, chunk, n, last))
        adm.base += n
        if last:
            self._complete_admission(adm)
        self._record_step("mixed")

    def _complete_admission(self, adm: _Admission) -> None:
        """The chunk just dispatched ends the prompt: the device sampled
        the first token and armed the slot. Host-side: attach the request
        to the slot (its trace starts at this step) and queue its TTFT
        stamp for the next sync."""
        b = adm.slot
        self.slots[b] = adm.req
        self._slot_start[b] = self._steps
        self._await_first.append(adm.req)
        self._c_admissions.inc()
        self._admit = None

    def _stamp_first_tokens(self, now: float) -> None:
        for req in self._await_first:
            if not req.first_token_s:
                req.first_token_s = now
                self._h_ttft.observe(now - req.submitted_s)
        self._await_first.clear()

    def _poll(self) -> None:
        """The periodic host sync: read the unconsumed suffix of the
        trace back in two transfers, harvest each occupied slot's tokens
        and prune the trace. Finish detection replays the device's stop
        conditions on the harvested tokens."""
        if not self._trace:
            return
        occupied = [(b, self._slot_start[b] - self._trace_base)
                    for b, r in enumerate(self.slots) if r is not None]
        starts = [s for _, s in occupied if s < len(self._trace)]
        if starts:
            lo = min(starts)
            suffix = self._trace[lo:]
            blocks = torch.cat([t for t, _ in suffix], dim=1).cpu().numpy()
            counts = torch.stack([c for _, c in suffix],
                                 dim=1).cpu().numpy()
            for b, start in occupied:
                s = start - lo
                if s >= len(suffix):
                    continue                           # armed post-trace
                col: List[int] = []
                gaps: List[Optional[float]] = []
                for off in range(s, len(suffix)):
                    if not counts[b, off]:
                        continue
                    w = self._trace_base + lo + off - self._step_wall_base
                    gap = None
                    if 0 < w < len(self._step_wall):
                        gap = self._step_wall[w] - self._step_wall[w - 1]
                    col.append(int(blocks[b, off]))
                    gaps.append(gap)
                self._harvest(b, col, gaps)
        # every occupied slot has now consumed the whole trace
        keep_from = min((self._slot_start[b] for b, r
                         in enumerate(self.slots) if r is not None),
                        default=self._steps)
        drop = keep_from - self._trace_base
        if drop > 0:
            del self._trace[:drop]
            self._trace_base = keep_from
        # keep one wall stamp before the oldest live step (its gap needs
        # the predecessor's stamp)
        wdrop = keep_from - 1 - self._step_wall_base
        if wdrop > 0:
            del self._step_wall[:wdrop]
            self._step_wall_base = keep_from - 1

    def _harvest(self, b: int, col: List[int],
                 gaps: List[Optional[float]]) -> None:
        """Append slot ``b``'s sampled tokens host-side, cut at the stop
        condition the device applied (it kept decoding the finished slot
        until this poll). The first token of a request is TTFT, not ITL."""
        req = self.slots[b]
        resp = self.responses[req.uid]
        done = False
        for tok, gap in zip(col, gaps):
            if tok == ERR_TOKEN:
                resp.finish_reason = "error"
                self._c_errors.inc()
                done = True
                break
            if resp.tokens and gap is not None:
                self._h_itl.observe(gap)
            resp.tokens.append(tok)
            if req.eos_id is not None and tok == req.eos_id:
                resp.finish_reason = "eos"
                done = True
                break
            if len(resp.tokens) >= req.max_new_tokens:
                resp.finish_reason = "length"
                done = True
                break
        if done:
            resp.finished = True
            req.finished_s = time.perf_counter()
            self.slots[b] = None
        else:
            self._slot_start[b] = self._steps              # all consumed

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active_slots
                    or self._admit is not None)

    def tick(self, steps: Optional[int] = None) -> int:
        """One admission pass, one burst of up to ``steps`` fused steps
        (default ``sync_every``) and one poll. Returns the steps run."""
        k = self.sync_every if steps is None else max(1, steps)
        self._fill_free_slots()
        if not (self.active_slots or self._admit is not None):
            self._poll()
            return 0
        t0 = time.perf_counter()
        # steps run outside tick (raw .step() calls) have no wall stamp
        while len(self._step_wall) + self._step_wall_base < self._steps:
            self._step_wall.append(t0)
        n0 = len(self.step_times)
        ran0 = self._steps
        while self._steps - ran0 < k:
            first_ever = self._steps == 0
            before = len(self.step_times)
            self.step()
            if first_ever:
                # isolate the warm-up step (kernel builds, allocator
                # growth) in its own step_times entry; latency_stats
                # drops it
                self._sync()
                now = time.perf_counter()
                made = len(self.step_times) - before
                for i in range(before, len(self.step_times)):
                    self.step_times[i] = (now - t0) / made
                self._step_wall.extend([now] * made)
                t0 = now
                n0 = len(self.step_times)
        self._sync()
        t1 = time.perf_counter()
        m = len(self.step_times) - n0
        if m > 0:
            # burst-average: per-step dispatch time plus its share of sync
            dt = (t1 - t0) / m
            for i in range(n0, len(self.step_times)):
                self.step_times[i] = dt
            for i in range(m):
                self._step_wall.append(t0 + dt * (i + 1))
        self._stamp_first_tokens(t1)
        self._poll()
        return self._steps - ran0

    def run(self, max_steps: int = 100_000,
            sync_every: Optional[int] = None) -> Dict[int, Response]:
        k = self.sync_every if sync_every is None else max(1, sync_every)
        steps = 0
        while self.has_work and steps < max_steps:
            made = self.tick(min(k, max_steps - steps))
            steps += made
            if made == 0 and not self.has_work:
                break
        self._poll()   # partial tokens for interrupted slots
        return self.responses

    def reset_stats(self) -> None:
        """Forget timing and finished-request history (cache state is
        kept): for benchmarks that warm an engine up, then measure."""
        self.metrics.reset()
        self._drop_compile_step = False
        for uid in [u for u, r in self.responses.items() if r.finished]:
            del self.responses[uid]

    def latency_stats(self) -> Dict[str, float]:
        """Latency summary. The ``decode_ms_*`` / ``ttft_ms_*`` /
        ``itl_ms_*`` keys are present only when their stream has at least
        one sample."""
        drop = 1 if self._drop_compile_step else 0
        finished = [r for r in self.responses.values() if r.finished]
        stats: Dict[str, float] = {
            "n_finished": len(finished),
            "tokens_generated": sum(r.n_generated for r in finished),
            "decode_steps": self._steps,
            "prefill_chunk": self.prefill_chunk,
            "chunked_admissions": self._c_admissions.value,
            "slot_errors": self._c_errors.value,
        }
        telemetry.pct_stats(stats, "decode_ms", self.step_times[drop:],
                            (50, 99))
        telemetry.pct_stats(stats, "ttft_ms", self._h_ttft.values,
                            (50, 95, 99))
        telemetry.pct_stats(stats, "itl_ms", self._h_itl.values,
                            (50, 95, 99))
        return stats
