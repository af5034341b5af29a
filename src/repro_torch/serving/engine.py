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
(``tokens``, ``remaining``, ``active``, ``eos``) lives in persistent
device buffers that each step updates in place, and the per-step token
trace stays on the device until the periodic poll, every ``sync_every``
steps, which cuts each slot's stream at the same stop condition the
device applied. An on-device guard turns a row with non-finite logits
into :data:`ERR_TOKEN` and a ``finish_reason="error"`` finish while the
rest of the batch continues.

Each step is a **program** (:class:`StepProgram`), the counterpart of
the JAX engine's jitted step programs: the plain step, and one mixed
step per admitting slot (the mixed step slices the cache at its slot).
A program's body takes no arguments and reads only static buffers: the
decode state, the cache, the params and one staging buffer into which
the host copies a mixed step's chunk and scalars (from pinned memory,
asynchronously), so no step syncs the host. With ``graphs`` on (the
default on a CUDA device) a program's first call runs its body eagerly,
as the warm-up (kernel builds, attribute setup, cuBLAS handles), then
captures it as a CUDA graph; later calls replay the graph. On the CPU
the bodies run eagerly. Every build is recorded by the recompile
watchdog (``telemetry.CompileWatchdog``), which warns once the engine
is marked steady; ``program_cache_sizes()`` counts the programs built.
The page-table push, copy-on-write page copies and slot resets stay
eager, outside the programs: they write in place into the cache's
persistent leaves, which the graphs read.

With ``paged=True`` the per-slot rings are replaced by a pool of
``num_pages`` pages of ``page_size`` tokens (``serving/paged_kv.py``):
the host allocator provisions the pages every dispatched step will
write (an upper bound on each slot's depth, ``_depth_ub``, corrected by
a shrink at every poll), pushes the block tables to the device, and
admits a request only when the pool can hold its prompt and first decode
write (backpressure: the head of the queue waits). Plain steps then
decode through a masked T=1 ``extend_into_cache``, so rows the device
already finished write nothing. When the pool runs out mid-decode,
provisioning polls (a finished slot may hold pages), then preempts the
lowest resumable slot and requeues it at the front; it resumes by
replaying its prompt plus the tokens it had generated through chunked
admission, and only a pool that cannot hold the live set raises.

With ``kv_cache_dtype="int8"`` (or a config with ``kv_quant``, such as
the ``edge`` variant) the cache holds int8 K/V with per-(slot, head)
scales, on rings or in the pool; the parameters may be quantized
(``repro_torch.quant``), which the model routes by their structure.

Lifecycle control, as in the JAX engine: requests carry ``deadline_s``
and ``priority``; ``Engine.cancel(uid)`` and deadline enforcement at tick
boundaries finish a stream with ``finish_reason`` "cancelled" or
"timeout", keeping its partial output and releasing its slot and pages at
once. Under slot or page pressure the engine preempts a victim (lowest
priority, then latest deadline, then lowest slot) and requeues it; it
resumes by replay. A cancel, a timeout or a preemption changes only host
state and, in place and outside any step program, the device row
``active[b]`` that the programs read, so none of them builds a program
or syncs the host beyond the poll it makes.

Faults (``serving/faults.py``; ``Engine(faults=...)`` or
``REPRO_FAULTS``) fire at three engine sites: ``slow_step`` (a host
stall before a step), ``nan_logits`` (NaN into one row's sampler logits,
which the guard contains to that row) and ``page_alloc`` (a forced pool
exhaustion inside provisioning). The NaN goes through the poison lane,
a static ``(max_batch,)`` f32 device buffer that both step bodies add to
their sampler logits on every step (0.0 is the identity on finite
values): arming writes NaN into one row in place before the step and
clearing zeroes the buffer after it, so the programs are the same with
or without faults. Request lifecycles go to a ``Recorder`` (the no-op by
default; ``recorder=True`` builds a ``serving/tracing.Tracer`` whose
Chrome trace ``export_trace(path)`` writes), and ``trace_dir=`` records
a ``torch.profiler`` trace of ``profile_steps`` steps after the first.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item when asked for: speculative decoding, the prefix cache and
tensor-parallel meshes.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.program import capture
from repro_torch.models.model import Model, build
from repro_torch.serving import faults as faults_mod
from repro_torch.serving import paged_kv, telemetry
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


def _slot_view(cache, slot: int):
    """Slot ``slot``'s batch-1 view of the stacked cache: every per-slot
    leaf sliced ``[:, slot:slot+1]``; page pools (``paged_kv.POOL_KEYS``)
    pass through whole, since slicing them would cut the page axis. The
    view's writes land in the batched cache."""
    return {name: {k: v if k in paged_kv.POOL_KEYS
                   else v[:, slot:slot + 1] for k, v in sub.items()}
            for name, sub in cache.items()}


class StepProgram:
    """One engine step program. ``body`` takes no arguments, reads only
    the engine's static buffers, the cache and the params, updates them
    in place and returns one tensor. Until ``capture`` a call runs the
    body eagerly (the CPU path). ``capture`` records the body into a CUDA
    graph on ``stream``, from the memory ``pool`` the engine's graphs
    share (they never run at once, and every output is copied right
    after its replay); later calls replay it, add the launches its
    capture recorded to the kernel counters and return a copy of the
    graph's output, which the next replay overwrites. Nothing falls back
    to eager: a failed capture or replay raises."""

    def __init__(self, body):
        self.body = body
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}

    def _new_graph(self, generator):
        graph = torch.cuda.CUDAGraph()
        # temperature sampling draws from the engine's generator: the
        # replays advance its offset as the eager calls would
        graph.register_generator_state(generator)
        return graph

    @staticmethod
    def _recording(graph, pool, stream):
        return torch.cuda.graph(graph, pool=pool, stream=stream)

    def capture(self, pool=None, stream=None, generator=None) -> None:
        """Record the body (``core.program.capture``)."""
        graph = self._new_graph(generator)
        out, launches = capture(self.body,
                                self._recording(graph, pool, stream))
        self.graph, self.out, self.launches = graph, out, launches

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.body()
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.out.clone()


@dataclasses.dataclass
class _Admission:
    """One in-flight chunked admission: ``tokens`` enter the slot
    ``prefill_chunk`` per mixed step, ``base`` of them so far. ``tokens``
    is the prompt plus, when resuming a preempted request, the ``n_done``
    tokens it had already generated: replaying them through the same
    extend path makes the resumed stream's next tokens those of an
    unpreempted run (greedy)."""
    req: Request
    slot: int
    base: int
    length: int
    tokens: np.ndarray
    n_done: int = 0


class Engine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 cache_len: int = 512, sampler: Optional[Sampler] = None,
                 seed: int = 0, sync_every: int = 8,
                 kv_cache_dtype: str = "", draft: Any = None,
                 spec_gamma: int = 0, prefill_chunk: Optional[int] = None,
                 prefix_cache_tokens: Optional[int] = None,
                 mesh: Any = None, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 faults: Any = None, recorder: Any = None,
                 trace_dir: str = "", profile_steps: int = 8,
                 graphs: Optional[bool] = None):
        """Arguments as in the JAX engine. ``params`` and the cache live
        on ``model.device``. ``prefill_chunk`` sizes chunked admission
        (None follows ``cfg.prefill_chunk``; 0 = the whole prompt in one
        chunk). ``paged=True`` serves from a pool of ``num_pages`` pages
        of ``page_size`` tokens (None sizes it for the contiguous
        layout's capacity plus two pages of provisioning headroom per
        slot); the pool must hold one full-length stream.
        ``kv_cache_dtype="int8"`` rebuilds the model with ``kv_quant``,
        as the JAX engine does. ``faults``: a ``Faults`` schedule, a spec
        string for ``Faults.parse``, False for none, or None to follow
        ``REPRO_FAULTS``. ``recorder``: True builds a ``Tracer``, or pass
        a ``telemetry.Recorder``; None keeps the no-op. ``trace_dir``:
        write a ``torch.profiler`` Chrome trace of ``profile_steps``
        steps, starting after step 1, into that directory. ``graphs``:
        run the step programs as CUDA graphs (None: on a CUDA device, and
        eager on the CPU; False: eager anywhere; True on the CPU raises).
        The arguments of features not ported yet raise."""
        if kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"unsupported kv_cache_dtype "
                             f"{kv_cache_dtype!r} (use '' or 'int8')")
        if kv_cache_dtype == "int8" and not model.cfg.kv_quant:
            model = build(model.cfg.replace(kv_quant=True), model.device)
        cfg = model.cfg
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
        self.model = model
        self.params = params
        self.device = model.device
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True needs a CUDA device; the model "
                             f"is on {self.device}")
        self.graphs = on_card if graphs is None else bool(graphs)
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
        # the registry holds every host-side stat; the recorder is the
        # request-lifecycle event sink (a no-op unless asked for)
        self.metrics = telemetry.MetricsRegistry()
        if recorder is True:
            from repro_torch.serving.tracing import Tracer
            recorder = Tracer()
        self.recorder: telemetry.Recorder = recorder or telemetry.Recorder()
        self._watchdog = telemetry.CompileWatchdog(self.metrics,
                                                   self.recorder)
        self._step_series = self.metrics.get_series("step_wall_s")
        self._kind_series = self.metrics.get_series("step_kind")
        self._kinds_base = 0               # global step of step_kinds[0]
        self._c_tokens = self.metrics.counter("tokens_emitted")
        self._c_steps = self.metrics.counter("steps_total", persist=True)
        self._c_admissions = self.metrics.counter("chunked_admissions")
        # admissions that could not take the chunked path: none can in
        # the port (every family it serves extends); kept so the counter
        # and its key read as in the JAX engine
        self._c_fallback = self.metrics.counter("fallback_admissions")
        self._h_ttft = self.metrics.histogram("ttft_s")
        self._h_itl = self.metrics.histogram("itl_s")
        self._c_preempt = self.metrics.counter("preemptions")
        self._c_timeout = self.metrics.counter("timeouts")
        self._c_cancel = self.metrics.counter("cancellations")
        self._c_faults = self.metrics.counter("faults_injected")
        self._c_errors = self.metrics.counter("slot_errors")
        self._c_polls = self.metrics.counter("trace_polls")
        self._trace_dir = trace_dir
        self._profile_steps = max(1, int(profile_steps))
        self._prof = None                  # the torch.profiler window
        self._prof_done = False
        self._prof_base = 0
        #: the Chrome trace the profiler window wrote (None until then)
        self.profile_trace: Optional[str] = None
        self._kv_nbytes: Optional[int] = None   # lazy: cache bytes

        # --- fault injection ------------------------------------------ #
        if faults is None:
            faults = faults_mod.from_env()
        elif isinstance(faults, str):
            faults = faults_mod.Faults.parse(faults)
        elif faults is False:
            faults = faults_mod.NoFaults()
        self.faults = faults
        if self.faults.enabled:
            self.metrics.add_collector(self.faults.stats)

        # --- host-side scheduling state ------------------------------- #
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.requests: Dict[int, Request] = {}
        self.responses: Dict[int, Response] = {}
        self._admit: Optional[_Admission] = None
        self._deadline_armed = False   # a live request has deadline_s

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
        # the poison lane: added to every step program's sampler logits
        # (0.0 is the identity on finite values). The nan_logits site
        # writes NaN into one row for one step, in place: the tensor is
        # never rebound, so the captured graphs read it on every replay
        self._poison = torch.zeros((max_batch,), dtype=torch.float32,
                                   device=dev)

        # --- paged KV cache ------------------------------------------- #
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self._paged: Optional[paged_kv.PagedKVState] = None
        # per-slot provisioned depth: an upper bound on the device's
        # committed depth, advanced ahead of each dispatched step and
        # corrected at every poll
        self._depth_ub = [0] * max_batch
        if self.paged:
            if not model.supports_paged:
                raise ValueError(
                    "paged KV requires attention-only stacks; family "
                    f"{cfg.family!r} has other mixers")
            n_blk = paged_kv.num_blocks(self.kv_len, self.page_size)
            # default: capacity parity with the contiguous layout, plus
            # headroom for provisioning drift (depth upper bounds run
            # ahead of the harvested truth between polls)
            self.num_pages = int(num_pages) if num_pages \
                else max_batch * n_blk + 2 * max_batch
            if self.num_pages < n_blk:
                # one full-length stream must always fit once the pool
                # drains, else admission backpressure can never clear
                raise ValueError(
                    f"num_pages={self.num_pages} cannot hold one full "
                    f"stream ({n_blk} blocks of {self.page_size} tokens)")
            self._paged = paged_kv.PagedKVState(
                max_batch, self.kv_len, self.page_size, self.num_pages)
            self.metrics.add_collector(self._paged.stats)
            self.cache = model.make_paged_cache(
                max_batch, cache_len, page_size=self.page_size,
                num_pages=self.num_pages)
        else:
            self.num_pages = 0
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

        # --- step programs -------------------------------------------- #
        # the mixed step's host values, copied in one transfer a step:
        # the chunk's C tokens, then n, last, the admitted request's
        # token budget and its eos id (-1: none)
        self._stage = torch.zeros((self.prefill_chunk + 4,),
                                  dtype=torch.int64, device=dev)
        self._programs: Dict[Tuple[Any, ...], StepProgram] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.graphs else None
        self._capture_stream = torch.cuda.Stream(dev) if self.graphs \
            else None

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
        """One engine step happened: the global counter, the per-kind
        counters and the aligned kind series (``step()`` appends the wall
        entry once timing is known)."""
        self._kind_series.append(kind)
        self.metrics.counter("steps_" + kind).inc()
        self._c_steps.inc()
        self._steps += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ #
    # step programs (device work only, no host sync)
    # ------------------------------------------------------------ #
    def _run_program(self, key: Tuple[Any, ...], body) -> torch.Tensor:
        """Call the step program ``key`` (its name first). Its first call
        builds it: the body runs eagerly (the warm-up) and, with graphs
        on, is then captured; the watchdog records the build with the
        first call's wall time (on the card the capture starts with a
        device sync, so it covers the warm-up's device work too)."""
        prog = self._programs.get(key)
        if prog is not None:
            return prog()
        t0 = time.perf_counter()
        out = body()
        prog = StepProgram(body)
        if self.graphs:
            prog.capture(self._graph_pool, self._capture_stream,
                         self.generator)
        t1 = time.perf_counter()
        self._programs[key] = prog
        self._watchdog.record(key[0], t1 - t0, self._steps, t1)
        return out

    def program_cache_sizes(self) -> Dict[str, int]:
        """Programs built per name: ``step`` always, ``mixed`` (one per
        admitting slot) once the first mixed step ran, the keys of the
        JAX engine's dict. Steady serving keeps every count flat."""
        out = {"step": 0}
        for name, *_ in self._programs:
            out[name] = out.get(name, 0) + 1
        return out

    def mark_steady(self) -> None:
        """Arm the recompile watchdog without touching stats: every later
        program build is a steady-state regression (``RecompileWarning``
        and the ``steady_compiles`` counter). ``reset_stats()`` arms it
        too."""
        self._watchdog.arm()

    def _decode(self) -> torch.Tensor:
        """Plain step body: decode + sample + slot bookkeeping on device,
        the decode state updated in place; the sampler logits carry the
        poison lane. Returns (B, 2) int64: each row's sampled token and
        its emit count (1). A paged engine
        decodes through a masked T=1 extend (per row the same arithmetic
        as ``decode_step``), so rows the device already finished neither
        write into pages nor advance: provisioning stays an upper bound
        on real writes."""
        active, remaining = self.active, self.remaining
        if self.paged:
            logits, _ = self.model.extend_into_cache(
                self.params, self.tokens, self.cache, active.to(torch.int32),
                last_only=True)
        else:
            logits, _ = self.model.decode_step(self.params, self.tokens,
                                               self.cache)
        nxt, bad = _guarded_sample(
            self.sampler, self.generator,
            logits[:, -1].float() + self._poison[:, None])
        done = active & (bad | (remaining <= 1) | (nxt == self.eos))
        new_remaining = torch.where(active, remaining - 1, remaining)
        new_active = active & ~done
        self.remaining.copy_(new_remaining)
        self.active.copy_(new_active)
        # the next step embeds these: an ERR_TOKEN row (now inactive)
        # feeds a valid id instead, the trace keeps the sentinel
        self.tokens.copy_(nxt.clamp(min=0)[:, None])
        return torch.stack([nxt, torch.ones_like(nxt)], dim=1)

    def _mixed(self, slot: int) -> torch.Tensor:
        """Mixed step body for an admission into ``slot``: decode every
        active slot, advance the slot by the staged chunk at batch 1
        through the view ``cache[:, slot:slot+1]`` (the writes land in
        the batched cache; page pools pass whole and the chunk's K/V
        goes through the slot's block-table row), sample all rows at
        once (the logits carry the poison lane) and arm the slot when its
        prompt is complete. Reads the
        chunk and its scalars from the staging buffer (``_stage_chunk``).
        Returns (B, 2) int64: tokens and emit counts."""
        C = self.prefill_chunk
        st = self._stage
        n, last, a_rem, a_eos = st[C:C + 1], st[C + 1], st[C + 2], st[C + 3]
        active, remaining, eos = self.active, self.remaining, self.eos
        is_admit = self._rows == slot
        dec_logits, _ = self.model.extend_into_cache(
            self.params, self.tokens, self.cache, active.to(torch.int32),
            last_only=True)
        ch_logits, _ = self.model.extend_into_cache(
            self.params, st[:C][None], _slot_view(self.cache, slot),
            n.to(torch.int32), last_only=True)
        logits = torch.where(is_admit[:, None], ch_logits[0, 0][None],
                             dec_logits[:, 0])
        nxt, bad = _guarded_sample(self.sampler, self.generator,
                                   logits.float() + self._poison[:, None])
        arm = is_admit & (last != 0)
        emit = active | arm
        done = emit & (bad | (torch.where(arm, a_rem, remaining) <= 1)
                       | (nxt == torch.where(arm, a_eos, eos)))
        new_remaining = torch.where(
            arm, a_rem - 1, torch.where(active, remaining - 1, remaining))
        new_eos = torch.where(arm, a_eos, eos)
        new_tokens = torch.where(emit, nxt.clamp(min=0), self.tokens[:, 0])
        self.active.copy_(emit & ~done)
        self.remaining.copy_(new_remaining)
        self.eos.copy_(new_eos)
        self.tokens.copy_(new_tokens[:, None])
        return torch.stack([nxt, emit.to(nxt.dtype)], dim=1)

    def _stage_chunk(self, adm: _Admission, n: int) -> bool:
        """Write the admission's next chunk (its ``n`` valid tokens) and
        its scalars into one host vector and copy it into the staging
        buffer: from pinned memory without blocking on the card (a fresh
        pinned block each step: the host allocator reuses one only after
        its copy ran). Returns whether the chunk ends the prompt."""
        C = self.prefill_chunk
        last = adm.base + n >= adm.length
        req = adm.req
        host = torch.zeros((C + 4,), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        buf[:n] = adm.tokens[adm.base:adm.base + n]
        buf[C:] = (n, last, req.max_new_tokens - adm.n_done,
                   -1 if req.eos_id is None else int(req.eos_id))
        self._stage.copy_(host, non_blocking=True)
        return last

    def _reset_slot(self, b: int) -> None:
        """Erase slot ``b``: every position empty, depth 0, so a recycled
        slot keeps no stale keys from its previous occupant. An SSM
        sub-cache has no positions to mask a previous occupant behind:
        its state, conv tail, depth and checkpoints are zeroed."""
        for sub in self.cache.values():
            if "pos" in sub:
                sub["pos"][:, b] = -1
                sub["step"][:, b] = 0
            else:
                for leaf in sub.values():
                    leaf[:, b] = 0

    # ------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        """Validate and enqueue. Malformed requests raise ``ValueError``
        here, with the violated constraint spelled out."""
        self._validate(req)
        req.submitted_s = time.perf_counter()
        if req.deadline_s is not None:
            self._deadline_armed = True
        if self.recorder.enabled:
            self.recorder.on_submit(req)
        self.queue.append(req)
        self.requests[req.uid] = req
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
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"request {req.uid}: deadline_s must be positive, got "
                f"{req.deadline_s}")
        if req.embeddings is not None:
            raise _not_ported("frontend embeddings", "10 (other families)")
        old = self.responses.get(req.uid)
        if old is not None and not old.finished:
            raise ValueError(f"request uid {req.uid} is already in flight")
        if prompt.size > self.kv_len and (
                self.paged or not self.model.cfg.sliding_window):
            # a sliding-window ring serves longer prompts (the window
            # mask hides overwritten context); full attention and paged
            # caches cannot: the overwrite would drop attended positions
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

    def _eff_len(self, req: Request) -> int:
        """Length of the request's effective token stream: the prompt plus
        any tokens generated before a preemption (replayed on resume)."""
        resp = self.responses.get(req.uid)
        if resp is None or resp.finished:
            return len(req.prompt)
        return len(req.prompt) + len(resp.tokens)

    def _admit_fits(self, req: Request) -> bool:
        """Paged admission backpressure: admit only when the pool can
        hold the whole effective stream plus the first decode write;
        otherwise the head of the queue waits (and nothing behind it is
        admitted either)."""
        return not self.paged or self._paged.can_admit(self._eff_len(req))

    def _fill_free_slots(self) -> None:
        """Admission scheduler (FIFO head): the head of the queue starts a
        chunked admission when a slot is free (at most one in flight)
        and, when paged, the pool can hold it. A head that outranks a
        live stream may preempt it when the slot table or the pool is
        short: the victim requeues right behind the displacing request
        (never ahead, which would livelock) and resumes later by
        replay."""
        while self.queue and self._admit is None:
            req = self.queue[0]
            b = self._free_slot()
            if b is None or not self._admit_fits(req):
                if self._outranked(req) and self._preempt_one(
                        below=req.priority, requeue_pos=1):
                    continue
                return
            self._start_chunked(self.queue.popleft(), b)

    def _outranked(self, req: Request) -> bool:
        """Cheap pre-check (no device sync) for priority displacement:
        some occupied slot runs at strictly lower priority than ``req``.
        A chunked admission in flight blocks displacement: the head could
        not admit into the freed slot until it completes."""
        if self._admit is not None:
            return False
        return any(r is not None and r.priority < req.priority
                   for r in self.slots)

    def _start_chunked(self, req: Request, b: int) -> None:
        """Begin a chunked admission into slot ``b``. A preempted request
        re-admits through this same path: its effective stream is the
        prompt plus the tokens it had already generated, replayed chunk
        by chunk, and it is armed with the budget it has left."""
        req.started_s = req.started_s or time.perf_counter()
        resp = self.responses.get(req.uid)
        done = resp.tokens if resp is not None else []
        toks = np.asarray(req.prompt, np.int64)
        if done:
            toks = np.concatenate([toks, np.asarray(done, np.int64)])
        self._reset_slot(b)
        if self.paged:
            self._paged.release_slot(b)
            self._depth_ub[b] = 0
        self._admit = _Admission(req=req, slot=b, base=0,
                                 length=len(toks), tokens=toks,
                                 n_done=len(done))
        if self.recorder.enabled:
            self.recorder.on_admission(req, b, 0, "chunked")

    # ------------------------------------------------------------ #
    # lifecycle control: cancel / deadlines / preempt-and-requeue
    # ------------------------------------------------------------ #
    def cancel(self, uid: int) -> bool:
        """Cancel a request in any live state: queued, mid-admission or
        active. Tokens already produced stay in the response; the slot
        and (paged) its pages are released at once and ``finish_reason``
        reads "cancelled". An active slot is polled first (its tokens
        on the device are committed) and then deactivated in place.
        Returns True if the request was live, False when it is unknown
        or had already finished."""
        req = self.requests.get(uid)
        resp = self.responses.get(uid)
        if req is None or resp is None or resp.finished:
            return False
        now = time.perf_counter()
        if req in self.queue:
            self.queue.remove(req)
            self._finish_request(req, "cancelled", now)
            self._c_cancel.inc()
            return True
        if self._admit is not None and self._admit.req.uid == uid:
            self._abort_admission("cancelled", now)
            self._c_cancel.inc()
            return True
        for b, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._poll()       # commit tokens already produced...
                if resp.finished:  # ...which may have finished it first
                    return False
                self._release_active_slot(b)
                self._finish_request(req, "cancelled",
                                     time.perf_counter())
                self._c_cancel.inc()
                return True
        return False

    def _finish_request(self, req: Request, reason: str,
                        now: float) -> None:
        resp = self.responses[req.uid]
        resp.finished = True
        resp.finish_reason = reason
        req.finished_s = now
        if self.recorder.enabled:
            self.recorder.on_finish(req, reason, now)

    def _release_active_slot(self, b: int) -> None:
        """Tear down an occupied slot, keeping its harvested tokens:
        deactivate the device row in place (masked steps then neither
        write KV nor advance it; no program is rebuilt), detach the
        request and, when paged, return its pages to the pool."""
        self.active[b].fill_(False)
        self.slots[b] = None
        self._slot_start[b] = self._steps
        if self.paged:
            self._paged.release_slot(b)
            self._depth_ub[b] = 0

    def _abort_admission(self, reason: str, now: float) -> None:
        """Tear down the in-flight chunked admission: its slot was never
        attached nor armed on the device, so only the pages provisioned
        for it go back."""
        adm, self._admit = self._admit, None
        if self.paged:
            self._paged.release_slot(adm.slot)
            self._depth_ub[adm.slot] = 0
        self._finish_request(adm.req, reason, now)

    def _enforce_deadlines(self, include_active: bool = True) -> None:
        """Finish every request past its absolute deadline with
        ``finish_reason="timeout"``, keeping partial tokens. Runs at tick
        boundaries: before admission with ``include_active=False``
        (queued and admitting only: an active slot may hold tokens not
        yet harvested) and right after each poll with the full sweep."""
        now = time.perf_counter()
        for req in [r for r in self.queue if r.deadline_abs() <= now]:
            self.queue.remove(req)
            self._finish_request(req, "timeout", now)
            self._c_timeout.inc()
        if self._admit is not None \
                and self._admit.req.deadline_abs() <= now:
            self._abort_admission("timeout", now)
            self._c_timeout.inc()
        if not include_active:
            return
        for b, r in enumerate(self.slots):
            if r is not None and r.deadline_abs() <= now:
                self._release_active_slot(b)
                self._finish_request(r, "timeout", now)
                self._c_timeout.inc()

    def _select_victim(self, exclude=(),
                       below: Optional[int] = None) -> Optional[int]:
        """The slot to preempt: lowest priority first, then latest
        deadline (none counts as latest), then lowest slot index. Only
        streams that can resume qualify (the effective stream plus one
        decode write still fits the KV ring). ``below`` restricts victims
        to priorities strictly below it (priority displacement)."""
        best = None
        for b, r in enumerate(self.slots):
            if r is None or b in exclude:
                continue
            if below is not None and r.priority >= below:
                continue
            if self._eff_len(r) + 1 > self.kv_len:
                continue           # too long to replay: not resumable
            key = (r.priority, -r.deadline_abs(), b)
            if best is None or key < best[0]:
                best = (key, b)
        return None if best is None else best[1]

    def _preempt_one(self, exclude=(), below: Optional[int] = None,
                     requeue_pos: int = 0) -> bool:
        """Preempt-and-requeue one victim stream: poll first so every
        token the device already produced is committed, release the
        victim's slot and pages, and requeue it (position 0 = the front;
        1 = right behind a displacing higher-priority head). Returns
        False when no resumable victim exists."""
        self._poll()
        b = self._select_victim(exclude=exclude, below=below)
        if b is None:
            return False
        req = self.slots[b]
        self._release_active_slot(b)
        req.preemptions += 1
        self._c_preempt.inc()
        if self.recorder.enabled:
            self.recorder.on_preempt(req, b, time.perf_counter())
        pos = min(requeue_pos, len(self.queue))
        if pos <= 0:
            self.queue.appendleft(req)
        else:
            self.queue.insert(pos, req)
        return True

    # ------------------------------------------------------------ #
    # fault sites
    # ------------------------------------------------------------ #
    def _fire(self, site: str, **ctx):
        """Ask the fault schedule whether ``site`` fails here (None when
        nothing is scheduled). Fired faults count into
        ``faults_injected`` and the recorder's fault lane."""
        spec = self.faults.fire(site, **ctx)
        if spec is not None:
            self._c_faults.inc()
            if self.recorder.enabled:
                self.recorder.on_fault(site, self._steps,
                                       time.perf_counter())
        return spec

    def _set_poison(self, b: int) -> None:
        """Arm the ``nan_logits`` fault: NaN into row ``b`` of the poison
        lane for the next dispatched step, written in place outside any
        program (no build, no host sync)."""
        self._poison[b % self.max_batch].fill_(float("nan"))

    def _clear_poison(self) -> None:
        self._poison.zero_()

    # ------------------------------------------------------------ #
    # paged provisioning (host allocator <-> device page pools)
    # ------------------------------------------------------------ #
    def _provision(self, slot: int, start: int, n: int) -> bool:
        """Make the pages behind positions [start, start+n) of ``slot``
        privately writable before a dispatched step (allocate missing
        pages, copy-on-write split shared ones). Exhaustion, real or
        forced by the ``page_alloc`` fault site, degrades: poll (a
        finished slot may hold pages), then preempt-and-requeue a victim;
        only a pool that cannot hold the live set raises.
        Returns False when it polled or preempted: the poll's shrink may
        have reclaimed headroom provisioned for other slots this round,
        so callers rebuild their provisioning pass. A poll may also have
        finished ``slot`` itself; then nothing is allocated for it (the
        JAX engine allocates the pages anyway and holds them until the
        slot is reused)."""
        clean, polled = True, False
        while True:
            if not clean and self.slots[slot] is None and (
                    self._admit is None or self._admit.slot != slot):
                return False
            forced = self.faults.enabled and self._fire(
                "page_alloc", step=self._steps, slot=slot)
            if not forced:
                try:
                    copies = self._paged.prepare_write(slot, start, n)
                    break
                except paged_kv.PagePoolExhausted:
                    pass
            clean = False
            if not polled:
                polled = True
                self._poll()
                continue
            if self._preempt_one(exclude={slot}):
                continue
            if forced:
                # the forced exhaustion outlived every rung; unlike a
                # real one it freed nothing, so consult the actual pool
                # before declaring the ladder dead
                try:
                    copies = self._paged.prepare_write(slot, start, n)
                    break
                except paged_kv.PagePoolExhausted:
                    pass
            raise RuntimeError(
                f"KV page pool exhausted mid-decode (slot {slot}, "
                f"positions [{start}, {start + n})) with no resumable "
                f"victim to preempt")
        if copies:
            self._copy_pages(copies)
        return clean

    def _copy_pages(self, copies) -> None:
        """Copy-on-write splits: duplicate the shared pool pages on the
        device before the write that would have mutated them through an
        alias (an index copy on every pool leaf)."""
        dev = self.device
        src = torch.tensor([s for s, _ in copies], dtype=torch.long,
                           device=dev)
        dst = torch.tensor([d for _, d in copies], dtype=torch.long,
                           device=dev)
        for sub in self.cache.values():
            for k in paged_kv.POOL_KEYS:
                if k in sub:
                    sub[k][:, dst] = sub[k][:, src]

    def _push_block_tables(self) -> None:
        """Copy the host-authoritative block tables into every attention
        sub-cache's ``bt`` leaf when they changed. The allocator mutates
        its table in place at the next provisioning, so the upload takes
        a fresh pinned copy each time and stays asynchronous: no host
        sync between polls."""
        if not self._paged.dirty:
            return
        bt = torch.from_numpy(self._paged.block_tables.copy())
        if self.device.type == "cuda":
            bt = bt.pin_memory().to(self.device, non_blocking=True)
        for sub in self.cache.values():
            sub["bt"].copy_(bt[None].expand_as(sub["bt"]))
        self._paged.dirty = False

    def _provision_decode_rows(self, per_row: int) -> bool:
        """Provision ``per_row`` decode writes for every occupied slot
        (an upper bound: rows the device already finished write nothing;
        the poll's shrink reclaims the overshoot). One degraded
        ``_provision`` aborts the round; callers loop until a round runs
        clean."""
        for b, r in enumerate(self.slots):
            if r is not None:
                if not self._provision(b, self._depth_ub[b], per_row):
                    return False
                self._depth_ub[b] += per_row
        return True

    # ------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------ #
    def step(self) -> None:
        """One engine step (plain or mixed): device work only; tokens,
        finish flags and counters stay on the device. The ``slow_step``
        and ``nan_logits`` fault sites fire first; a poisoned row is
        cleared after the dispatch."""
        t0 = time.perf_counter()
        n0 = self._steps
        poisoned = False
        if self.faults.enabled:
            spec = self._fire("slow_step", step=self._steps)
            if spec is not None and spec.delay_s > 0:
                time.sleep(spec.delay_s)
            spec = self._fire("nan_logits", step=self._steps)
            if spec is not None:
                self._set_poison(spec.slot or 0)
                poisoned = True
        if self._admit is None and self.queue:
            # pipeline the next admission mid-burst
            b = self._free_slot()
            if b is not None and self._admit_fits(self.queue[0]):
                self._start_chunked(self.queue.popleft(), b)
        if self._admit is not None:
            self._step_mixed(self._admit)
        else:
            self._step_plain()
        if poisoned:
            self._clear_poison()
        made = self._steps - n0
        dt = (time.perf_counter() - t0) / max(made, 1)
        for _ in range(made):
            self.step_times.append(dt)

    def _step_plain(self) -> None:
        if self.paged:
            while not self._provision_decode_rows(1):
                pass
            self._push_block_tables()
        self._push_trace(self._run_program(("step",), self._decode))
        self._record_step("plain")

    def _push_trace(self, rec: torch.Tensor) -> None:
        self._trace.append((rec[:, :1], rec[:, 1]))

    def _step_mixed(self, adm: _Admission) -> None:
        n = min(self.prefill_chunk, adm.length - adm.base)
        if self.paged:
            while True:
                if not self._provision_decode_rows(1):
                    continue
                if self._provision(adm.slot, adm.base, n):
                    break
            self._depth_ub[adm.slot] = adm.base + n
            self._push_block_tables()
        last = self._stage_chunk(adm, n)
        slot = adm.slot
        self._push_trace(self._run_program(("mixed", slot),
                                           lambda: self._mixed(slot)))
        if self.recorder.enabled:
            self.recorder.on_chunk(adm.req, slot, adm.base, adm.base + n,
                                   last)
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
                if self.recorder.enabled:
                    self.recorder.on_first_token(req, now)
        self._await_first.clear()

    def _poll(self) -> None:
        """The periodic host sync: read the unconsumed suffix of the
        trace back in two transfers (counted in ``trace_polls``), harvest
        each occupied slot's tokens and prune the trace. Finish detection
        replays the device's stop conditions on the harvested tokens."""
        if not self._trace:
            self._sample_occupancy()
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
            self._c_polls.inc()
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
        if self.paged:
            # the harvested trace reveals each live slot's true committed
            # depth (prompt + generated - 1 pending): release the pages
            # the provisioning upper bound ran ahead by
            for b, r in enumerate(self.slots):
                if r is not None:
                    nt = len(self.responses[r.uid].tokens)
                    if nt:
                        depth = len(r.prompt) + nt - 1
                        self._paged.shrink(b, depth)
                        self._depth_ub[b] = depth
            if __debug__:
                self._paged.check_invariants()
        self._sample_occupancy()

    def _sample_occupancy(self) -> None:
        """Refresh the poll-time gauges (live occupancy, queue depth,
        pool pressure, KV bytes per live token) and feed the recorder's
        counter lanes, from host state only: the page allocator and the
        slot table are host-authoritative."""
        m = self.metrics
        active = self.active_slots
        m.gauge("active_slots").set(active)
        m.gauge("queue_depth").set(len(self.queue))
        pool: Dict[str, float] = {}
        if self.paged:
            ps = self._paged.stats()
            pool["kv_pages_live"] = ps["kv_pages_live"]
            pool["kv_pages_free"] = ps["kv_pages_free"]
            m.gauge("kv_pages_free").set(ps["kv_pages_free"])
            live_tok = ps["kv_pages_live"] * self.page_size
        else:
            live_tok = sum(
                len(r.prompt) + len(self.responses[r.uid].tokens)
                for r in self.slots if r is not None)
        if live_tok:
            if self._kv_nbytes is None:
                self._kv_nbytes = sum(t.nbytes for sub in self.cache.values()
                                      for t in sub.values())
            m.gauge("kv_bytes_per_live_token").set(
                self._kv_nbytes / live_tok)
        if self.recorder.enabled:
            self.recorder.on_poll(time.perf_counter(), active, pool)

    def _harvest(self, b: int, col: List[int],
                 gaps: List[Optional[float]]) -> None:
        """Append slot ``b``'s sampled tokens host-side, cut at the stop
        condition the device applied (it kept decoding the finished slot
        until this poll). The first token of a request is TTFT, not ITL."""
        req = self.slots[b]
        resp = self.responses[req.uid]
        done = False
        n0 = len(resp.tokens)
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
        appended = len(resp.tokens) - n0
        if appended:
            self._c_tokens.inc(appended)
            if self.recorder.enabled:
                self.recorder.on_emit(req, b, appended, time.perf_counter())
        if done:
            resp.finished = True
            req.finished_s = time.perf_counter()
            if self.recorder.enabled:
                self.recorder.on_finish(req, resp.finish_reason,
                                        req.finished_s)
            self.slots[b] = None
            if self.paged:
                # the stream's pages return to the free list
                self._paged.release_slot(b)
                self._depth_ub[b] = 0
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
        (default ``sync_every``) and one poll, with deadline sweeps before
        admission (queued and admitting requests) and after the poll
        (every request). Returns the steps run."""
        k = self.sync_every if steps is None else max(1, steps)
        if self._deadline_armed:
            self._enforce_deadlines(include_active=False)
        self._fill_free_slots()
        if not (self.active_slots or self._admit is not None):
            self._poll()
            if self._deadline_armed:
                self._enforce_deadlines()
            return 0
        t0 = t_begin = time.perf_counter()
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
        if self.recorder.enabled and self._steps > ran0:
            # the steps lane: each step ends at its wall stamp and starts
            # at its predecessor's (the burst's start for the first)
            spans = []
            for g in range(ran0, self._steps):
                w = g - self._step_wall_base
                start = self._step_wall[w - 1] if w > 0 else t_begin
                spans.append((start, self._step_wall[w],
                              self.step_kinds[g - self._kinds_base]))
            self.recorder.on_steps(spans)
        self._stamp_first_tokens(t1)
        self._poll()
        if self._deadline_armed:
            self._enforce_deadlines()
        self._maybe_profile()
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
        self._stop_profile()
        return self.responses

    def reset_stats(self) -> None:
        """Forget timing and finished-request history (cache state and
        the step programs are kept): for benchmarks that warm an engine
        up, then measure. Also arms the recompile watchdog, as
        ``mark_steady()`` does: the warm-then-measure boundary is where
        steady state begins."""
        self.metrics.reset()
        self._kinds_base = self._steps
        self._watchdog.arm()
        self._drop_compile_step = False
        for uid in [u for u, r in self.responses.items() if r.finished]:
            del self.responses[uid]
            self.requests.pop(uid, None)
        if self.paged:
            pk = self._paged
            pk.alias_pages = pk.cow_splits = pk.pages_released = 0

    # ------------------------------------------------------------ #
    # trace / profiler export
    # ------------------------------------------------------------ #
    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Export the recorded request-lifecycle trace as a Chrome
        trace-event object (written as JSON to ``path`` when given); see
        ``serving/tracing.py`` for the lanes. Requires a tracing recorder
        (``Engine(..., recorder=True)``)."""
        exp = getattr(self.recorder, "export_chrome_trace", None)
        if exp is None:
            raise RuntimeError(
                "export_trace needs a tracing recorder: build the "
                "engine with recorder=True (or a tracing.Tracer)")
        return exp(path)

    def _maybe_profile(self) -> None:
        """Drive the ``torch.profiler`` window of ``trace_dir=``: start
        after the first step (so the first builds do not dominate it),
        stop after ``profile_steps`` steps. A profiler that cannot start
        (another one running, a directory that cannot be written)
        disables the window, never the run."""
        if not self._trace_dir or self._prof_done:
            return
        if self._prof is None:
            if self._steps >= 1:
                try:
                    from torch.profiler import ProfilerActivity, profile
                    acts = [ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        acts.append(ProfilerActivity.CUDA)
                    prof = profile(activities=acts)
                    prof.start()
                    self._prof, self._prof_base = prof, self._steps
                except Exception:
                    self._prof_done = True
        elif self._steps - self._prof_base >= self._profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close the profiler window and write its Chrome trace into
        ``trace_dir`` (``profile_trace`` names the file)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._prof_done = True
        try:
            self._sync()
            prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            path = os.path.join(
                self._trace_dir,
                f"engine_{os.getpid()}_{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.profile_trace = path
        except Exception:
            pass

    def latency_stats(self) -> Dict[str, float]:
        """Latency summary. The ``decode_ms_*`` / ``ttft_ms_*`` /
        ``itl_ms_*`` keys are present only when their stream has at least
        one sample; the ``kv_*`` pool keys only on a paged engine."""
        drop = 1 if self._drop_compile_step else 0
        finished = [r for r in self.responses.values() if r.finished]
        stats: Dict[str, float] = {
            "n_finished": len(finished),
            "tokens_generated": sum(r.n_generated for r in finished),
            "fallback_admissions": self._c_fallback.value,
            "decode_steps": self._steps,
            "prefill_chunk": self.prefill_chunk,
            "chunked_admissions": self._c_admissions.value,
            "preemptions": self._c_preempt.value,
            "timeouts": self._c_timeout.value,
            "cancellations": self._c_cancel.value,
            "slot_errors": self._c_errors.value,
            "faults_injected": self._c_faults.value,
        }
        telemetry.pct_stats(stats, "decode_ms", self.step_times[drop:],
                            (50, 99))
        telemetry.pct_stats(stats, "ttft_ms", self._h_ttft.values,
                            (50, 95, 99))
        telemetry.pct_stats(stats, "itl_ms", self._h_itl.values,
                            (50, 95, 99))
        if self.paged:
            stats.update(self._paged.stats())
        return stats
