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
The page-table push, copy-on-write page copies, slot resets and the
prefix cache's copies stay eager, outside the programs: they write in
place into the cache's persistent leaves, which the graphs read, so a
prefix hit builds no program (the JAX engine jits a materialize program
per hit length instead).

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

With ``prefix_cache_tokens > 0`` (attention-only stacks) a host-side
trie (``serving/prefix_cache.py``) keeps the KV of recently admitted
prompt heads. A request whose stream starts with a stored head resumes
chunked admission after it: on the rings the entry's K/V (and int8
scales) are copied into the slot in place and its position row stamped;
on the paged pool the slot's block table aliases the entry's pages
(refcount bumps, no copy). A first admission publishes its prompt's
bucketed head: a clone of the slot's K/V on the rings, a pin of its
pages on the pool. Under page pressure the ladder evicts LRU entries
before it polls or preempts.

Speculative decoding (``draft=`` / ``spec_gamma=``, or ``cfg.draft``):
every step is a **spec step**, one program that proposes ``gamma``
tokens a row, scores ``[pending, proposals]`` in one masked target
forward (``Model.verify_step``'s window), accepts a prefix on device
(``Sampler.speculative``; greedy output equals plain decode) and rolls
every cache back to the committed depth. The drafter is a self-draft
(``quant/self_draft.py``: ``"int8@1"`` and the like; its cache lags the
committed depth by one position, so its first proposal comes from the
window ``[prev, pending]`` and the rest from ``gamma - 1`` single-token
decodes) or ``"ngram"`` (``serving/ngram_draft.py``: proposals from the
slot's own stream, kept on the device as ``hist``; no draft cache, so an
SSM stack speculates too, committing by checkpoint restore and a replay
of the accepted prefix inside the same program). Admission then runs as
its own **admit chunk** program (target, and the lagging draft one
position short), dispatched right before the spec step. A spec step
emits up to ``gamma + 1`` tokens a row, so every trace record is that
wide, and the poll comes ``gamma + 1`` times less often. In spec mode
the prefix cache is off, as in the JAX engine.

Frontend requests (``Request.embeddings``, (n_tokens, d_embed) frames
or patches), as in the JAX engine: after the slot's reset an
encoder-decoder encodes the frames once and writes every layer's
cross-attention K/V into the slot's rows of the cache's ``xk``/``xv``,
which every later chunk and decode reads untouched; a VLM runs its
prefix through the masked extend as one embedding chunk, so its text
starts at position ``n_tokens`` (and a prompt may take ``kv_len -
n_tokens`` tokens). Both are admission programs (``encode``, one for
every slot; ``embed_chunk``, one a slot), CUDA graphs on the card
captured at their first call, that read a static frames buffer and
write the cache in place (``_admit_frontend``);
``program_cache_sizes()`` leaves them out, as JAX's leaves its slot
programs out. An encoder-decoder
request must carry frames; frames need a frontend of that shape, and
the paged pool (token-only, as in JAX) refuses them; embeddings
requests skip the prefix cache; model-draft speculation refuses an
encoder-decoder (n-gram speculation serves it).

On a serving mesh (``mesh=``: a ``launch.mesh.Mesh``, a spec string
for ``make_serving_mesh``, or None to follow ``cfg.mesh``; one process a
rank, under ``torchrun``) every rank runs this same host scheduler on
the same requests, so every rank makes the same decisions. Params are
placed leaf by leaf by ``distribution.sharding.param_shardings`` and the
cache by ``cache_shardings``: each rank holds its block (weights and KV
heads split over the model axis). The decode state and the slots are
split over the data axis as ``batch_shardings`` places them: data rank
d holds slots ``[d * B_loc, (d + 1) * B_loc)``, and its step programs
run on those rows alone, with the mesh current, so the model's layers
issue their collectives over the model group (``models/layers.py``).
Each step's record is ``all_gather``ed over the data group inside the
program, so every host sees every slot's tokens and finish flags. A
chunked admission runs only in the data group that owns the slot (the
others take a plain step, or in spec mode an idle record); the model
groups stay in lockstep, since a model group lies inside one data
group. A prefix-cache entry is a slot's K/V on the rank's heads,
``broadcast`` from the owning data rank over the data group, so every
rank stores it (JAX replicates it over data) and a hit copies locally.
On the card the steps are CUDA graphs with the NCCL collectives inside:
the communicators are warmed eagerly first, on the capture stream. The
SSM, hybrid, encoder-decoder and VLM families and the paged pool on a
mesh wait for ROADMAP section 1, item 13b.
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
from repro_torch.core.program import capture, capture_stream
from repro_torch.distribution import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model, build
from repro_torch.serving import faults as faults_mod
from repro_torch.serving import paged_kv, telemetry
from repro_torch.serving.ngram_draft import ngram_propose
from repro_torch.serving.prefix_cache import PrefixCache
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


def _finite_rows(logits):
    """Zero the logit rows that are not finite (the draft-side guard:
    proposals from a poisoned draft row are garbage that the target's
    verify rejects; zeroing keeps sampling and the accept ratio
    defined)."""
    ok = torch.isfinite(logits).all(dim=-1, keepdim=True)
    return torch.where(ok, logits, torch.zeros_like(logits))


def _slot_view(cache, slot: int):
    """Slot ``slot``'s batch-1 view of the stacked cache: every per-slot
    leaf sliced ``[:, slot:slot+1]`` (the encoder-decoder's bare
    ``xk``/``xv`` memory tensors too); page pools
    (``paged_kv.POOL_KEYS``) pass through whole, since slicing them would
    cut the page axis. The view's writes land in the batched cache."""
    return {name: {k: v if k in paged_kv.POOL_KEYS
                   else v[:, slot:slot + 1] for k, v in sub.items()}
            if isinstance(sub, dict) else sub[:, slot:slot + 1]
            for name, sub in cache.items()}


#: the step programs ``program_cache_sizes`` counts (the JAX engine's keys)
_STEP_PROGRAMS = ("step", "mixed", "admit_chunk")

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
        self.collectives: Dict[str, int] = {}

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
        with mesh_mod.recorded_collectives() as collectives:
            out, launches = capture(self.body,
                                    self._recording(graph, pool, stream))
        self.graph, self.out, self.launches = graph, out, launches
        self.collectives = collectives

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.body()
        self.graph.replay()
        kernels.add_launches(self.launches)
        mesh_mod.add_collectives(self.collectives)
        return self.out.clone()


@dataclasses.dataclass
class _Admission:
    """One in-flight chunked admission: ``tokens`` enter the slot
    ``prefill_chunk`` per mixed step, ``base`` of them so far (it starts
    past the head a prefix-cache hit served). ``tokens`` is the prompt
    plus, when resuming a preempted request (``resumed``), the
    ``n_done`` tokens it had already generated: replaying them through
    the same extend path makes the resumed stream's next tokens those of
    an unpreempted run (greedy)."""
    req: Request
    slot: int
    base: int
    length: int
    tokens: np.ndarray
    n_done: int = 0
    resumed: bool = False


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
        chunk). ``prefix_cache_tokens``: the shared-prefix KV budget in
        tokens (None follows ``cfg.prefix_cache_tokens``, 0 is off); an
        SSM stack builds no prefix cache, as in the JAX engine.
        ``paged=True`` serves from a pool of ``num_pages`` pages
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
        ``draft``: a self-draft spec (``"int8@1"``, see
        ``quant.self_draft``), ``"ngram"`` for the prompt-lookup drafter,
        a ``(draft_model, draft_params)`` pair, or None to follow
        ``cfg.draft``; ``spec_gamma``: tokens proposed a step (0 follows
        ``cfg.spec_gamma``, 4 once a draft is set). A model draft needs
        caches that rewind without replay on both sides (attention-only
        stacks); the n-gram drafter serves every family. ``mesh``: a
        ``launch.mesh.Mesh``, a spec string (``"auto"``, ``"2,4"``; ``""``,
        ``"none"`` and ``"off"`` turn it off) or None to follow
        ``cfg.mesh``; the model's params are whole on every rank and the
        engine keeps each rank's block."""
        if kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"unsupported kv_cache_dtype "
                             f"{kv_cache_dtype!r} (use '' or 'int8')")
        if kv_cache_dtype == "int8" and not model.cfg.kv_quant:
            model = build(model.cfg.replace(kv_quant=True), model.device)
        cfg = model.cfg
        pct = cfg.prefix_cache_tokens if prefix_cache_tokens is None \
            else prefix_cache_tokens
        mesh_src = cfg.mesh if mesh is None else mesh
        if isinstance(mesh_src, str):
            mesh_src = None if mesh_src in ("", "none", "off") \
                else mesh_mod.make_serving_mesh(mesh_src)
        self.mesh = mesh_src
        if self.mesh is not None:
            if cfg.family not in ("dense", "moe"):
                raise _not_ported(f"the {cfg.family} family on a serving "
                                  f"mesh", "13b")
            if paged:
                raise _not_ported("the paged KV pool on a serving mesh",
                                  "13b")
        self.model = model
        self.params = self._place(params)
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
        # a VLM's prompt carries its frontend prefix in the same rows
        self._prefix = model.frontend_prefix
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
        self._c_spec_emitted = self.metrics.counter("spec_tokens_emitted")
        self._c_spec_steps = self.metrics.counter("spec_active_steps")
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
        # the slots this rank's device state holds: [_b0, _b0 + _bl)
        # (all of them off a mesh, or when the batch does not divide the
        # data axis and batch_shardings replicates it)
        self._data_split = self.mesh is not None and sharding.batch_shardings(
            (max_batch,), self.mesh)[0] is not None
        self._bl = max_batch // self.mesh.axis_size("data") \
            if self._data_split else max_batch
        self._b0 = self.mesh.axis_index("data") * self._bl \
            if self._data_split else 0
        # the batch steps sample this rank's rows with the noise one
        # device gives them (``Sampler.rows``); a batch-1 admission
        # samples with ``self.sampler``
        self._row_sampler = dataclasses.replace(
            self.sampler, rows=(max_batch, self._b0)) \
            if self._data_split else self.sampler
        self.requests: Dict[int, Request] = {}
        self.responses: Dict[int, Response] = {}
        self._admit: Optional[_Admission] = None
        self._deadline_armed = False   # a live request has deadline_s

        # --- device-resident decode state ----------------------------- #
        dev = self.device
        bl = self._bl
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.tokens = torch.zeros((bl, 1), dtype=torch.int64, device=dev)
        # spec: the token preceding the pending one (the draft cache
        # lags the committed depth by one position)
        self.prev = torch.zeros((bl, 1), dtype=torch.int64, device=dev)
        self.remaining = torch.zeros((bl,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((bl,), dtype=torch.bool, device=dev)
        self.eos = torch.full((bl,), -1, dtype=torch.int64, device=dev)
        self._rows = torch.arange(bl, device=dev)
        # the poison lane: added to every step program's sampler logits
        # (0.0 is the identity on finite values). The nan_logits site
        # writes NaN into one row for one step, in place: the tensor is
        # never rebound, so the captured graphs read it on every replay
        self._poison = torch.zeros((bl,), dtype=torch.float32, device=dev)

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
            self.cache = self._place_cache(model.make_cache(max_batch,
                                                            cache_len))

        # --- speculative decoding ------------------------------------- #
        draft_src = draft if draft is not None else (cfg.draft or None)
        gamma = spec_gamma or cfg.spec_gamma
        if draft_src is not None and gamma == 0:
            gamma = 4
        if gamma and draft_src is None:
            raise ValueError("spec_gamma set but no draft configured "
                             "(pass draft=... or set cfg.draft)")
        self.spec_gamma = gamma if draft_src is not None else 0
        self._ngram = isinstance(draft_src, str) \
            and draft_src.partition("@")[0] == "ngram"
        self._draft_model: Optional[Model] = None
        self._draft_params = None
        self.draft_cache = None
        self.hist = self.hist_len = None   # the n-gram drafter's history
        self._hist_cap = 0
        if self.spec_gamma:
            if self.spec_gamma + 1 > self.kv_len:
                raise ValueError(
                    f"spec_gamma={self.spec_gamma} needs a verify window "
                    f"of {self.spec_gamma + 1} <= kv ring {self.kv_len}")
            if self._ngram:
                # each slot's effective stream, on the device so the spec
                # step stays sync-free; a trash column past the H tokens
                # takes the writes JAX drops (index H, mode="drop")
                H = self._hist_cap = 2 * self.kv_len
                self.hist = torch.full((bl, H + 1), -1,
                                       dtype=torch.int64, device=dev)
                self.hist_len = torch.zeros((bl,), dtype=torch.int64,
                                            device=dev)
            else:
                if isinstance(draft_src, str):
                    from repro_torch.quant.self_draft import make_self_draft
                    dmodel, dparams = make_self_draft(model, params,
                                                      draft_src)
                else:
                    dmodel, dparams = draft_src
                if model.rollback_needs_replay \
                        or dmodel.rollback_needs_replay:
                    raise ValueError(
                        "model-draft speculation requires caches that "
                        "rewind without replay on both sides (attention-"
                        f"backed); families {cfg.family!r} / "
                        f"{dmodel.cfg.family!r} carry recurrent state — "
                        "use draft='ngram' instead")
                if model.is_encdec:
                    raise ValueError(
                        "model-draft speculation is not wired for "
                        "encoder-decoder stacks (the draft would need "
                        "its own cross-attention memory per request) — "
                        "use draft='ngram' instead")
                self._draft_model = dmodel
                # the self-draft's params are (slices of) the target's:
                # they shard by the same rules
                self._draft_params = self._place(dparams)
                # contiguous even when the target is paged
                self.draft_cache = self._place_cache(
                    dmodel.make_cache(max_batch, cache_len))
            # a spec step emits up to gamma + 1 tokens a slot: poll that
            # much more often, so the overshoot past a finish stays the
            # same number of tokens as in plain decode
            self.sync_every = max(1, self.sync_every
                                  // (self.spec_gamma + 1))

        # --- shared-prefix KV reuse ----------------------------------- #
        # attention-only stacks, as in the JAX engine: recurrent state
        # has no per-position slices to share; off in spec mode, where
        # the draft cache would still need recomputing. On the pool
        # entries are page lists bucketed on the page size, so a hit
        # aliases whole pages, and an evicted entry drops its page
        # references (the pages outlive it while a live slot still
        # aliases them)
        self.prefix_cache: Optional[PrefixCache] = None
        if pct and not self.spec_gamma and model.supports_paged:
            if self.paged:
                self.prefix_cache = PrefixCache(
                    pct, self.page_size,
                    on_evict=lambda e: self._paged.release_pages(e["kv"]))
            else:
                self.prefix_cache = PrefixCache(pct, self.prefill_chunk)
            self.metrics.add_collector(self.prefix_cache.stats)

        # 0, 1, ..., S - 1: the position row a prefix hit stamps
        S = max((sub["pos"].shape[-1] for sub in self.cache.values()
                 if isinstance(sub, dict) and "pos" in sub), default=0)
        self._positions = torch.arange(S, dtype=torch.int32, device=dev)

        # per-step token trace on device: (block (B, W), emit count (B,),
        # whether a spec step made it) per step, harvested at the next
        # poll. W is 1, or gamma + 1 for every record in spec mode (the
        # admit chunk's one token padded), so a poll reads each part of
        # the trace back in one transfer
        self._width = self.spec_gamma + 1
        self._trace: List[Tuple[torch.Tensor, torch.Tensor, bool]] = []
        self._trace_base = 0                  # global step of _trace[0]
        self._slot_start = [0] * max_batch    # global step per slot
        self._steps = 0
        self._step_wall: List[float] = []     # per-step wall stamps (ITL)
        self._step_wall_base = 0
        self._await_first: List[Request] = []
        self._drop_compile_step = True        # step_times[0] is warm-up

        # --- step programs -------------------------------------------- #
        # the mixed step's (or admit chunk's) host values, copied in one
        # transfer a step: the chunk's C tokens, then n, last, the
        # admitted request's token budget, its eos id (-1: none), the
        # draft's chunk length and the stream's last token (the armed
        # slot's ``prev``)
        self._stage = torch.zeros((self.prefill_chunk + 6,),
                                  dtype=torch.int64, device=dev)
        # a frontend request's frames (copied in from pinned memory) and
        # the slot the encode program writes: static buffers the
        # admission programs read
        fe = cfg.frontend
        self._frames = None if fe is None else torch.zeros(
            (1, fe.n_tokens, fe.d_embed), dtype=torch.float32, device=dev)
        self._frontend_slot = torch.zeros((1,), dtype=torch.int64,
                                          device=dev)
        self._programs: Dict[Tuple[Any, ...], StepProgram] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.graphs else None
        self._capture_stream = capture_stream(dev) if self.graphs \
            else None
        if self.mesh is not None and self.graphs:
            # the communicators are made eagerly, before any capture
            self.mesh.warm(dev, self._capture_stream)

    # ------------------------------------------------------------ #
    # the mesh: this rank's blocks and slots
    # ------------------------------------------------------------ #
    def _place(self, params):
        """This rank's block of a whole params tree (the tree itself off
        a mesh)."""
        if self.mesh is None:
            return params
        return sharding.shard_tree(
            params, sharding.param_shardings(params, self.mesh), self.mesh)

    def _place_cache(self, cache):
        if self.mesh is None:
            return cache
        return sharding.shard_tree(
            cache, sharding.cache_shardings(cache, self.mesh), self.mesh)

    def _local_slot(self, b: int) -> Optional[int]:
        """Slot ``b``'s row in this rank's device state, or None when
        another data rank holds it."""
        lb = b - self._b0
        return lb if 0 <= lb < self._bl else None

    def _gather_record(self, rec: torch.Tensor) -> torch.Tensor:
        """A step's record of this rank's rows, whole over the data axis
        (``all_gather`` over the data group, inside the program)."""
        if not self._data_split:
            return rec
        return self.mesh.all_gather(rec, "data", dim=0)

    def _idle_record(self) -> torch.Tensor:
        """The admit-chunk record of a data group that does not own the
        admitting slot: every row's pending token, emitting nothing. It
        draws the noise the owner's admission sample draws, so the
        generators of all data groups stay in step."""
        if self.sampler.temperature:
            self.sampler(self.generator, torch.zeros(
                (1, self.model.cfg.vocab), device=self.device))
        g = self.spec_gamma
        rec = torch.cat([self.tokens, self.tokens.new_zeros(
            (self._bl, g + 1))], dim=1)
        return self._gather_record(rec)

    # ------------------------------------------------------------ #
    # host-side step series
    # ------------------------------------------------------------ #
    @property
    def step_times(self) -> List[float]:
        """Per-step wall clock, aligned with ``step_kinds``."""
        return self._step_series.values

    @property
    def step_kinds(self) -> List[str]:
        """"plain" | "mixed" | "admit" | "spec" per step, aligned with
        ``step_times``."""
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
        if self.mesh is not None:
            body = self._on_mesh(body, key[0] in _STEP_PROGRAMS)
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

    def _on_mesh(self, body, gather: bool):
        """``body`` run with the mesh current (the layers' collectives),
        its record gathered over the data axis when it is a step's."""
        mesh = self.mesh

        def run():
            with sharding.use_mesh(mesh):
                out = body()
                return self._gather_record(out) if gather else out
        return run

    def program_cache_sizes(self) -> Dict[str, int]:
        """Programs built per name: ``step`` always (the plain step, or
        the spec step in spec mode), ``mixed`` (one per admitting slot)
        once the first mixed step ran, ``admit_chunk`` (one per admitting
        slot) in spec mode: the keys of the JAX engine's dict. Steady
        serving keeps every count flat. The frontend admission programs
        (``encode``, ``embed_chunk``) are left out, as the JAX engine
        leaves its slot programs out; the watchdog records their builds
        as it records every program's."""
        out = {"step": 0}
        for name, *_ in self._programs:
            if name in _STEP_PROGRAMS:
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
            self._row_sampler, self.generator,
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
        nxt, bad = _guarded_sample(self._row_sampler, self.generator,
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

    def _verify(self, draft_tokens, draft_logits):
        """The spec steps' shared middle: one masked target forward over
        ``[pending, proposals]`` (active rows advance by gamma + 1, the
        others by 0), the poison lane on its logits, the accept rule,
        and a non-finite row emitting one :data:`ERR_TOKEN`. Returns
        ``(seq, block, n_acc, n_emit, bad, steps_now, committed)``:
        ``steps_now`` the depths after the verify (a fresh tensor),
        ``committed`` the depths to roll back to (active rows: the old
        depth + 1 + n_acc)."""
        g, active = self.spec_gamma, self.active
        act1 = active.to(torch.int32)
        seq = torch.cat([self.tokens, draft_tokens], dim=1)
        t_logits, _ = self.model.extend_into_cache(
            self.params, seq, self.cache, (g + 1) * act1)
        t32 = t_logits.float() + self._poison[:, None, None]
        bad = active & ~torch.isfinite(t32).all(dim=2).all(dim=1)
        block, n_acc = self._row_sampler.speculative(
            self.generator, draft_tokens, draft_logits,
            torch.where(bad[:, None, None], torch.zeros_like(t32), t32))
        block = torch.where(bad[:, None], torch.full_like(block, ERR_TOKEN),
                            block)
        n_acc = torch.where(bad, torch.zeros_like(n_acc), n_acc)
        n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
        steps_now = self.model.cache_steps(self.cache).long()
        committed = torch.where(active, steps_now - g + n_acc, steps_now)
        return seq, block, n_acc, n_emit, bad, steps_now, committed

    def _accept(self, block, n_emit, bad) -> torch.Tensor:
        """The spec steps' bookkeeping (the plain step's stop conditions
        with a variable emit count), written into the decode state in
        place; returns the record (B, gamma + 2): the block, then the
        emit count."""
        g, active = self.spec_gamma, self.active
        remaining, eos = self.remaining, self.eos
        idx = torch.arange(g + 1, device=block.device)[None, :]
        emitted = idx < n_emit[:, None]
        eos_hit = (emitted & (block == eos[:, None])).any(dim=1)
        done = active & (bad | (remaining <= n_emit) | eos_hit)
        new_remaining = torch.where(
            active, torch.clamp(remaining - n_emit, min=0), remaining)
        last = torch.gather(block, 1,
                            (torch.clamp(n_emit, min=1) - 1)[:, None])[:, 0]
        nxt = torch.where(active, last, self.tokens[:, 0])
        self.active.copy_(active & ~done)
        self.remaining.copy_(new_remaining)
        # an ERR_TOKEN row (now inactive) feeds a valid id
        self.tokens.copy_(nxt.clamp(min=0)[:, None])
        return torch.cat([block, n_emit[:, None]], dim=1)

    def _spec(self) -> torch.Tensor:
        """Spec step body with a model draft. The draft proposes gamma
        tokens: its verify window ``[prev, pending]`` then gamma - 1
        single-token decodes, every forward masked by ``active`` (an
        admitting row between chunks stays as it is), each proposal
        sampled from logits that ``_finite_rows`` keeps defined. The
        target verifies (``_verify``), both caches roll back (the target
        to the committed depth, the draft one short of it), and the
        decode state and ``prev`` take the emitted block's tail."""
        g, active = self.spec_gamma, self.active
        draft, dparams, dcache = (self._draft_model, self._draft_params,
                                  self.draft_cache)
        act1 = active.to(torch.int32)
        window = torch.cat([self.prev, self.tokens], dim=1)
        dl, _ = draft.extend_into_cache(dparams, window, dcache, 2 * act1)
        cur = _finite_rows(dl[:, -1].float())
        d_toks, d_logits = [], []
        for i in range(g):
            t = self._row_sampler(self.generator, cur)
            d_toks.append(t)
            d_logits.append(cur)
            if i + 1 < g:
                dl, _ = draft.extend_into_cache(dparams, t[:, None], dcache,
                                                act1)
                cur = _finite_rows(dl[:, -1].float())
        _, block, n_acc, n_emit, bad, _, committed = self._verify(
            torch.stack(d_toks, dim=1), torch.stack(d_logits, dim=1))
        d_back = torch.where(active, committed - 1,
                             draft.cache_steps(dcache).long())
        self.model.rollback(self.cache, committed)
        draft.rollback(dcache, d_back)
        # the token preceding the new pending one: the last accepted
        # proposal, or the old pending token when none was accepted
        prev = torch.where(
            n_acc > 0,
            torch.gather(block, 1,
                         (torch.clamp(n_acc, min=1) - 1)[:, None])[:, 0],
            self.tokens[:, 0])
        prev = torch.where(active, prev, self.prev[:, 0])
        rec = self._accept(block, n_emit, bad)
        self.prev.copy_(prev.clamp(min=0)[:, None])
        return rec

    def _ngram_spec(self) -> torch.Tensor:
        """Spec step body with the prompt-lookup drafter: proposals from
        each row's history (``ngram_propose``), the target's verify
        (``_verify``), the rollback (a recurrent stack restores the
        pre-verify checkpoint and replays the accepted prefix, pending
        plus n_acc proposals, through the same masked extend: the
        checkpoint restore is in place and the replay rewrites the
        checkpoints), then the emitted block appended to the history
        (entries past its H tokens go to the trash column)."""
        g, active, H = self.spec_gamma, self.active, self._hist_cap
        draft_tokens, draft_logits = ngram_propose(
            self.hist[:, :H], self.hist_len, gamma=g,
            vocab=self.model.cfg.vocab)
        seq, block, n_acc, n_emit, bad, steps_now, committed = \
            self._verify(draft_tokens, draft_logits)
        if self.model.rollback_needs_replay:
            pre = torch.where(active, steps_now - (g + 1), steps_now)
            self.model.rollback(self.cache, pre)
            self.model.extend_into_cache(
                self.params, seq, self.cache,
                torch.where(active, n_acc + 1,
                            torch.zeros_like(n_acc)).to(torch.int32),
                last_only=True)
        else:
            self.model.rollback(self.cache, committed)
        idx = torch.arange(g + 1, device=block.device)[None, :]
        wpos = torch.where((idx < n_emit[:, None]) & active[:, None],
                           torch.clamp(self.hist_len[:, None] + idx, max=H),
                           torch.full_like(idx, H))
        self.hist.scatter_(1, wpos, block)
        self.hist_len.copy_(torch.clamp(self.hist_len + n_emit, max=H))
        return self._accept(block, n_emit, bad)

    def _admit_chunk(self, slot: int) -> torch.Tensor:
        """Spec-mode admission chunk body for ``slot``: advance the slot
        by the staged chunk at batch 1 in the target cache and, with a
        model draft, by the staged draft length in the draft cache (one
        position behind: the stream's last token becomes ``prev`` and
        the first verify window re-reads it); sample the first token and
        arm the slot when the chunk ends the prompt; with the n-gram
        drafter append that token to the slot's history. Returns (B,
        gamma + 2): the armed token in column 0 (padded to the spec
        width) and the emit counts."""
        C, g = self.prefill_chunk, self.spec_gamma
        st = self._stage
        n, last, a_rem, a_eos = st[C:C + 1], st[C + 1], st[C + 2], st[C + 3]
        d_len, a_prev = st[C + 4:C + 5], st[C + 5]
        active, tokens = self.active, self.tokens
        is_admit = self._rows == slot
        logits, _ = self.model.extend_into_cache(
            self.params, st[:C][None], _slot_view(self.cache, slot),
            n.to(torch.int32), last_only=True)
        if self._draft_model is not None:
            self._draft_model.extend_into_cache(
                self._draft_params, st[:C][None],
                _slot_view(self.draft_cache, slot), d_len.to(torch.int32),
                last_only=True)
        nxt, bad = _guarded_sample(
            self.sampler, self.generator,
            logits[:, 0].float() + self._poison[slot])            # (1,)
        arm = is_admit & (last != 0)
        done = arm & (bad[0] | (a_rem <= 1) | (nxt[0] == a_eos))
        block = torch.where(arm, nxt[0], tokens[:, 0])
        self.active.copy_(active | (arm & ~done))
        self.remaining.copy_(torch.where(arm, a_rem - 1, self.remaining))
        self.eos.copy_(torch.where(arm, a_eos, self.eos))
        if self._draft_model is not None:
            self.prev.copy_(torch.where(arm, a_prev, self.prev[:, 0])[:, None])
        if self._ngram:
            H = self._hist_cap
            wpos = torch.where(last != 0, self.hist_len[slot],
                               torch.full_like(self.hist_len[slot], H))
            self.hist[slot].scatter_(0, torch.clamp(wpos, max=H)[None],
                                     nxt[:1])
            self.hist_len.copy_(torch.where(
                is_admit & (last != 0),
                torch.clamp(self.hist_len + 1, max=H), self.hist_len))
        self.tokens.copy_(torch.where(arm, nxt[0].clamp(min=0),
                                      tokens[:, 0])[:, None])
        pad = torch.zeros((block.shape[0], g), dtype=block.dtype,
                          device=block.device)
        return torch.cat([block[:, None], pad, arm.to(block.dtype)[:, None]],
                         dim=1)

    def _stage_chunk(self, adm: _Admission, n: int) -> bool:
        """Write the admission's next chunk (its ``n`` valid tokens) and
        its scalars into one host vector and copy it into the staging
        buffer: from pinned memory without blocking on the card (a fresh
        pinned block each step: the host allocator reuses one only after
        its copy ran). Returns whether the chunk ends the prompt."""
        C = self.prefill_chunk
        last = adm.base + n >= adm.length
        req = adm.req
        host = torch.zeros((C + 6,), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        buf[:n] = adm.tokens[adm.base:adm.base + n]
        # the draft consumes the same chunk capped one short of the
        # stream (its cache lags the committed depth by one position)
        buf[C:] = (n, last, req.max_new_tokens - adm.n_done,
                   -1 if req.eos_id is None else int(req.eos_id),
                   max(0, min(n, adm.length - 1 - adm.base)),
                   int(adm.tokens[-1]))
        self._stage.copy_(host, non_blocking=True)
        return last

    def _reset_slot(self, b: int, upto: int = 0, cache=None) -> None:
        """Erase slot ``b``: every position empty, depth 0, so a recycled
        slot keeps no stale keys from its previous occupant. With ``upto``
        > 0 (a prefix-cache hit) the first ``upto`` positions are stamped
        valid instead, depth ``upto`` (JAX's ``pos_row``): their K/V was
        just copied in, or the block table aliases written pages. An SSM
        sub-cache has no positions to mask a previous occupant behind:
        its state, conv tail, depth and checkpoints are zeroed, and so are
        the slot's rows of an encoder-decoder's memory (``xk``/``xv``), as
        the JAX engine's reset zeroes them. Every write is in place,
        ``upto`` a host int (no sync): a copy of the static
        ``_positions`` row, a fill of the rest and of the depth.
        ``cache``: the cache to reset (default the target's; the draft
        cache in spec mode)."""
        b = self._local_slot(b)
        if b is None:
            return
        for sub in (self.cache if cache is None else cache).values():
            if not isinstance(sub, dict):
                sub[:, b] = 0
            elif "pos" in sub:
                pos = sub["pos"][:, b]
                if upto:
                    pos[:, :upto] = self._positions[:upto]
                pos[:, upto:] = -1
                sub["step"][:, b] = upto
            else:
                for leaf in sub.values():
                    leaf[:, b] = 0

    def _materialize(self, b: int, kv, upto: int) -> None:
        """Copy the first ``upto`` positions of a ring entry (``kv``: per
        attention sub-cache, its K/V leaves and int8 scales, each
        ``[n_blocks, 1, P, ...]``, P >= ``upto``) into slot ``b`` in place
        and stamp the slot's positions: the ring counterpart of the JAX
        engine's ``materialize`` program. A partial hit takes a prefix of
        a longer entry, exact by causality. On a mesh only the data rank
        that holds the slot copies."""
        lb = self._local_slot(b)
        if lb is None:
            return
        for name, part in kv.items():
            sub = self.cache[name]
            for k, src in part.items():
                sub[k][:, lb, :upto].copy_(src[:, 0, :upto])
        self._reset_slot(b, upto)

    def _extract(self, b: int, P: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The ring entry of slot ``b``'s first ``P`` positions: a clone
        of each attention sub-cache's K/V leaves (and int8 scales), since
        a view would see the next decode step's writes. On a data-split
        mesh the data rank that holds the slot ``broadcast``s it over the
        data group, so every rank stores the entry (on its heads)."""
        lb = self._local_slot(b)
        out = {}
        for name, sub in self.cache.items():
            if not isinstance(sub, dict) or "pos" not in sub:
                continue
            out[name] = {}
            for k in ("k", "v", "k_scale", "v_scale"):
                if k not in sub:
                    continue
                if lb is not None:
                    t = sub[k][:, lb:lb + 1, :P].clone()
                else:
                    shape = (sub[k].shape[0], 1, P) + sub[k].shape[3:]
                    t = torch.empty(shape, dtype=sub[k].dtype,
                                    device=sub[k].device)
                if self._data_split:
                    self.mesh.broadcast(t, "data", b // self._bl)
                out[name][k] = t
        return out

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
        old = self.responses.get(req.uid)
        if old is not None and not old.finished:
            raise ValueError(f"request uid {req.uid} is already in flight")
        cap = self.kv_len - self._prefix
        if prompt.size > cap and (
                self.paged or not self.model.cfg.sliding_window):
            # a sliding-window ring serves longer prompts (the window
            # mask hides overwritten context); full attention and paged
            # caches cannot: the overwrite would drop attended positions
            raise ValueError(
                f"request {req.uid}: prompt of {prompt.size} tokens "
                f"exceeds the KV capacity of {cap} (cache_len="
                f"{self.cache_len}"
                + (f" minus a {self._prefix}-token frontend prefix"
                   if self._prefix else "")
                + "); raise cache_len or shorten the prompt")
        if self.model.is_encdec and req.embeddings is None:
            raise ValueError(
                f"request {req.uid}: encoder-decoder serving requires "
                "frontend frame embeddings on every request (the "
                "cross-attention memory is encoded at admission)")
        if req.embeddings is not None:
            fe = self.model.cfg.frontend
            if fe is None:
                raise ValueError(
                    f"request {req.uid}: embeddings were supplied but "
                    "the model has no frontend to consume them")
            if self.paged:
                raise ValueError(
                    "paged KV serving is token-only: frontend "
                    "embeddings have no paged admission program")
            emb = np.asarray(req.embeddings)
            if emb.shape != (fe.n_tokens, fe.d_embed):
                raise ValueError(
                    f"request {req.uid}: embeddings must have shape "
                    f"({fe.n_tokens}, {fe.d_embed}) to match the "
                    f"frontend, got {emb.shape}")

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
        hold the whole effective stream plus the first decode write
        (conservative: a prefix hit would need less), evicting LRU prefix
        entries first; otherwise the head of the queue waits (and nothing
        behind it is admitted either)."""
        if not self.paged:
            return True
        need = self._eff_len(req)
        while not self._paged.can_admit(need):
            if self.prefix_cache is None \
                    or not self.prefix_cache.drop_lru():
                return False
        return True

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
        """Begin a chunked admission into slot ``b``: probe the prefix
        cache with the effective stream, then serve the hit's head (the
        rings: copy it into the slot; the pool: alias its pages) or reset
        the slot; the mixed steps take the stream from there. A preempted
        request re-admits through this same path: its effective stream
        is the prompt plus the tokens it had already generated, replayed
        chunk by chunk, and it is armed with the budget it has left."""
        req.started_s = req.started_s or time.perf_counter()
        resp = self.responses.get(req.uid)
        done = resp.tokens if resp is not None else []
        toks = np.asarray(req.prompt, np.int64)
        if done:
            toks = np.concatenate([toks, np.asarray(done, np.int64)])
        kv, base = None, 0
        if self.prefix_cache is not None and req.embeddings is None:
            # an embeddings request never touches the prefix cache: its
            # tokens alone do not key the slot's content (two requests
            # with one prompt and other frames would alias)
            kv, _, base = self.prefix_cache.lookup(toks)
        if self._ngram:
            # seed the drafter's history with the effective stream (its
            # most recent H tokens), from pinned memory without blocking
            H = self._hist_cap
            n = min(len(toks), H)
            host = torch.full((H,), -1, dtype=torch.int64,
                              pin_memory=self.device.type == "cuda")
            host.numpy()[:n] = toks[len(toks) - n:]
            lb = self._local_slot(b)
            if lb is not None:
                self.hist[lb, :H].copy_(host, non_blocking=True)
                self.hist_len[lb].fill_(n)
        if self._draft_model is not None:
            self._reset_slot(b, cache=self.draft_cache)
        if self.paged:
            self._paged.release_slot(b)
            if kv is not None:
                self._paged.alias_prefix(b, kv[:base // self.page_size])
            self._reset_slot(b, base)
            self._depth_ub[b] = base
        elif kv is not None:
            self._materialize(b, kv, base)
        else:
            self._reset_slot(b)
        if req.embeddings is not None:
            self._admit_frontend(req, b)
        self._admit = _Admission(req=req, slot=b, base=base,
                                 length=len(toks), tokens=toks,
                                 n_done=len(done), resumed=bool(done))
        if self.recorder.enabled:
            self.recorder.on_admission(req, b, base, "chunked")

    def _admit_frontend(self, req: Request, b: int) -> None:
        """A frontend request's admission work, after the slot's reset
        and before its text chunks (a preempted request runs it again
        when it is admitted again): the frames go into the static
        ``_frames`` buffer through a fresh pinned block without
        blocking, then an admission program runs (the JAX engine's
        ``_get_encode_fn`` and ``_get_embed_chunk``), a CUDA graph on the
        card like the step programs, captured at its first call. An
        encoder-decoder's ``encode`` program (one for every slot: the
        slot index is a device scalar it reads) encodes the frames once
        (``EncDecModel.encode_memory``) and copies the per-layer
        cross-attention K/V into the slot's rows of the cache's
        ``xk``/``xv``, in place: the step graphs read those tensors, so
        nothing is rebound. A VLM's ``embed_chunk`` program (one a
        slot, as the mixed step) runs the frames as one embedding chunk
        (``frontend.n_tokens`` positions) through the masked extend on
        the slot's view, into the target's cache and, with a model
        draft, the draft's."""
        emb = np.asarray(req.embeddings, dtype=np.float32)
        on_card = self.device.type == "cuda"
        host = torch.empty((1,) + emb.shape, dtype=torch.float32,
                           pin_memory=on_card)
        host.numpy()[0] = emb
        self._frames.copy_(host, non_blocking=on_card)
        if self.model.is_encdec:
            self._frontend_slot.fill_(b)
            self._run_program(("encode",), self._encode)
        else:
            self._run_program(("embed_chunk", b),
                              lambda: self._embed_chunk(b))

    def _encode(self) -> torch.Tensor:
        """Encode program body: the staged frames encoded, each layer's
        cross-attention K/V written into the ``_frontend_slot`` row of
        the cache's memory."""
        xk, xv = self.model.encode_memory(self.params, self._frames)
        self.cache["xk"].index_copy_(1, self._frontend_slot, xk)
        self.cache["xv"].index_copy_(1, self._frontend_slot, xv)
        return self._frontend_slot

    def _embed_chunk(self, b: int) -> torch.Tensor:
        """Embedding-chunk program body for slot ``b``: the staged frames
        through the masked extend on the slot's view (every position of
        the prefix; only the last row's logits are formed, and none is
        used), in the target's cache and the model draft's."""
        logits, _ = self.model.extend_into_cache(
            self.params, None, _slot_view(self.cache, b),
            embeddings=self._frames, last_only=True)
        if self._draft_model is not None:
            self._draft_model.extend_into_cache(
                self._draft_params, None, _slot_view(self.draft_cache, b),
                embeddings=self._frames, last_only=True)
        return logits

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
        lb = self._local_slot(b)
        if lb is not None:
            self.active[lb].fill_(False)
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
            if self._eff_len(r) + 1 > self.kv_len - self._prefix:
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
        lb = self._local_slot(b % self.max_batch)
        if lb is not None:
            self._poison[lb].fill_(float("nan"))

    def _clear_poison(self) -> None:
        self._poison.zero_()

    # ------------------------------------------------------------ #
    # paged provisioning (host allocator <-> device page pools)
    # ------------------------------------------------------------ #
    def _provision(self, slot: int, start: int, n: int) -> bool:
        """Make the pages behind positions [start, start+n) of ``slot``
        privately writable before a dispatched step (allocate missing
        pages, copy-on-write split shared ones). Exhaustion, real or
        forced by the ``page_alloc`` fault site, degrades: evict LRU
        prefix entries, then poll (a finished slot may hold pages), then
        preempt-and-requeue a victim; only a pool that cannot hold the
        live set raises.
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
            # the first rung: an evicted prefix entry may free pages and
            # costs no poll, so the round stays clean
            if self.prefix_cache is not None \
                    and self.prefix_cache.drop_lru():
                continue
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
        alias (a gather and an index copy on every pool leaf, in place).
        The (src, dst) pairs go up through a fresh pinned block without
        blocking, as the block tables do: no host sync."""
        on_card = self.device.type == "cuda"
        host = torch.empty((2, len(copies)), dtype=torch.long,
                           pin_memory=on_card)
        host.numpy()[:] = np.asarray(copies, dtype=np.int64).T
        idx = host.to(self.device, non_blocking=True) if on_card else host
        src, dst = idx[0], idx[1]
        for sub in self.cache.values():
            for k in paged_kv.POOL_KEYS:
                if k in sub:
                    sub[k].index_copy_(1, dst, sub[k].index_select(1, src))

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
        """One engine step (plain, mixed or spec; in spec mode an admit
        chunk first while an admission is in flight): device work only; tokens,
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
        adm = self._admit
        if self.spec_gamma:
            if adm is not None:
                self._step_admit_chunk(adm)
                if self.active_slots:
                    self._step_spec()
            else:
                self._step_spec()
        elif adm is not None:
            self._step_mixed(adm)
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

    def _push_trace(self, rec: torch.Tensor, spec: bool = False) -> None:
        W = self._width
        self._trace.append((rec[:, :W], rec[:, W], spec))

    def _step_spec(self) -> None:
        if self.paged:
            # a spec step writes up to gamma + 1 positions an active row
            # (the verify window); rollback keeps the committed prefix
            # and the poll's shrink drops the pages past it
            while not self._provision_decode_rows(self.spec_gamma + 1):
                pass
            self._push_block_tables()
        body = self._ngram_spec if self._ngram else self._spec
        self._push_trace(self._run_program(("step",), body), spec=True)
        self._record_step("spec")

    def _step_admit_chunk(self, adm: _Admission) -> None:
        """Dispatch the spec-mode admission chunk program; the spec step
        that follows decodes the other slots."""
        n = min(self.prefill_chunk, adm.length - adm.base)
        if self.paged:
            # the target's chunk only: the draft cache stays contiguous,
            # and the spec step provisions the decode rows (a slot this
            # chunk arms included)
            while not self._provision(adm.slot, adm.base, n):
                pass
            self._depth_ub[adm.slot] = adm.base + n
            self._push_block_tables()
        last = self._stage_chunk(adm, n)
        slot, ls = adm.slot, self._local_slot(adm.slot)
        if ls is None:       # another data group admits
            self._push_trace(self._idle_record())
        else:
            self._push_trace(self._run_program(
                ("admit_chunk", ls), lambda: self._admit_chunk(ls)))
        if self.recorder.enabled:
            self.recorder.on_chunk(adm.req, slot, adm.base, adm.base + n,
                                   last)
        adm.base += n
        if last:
            self._complete_admission(adm)
        self._record_step("admit")

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
        slot, ls = adm.slot, self._local_slot(adm.slot)
        if ls is None:       # another data group admits: decode alone
            self._push_trace(self._run_program(("step",), self._decode))
        else:
            self._push_trace(self._run_program(("mixed", ls),
                                               lambda: self._mixed(ls)))
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
        to the slot (its trace starts at this step), queue its TTFT stamp
        for the next sync, and publish the prompt's head to the prefix
        cache before any decode step can wrap the ring over it: a pin of
        the slot's own pages on the pool, a clone of its K/V on the
        rings, queued behind the step on the stream. A resumed admission
        publishes nothing: its prompt was published on its first
        admission, and the rest of its stream is its own output."""
        b = adm.slot
        self.slots[b] = adm.req
        self._slot_start[b] = self._steps
        self._await_first.append(adm.req)
        self._c_admissions.inc()
        self._admit = None
        if self.prefix_cache is not None and not adm.resumed \
                and adm.req.embeddings is None:
            P = self.prefix_cache.wants(adm.req.prompt)
            if P and P <= self.kv_len:
                kv = self._paged.snapshot_prefix(b, P) if self.paged \
                    else self._extract(b, P)
                self.prefix_cache.insert(adm.req.prompt, P, kv)

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
            blocks = torch.stack([t for t, _, _ in suffix],
                                 dim=1).cpu().numpy()          # (B, n, W)
            counts = torch.stack([c for _, c, _ in suffix],
                                 dim=1).cpu().numpy()          # (B, n)
            self._c_polls.inc()
            for b, start in occupied:
                s = start - lo
                if s >= len(suffix):
                    continue                           # armed post-trace
                col: List[int] = []
                gaps: List[Optional[float]] = []
                for off in range(s, len(suffix)):
                    c = int(counts[b, off])
                    if suffix[off][2]:
                        # every (spec step, occupied slot) pair emitted
                        # 1 + n_acc tokens (0 once the device finished it)
                        self._c_spec_emitted.inc(c)
                        self._c_spec_steps.inc(int(c > 0))
                    if not c:
                        continue
                    w = self._trace_base + lo + off - self._step_wall_base
                    gap = None
                    if 0 < w < len(self._step_wall):
                        gap = self._step_wall[w] - self._step_wall[w - 1]
                    for tok in blocks[b, off, :c]:
                        col.append(int(tok))
                        gaps.append(None if gap is None else gap / c)
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
                self._paged.check_invariants(
                    self.prefix_cache.entries()
                    if self.prefix_cache is not None else None)
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
                self._kv_nbytes = sum(t.nbytes
                                      for t in _leaves(self.cache))
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
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            pc.hits = pc.misses = pc.hit_tokens = pc.evictions = 0
        if self.paged:
            pk = self._paged
            pk.alias_pages = pk.cow_splits = pk.pages_released = 0

    def _release(self) -> None:
        """Break the engine's reference cycles, so that its last outside
        reference going frees its device memory at once rather than at
        the garbage collector's next pass: the step programs' bodies
        close over the engine (dropping them drops their CUDA graphs,
        and the graph pool goes with its last graph), and so does the
        prefix cache's eviction hook. The engine serves nothing after
        this. ``Fleet.rejoin`` calls it on the engine it replaces."""
        self._stop_profile()
        self._programs.clear()
        if self.prefix_cache is not None:
            self.prefix_cache.on_evict = None

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
        one sample; the ``prefix_*`` keys only with a prefix cache, the
        ``kv_*`` pool keys only on a paged engine, the ``spec_*`` keys
        only in spec mode."""
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
        if self.prefix_cache is not None:
            stats.update(self.prefix_cache.stats())
        if self.paged:
            stats.update(self._paged.stats())
        if self.spec_gamma:
            # acceptance rate = mean(n_acc) / gamma over the harvested
            # (spec step, active slot) pairs
            emitted = self._c_spec_emitted.value
            steps = self._c_spec_steps.value
            n = max(steps, 1)
            stats["spec_gamma"] = self.spec_gamma
            stats["spec_tokens_per_step"] = emitted / n
            stats["spec_acceptance_rate"] = \
                (emitted - steps) / (self.spec_gamma * n)
        return stats
