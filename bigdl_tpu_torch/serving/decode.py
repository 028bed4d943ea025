"""Continuous-batching decode engine: token streaming over a paged KV
cache (≙ ``bigdl_tpu/serving/decode.py``).

:class:`~bigdl_tpu_torch.serving.ServingEngine` batches fixed-shape
forward passes.  Token streaming costs per generated token, and a static
batch idles the card on its slowest member, so this engine decodes at
**slot** granularity::

    submit(prompt)                      client threads
       └─ bounded waiting queue         shed at the door when full
            └─ decode loop (one thread, owns the device pool)
                 admit  → free slot + pages → PREFILL (prompt padded to
                          a power-of-two bucket of the BucketLadder, so a
                          mixed prompt stream runs only the shapes that
                          warmup ran)
                 step   → ONE fixed-shape decode step advances every live
                          slot by one token (per-slot positions, page-table
                          write and gather, kvcache.py)
                 retire → eos / max_new / deadline: free the slot's pages,
                          complete the future, recycle the slot
                 evict  → a slot that cannot grow a page evicts the
                          YOUNGEST other admission (never an older one: the
                          oldest request always completes, which keeps the
                          dance free of livelock); the victim re-queues and
                          on readmission RE-PREFILLS its prompt at the same
                          bucket, then REPLAYS its recorded tokens through
                          the decode step, so the rebuilt KV is bitwise the
                          evicted one and greedy decode continues exactly

Slot membership changes every step, shapes never do: dead slots ride
along as rows with token 0, length 0 and tables of ``-1``, so no row's
arithmetic depends on which other slots are live (what makes the replay
bitwise) and no step filters rows on the host.

Where the reference compiles one XLA program per prefill bucket and one
for the step, the port runs each once at :meth:`DecodeEngine.warmup`,
with tables of ``-1`` so that every write goes to the pool's sink page.
Those runs count ``decode/warmup_compiles``; a bucket or step first run
after warmup counts ``decode/recompiles``, never silently.  The pool is a
set of tensors written in place under ``torch.inference_mode()``; after a
step that raised, :meth:`DecodeEngine._recover_pool` builds a zeroed pool,
since a step that fails mid-layer leaves the pool half written.

The decode loop is its own thread: it enters ``torch.inference_mode()``
and the entry's CUDA device itself (both are thread-local).  A step
makes one host sync, one copy of the chosen tokens and the non-finite
flags together.  Sampling (temperature > 0) draws Gumbel noise from a
``torch.Generator`` on the engine's device seeded from ``(seed, step)``;
temperature 0 is greedy.

Per-token SLO accounting: ``decode/ttft_ms`` (submit → first token) and
``decode/intertoken_ms`` histograms, ``decode/*`` counters, ``kv/*``
pool gauges, and a per-request trace (admit → queue → prefill → one
``token`` span per decode step) in a bounded :class:`TraceRing`.  Shed
requests finish their trace with a terminal cause span before their
future fails, as in ServingEngine.

The engine speaks ServingEngine's replica protocol (``submit`` /
``predict`` / ``warmup`` / ``shutdown`` / ``pending_rows`` /
``max_queue_fill`` / ``stats`` / ``registry`` / ``recorder``), so that
:func:`build_decode_replica_set` fronts N of them with a
:class:`~bigdl_tpu_torch.serving.ReplicaSet`.

Goodput: the engine owns a ledger on its recorder (one device).  Warmup
runs land in ``compile_warmup``, a prefill is goodput, each step's
interval splits by slot occupancy (live slots goodput, spare slots with
queued work ``queue_wait``, the rest idle), and parked time goes to the
background phase.  The folds are host arithmetic on time stamps the loop
takes anyway: no host sync and no token changes.

The ``serving.decode_step`` fault site fires before each step: ``delay``
is a wedged step (the replica set's wedge verdict), ``err`` fails the
live requests (a replica set fails them over).

Not ported yet (ROADMAP queue A, item 8): ``serve_metrics``.
"""
from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import faults as faultplane
from ..models.transformer import gumbel_sample
from ..observability import Recorder
from ..observability.goodput import GoodputLedger, ledger_phase
from ..observability.profile import TraceRing, dump_chrome_trace
from .buckets import BucketLadder
from .kvcache import PagedKVCache
from .queue import EngineClosedError, LoadShedError
from .registry import ModelRegistry

_END = object()


class DecodeStream:
    """One streaming decode: iterate :meth:`tokens` as they are emitted
    (ints), or wait for :attr:`future`, the full ``prompt + generated``
    int32 array.  A shed or failed request raises from both."""

    def __init__(self):
        self.future: Future = Future()
        self._q: "queue_mod.Queue" = queue_mod.Queue()

    def tokens(self):
        while True:
            t = self._q.get()
            if t is _END:
                # the future resolves before the end marker lands, so a
                # shed or failed request raises here too: a truncated
                # stream must never look like a short success
                exc = self.future.exception() if self.future.done() \
                    else None
                if exc is not None:
                    raise exc
                return
            yield t

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)


class _DecodeRequest:
    """One request across its whole life (evictions included)."""

    __slots__ = ("prompt", "max_new", "temperature", "eos_id", "deadline",
                 "arrival", "stream", "generated", "trace", "slot",
                 "first_token_at", "last_token_at", "evictions",
                 "replay_i")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float, eos_id: Optional[int],
                 deadline: Optional[float], stream: DecodeStream,
                 trace=None):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.deadline = deadline     # absolute monotonic seconds or None
        self.arrival = time.monotonic()
        self.stream = stream
        self.generated: List[int] = []
        self.trace = trace
        self.slot: Optional[int] = None
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.evictions = 0
        # readmission replay cursor: > 0 while the slot re-feeds its
        # recorded tokens through the decode step (DecodeEngine._prefill)
        self.replay_i = 0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class DecodeEngine:
    """Slot-based continuous-batching decode over one TransformerLM.

    ``registry`` / ``model_name``  the served entry; its module must have
                    ``apply_with_cache`` (prefill) and ``decode_tokens``.
                    A weight swap through the registry lands at the next
                    step.  The engine runs on the entry's device.
    ``slots``       concurrent sequences in the step batch
    ``page_size`` / ``pool_pages``  paged-KV geometry (kvcache.py);
                    ``pool_pages`` defaults to ``slots * max_context /
                    page_size`` (no eviction pressure); smaller pools
                    evict
    ``max_context`` longest prompt + generation a slot may hold
    ``max_prompt``  admission cap on a client's prompt length
    ``max_new_tokens``  default generation budget per request
    ``max_waiting`` waiting-queue bound, in requests; beyond it submit
                    sheds with :class:`LoadShedError`
    ``int8_kv``     store KV pages int8 with per-row scales
    ``eos_id``      default stop token (None = run to max_new)
    ``seed``        sampling seed (temperature > 0 requests)
    """

    #: a "row" here is one token of a SEQUENCE: a replica set must submit
    #: prompts whole, never slice them into batch chunks
    row_splittable = False

    def __init__(self, registry: ModelRegistry, model_name: str = "lm", *,
                 slots: int = 8, page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 max_context: Optional[int] = None,
                 max_prompt: Optional[int] = None,
                 max_new_tokens: int = 32, max_waiting: int = 64,
                 int8_kv: bool = False, kv_dtype=None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 recorder: Optional[Recorder] = None,
                 trace_requests: bool = True, trace_capacity: int = 512,
                 report_every: int = 32):
        self.registry = registry
        self.model_name = model_name
        entry = registry.get(model_name)
        model = entry.model
        if not hasattr(model, "apply_with_cache") \
                or not hasattr(model, "decode_tokens"):
            raise TypeError(
                f"DecodeEngine serves TransformerLM-style models with "
                f"apply_with_cache/decode_tokens; got "
                f"{type(model).__name__}")
        self.model = model
        self.device = entry.device
        cfg = model.cfg
        self.slots = int(slots)
        self.max_context = int(cfg.max_len if max_context is None
                               else max_context)
        if not 1 < self.max_context <= cfg.max_len:
            raise ValueError(f"max_context {self.max_context} must be in "
                             f"(1, max_len={cfg.max_len}]")
        self.max_prompt = int(self.max_context - 1 if max_prompt is None
                              else max_prompt)
        if not 0 < self.max_prompt < self.max_context:
            raise ValueError(f"max_prompt {self.max_prompt} must be in "
                             f"(0, max_context={self.max_context})")
        self.max_new_tokens = int(max_new_tokens)
        self.max_waiting = int(max_waiting)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.recorder = recorder if recorder is not None else Recorder()
        if self.recorder.get_ledger() is None:
            self.recorder.set_ledger(GoodputLedger(
                name=f"decode:{model_name}", devices=1))
        self.trace_ring = TraceRing(trace_capacity) if trace_requests \
            else None
        self.report_every = int(report_every)
        # prefill buckets only ever see client prompts: a readmission
        # re-prefills its PROMPT and replays the generated tail through
        # the decode step, so the ladder tops out at max_prompt
        self.ladder = BucketLadder(self.max_prompt)
        self.kv = PagedKVCache(
            [blk.attn.name for blk in model.blocks],
            n_heads=cfg.n_heads, head_dim=cfg.head_dim,
            n_pages=pool_pages if pool_pages is not None
            else self.slots * -(-self.max_context // page_size),
            page_size=page_size, n_slots=self.slots,
            max_context=self.max_context,
            dtype=kv_dtype or getattr(torch, cfg.dtype), int8=int8_kv,
            recorder=self.recorder, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._pool = self.kv.init_pool()
        # slot state, mutated only by the decode thread
        self._lengths = np.zeros(self.slots, np.int32)
        self._last_tokens = np.zeros(self.slots, np.int32)
        self._admitted_at = np.zeros(self.slots, np.float64)
        self._live: Dict[int, _DecodeRequest] = {}
        self._steps = 0
        # shared state: every read and write under self._lock (a Condition)
        self._lock = threading.Condition()
        self._waiting: List[_DecodeRequest] = []
        self._programs: Dict[Any, Any] = {}
        self._warmed = False
        self._closed = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------- #
    def warmup(self, name: Optional[str] = None):
        """Run every prefill bucket and the decode step once (all writes
        to the sink page): the zero-recompile line.  Runs here count
        ``decode/warmup_compiles``; a first run after it counts
        ``decode/recompiles``."""
        if name is not None and name != self.model_name:
            raise KeyError(f"DecodeEngine serves {self.model_name!r}, "
                           f"not {name!r}")
        with self.recorder.span("decode.warmup"), self._on_device(), \
                ledger_phase(self.recorder, "compile_warmup"):
            for bucket in self.ladder:
                self._program("prefill", bucket)
            self._program("decode")
        with self._lock:
            self._warmed = True
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admissions; ``drain=True`` finishes live and queued work,
        ``drain=False`` fails it fast with :class:`EngineClosedError`."""
        with self._lock:
            self._closed = True
            self._drain = bool(drain)
            t = self._thread
            self._lock.notify_all()
        if t is not None:
            t.join(timeout)
        return self

    def telemetry_sources(self):
        """``[(model_name, recorder)]``: the ``decode/*`` and ``kv/*``
        families of this engine."""
        return [(self.model_name, self.recorder)]

    def dump_chrome_trace(self) -> str:
        """Chrome-trace/Perfetto JSON of the recent request traces."""
        traces = self.trace_ring.traces() if self.trace_ring is not None \
            else []
        meta = {"dropped_traces": getattr(self.trace_ring, "dropped", 0)}
        return dump_chrome_trace(traces, extra_meta=meta)

    def _on_device(self):
        """``torch.inference_mode()`` with the engine's CUDA device
        current: both are thread-local, so each thread that runs the
        model enters them itself."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    # -- request path ----------------------------------------------------- #
    def submit(self, name: str, x, deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_id: Optional[int] = None, trace_ctx=None) -> Future:
        """Enqueue one prompt; returns the Future of the full
        ``prompt + generated`` int32 array.  ``deadline_ms`` sheds the
        request when it expires before or during decode (terminal
        ``deadline`` trace span, then the future fails).  ``trace_ctx``
        threads an upstream
        :class:`~bigdl_tpu_torch.observability.TraceContext` into the
        request's trace."""
        return self.stream(name, x, deadline_ms=deadline_ms,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature, eos_id=eos_id,
                           trace_ctx=trace_ctx).future

    def stream(self, name: str, x, deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_id: Optional[int] = None,
               trace_ctx=None) -> DecodeStream:
        """Like :meth:`submit`, but returns the :class:`DecodeStream`,
        whose :meth:`~DecodeStream.tokens` iterator yields tokens as the
        decode loop emits them."""
        t_admit = time.monotonic()
        if name != self.model_name:
            raise KeyError(f"DecodeEngine serves {self.model_name!r}, "
                           f"not {name!r}")
        prompt = np.asarray(x, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.max_prompt:
            raise ValueError(f"prompt length {prompt.size} exceeds "
                             f"max_prompt {self.max_prompt}")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new > self.max_context:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new}) exceeds "
                f"max_context {self.max_context}")
        if self.kv.pages_for(prompt.size + max_new) > self.kv.n_pages:
            # a request the whole pool cannot hold would evict itself
            # forever once it ran alone: reject it at the door
            raise ValueError(
                f"request needs {self.kv.pages_for(prompt.size + max_new)}"
                f" pages at full length, pool has {self.kv.n_pages}; "
                "grow pool_pages or shrink max_new_tokens")
        rec = self.recorder
        rec.inc("decode/requests")
        rec.inc("serving.requests")
        ring = self.trace_ring
        tr = ring.new_trace(self.model_name, ctx=trace_ctx) \
            if ring is not None else None
        if tr is not None:
            tr.meta.update(prompt_len=int(prompt.size), max_new=max_new)
        deadline = None if deadline_ms is None \
            else t_admit + float(deadline_ms) / 1e3
        stream = DecodeStream()
        req = _DecodeRequest(prompt, max_new, temperature,
                             eos_id if eos_id is not None else self.eos_id,
                             deadline, stream, trace=tr)
        if tr is not None:
            now = time.monotonic()
            tr.add_span("admit", t_admit, now)
            tr.open("queue", now)
        with self._lock:
            if self._closed:
                if tr is not None:
                    tr.discard("queue")
                    tr.terminal("engine_closed", time.monotonic(),
                                name="closed")
                    ring.finish(tr)
                raise EngineClosedError("decode engine is shut down")
            if len(self._waiting) >= self.max_waiting:
                rec.inc("decode/shed_queue_full")
                if tr is not None:
                    tr.discard("queue")
                    tr.terminal("queue_full", time.monotonic())
                    ring.finish(tr)
                raise LoadShedError(
                    "queue_full",
                    f"{len(self._waiting)} requests waiting, cap "
                    f"{self.max_waiting}")
            self._waiting.append(req)
            self._ensure_loop_locked()
            self._lock.notify_all()
            depth = len(self._waiting)
        rec.gauge("decode/queue_depth", depth)
        return stream

    def predict(self, name: str, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None, **kw):
        """Synchronous decode: greedy by default, so two predictions from
        the same snapshot are bitwise equal."""
        return self.submit(name, x, deadline_ms=deadline_ms,
                           **kw).result(timeout)

    # -- replica-protocol introspection ------------------------------------ #
    def pending_rows(self) -> int:
        """Outstanding work in tokens: queued prompts + generation
        budgets, plus what live slots still owe.  Zero means idle."""
        with self._lock:
            waiting = list(self._waiting)
            live = list(self._live.values())
        n = sum(int(r.prompt.size) + r.max_new for r in waiting)
        n += sum(max(r.max_new - len(r.generated), 1) for r in live)
        return n

    def max_queue_fill(self) -> float:
        with self._lock:
            return len(self._waiting) / self.max_waiting

    def stats(self) -> Dict[str, Any]:
        rec = self.recorder
        out = {k: rec.counter_value(f"decode/{k}")
               for k in ("requests", "prefills", "readmissions", "steps",
                         "tokens", "finished", "shed_queue_full",
                         "shed_deadline", "recompiles", "warmup_compiles",
                         "errors")}
        steps = max(out["steps"], 1.0)
        out["occupancy"] = out["tokens"] / (steps * self.slots)
        out["kv_pool_fill"] = self.kv.fill()
        out["kv_peak_fill"] = rec.gauge_value("kv/peak_fill")
        out["evictions"] = rec.counter_value("kv/evictions")
        for h, label in (("decode/ttft_ms", "ttft"),
                         ("decode/intertoken_ms", "intertoken")):
            q = rec.hist_quantiles(h, (50.0, 99.0))
            if q:
                out[f"{label}_p50_ms"] = q.get("p50")
                out[f"{label}_p99_ms"] = q.get("p99")
        return out

    # -- programs ---------------------------------------------------------- #
    def _program(self, kind: str, bucket: Optional[int] = None):
        """The runner of the decode step or of one prefill bucket.  Before
        warmup ends, a new runner is run once on inputs whose every write
        goes to the sink (``decode/warmup_compiles``); after it, a new
        runner counts ``decode/recompiles`` and its first real call is its
        first run."""
        key = (kind, bucket)
        with self._lock:
            prog = self._programs.get(key)
            warmed = self._warmed
        if prog is not None:
            return prog
        model, kv, dev = self.model, self.kv, self.device
        if kind == "decode":
            prog = _decode_program(model, kv, dev, self._gen, self.seed)
        else:
            prog = _prefill_program(model, kv, dev, self._gen, self.seed,
                                    bucket)
        if warmed:
            self.recorder.inc("decode/recompiles")
        else:
            params = self.registry.get(self.model_name).snapshot.params
            with self.recorder.span("decode.compile"), \
                    ledger_phase(self.recorder, "compile_warmup"):
                if kind == "decode":
                    s, p = self.slots, kv.max_pages_per_slot
                    prog(params, self._pool, np.zeros(s, np.int32),
                         np.zeros(s, np.int32),
                         np.full((s, p), -1, np.int32),
                         np.zeros(s, np.float32), 0)
                else:
                    prog(params, self._pool, np.zeros((1, bucket), np.int32),
                         1, np.full(-(-bucket // kv.page_size), -1,
                                    np.int32), 0.0, 0)
            self.recorder.inc("decode/warmup_compiles")
        with self._lock:
            self._programs[key] = prog
        return prog

    # -- decode loop ------------------------------------------------------- #
    def _ensure_loop_locked(self):
        if self._thread is None or not self._thread.is_alive():
            # the thread holds the engine weakly so that a dropped engine
            # is collectable; _decode_loop then fails stranded requests
            t = threading.Thread(
                target=_decode_loop,
                args=(weakref.ref(self), self._lock, self._waiting,
                      self._live, self.trace_ring),
                daemon=True, name=f"decode-{self.model_name}")
            self._thread = t
            t.start()

    def _tick(self) -> bool:
        """One scheduling round; returns False when the loop should exit
        (closed and nothing left to do)."""
        with self._lock:
            has_work = bool(self._waiting) or bool(self._live)
            closed, drain = self._closed, self._drain
            if closed and not drain:
                stranded = list(self._waiting) + list(self._live.values())
                self._waiting[:] = []
                live_slots = list(self._live)
                self._live.clear()
            elif not has_work:
                if closed:
                    return False
                # zero the load gauges while parked: they are only written
                # by live steps, so an idle engine would otherwise show its
                # last in-flight load forever
                self.recorder.gauge("decode/live_slots", 0)
                self.recorder.gauge("decode/occupancy", 0.0)
                led = self.recorder.get_ledger()
                if led is not None:
                    # parked time folds to the background phase instead of
                    # the next step's occupancy split
                    led.note_step_begin()
                self._lock.wait(0.1)
                return True
        if closed and not drain:
            exc = EngineClosedError("engine shut down before this "
                                    "request finished")
            for slot in live_slots:
                self.kv.free_slot(slot)
            for req in stranded:
                self._finish(req, exc=exc, cause="closed")
            self.recorder.gauge("decode/queue_depth", 0)
            return False
        try:
            self._admit()
            self._step_live()
        except Exception as e:       # the decode loop must survive
            self.recorder.inc("decode/errors")
            self._recover_pool(e)
        return True

    def _admit(self):
        """Move waiting requests into free slots (expired ones shed); each
        admission is one bucketed prefill."""
        while True:
            with self._lock:
                if not self._waiting:
                    return
                free = [s for s in range(self.slots)
                        if s not in self._live]
                if not free:
                    return
                req = self._waiting[0]
                now = time.monotonic()
                if req.expired(now):
                    self._waiting.pop(0)
                    shed = True
                else:
                    prompt = req.prompt
                    if not self.kv.can_fit(prompt.size):
                        # pool-exhaustion backpressure: admissions never
                        # evict (that invites eviction ping-pong); the
                        # request waits for pages, and sustained
                        # saturation reaches clients as queue growth, then
                        # as queue_full sheds
                        return
                    self._waiting.pop(0)
                    shed = False
                self.recorder.gauge("decode/queue_depth",
                                    len(self._waiting))
            if shed:
                self._shed_deadline(req, at="queue")
                continue
            slot = free[0]
            if not self.kv.alloc_for(slot, prompt.size):
                with self._lock:        # raced below can_fit: wait
                    self._waiting.insert(0, req)
                    depth = len(self._waiting)
                self.recorder.gauge("decode/queue_depth", depth)
                return
            try:
                self._prefill(slot, req, prompt)
            except Exception as e:
                self.recorder.inc("decode/errors")
                self._live.pop(slot, None)
                self.kv.free_slot(slot)
                self._finish(req, exc=e)
                self._recover_pool(e)

    def _evict_for(self, needy_slot: int, n_tokens: int) -> bool:
        """Evict slots YOUNGER than ``needy_slot`` (latest admission first)
        until it can hold ``n_tokens``; the victims re-queue and
        re-prefill + replay on readmission.  Returns False when no younger
        victim remains: the needy slot then yields itself.

        Youngest first and never an older one: the oldest live admission
        never loses its pages, so it always runs to completion, which
        keeps the dance free of livelock (evicting the oldest instead lets
        each fresh admission steal the pages of a victim mid-replay,
        forever)."""
        while not self.kv.alloc_for(needy_slot, n_tokens):
            victims = [s for s in self._live
                       if s != needy_slot
                       and self._admitted_at[s]
                       > self._admitted_at[needy_slot]]
            if not victims:
                return False
            victim = max(victims, key=lambda s: self._admitted_at[s])
            self._evict(victim)
        return True

    def _evict(self, slot: int):
        req = self._live.pop(slot)
        self.kv.free_slot(slot, evict=True)
        req.slot = None
        req.evictions += 1
        if req.trace is not None:
            req.trace.meta["evictions"] = req.evictions
        with self._lock:
            self._waiting.append(req)
            depth = len(self._waiting)
        self.recorder.gauge("decode/queue_depth", depth)

    def _prefill(self, slot: int, req: _DecodeRequest, prompt: np.ndarray):
        rec = self.recorder
        t0 = time.monotonic()
        if req.trace is not None:
            req.trace.close("queue", t0)
            req.trace.open("prefill", t0)
        bucket = self.ladder.bucket_for(prompt.size)
        prog = self._program("prefill", bucket)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :prompt.size] = prompt
        # the bucket may round up past max_context, so its page span can
        # exceed the slot's table row: pad with -1 (padding-only pages,
        # written to the sink)
        n_pages = -(-bucket // self.kv.page_size)
        table = np.full(n_pages, -1, np.int32)
        m = min(n_pages, self.kv.max_pages_per_slot)
        table[:m] = self.kv.tables[slot, :m]
        snap = self.registry.get(self.model_name).snapshot
        with rec.span("decode.prefill"):
            token, bad = prog(snap.params, self._pool, toks,
                              int(prompt.size), table, req.temperature,
                              self._steps)
        if bad:
            # non-finite prefill logits: the call itself succeeded, so the
            # other live slots' KV is intact; fail this request alone
            rec.inc("decode/nonfinite")
            if req.trace is not None:
                req.trace.close("prefill", time.monotonic(),
                                bucket=bucket)
            self.kv.free_slot(slot)
            self._finish(req, exc=RuntimeError(
                f"non-finite prefill logits serving {snap.version} — "
                f"poisoned weights?"), cause="nonfinite")
            return
        now = time.monotonic()
        rec.inc("decode/prefills")
        led = rec.get_ledger()
        if led is not None:
            # a prefill is productive single-sequence compute
            led.fold_split({"goodput": 1.0})
        req.slot = slot
        self._live[slot] = req
        self._lengths[slot] = prompt.size
        self._admitted_at[slot] = now
        if req.trace is not None:
            req.trace.close("prefill", now, bucket=bucket,
                            prompt_rows=int(prompt.size))
        if req.generated:
            # READMISSION: the prefill above ran the same bucket on the
            # same prompt as the first admission, so its KV (and the token
            # it predicts, dropped here) are bitwise the first ones.  The
            # recorded tokens now replay through the decode step, which
            # wrote their KV the first time, so the rebuilt cache is
            # bitwise the evicted one.  (A prefill of prompt + generated
            # would compute those rows through other matmul shapes, whose
            # last-ulp drift can flip a later argmax.)
            rec.inc("decode/readmissions")
            req.replay_i = 1
            self._last_tokens[slot] = req.generated[0]
        else:
            self._emit_token(slot, req, token, now)

    def _step_live(self):
        """One fixed-shape decode step over every live slot."""
        if not self._live:
            return
        rec = self.recorder
        now = time.monotonic()
        # deadline sheds and page growth happen before the step, so that
        # the step's inputs are consistent
        for slot in list(self._live):
            req = self._live.get(slot)
            if req is None:
                continue            # evicted by an earlier slot's growth
            if req.expired(now):
                self._live.pop(slot)
                self.kv.free_slot(slot)
                self._shed_deadline(req, at="decode")
                continue
            if not self.kv.alloc_for(slot, int(self._lengths[slot]) + 1):
                if not self._evict_for(slot, int(self._lengths[slot]) + 1):
                    # nothing else to evict: this slot itself yields
                    self._evict(slot)
        if not self._live:
            return
        live_slots = sorted(self._live)
        tokens = self._last_tokens.copy()
        lengths = self._lengths.copy()
        temps = np.zeros(self.slots, np.float32)
        for s in live_slots:
            temps[s] = self._live[s].temperature
        for s in range(self.slots):
            if s not in self._live:
                tokens[s] = 0
                lengths[s] = 0
        snap = self.registry.get(self.model_name).snapshot
        prog = self._program("decode")
        faultplane.inject("serving.decode_step", rec)
        with rec.span("decode.step"):
            toks, bads = prog(snap.params, self._pool, tokens, lengths,
                              self.kv.tables, temps, self._steps)
        now = time.monotonic()
        for slot in list(self._live):
            if slot in self._live and bads[slot]:
                rec.inc("decode/nonfinite")
                req = self._live.pop(slot)
                self.kv.free_slot(slot)
                self._finish(req, exc=RuntimeError(
                    f"non-finite decode logits serving {snap.version} — "
                    f"poisoned weights?"), cause="nonfinite")
        live_slots = [s for s in live_slots if s in self._live]
        if not live_slots:
            return
        self._steps += 1
        n_live = len(live_slots)
        rec.inc("decode/steps")
        rec.inc("decode/tokens", n_live)
        rec.inc("serving.rows", n_live)   # per-token progress
        rec.gauge("decode/live_slots", n_live)
        rec.gauge("decode/occupancy", n_live / self.slots)
        led = rec.get_ledger()
        if led is not None:
            # this step's interval split by slot occupancy: live slots are
            # goodput, spare slots with queued work queue_wait, the rest
            # idle
            with self._lock:
                depth = len(self._waiting)
            spare = self.slots - n_live
            led.fold_split({"goodput": n_live,
                            "queue_wait": min(spare, depth),
                            "idle": max(spare - depth, 0)})
        for slot in live_slots:
            self._lengths[slot] += 1
            req = self._live[slot]
            if req.replay_i and req.replay_i < len(req.generated):
                # replaying a readmitted slot: this step's prediction was
                # emitted before the eviction; feed the recorded token on
                self._last_tokens[slot] = req.generated[req.replay_i]
                req.replay_i += 1
                rec.inc("decode/replayed_tokens")
                continue
            if req.replay_i:
                req.replay_i = 0       # caught up: the prediction is new
            self._emit_token(slot, req, int(toks[slot]), now)
        if self.report_every and self._steps % self.report_every == 0:
            self._emit_decode_event()

    def _emit_token(self, slot: int, req: _DecodeRequest, token: int,
                    now: float):
        rec = self.recorder
        req.generated.append(token)
        self._last_tokens[slot] = token
        if req.first_token_at is None:
            req.first_token_at = now
            rec.observe("decode/ttft_ms", (now - req.arrival) * 1e3)
        elif req.last_token_at is not None:
            rec.observe("decode/intertoken_ms",
                        (now - req.last_token_at) * 1e3)
        if req.trace is not None:
            # one span per step this request took part in
            req.trace.add_span("token",
                               req.last_token_at or req.first_token_at,
                               now)
        req.last_token_at = now
        req.stream._q.put(token)
        done = len(req.generated) >= req.max_new \
            or (req.eos_id is not None and token == req.eos_id)
        if done:
            self._live.pop(slot, None)
            self.kv.free_slot(slot)
            self._finish(req, result=np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)]))

    def _finish(self, req: _DecodeRequest, result=None,
                exc: Optional[BaseException] = None,
                cause: Optional[str] = None):
        rec = self.recorder
        now = time.monotonic()
        tr = req.trace
        ring = self.trace_ring
        if tr is not None and ring is not None:
            # finish the trace BEFORE completing the future: a client
            # unblocked by .result() must find its request in the ring
            if exc is None:
                tr.meta["tokens"] = len(req.generated)
            else:
                tr.terminal(cause or type(exc).__name__, now)
            ring.finish(tr)
        # the future resolves before the stream's end marker: a consumer
        # whose tokens() iterator just ended may call result(0) at once
        if exc is None:
            rec.inc("decode/finished")
            lat = (now - req.arrival) * 1e3
            rec.observe("decode/request_ms", lat)
            rec.observe("serving.latency_ms", lat)
            req.stream.future.set_result(result)
        else:
            req.stream.future.set_exception(exc)
        req.stream._q.put(_END)

    def _shed_deadline(self, req: _DecodeRequest, at: str):
        """Deadline shed: the terminal ``deadline`` span lands before the
        future fails, in decode as at the queue pop."""
        self.recorder.inc("decode/shed_deadline")
        self._finish(req, exc=LoadShedError(
            "deadline", f"expired during {at}"), cause="deadline")

    def _fail_live(self, exc: BaseException):
        for slot in list(self._live):
            req = self._live.pop(slot)
            self.kv.free_slot(slot)
            self._finish(req, exc=exc)

    def _recover_pool(self, exc: BaseException):
        """After a prefill or decode call raised: the pool may be half
        written (a step that fails mid-layer has written some layers), so
        the live requests' KV cannot be trusted.  Fail them, release their
        pages, and start from a zeroed pool, so that the engine recovers
        from a transient failure instead of failing every later
        request.  Before the next call it waits for the card to finish
        what the failed call queued: that call's input copy may still read
        the staging buffer which the next call rewrites."""
        self._fail_live(exc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._pool = self.kv.init_pool()

    def _emit_decode_event(self):
        rec = self.recorder
        counters = {k: rec.counter_value(k) for k in (
            "decode/requests", "decode/prefills", "decode/readmissions",
            "decode/steps", "decode/tokens", "decode/finished",
            "decode/shed_deadline", "decode/shed_queue_full",
            "decode/recompiles", "kv/page_allocs", "kv/page_frees",
            "kv/evictions")}
        with self._lock:
            depth = len(self._waiting)
        rec.emit_record(
            "decode_event", step=self._steps, live=len(self._live),
            slots=self.slots, occupancy=len(self._live) / self.slots,
            kv_fill=self.kv.fill(), queue_depth=depth,
            ttft=rec.hist_quantiles("decode/ttft_ms", (50.0, 99.0)),
            intertoken=rec.hist_quantiles("decode/intertoken_ms",
                                          (50.0, 99.0)),
            counters=counters)


def _select_tokens(logits, temps, gen: Optional[torch.Generator]):
    """Greedy argmax (temperature 0: deterministic) or, with ``gen``,
    softmax sampling at each row's temperature (Gumbel-max, uniforms
    from ``gen``)."""
    greedy = torch.argmax(logits, dim=-1).int()
    if gen is None:
        return greedy
    sampled = gumbel_sample(logits / torch.clamp(temps, min=1e-6)[:, None],
                            gen)
    return torch.where(temps > 0.0, sampled, greedy)


def _seeded(gen: torch.Generator, seed: int, step: int) -> torch.Generator:
    """``gen`` reseeded from ``(seed, step)`` (host only, no sync), through
    splitmix64, so that every bit of the seed differs from one pair to the
    next (the CPU generator reads only the low 32)."""
    mask = (1 << 64) - 1
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return gen.manual_seed((z ^ (z >> 31)) >> 1)


def _staging(n: int, dev: torch.device) -> torch.Tensor:
    """A host int32 buffer of ``n`` for the inputs of one program, pinned
    when they go to a CUDA device, so that their copy does not block the
    host.  A program reuses its buffer: the call before it ended with the
    device-to-host copy of its outputs, which the stream runs after that
    call's input copy."""
    return torch.empty(n, dtype=torch.int32, pin_memory=dev.type == "cuda")


def _decode_program(model, kv: PagedKVCache, dev: torch.device,
                    gen: torch.Generator, seed: int):
    """The decode step: ``run(params, pool, tokens, lengths, tables,
    temps, step) -> (tokens, non-finite flags)``, numpy in and out.  Its
    inputs cross in one asynchronous host-to-device copy, its outputs in
    one device-to-host copy: the step's one host sync."""
    s, p = kv.n_slots, kv.max_pages_per_slot
    stage = _staging(3 * s + s * p, dev)

    def run(params, pool, tokens, lengths, tables, temps, step):
        np.concatenate([tokens, lengths, tables.reshape(-1),
                        temps.astype(np.float32).view(np.int32)],
                       out=stage.numpy())
        d = stage.to(dev, non_blocking=True)
        tok_d, len_d = d[:s], d[s:2 * s]
        tab_d = d[2 * s:2 * s + s * p].view(s, p)
        temp_d = d[2 * s + s * p:].view(torch.float32)

        def kv_io(name, k_new, v_new):
            kv.write_token(pool[name], tab_d, len_d, k_new, v_new)
            return kv.gather_window(pool[name], tab_d)

        logits = model.decode_tokens(params, tok_d, len_d, kv_io)
        g = _seeded(gen, seed, step) if (temps > 0).any() else None
        tok = _select_tokens(logits, temp_d, g)
        bad = ~torch.isfinite(logits).all(dim=-1)
        out = torch.stack([tok, bad.int()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    return run


def _prefill_program(model, kv: PagedKVCache, dev: torch.device,
                     gen: torch.Generator, seed: int, bucket: int):
    """One prefill bucket: ``run(params, pool, tokens (1, bucket),
    true_len, table, temp, step) -> (token, non-finite)``.  The prompt
    runs through the contiguous cache path (``apply_with_cache`` at
    ``cache_len = bucket``) and its k/v are written into the slot's
    pages."""
    cache_dtype = kv.dtype if not kv.int8 else getattr(torch,
                                                       model.cfg.dtype)
    stage = _staging(bucket + -(-bucket // kv.page_size), dev)

    def run(params, pool, tokens, true_len, table, temp, step):
        np.concatenate([tokens.reshape(-1), table], out=stage.numpy())
        d = stage.to(dev, non_blocking=True)
        tok_d, tab_d = d[:bucket].view(1, bucket), d[bucket:]
        cache = model.init_cache(1, dtype=cache_dtype, cache_len=bucket)
        logits, cache = model.apply_with_cache(params, tok_d, cache, 0)
        for name in kv.layer_names:
            kv.write_prefill(pool[name], tab_d, cache[name]["k"],
                             cache[name]["v"])
        last = logits[0, true_len - 1]
        g = _seeded(gen, seed, step) if temp > 0 else None
        tok = _select_tokens(last[None, :], torch.full(
            (1,), float(temp), device=dev), g)[0]
        bad = ~torch.isfinite(last).all()
        out = torch.stack([tok, bad.int()]).cpu().numpy()
        return int(out[0]), bool(out[1])

    return run


def _decode_loop(engine_ref, cond, waiting, live, ring):
    """The decode thread.  Holds the engine weakly so that a dropped,
    never-shut-down engine stays collectable; stranded requests then fail
    instead of hanging their clients."""
    while True:
        eng = engine_ref()
        if eng is None:
            exc = EngineClosedError(
                "decode engine was garbage-collected before this "
                "request ran")
            with cond:
                stranded = list(waiting) + list(live.values())
                waiting[:] = []
                live.clear()
            for req in stranded:
                if ring is not None and req.trace is not None:
                    req.trace.terminal("engine_closed", time.monotonic(),
                                       name="closed")
                    ring.finish(req.trace)
                if not req.stream.future.done():
                    req.stream.future.set_exception(exc)
                req.stream._q.put(_END)
            return
        try:
            with eng._on_device():
                alive = eng._tick()
        except Exception:
            alive = True           # _tick handles per-request failures;
            # a bug here must not kill the loop
        finally:
            del eng                # never hold the engine across waits
        if not alive:
            return


def build_decode_replica_set(model, n: int, *, name: str = "lm",
                             probe_prompt=None,
                             engine_kw: Optional[Dict[str, Any]] = None,
                             **rs_kw):
    """N decode replicas behind one
    :class:`~bigdl_tpu_torch.serving.ReplicaSet`: one registry +
    DecodeEngine + Recorder per replica, all serving ``name`` (each
    registry holds its own owning copy of ``model``'s weights, on the
    model's device).  The golden probe defaults to a short fixed prompt so
    that ejected replicas can re-admit.  A CanaryPublisher over the set
    validates publications with a golden decode."""
    from .replicas import ReplicaSet
    engine_kw = dict(engine_kw or {})
    engine_kw.pop("recorder", None)
    engines = []
    for _ in range(int(n)):
        reg = ModelRegistry()
        reg.register(name, model)
        engines.append(DecodeEngine(reg, name, recorder=Recorder(),
                                    **engine_kw))
    rs = ReplicaSet(engines, **rs_kw)
    probe = probe_prompt if probe_prompt is not None \
        else np.arange(1, 5, dtype=np.int32)
    rs.set_probe(name, probe)
    return rs


__all__ = ["DecodeEngine", "DecodeStream", "build_decode_replica_set"]
