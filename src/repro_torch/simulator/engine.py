"""Event-heap discrete-event engine for gpu-let serving (paper §5, §6).

One priority queue of typed events drives the whole horizon:

  * ``COMPLETE``  — a gpu-let's in-flight batch finished; resume its
    duty-cycle walk;
  * ``WAKE``      — a sleeping gpu-let reaches its next duty-cycle boundary
    (or its first queued arrival);
  * ``TICK``      — periodic reschedule tick: the engine reports the window's
    observed rates to a subscriber (the ServingController), which may hand
    back a new ``ScheduleResult``;
  * ``APPLY``     — a reorganization completes: the new partitioning goes
    live and every still-queued request is re-routed onto it.

Client arrivals do not occupy the heap at all: the (pre-sorted) arrival
stream is merged into the event loop directly — the next arrival is
ingested whenever it precedes the earliest heap event — which removes one
heap push/pop per request versus the old ARRIVAL-sentinel scheme while
preserving its ordering exactly (arrivals at a tied timestamp ingest
before the event, with the same 1e-12 tolerance).

Execution semantics per gpu-let mirror cluster.py's duty-cycle walk
(Fig. 1 + the Nexus dispatch rule): one batch per assigned model per cycle,
adaptive catch-up batching up to the largest SLO-feasible batch, requests
whose queueing delay already exceeds their SLO dropped at batch formation,
and ground-truth interference applied when the partner gpu-let has a batch
in flight at launch time.  Mid-flight rescheduling carries queued requests
across partition reorganizations, with the paper's 10-15 s reorganization
cost modeled as an explicit delay (``reorg_ms``; ``reorg_policy`` selects
whether the old partitioning keeps serving or launches pause).

Struct-of-arrays hot path
-------------------------
Requests never exist as objects inside the engine.  The trace is a
:class:`~repro.simulator.trace.RequestTrace` (parallel numpy arrays); the
engine works in a *local, arrival-sorted index space* over gathered copies
of those arrays, and every per-gpu-let queue is an :class:`_IdxQueue` —
a growable index ring over the arrays, not a deque of objects.  Batch
formation and SLO-expiry drops are vectorized mask operations on index
slices; completions are stamped with one fancy-indexed store per batch;
metrics reduce once at the end (``metrics.collect_arrays``).  Results are
scattered back to the shared trace (fabric runs) or written back into the
submitted ``Request`` objects (API-edge runs) after the horizon.

The event *logic* is unchanged from the object-path engine — for a given
seeded trace the SoA path is metrics-identical, per request (property-
tested against pre-refactor goldens in tests/test_soa_equivalence.py) —
but a 100k-request trace now simulates in well under a second and
million-request fabric sweeps are routine.
"""
from __future__ import annotations

import dataclasses
import heapq
from bisect import bisect_left, bisect_right
from collections.abc import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.hardware import AcceleratorSpec, RTX_2080TI
from repro_torch.core.interference import true_interference_factors
from repro_torch.core.latency import LatencyMemo, LatencyProvider
from repro_torch.core.profiles import ModelProfile
from repro_torch.core.scheduler_base import ScheduleResult
from repro_torch.obs.spans import (ApplySpan, BatchSpan, DecodeSpan, DropSpan,
                             PreemptSpan, TickSpan)
from repro_torch.obs.timeline import (CAUSE_COMPLETED, CAUSE_DROP_DEADLINE,
                                CAUSE_DROP_SHUTDOWN)
from repro_torch.simulator.events import Request
from repro_torch.simulator.metrics import SimMetrics, collect_arrays
from repro_torch.simulator.trace import COMPLETED, DROPPED, PENDING, UNSERVED, \
    RequestTrace

# Event kinds, in tie-break order at equal timestamps: arrivals (merged
# from the sorted trace, kind 0 slot kept for them) are ingested before
# anything launches (a batch forming at t sees requests arriving at t),
# completions clear in-flight state before partners probe interference,
# reorganizations apply before ticks observe, and wakes run last.
ARRIVAL, COMPLETE, APPLY, TICK, WAKE = 0, 1, 2, 3, 4

_INF = float("inf")

#: local-only status sentinel for rows revoked by a crash or migration
#: hand-back (ISSUE 9).  Never written to the shared trace: the masked
#: scatter/sync paths skip these rows entirely, so the fabric's replay
#: dispatch (which may create a *new* local row for the same global id,
#: possibly on this same engine) stays the single writer.
EVICTED_LOCAL = 255


@dataclasses.dataclass
class EngineConfig:
    horizon_ms: float = 20_000.0
    acc: AcceleratorSpec = RTX_2080TI
    #: reschedule-tick period; None disables ticks (static schedule).
    period_ms: float | None = None
    #: partition-reorganization cost: delay between a reschedule decision
    #: and the new partitioning going live (paper: 10-15 s).
    reorg_ms: float = 0.0
    #: "serve-old": the previous partitioning keeps serving during the
    #: reorganization (paper §5: the cost hides inside the window).
    #: "pause": launches stop; arrivals queue up until the APPLY.
    reorg_policy: str = "serve-old"
    #: hard stop for the drain phase after the horizon (guards pathological
    #: overload traces, mirroring cluster.py's max-clock guard).
    drain_factor: float = 8.0
    #: pluggable L(b, p) source; None = the calibrated analytic GPU model.
    #: The tpu-let path passes core/tpulets.RooflineLatency here.
    lat: LatencyProvider | None = None
    #: apply ground-truth pairwise interference between co-located gpu-lets.
    #: tpu-lets are disjoint sub-meshes (no shared SMs/L2), so the TPU path
    #: disables this.
    interference: bool = True
    #: priority-aware serving: queues order by priority class (0 = most
    #: important) and a strictly-lower-priority in-flight batch may be
    #: preempted when an arriving request's SLO cannot survive waiting it
    #: out.  Off by default: the single-tenant engine is priority-blind and
    #: byte-identical to pre-fabric behavior.
    preemption: bool = False
    #: modeled cost of tearing down a preempted batch before the gpu-let
    #: can launch again (kernel drain + context flip).
    preempt_cost_ms: float = 1.0
    #: keep the per-event log (``engine.log``).  Costs one tuple per
    #: batch/drop/preempt — switch off for multi-million-request sweeps
    #: where the log would dominate memory.  Metrics are unaffected.
    event_log: bool = True
    #: streaming traces: max tokens one decode chunk advances each live
    #: stream before membership is re-examined — the continuous-batching
    #: granularity.  Smaller = new prefills join the pool sooner (better
    #: TTFT under load), larger = fewer simulator events.
    decode_quantum: int = 8
    #: fault injection (ISSUE 9): sorted, non-overlapping ``(t0, t1)``
    #: node-down windows (``t1`` may be ``inf`` for a permanent crash).
    #: Inside a window no batch launches — walkers park and wake at the
    #: window end; the fabric's chaos loop evicts queued/in-flight work
    #: at the window start via :meth:`EventHeapEngine.crash_evict`.
    outages: tuple = ()
    #: straggler windows ``(t0, t1, factor)``: every launch whose start
    #: falls inside a window runs ``factor``× slower.  The inflation is
    #: stamped into the timeline's interference column (it is a
    #: co-location-shaped slowdown), keeping attribution exact.
    slowdowns: tuple = ()


class _IdxQueue:
    """Index queue over the trace arrays (one per gpu-let×model).

    Holds local request ids (plain ints) in a flat list with a ``head``
    cursor: appends are list pushes, consumption is a pointer bump (with
    amortized compaction), and batch formation walks ints through
    python-scalar mirrors of the trace arrays — orders of magnitude
    cheaper than attribute access on request objects, and cheaper than
    per-batch numpy dispatch at the typical single-digit batch sizes.
    Under priority serving a parallel ``pri`` list keeps the queue
    priority-sorted (FIFO within a class); class-ordered insertion is a
    C ``bisect`` plus one ``list.insert`` memmove.
    """

    __slots__ = ("buf", "pri", "head")

    def __init__(self) -> None:
        self.buf: list[int] = []
        self.pri: list[int] = []
        self.head = 0

    def __len__(self) -> int:
        return len(self.buf) - self.head

    def append(self, i: int, p: int) -> None:
        self.buf.append(i)
        self.pri.append(p)

    def insert_by_priority(self, i: int, p: int) -> None:
        """Class-ordered insertion: after every entry with priority <= p."""
        pos = bisect_right(self.pri, p, self.head)
        self.buf.insert(pos, i)
        self.pri.insert(pos, p)

    def requeue_front_of_class(self, ids: Sequence[int],
                               pris: Sequence[int]) -> None:
        """Re-insert a preempted batch at the head of each class segment.

        The batch holds the oldest requests of its level(s), so it re-runs
        before same-level arrivals but never jumps a more important one.
        Reversed insertion at each class boundary preserves batch order.
        """
        for k in range(len(ids) - 1, -1, -1):
            p = pris[k]
            pos = bisect_left(self.pri, p, self.head)
            self.buf.insert(pos, ids[k])
            self.pri.insert(pos, p)

    def compact(self) -> None:
        """Drop consumed prefix once it dominates the buffer."""
        h = self.head
        if h > 64 and 2 * h >= len(self.buf):
            del self.buf[:h]
            del self.pri[:h]
            self.head = 0

    def drain(self) -> list[int]:
        """All queued ids (copy); caller owns interpreting them."""
        return self.buf[self.head:]


class _LetRt:
    """Runtime state of one gpu-let (one duty-cycle walker)."""

    __slots__ = ("let", "idx", "partner", "duty", "walk_order", "queues",
                 "qlist", "cycle_start", "t", "slot", "inflight", "pending",
                 "idle_floor", "gen", "inflight_reqs", "inflight_prio",
                 "busy", "epoch", "frac", "latcache", "dstreams", "dlat")

    def __init__(self, let, idx: int, epoch: int):
        self.let = let
        self.idx = idx
        self.epoch = epoch
        self.partner: _LetRt | None = None
        self.duty = max((a.duty_ms for a in let.assignments), default=1.0)
        #: bumped on preemption so the cancelled batch's COMPLETE is stale
        self.gen = 0
        self.inflight_reqs: list[int] | None = None
        self.inflight_prio = 0    # best (lowest) priority level in flight
        #: (assignment, catch-up cap, model id, profile, queue) in launch
        #: order — tightest SLO first.  The scheduler's duty-cycle
        #: admission (``duty + L <= SLO``) assumes a model's batch launches
        #: at the cycle start; EDF ordering within the cycle keeps that
        #: assumption honest for tight-SLO models and pushes the in-cycle
        #: serialization wait onto the models with slack.
        self.walk_order: list[tuple] = []
        #: model id -> _IdxQueue, in assignment order (vocab models only)
        self.queues: dict[int, _IdxQueue] = {}
        self.qlist: list[_IdxQueue] = []
        self.cycle_start = 0.0
        self.t = 0.0              # local clock: time processed through
        self.slot = 0
        self.inflight: tuple[int, int, float, float] | None = None
        self.pending = False      # a COMPLETE or WAKE event will drive us
        self.idle_floor = 0.0     # earliest allowed next cycle when idle
        self.busy = 0.0           # busy-time accumulator (this epoch)
        self.frac = let.frac      # hoisted: GpuLet.frac is a property
        #: (model id, batch size) -> interference-free exec ms; the memo
        #: call per launch is measurable at millions of batches
        self.latcache: dict[tuple[int, int], float] = {}
        #: streaming only: model id -> decode pool, a FIFO of
        #: ``[local_id, remaining_tokens]`` entries for streams past
        #: prefill; and a (model id, pool size) -> step-ms cache
        self.dstreams: dict[int, list] = {}
        self.dlat: dict[tuple[int, int], float] = {}


#: tick subscriber: (t_ms, observed_rates_req_s, engine) -> new schedule|None
TickFn = Callable[[float, dict[str, float], "EventHeapEngine"],
                  ScheduleResult | None]


class EventHeapEngine:
    """Discrete-event serving engine over one event heap."""

    def __init__(self, profiles: Mapping[str, ModelProfile],
                 cfg: EngineConfig | None = None,
                 schedule: ScheduleResult | None = None,
                 on_tick: TickFn | None = None):
        self.profiles = dict(profiles)
        self.cfg = cfg or EngineConfig()
        self.on_tick = on_tick
        self.memo = LatencyMemo(self.cfg.acc, inner=self.cfg.lat)
        self.preemptions = 0
        self._intf_cache: dict[tuple, float] = {}
        self._heap: list[tuple] = []
        self._seq = 0
        self.now = 0.0
        self.epoch = 0
        self.paused = False
        self._pending_schedule: ScheduleResult | None = None
        #: pre-planned partition changes (fabric migration cuts): APPLY
        #: events carry 1-based indices into this list
        self._apply_plan: list[ScheduleResult] = []
        self.schedule: ScheduleResult | None = None
        self.lets: list[_LetRt] = []
        #: model id -> [let_idx, rate, wrr_credit] targets (live schedule)
        self._targets: dict[int, list[list]] = {}
        self.unrouted: dict[int, _IdxQueue] = {}
        self.busy_ms: dict[tuple[int, int], float] = {}
        #: compact event log of typed span records (repro.obs.spans):
        #: BatchSpan / DecodeSpan / DropSpan / PreemptSpan / ApplySpan /
        #: TickSpan.  Records are NamedTuples with the historical field
        #: order, so positional consumers (e[0] == "batch") still work.
        self.log: list[tuple] = []
        self.ticks: list[tuple[float, bool]] = []
        #: per-window observed arrival counts (flushed at each TICK and at
        #: end of horizon when ticks are enabled)
        self.window_obs: list[dict[str, float]] = []
        self._win_counts: dict[int, int] = {}
        self._win_start = 0.0
        # ---- trace state (bound at run()) ----
        self.trace: RequestTrace | None = None
        self._own_chunks: list[np.ndarray] = []      # global ids, submit order
        self._late_chunks: list[np.ndarray] = []     # post-bind add_arrivals
        self._pending_objs: list[Request] = []       # object-edge submissions
        self._bound = False
        self._arr_idx = 0
        self._n = 0
        # local arrival-sorted arrays (gathered copies; see run())
        self._gidx = self._arr = self._slo = self._done = None
        self._mid = self._pri = self._status = self._preempted = None
        self._arr_l: list[float] = []
        self._slo_l: list[float] = []
        self._mid_l: list[int] = []
        self._pri_l: list[int] = []
        self._prof_by_mid: list[ModelProfile | None] = []
        # streaming mirrors (bound only when trace.has_streams)
        self._streams_on = False
        self._plen_l: list[int] = []
        self._olen_l: list[int] = []
        self._ttft_l: list[float] = []
        self._tpot_l: list[float] = []
        self._ftok_l: list[float] = []
        self._tok_l: list[int] = []
        self._tpot_by_mid: list[float] = []
        # observability mirrors (bound only when trace.obs is attached)
        self._tl_on = False
        self._tlf_l: list[float] = []   # first launch
        self._tll_l: list[float] = []   # last (surviving) launch
        self._tli_l: list[float] = []   # surviving-launch interference
        self._tld_l: list[float] = []   # accumulated decode interference
        self._tlr_l: list[float] = []   # resolve stamp (drops)
        self._tlc_l: list[int] = []     # cause code
        # hoisted config flags (read per routed request)
        self._preempt_on = self.cfg.preemption
        self._log_on = self.cfg.event_log
        # fault injection (chaos serving): outage/straggler windows and
        # the local->global id map + eviction bookkeeping.  All three
        # flags are False/zero on a faults-off run, so every hot path
        # below stays byte-identical to the legacy engine.
        self._outages = tuple(self.cfg.outages)
        self._outage_on = bool(self._outages)
        self._slowdowns = tuple(self.cfg.slowdowns)
        self._slow_on = bool(self._slowdowns)
        self._gid_l: list[int] = []
        self._n_evicted = 0
        if schedule is not None:
            self._install(schedule)

    # ---- event plumbing ---------------------------------------------------

    def _push(self, t: float, kind: int, a: int = 0, b: int = 0,
              c: int = 0) -> None:
        # flat 6-tuples: one allocation per event, and the (t, kind, seq)
        # prefix makes ties deterministic before payload fields compare
        self._seq += 1
        heapq.heappush(self._heap, (t, kind, self._seq, a, b, c))

    # ---- trace ingestion (API edges) --------------------------------------

    def submit(self, requests: Sequence[Request]) -> None:
        """Add a (whole-horizon) object-edge request trace.

        Results are written back into these objects after :meth:`run`
        (the object path is an adapter over the SoA hot path).
        """
        self._pending_objs.extend(requests)

    def submit_trace(self, trace: RequestTrace,
                     idx: np.ndarray | None = None) -> None:
        """Add an index slice of a shared SoA trace (the fabric hand-off).

        The engine stamps completions straight back into ``trace``'s
        arrays at the end of :meth:`run` — no object lists cross the
        node boundary.
        """
        if self.trace is not None and self.trace is not trace:
            raise ValueError("engine already bound to a different trace")
        if self._pending_objs:
            raise ValueError("cannot mix submit() and submit_trace()")
        self.trace = trace
        if idx is None:
            idx = np.arange(len(trace), dtype=np.int64)
        self._own_chunks.append(np.asarray(idx, dtype=np.int64))

    @property
    def requests(self) -> list:
        """Arrival-sorted request objects (API-edge compatibility).

        After an object-path run these are the submitted ``Request``
        objects; after a trace-path run they are zero-copy
        ``RequestView``\\ s into the shared trace.
        """
        if self._pending_objs:
            return sorted(self._pending_objs, key=lambda r: r.arrival_ms)
        if self.trace is not None and self._gidx is not None:
            return self.trace.views(self._gidx)
        return []

    # ---- binding: gather local arrival-sorted arrays ----------------------

    def _bind_trace(self) -> None:
        objs = self._pending_objs
        if objs and self.trace is None:
            self.trace = RequestTrace.from_requests(objs)
            self._own_chunks = [np.arange(len(objs), dtype=np.int64)]
        tr = self.trace
        if tr is None:
            tr = self.trace = RequestTrace([], np.empty(0), np.empty(0),
                                           np.empty(0, dtype=np.int32))
            self._own_chunks = [np.empty(0, dtype=np.int64)]
        own = (self._own_chunks[0] if len(self._own_chunks) == 1
               else np.concatenate(self._own_chunks))
        arr = tr.arrival_ms[own]
        order = np.argsort(arr, kind="stable")
        self._gidx = own[order]
        self._arr = arr[order]
        self._slo = tr.slo_ms[self._gidx]
        self._mid = tr.model_id[self._gidx]
        self._pri = tr.priority[self._gidx].astype(np.int64)
        n = self._n = len(own)
        # python-scalar mirrors: the per-event hot loops (ingest, kick,
        # batch formation) touch individual requests, where plain-list
        # reads/stores beat numpy scalar dispatch by ~10x.  The result
        # lists convert to arrays once at the end of run().
        self._arr_l = self._arr.tolist()
        self._slo_l = self._slo.tolist()
        self._mid_l = self._mid.tolist()
        self._pri_l = self._pri.tolist()
        self._done_l: list[float] = [np.nan] * n
        self._status_l: list[int] = [PENDING] * n
        self._preempted_l: list[bool] = [False] * n
        self._gid_l = self._gidx.tolist()
        self._done = self._status = self._preempted = None
        self._prof_by_mid = [self.profiles.get(m) for m in tr.models]
        self._streams_on = bool(tr.has_streams)
        if self._streams_on:
            if (self.on_tick is not None or self._apply_plan
                    or self._pending_schedule is not None):
                raise ValueError(
                    "streaming traces do not support mid-run reschedules")
            g = self._gidx
            self._plen_l = tr.prompt_len[g].tolist()
            self._olen_l = tr.output_len[g].tolist()
            self._ttft_l = tr.ttft_slo_ms[g].tolist()
            self._tpot_l = tr.tpot_slo_ms[g].tolist()
            self._ftok_l = [np.nan] * n
            self._tok_l = [0] * n
            # tightest per-model TPOT: the decode slot's EDF key and the
            # cadence the decode batch cap must hold
            tp = np.full(len(tr.models), np.inf)
            if n:
                np.minimum.at(tp, self._mid, tr.tpot_slo_ms[g])
            self._tpot_by_mid = tp.tolist()
        # lifecycle timeline mirrors: local fresh columns (replayed rows
        # were reset by the fabric before re-dispatch, so starting from
        # NaN/0 matches the timeline's current state for our rows) that
        # scatter back into trace.obs at the end of the run.
        self._tl_on = tr.obs is not None
        if self._tl_on:
            self._tlf_l = [np.nan] * n
            self._tll_l = [np.nan] * n
            self._tli_l = [0.0] * n
            self._tld_l = [0.0] * n
            self._tlr_l = [np.nan] * n
            self._tlc_l = [0] * n
        self._bound = True
        # the schedule was installed before the vocab existed: bind it now
        self._bind_schedule()

    def _finalize_arrays(self) -> None:
        """Convert the per-request result lists into arrays (end of run)."""
        if self._done is None:
            self._done = np.asarray(self._done_l, dtype=np.float64)
            self._status = np.asarray(self._status_l, dtype=np.uint8)
            self._preempted = np.asarray(self._preempted_l, dtype=bool)

    def _scatter_back(self) -> None:
        tr = self.trace
        g = self._gidx
        self._finalize_arrays()
        done, status, preempted = self._done, self._status, self._preempted
        keep = None
        if self._n_evicted:
            # crash-evicted rows were (or will be) re-dispatched by the
            # fabric — possibly back onto this very engine as a fresh
            # local row — so the dead rows must not write anything back
            keep = status != EVICTED_LOCAL
            g = g[keep]
            done, status, preempted = done[keep], status[keep], \
                preempted[keep]
        tr.completion_ms[g] = done
        tr.status[g] = status
        tr.preempted[g] |= preempted
        if self._streams_on:
            ftok = np.asarray(self._ftok_l, dtype=np.float64)
            tok = np.asarray(self._tok_l, dtype=np.int32)
            if keep is not None:
                ftok, tok = ftok[keep], tok[keep]
            tr.first_token_ms[g] = ftok
            tr.tokens_done[g] = tok
        if self._tl_on:
            tl = tr.obs
            tlf = np.asarray(self._tlf_l, dtype=np.float64)
            tll = np.asarray(self._tll_l, dtype=np.float64)
            tli = np.asarray(self._tli_l, dtype=np.float64)
            tld = np.asarray(self._tld_l, dtype=np.float64)
            # completed rows close at their completion stamp; everything
            # else closed at its drop decision (stamped in the walk/sweeps)
            res = np.asarray(self._tlr_l, dtype=np.float64)
            cau = np.asarray(self._tlc_l, dtype=np.uint8)
            if keep is not None:
                tlf, tll, tli, tld = tlf[keep], tll[keep], tli[keep], \
                    tld[keep]
                res, cau = res[keep], cau[keep]
            comp = status == COMPLETED
            res[comp] = done[comp]
            cau[comp] = CAUSE_COMPLETED
            tl.first_launch_ms[g] = tlf
            tl.last_launch_ms[g] = tll
            tl.intf_ms[g] = tli
            tl.decode_intf_ms[g] = tld
            tl.resolve_ms[g] = res
            tl.cause[g] = cau
        if self._pending_objs:
            tr.write_back(self._pending_objs)

    # ---- schedule installation / routing ----------------------------------

    def _flush_busy(self) -> None:
        """Fold the lets' busy-time accumulators into ``busy_ms``."""
        for rt in self.lets:
            if rt.busy:
                key = (rt.epoch, rt.idx)
                self.busy_ms[key] = self.busy_ms.get(key, 0.0) + rt.busy
                rt.busy = 0.0

    def _install(self, result: ScheduleResult) -> None:
        """Make ``result`` the live partitioning; re-route queued requests."""
        carry: list[int] = []
        for rt in self.lets:
            for q in rt.queues.values():
                carry.extend(q.drain())
        for q in self.unrouted.values():
            carry.extend(q.drain())
        self._flush_busy()
        # in-flight batches on the old partitioning run to completion; their
        # requests already carry completion times (recorded at launch).
        self.epoch += 1
        self.schedule = result
        self.lets = []
        self._targets = {}
        self.unrouted = {}
        for i, let in enumerate(result.gpulets):
            rt = _LetRt(let, i, self.epoch)
            rt.cycle_start = rt.t = rt.idle_floor = self.now
            self.lets.append(rt)
        for i, li in enumerate(result.gpulets):
            for j, lj in enumerate(result.gpulets):
                if j != i and lj.gpu_id == li.gpu_id:
                    self.lets[i].partner = self.lets[j]
        if self._bound:
            self._bind_schedule()
            if carry:
                carry.sort(key=self._arr_l.__getitem__)  # stable, like the
                # object path's carry.sort(key=arrival_ms)
                route = self._route
                for i in carry:
                    route(i)
            self.paused = False
            for rt in self.lets:
                self._kick(rt)

    def _bind_schedule(self) -> None:
        """Key the live schedule's routing/walk structures by model id."""
        if self.schedule is None or self.trace is None:
            return
        vocab = self.trace.model_index
        self._targets = {}
        for i, let in enumerate(self.schedule.gpulets):
            rt = self.lets[i]
            rt.queues = {}
            rt.walk_order = []
            for a in let.assignments:
                mid = vocab.get(a.model)
                if mid is not None:
                    q = rt.queues.get(mid)
                    if q is None:
                        q = rt.queues[mid] = _IdxQueue()
                    # routing entry carries the let + queue refs so the
                    # per-request hot path needs no dict lookups
                    self._targets.setdefault(mid, []).append(
                        [rt, q, a.rate, 0.0])
            # EDF launch order, matching the admission test's walk: each
            # model's catch-up batch cap is derived under its *launch
            # offset* within the cycle (the previous assignment's promised
            # in-cycle completion, recorded by the scheduler in
            # est_latency_ms) so catch-up batches cannot blow the SLO of a
            # model that launches behind earlier batches.
            ordered = sorted(let.assignments,
                             key=lambda a: self.profiles[a.model].slo_ms)
            offset = 0.0
            for a in ordered:
                prof = self.profiles[a.model]
                cap = max(a.batch, self.memo.max_batch_under_slo(
                    prof, let.frac, prof.slo_ms, offset_ms=offset))
                mid = vocab.get(a.model, -1)
                rt.walk_order.append((a, cap, mid, prof,
                                      rt.queues.get(mid)))
                offset = max(offset, a.est_latency_ms)
            if self._streams_on:
                # interleave one decode slot per served model, the whole
                # walk EDF-ordered by token-deadline slack: a decode
                # slot's key is the model's tightest TPOT (ties break
                # decode-first), a prefill slot's its TTFT-read SLO.
                # Decode slots carry ``assignment=None`` / ``queue=None``
                # and a pool-size cap holding the TPOT cadence.
                merged = [(e[3].slo_ms, 1, e) for e in rt.walk_order]
                seen: set[int] = set()
                for e in rt.walk_order:
                    mid = e[2]
                    if mid < 0 or mid in seen or e[4] is None:
                        continue
                    seen.add(mid)
                    prof = e[3]
                    tpot = self._tpot_by_mid[mid]
                    dcap = (self.memo.max_decode_batch(prof, let.frac,
                                                       tpot)
                            if tpot < np.inf else 0)
                    if dcap <= 0:
                        dcap = 1   # run solo; SLO misses surface in TPOT
                    merged.append((tpot, 0, (None, dcap, mid, prof,
                                             None)))
                merged.sort(key=lambda m: (m[0], m[1]))
                rt.walk_order = [m[2] for m in merged]
                rt.dstreams = {}
                rt.dlat = {}
            rt.qlist = list(rt.queues.values())

    def _route(self, i: int) -> None:
        """Smooth weighted round-robin routing to gpu-lets serving model i."""
        mid = self._mid_l[i]
        tgt = self._targets.get(mid)
        if not tgt:
            # not in the live partitioning: requests queue up (they are
            # re-routed at the next APPLY) instead of vanishing.
            q = self.unrouted.get(mid)
            if q is None:
                q = self.unrouted[mid] = _IdxQueue()
            q.append(i, self._pri_l[i])
            return
        if len(tgt) == 1:
            # single target: the WRR credit update is a net no-op
            entry = tgt[0]
        else:
            total = 0.0
            best = None
            for entry in tgt:
                c = entry[3] + entry[2]
                entry[3] = c
                total += entry[2]
                if best is None or c > best[3]:
                    best = entry
            best[3] -= total
            entry = best
        rt = entry[0]
        q = entry[1]
        if self._preempt_on:
            p = self._pri_l[i]
            if len(q.buf) == q.head or q.pri[-1] <= p:
                q.buf.append(i)
                q.pri.append(p)
            else:
                q.insert_by_priority(i, p)
            if rt.inflight is not None and rt.inflight_prio > p:
                self._maybe_preempt(rt, i)
        else:
            q.buf.append(i)
        if not rt.pending and rt.inflight is None:
            # an idle let's queues were all empty, so this request is the
            # earliest queued arrival — skip the scan
            self._kick(rt, self._arr_l[i])

    def _next_arrival(self, rt: _LetRt) -> float | None:
        arr = None
        arr_l = self._arr_l
        for q in rt.qlist:
            if len(q.buf) > q.head:
                a = arr_l[q.buf[q.head]]
                if arr is None or a < arr:
                    arr = a
        return arr

    def _kick(self, rt: _LetRt, arr: float | None = None) -> None:
        """Wake an idle gpu-let that (now) has queued work.

        ``arr`` short-circuits the earliest-arrival scan when the caller
        knows it — a route to an idle let implies every queue was empty,
        so the routed request IS the earliest (the idle-return from
        ``_walk`` only happens with all queues drained).
        """
        if rt.pending or rt.inflight is not None or self.paused:
            return
        if arr is None:
            arr = self._next_arrival(rt)
            if arr is None:
                return
        start = max(rt.idle_floor, arr, self.now)
        rt.cycle_start = start
        rt.slot = 0
        rt.t = max(rt.t, start)
        if start > self.now + 1e-9:
            rt.pending = True
            self._push(start, WAKE, self.epoch, rt.idx)
        else:
            self._walk(rt)

    # ---- priority preemption ----------------------------------------------

    def _maybe_preempt(self, rt: _LetRt, i: int) -> None:
        """Preempt rt's lower-priority in-flight batch iff it saves i's SLO.

        Preempting always wastes the unfinished execution plus a modeled
        teardown cost, so it only happens when (a) waiting out the batch
        would blow the SLO, (b) serving the request right after the
        teardown still fits the SLO, and (c) the remaining execution is
        longer than the teardown itself.
        """
        if rt.inflight_reqs is None:
            return   # streaming decode chunk: no cheap requeue, runs out
        _mid, _b, _start, done = rt.inflight
        remaining = done - self.now
        cost = self.cfg.preempt_cost_ms
        if remaining <= cost:
            return
        prof = self._prof_by_mid[self._mid_l[i]]
        est = self.memo.latency_ms(prof, 1, rt.frac)
        slack = self._slo_l[i] - (self.now - self._arr_l[i])
        if remaining + est <= slack or cost + est > slack:
            return
        self._preempt(rt, first_mid=self._mid_l[i])

    def _preempt(self, rt: _LetRt, first_mid: int | None = None) -> None:
        """Cancel rt's in-flight batch; its requests re-queue un-completed.

        ``first_mid`` restarts the walk at that model's slot so the
        preempting request launches right after the teardown — without it
        the walk would restart at slot 0 and could immediately relaunch
        the batch it just tore down (whenever the preempted model sits
        earlier in EDF order), defeating the preemption.
        """
        mid, b, _start, done = rt.inflight
        cost = self.cfg.preempt_cost_ms
        # the unfinished tail of the batch never executes; the teardown does.
        rt.busy += cost - (done - self.now)
        batch = rt.inflight_reqs
        done_l, status_l, pre_l = self._done_l, self._status_l, \
            self._preempted_l
        pri_l = self._pri_l
        for i in batch:
            done_l[i] = np.nan
            status_l[i] = PENDING
            pre_l[i] = True
        if self._streams_on:
            # a cancelled prefill never emitted its first token: unwind
            # the launch-time stamps and pull the batch back out of the
            # decode pool it had just joined
            ftok_l, tok_l = self._ftok_l, self._tok_l
            for i in batch:
                ftok_l[i] = np.nan
                tok_l[i] = 0
            dm = rt.dstreams.get(mid)
            if dm:
                member = set(batch)
                rt.dstreams[mid] = [e for e in dm
                                    if e[0] not in member]
        rt.queues[mid].requeue_front_of_class(
            batch, [pri_l[i] for i in batch])
        self.preemptions += 1
        if self._log_on:
            self.log.append(PreemptSpan("preempt", self.now, rt.idx,
                                        self.trace.models[mid], b))
        rt.inflight = None
        rt.inflight_reqs = None
        rt.gen += 1               # the pending COMPLETE event is now stale
        rt.slot = 0
        if first_mid is not None:
            for k, entry in enumerate(rt.walk_order):
                if entry[2] == first_mid and entry[0] is not None:
                    rt.slot = k
                    break
        rt.cycle_start = rt.t = self.now + cost
        rt.pending = True
        self._push(rt.t, WAKE, self.epoch, rt.idx)

    # ---- fault injection (ISSUE 9 chaos serving) --------------------------

    def _outage_end(self, t: float) -> float | None:
        """End of the outage window covering ``t``, or None when up."""
        for t0, t1 in self._outages:
            if t < t0:
                return None
            if t < t1:
                return t1
        return None

    def _slow_factor(self, t: float) -> float:
        for t0, t1, f in self._slowdowns:
            if t0 <= t < t1:
                return f
        return 1.0

    def _park(self, rt: _LetRt, t: float, slot: int, cycle_start: float,
              oe: float) -> None:
        """Park a walker through an outage window; wake at the window end.

        The walker's local clock jumps to the window end (nothing can
        launch in between), so the wake re-enters the walk past the
        window — or straight into a chained one, which parks it again.
        A permanent crash (``oe == inf``) parks forever: ``pending``
        stays set so kicks no-op, and no wake event is ever scheduled.
        """
        rt.slot = slot
        rt.cycle_start = cycle_start
        rt.pending = True
        if oe == _INF:
            rt.t = t
            return
        rt.t = oe if oe > t else t
        self._push(oe, WAKE, self.epoch, rt.idx)

    def _evict_local(self, i: int) -> None:
        self._done_l[i] = np.nan
        self._status_l[i] = EVICTED_LOCAL
        if self._streams_on:
            self._ftok_l[i] = np.nan
            self._tok_l[i] = 0
        if self._tl_on:
            self._tlr_l[i] = np.nan
            self._tlc_l[i] = 0
        self._n_evicted += 1

    def crash_evict(self, t_ms: float) -> np.ndarray:
        """A crash at ``t_ms``: every request this engine still owes dies.

        Revokes in-flight launch stamps (completions beyond ``t_ms``
        cannot have happened — the silicon went away mid-batch), drains
        every queue and decode pool, and marks the lot with a local
        EVICTED sentinel that masks them out of ``sync_trace`` /
        ``_scatter_back`` / ``metrics``.  Returns the *global* ids of the
        evicted rows so the fabric can account the casualties and decide
        replay; the same global id may later be re-dispatched here (a new
        local row), and the masked scatter keeps exactly one writer.
        """
        if not self._bound:
            self._bind_trace()
        out: list[int] = []
        gid_l = self._gid_l
        status_l = self._status_l
        # 1) in-flight work: completion stamps beyond the crash instant
        done_arr = np.asarray(self._done_l, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            hit = np.flatnonzero(done_arr > t_ms)
        for i in hit.tolist():
            if status_l[i] == COMPLETED:
                self._evict_local(i)
                out.append(gid_l[i])
        # 2) queued + pooled work, and the walkers' in-flight state
        for rt in self.lets:
            for q in rt.qlist:
                buf = q.buf
                for j in range(q.head, len(buf)):
                    i = buf[j]
                    if status_l[i] == PENDING:
                        self._evict_local(i)
                        out.append(gid_l[i])
                buf.clear()
                q.pri.clear()
                q.head = 0
            for dm in rt.dstreams.values():
                for e in dm:
                    i = e[0]
                    if status_l[i] == PENDING:
                        self._evict_local(i)
                        out.append(gid_l[i])
                dm.clear()
            rt.gen += 1        # any pending COMPLETE is stale
            rt.inflight = None
            rt.inflight_reqs = None
            rt.pending = False
            if rt.t < t_ms:
                rt.t = t_ms
            if rt.idle_floor < t_ms:
                rt.idle_floor = t_ms
        # 3) rows parked for a model the live schedule doesn't serve
        for q in self.unrouted.values():
            buf = q.buf
            for j in range(q.head, len(buf)):
                i = buf[j]
                if status_l[i] == PENDING:
                    self._evict_local(i)
                    out.append(gid_l[i])
            buf.clear()
            q.pri.clear()
            q.head = 0
        return np.asarray(out, dtype=np.int64)

    def evict_unrouted(self, mids) -> np.ndarray:
        """Pull queued rows of the given models out of ``unrouted``.

        The chaos loop's migration hand-back: a donor's removed model
        parks its queued requests in ``unrouted`` at the cut; this
        returns their global ids (marking the local rows EVICTED) so the
        fabric can replay them onto the model's new home.
        """
        if not self._bound:
            return np.empty(0, dtype=np.int64)
        out: list[int] = []
        status_l, gid_l = self._status_l, self._gid_l
        for mid in mids:
            q = self.unrouted.pop(int(mid), None)
            if q is None:
                continue
            for i in q.drain():
                if status_l[i] == PENDING:
                    self._evict_local(i)
                    out.append(gid_l[i])
        return np.asarray(out, dtype=np.int64)

    # ---- the duty-cycle walk ----------------------------------------------

    def _walk(self, rt: _LetRt) -> None:
        """One duty-cycle walker step: launch the next batch, or pace.

        The whole per-batch path — slot scan, batch formation (scalar
        port of the object path's pop loop: SLO-expired requests drop
        without a batch slot, and requests behind the cap-th live one
        stay queued even if already expired), completion stamping, and
        in-flight priority — runs fused over plain ints and list
        reads/stores, with the let's clock mirrored in locals.  At the
        typical single-digit batch sizes this beats both object
        attribute-chasing and per-batch numpy dispatch by an order of
        magnitude.

        Streaming traces divert to :meth:`_walk_stream` here — the one
        branch the classic path pays for the phase machinery.
        """
        if self._streams_on:
            return self._walk_stream(rt)
        walk = rt.walk_order
        n = len(walk)
        if n == 0:
            return
        arr_l = self._arr_l
        slo_l = self._slo_l
        done_l = self._done_l
        status_l = self._status_l
        log = self.log if self._log_on else None
        if self._tl_on:
            tlf_l, tll_l, tli_l = self._tlf_l, self._tll_l, self._tli_l
            tlr_l, tlc_l = self._tlr_l, self._tlc_l
        else:
            tlf_l = tll_l = tli_l = tlr_l = tlc_l = None
        outage_on = self._outage_on
        slow_on = self._slow_on
        t = rt.t                      # local mirrors of the walker clock
        slot = rt.slot
        cycle_start = rt.cycle_start
        while True:
            if outage_on:
                oe = self._outage_end(t)
                if oe is not None:
                    self._park(rt, t, slot, cycle_start, oe)
                    return
            if slot >= n:
                # cycle finished.  Nexus dispatch rule (§5): start the next
                # cycle immediately if some model's batch is already full,
                # otherwise pace by the duty cycle.
                nxt = cycle_start + rt.duty
                if t > nxt:
                    nxt = t
                for a, _cap, _mid, _prof, q in walk:
                    if q is not None:
                        h = q.head
                        buf = q.buf
                        b0 = a.batch
                        if len(buf) - h >= b0 \
                                and arr_l[buf[h + b0 - 1]] <= t:
                            nxt = cycle_start + 1e-3
                            if t > nxt:
                                nxt = t
                            break
                arr = None
                for q in rt.qlist:
                    if q.head < len(q.buf):
                        a2 = arr_l[q.buf[q.head]]
                        if arr is None or a2 < arr:
                            arr = a2
                if arr is None:
                    rt.idle_floor = nxt
                    rt.t = t
                    rt.slot = slot
                    rt.cycle_start = cycle_start
                    return  # idle: a routed arrival will _kick us
                cycle_start = arr if arr > nxt else nxt
                slot = 0
                if cycle_start > t + 1e-9:
                    t = cycle_start
                if cycle_start > self.now + 1e-9:
                    rt.pending = True
                    rt.t = t
                    rt.slot = slot
                    rt.cycle_start = cycle_start
                    self._seq += 1
                    heapq.heappush(self._heap,
                                   (cycle_start, WAKE, self._seq,
                                    self.epoch, rt.idx, 0))
                    return
                continue
            a, cap, mid, prof, q = walk[slot]
            slot += 1
            if q is None:
                continue
            buf = q.buf
            qn = len(buf)
            h = q.head
            if h == qn:
                continue
            # fused batch formation (see docstring)
            model = a.model
            batch: list[int] = []
            nb = 0
            while h < qn:
                i = buf[h]
                ai = arr_l[i]
                if ai > t:
                    break
                h += 1
                if t - ai > slo_l[i]:
                    status_l[i] = DROPPED
                    if tlr_l is not None:
                        tlr_l[i] = t
                        tlc_l[i] = CAUSE_DROP_DEADLINE
                    if log is not None:
                        log.append(DropSpan("drop", t, model))
                    continue
                batch.append(i)
                nb += 1
                if nb == cap:
                    break
            q.head = h
            if h > 64 and 2 * h >= qn:
                del buf[:h]
                del q.pri[:h]
                q.head = 0
            if not nb:
                continue
            lkey = (mid, nb)
            base = rt.latcache.get(lkey)
            if base is None:
                base = rt.latcache[lkey] = self.memo.latency_ms(
                    prof, nb, rt.frac)
            partner = rt.partner
            if partner is not None and partner.inflight is not None:
                exec_ms = self._intf(rt, mid, nb, t) * base
            else:
                exec_ms = base
            if slow_on:
                exec_ms *= self._slow_factor(t)
            done = t + exec_ms
            if self._preempt_on:
                pri_l = self._pri_l
                mp = pri_l[batch[0]]
                for i in batch:
                    done_l[i] = done
                    status_l[i] = COMPLETED
                    p = pri_l[i]
                    if p < mp:
                        mp = p
                rt.inflight_prio = mp
            else:
                for i in batch:
                    done_l[i] = done
                    status_l[i] = COMPLETED
            if tlf_l is not None:
                extra = exec_ms - base
                for i in batch:
                    if tlf_l[i] != tlf_l[i]:   # NaN: first-ever launch
                        tlf_l[i] = t
                    tll_l[i] = t
                    tli_l[i] = extra
            rt.inflight = (mid, nb, t, done)
            rt.inflight_reqs = batch
            rt.pending = True
            rt.busy += exec_ms
            if log is not None:
                log.append(BatchSpan("batch", self.epoch, rt.idx, t, done,
                                     model, nb))
            rt.t = done
            rt.slot = slot
            rt.cycle_start = cycle_start
            self._seq += 1
            heapq.heappush(self._heap,
                           (done, COMPLETE, self._seq,
                            self.epoch, rt.idx, rt.gen))
            return

    def _walk_stream(self, rt: _LetRt) -> None:
        """Streaming duty-cycle walker: continuous batching.

        Same fused scalar structure as :meth:`_walk`, with the request
        lifecycle split into phases:

        * **prefill slots** form batches exactly like classic slots but
          admit against the TTFT SLO (queueing past ``ttft_slo_ms``
          drops the stream), cost ``prefill_ms`` at the batch's padded
          (power-of-two bucketed) prompt length, stamp
          ``first_token_ms`` at launch, and feed surviving streams into
          the model's *decode pool* instead of completing them;
        * **decode slots** run one chunk — up to ``decode_quantum``
          tokens, clipped so no member overshoots its last token — over
          the pool's current membership.  Membership is re-examined
          every chunk: streams that just finished prefill join, streams
          that emit their last token leave mid-flight and are stamped
          completed at the chunk's launch.  That is continuous batching;
          the batch never waits for a "slot boundary".

        The walk order is EDF on token-deadline slack (decode slots keyed
        by the model's tightest TPOT, prefill slots by TTFT), and a
        cycle with a live decode pool never idles or paces — chunks run
        back-to-back with prefill slots interleaved between them.
        """
        walk = rt.walk_order
        n = len(walk)
        if n == 0:
            return
        arr_l = self._arr_l
        ttft_l = self._ttft_l
        done_l = self._done_l
        status_l = self._status_l
        ftok_l = self._ftok_l
        tok_l = self._tok_l
        olen_l = self._olen_l
        plen_l = self._plen_l
        quantum = self.cfg.decode_quantum
        log = self.log if self._log_on else None
        if self._tl_on:
            tlf_l, tll_l, tli_l = self._tlf_l, self._tll_l, self._tli_l
            tld_l, tlr_l, tlc_l = self._tld_l, self._tlr_l, self._tlc_l
        else:
            tlf_l = tll_l = tli_l = tld_l = tlr_l = tlc_l = None
        outage_on = self._outage_on
        slow_on = self._slow_on
        t = rt.t
        slot = rt.slot
        cycle_start = rt.cycle_start
        while True:
            if outage_on:
                oe = self._outage_end(t)
                if oe is not None:
                    self._park(rt, t, slot, cycle_start, oe)
                    return
            if slot >= n:
                nxt = cycle_start + rt.duty
                if t > nxt:
                    nxt = t
                for a, _cap, _mid, _prof, q in walk:
                    if q is not None:
                        h = q.head
                        buf = q.buf
                        b0 = a.batch
                        if len(buf) - h >= b0 \
                                and arr_l[buf[h + b0 - 1]] <= t:
                            nxt = cycle_start + 1e-3
                            if t > nxt:
                                nxt = t
                            break
                live = False
                for dm in rt.dstreams.values():
                    if dm:
                        live = True
                        break
                if live:
                    # decode work in the pool: next cycle immediately
                    cycle_start = t
                    slot = 0
                    continue
                arr = None
                for q in rt.qlist:
                    if q.head < len(q.buf):
                        a2 = arr_l[q.buf[q.head]]
                        if arr is None or a2 < arr:
                            arr = a2
                if arr is None:
                    rt.idle_floor = nxt
                    rt.t = t
                    rt.slot = slot
                    rt.cycle_start = cycle_start
                    return  # idle: a routed arrival will _kick us
                cycle_start = arr if arr > nxt else nxt
                slot = 0
                if cycle_start > t + 1e-9:
                    t = cycle_start
                if cycle_start > self.now + 1e-9:
                    rt.pending = True
                    rt.t = t
                    rt.slot = slot
                    rt.cycle_start = cycle_start
                    self._seq += 1
                    heapq.heappush(self._heap,
                                   (cycle_start, WAKE, self._seq,
                                    self.epoch, rt.idx, 0))
                    return
                continue
            a, cap, mid, prof, q = walk[slot]
            slot += 1
            if a is None:
                # ---- decode chunk over the model's pool ----
                dm = rt.dstreams.get(mid)
                if not dm:
                    continue
                if len(dm) > cap:
                    batch = dm[:cap]   # oldest streams hold cadence first
                    rest = dm[cap:]
                else:
                    batch = dm
                    rest = []
                nb = len(batch)
                k = quantum
                for e in batch:
                    if e[1] < k:
                        k = e[1]
                lkey = (mid, nb)
                step = rt.dlat.get(lkey)
                if step is None:
                    step = rt.dlat[lkey] = self.memo.decode_step_ms(
                        prof, nb, rt.frac)
                partner = rt.partner
                if partner is not None and partner.inflight is not None:
                    exec_ms = self._intf(rt, mid, nb, t) * step * k
                else:
                    exec_ms = step * k
                if slow_on:
                    exec_ms *= self._slow_factor(t)
                done = t + exec_ms
                keep = []
                for e in batch:
                    i = e[0]
                    tok_l[i] += k
                    if e[1] == k:
                        done_l[i] = done
                        status_l[i] = COMPLETED
                    else:
                        e[1] -= k
                        keep.append(e)
                keep.extend(rest)
                rt.dstreams[mid] = keep
                if tld_l is not None:
                    extra = exec_ms - step * k
                    if extra:
                        for e2 in batch:
                            tld_l[e2[0]] += extra
                rt.inflight = (mid, nb, t, done)
                rt.inflight_reqs = None   # chunks are not preemptible
                rt.inflight_prio = -1
                rt.pending = True
                rt.busy += exec_ms
                if log is not None:
                    log.append(DecodeSpan("decode", self.epoch, rt.idx, t,
                                          done, prof.name, nb, k))
                rt.t = done
                rt.slot = slot
                rt.cycle_start = cycle_start
                self._seq += 1
                heapq.heappush(self._heap,
                               (done, COMPLETE, self._seq,
                                self.epoch, rt.idx, rt.gen))
                return
            if q is None:
                continue
            # ---- prefill batch formation (TTFT-admitted) ----
            buf = q.buf
            qn = len(buf)
            h = q.head
            if h == qn:
                continue
            model = a.model
            batch = []
            nb = 0
            ptok = 1
            while h < qn:
                i = buf[h]
                ai = arr_l[i]
                if ai > t:
                    break
                h += 1
                if t - ai > ttft_l[i]:
                    status_l[i] = DROPPED
                    if tlr_l is not None:
                        tlr_l[i] = t
                        tlc_l[i] = CAUSE_DROP_DEADLINE
                    if log is not None:
                        log.append(DropSpan("drop", t, model))
                    continue
                batch.append(i)
                nb += 1
                pl = plen_l[i]
                if pl > ptok:
                    ptok = pl
                if nb == cap:
                    break
            q.head = h
            if h > 64 and 2 * h >= qn:
                del buf[:h]
                del q.pri[:h]
                q.head = 0
            if not nb:
                continue
            # pad the batch to its longest prompt, bucketed to a power
            # of two so the latency cache stays small
            bucket = 1 << (ptok - 1).bit_length()
            lkey = (mid, nb, bucket)
            base = rt.latcache.get(lkey)
            if base is None:
                base = rt.latcache[lkey] = self.memo.prefill_ms(
                    prof, nb, rt.frac, bucket)
            partner = rt.partner
            if partner is not None and partner.inflight is not None:
                exec_ms = self._intf(rt, mid, nb, t) * base
            else:
                exec_ms = base
            if slow_on:
                exec_ms *= self._slow_factor(t)
            done = t + exec_ms
            dm = rt.dstreams.get(mid)
            if dm is None:
                dm = rt.dstreams[mid] = []
            if self._preempt_on:
                pri_l = self._pri_l
                mp = pri_l[batch[0]]
                for i in batch:
                    ftok_l[i] = done
                    tok_l[i] = 1
                    rem = olen_l[i] - 1
                    if rem:
                        dm.append([i, rem])
                    else:
                        done_l[i] = done
                        status_l[i] = COMPLETED
                    p = pri_l[i]
                    if p < mp:
                        mp = p
                rt.inflight_prio = mp
            else:
                for i in batch:
                    ftok_l[i] = done
                    tok_l[i] = 1
                    rem = olen_l[i] - 1
                    if rem:
                        dm.append([i, rem])
                    else:
                        done_l[i] = done
                        status_l[i] = COMPLETED
            if tlf_l is not None:
                extra = exec_ms - base
                for i in batch:
                    if tlf_l[i] != tlf_l[i]:   # NaN: first-ever launch
                        tlf_l[i] = t
                    tll_l[i] = t
                    tli_l[i] = extra
            rt.inflight = (mid, nb, t, done)
            rt.inflight_reqs = batch
            rt.pending = True
            rt.busy += exec_ms
            if log is not None:
                log.append(BatchSpan("batch", self.epoch, rt.idx, t, done,
                                     model, nb))
            rt.t = done
            rt.slot = slot
            rt.cycle_start = cycle_start
            self._seq += 1
            heapq.heappush(self._heap,
                           (done, COMPLETE, self._seq,
                            self.epoch, rt.idx, rt.gen))
            return

    def _intf(self, rt: _LetRt, mid: int, b: int, t: float) -> float:
        """Ground-truth slowdown if the partner has a batch in flight."""
        p = rt.partner
        if p is None or p.inflight is None or not self.cfg.interference:
            return 1.0
        pmid, pb, _ps, pe = p.inflight
        if pe <= t:
            return 1.0
        key = (mid, rt.let.size, b, pmid, p.let.size, pb)
        f = self._intf_cache.get(key)
        if f is None:
            f, _ = true_interference_factors(
                self._prof_by_mid[mid], rt.let.frac, b,
                self._prof_by_mid[pmid], p.let.frac, pb, self.cfg.acc)
            self._intf_cache[key] = f
        return f

    # ---- reschedule ticks -------------------------------------------------

    def _flush_window(self, end_ms: float) -> dict[str, float]:
        span_s = max(end_ms - self._win_start, 1e-9) / 1e3
        models = self.trace.models if self.trace is not None else []
        obs = {models[m]: c / span_s for m, c in self._win_counts.items()}
        self.window_obs.append(obs)
        # clear in place: run()'s hot loop holds a reference to this dict
        self._win_counts.clear()
        self._win_start = end_ms
        return obs

    def apply_schedule(self, result: ScheduleResult,
                       delay_ms: float | None = None) -> None:
        """Inject a new partitioning (optionally after a reorg delay)."""
        delay = self.cfg.reorg_ms if delay_ms is None else delay_ms
        if delay <= 0.0:
            self._install(result)
            if self._log_on:
                self.log.append(ApplySpan("apply", self.now))
            return
        self._pending_schedule = result
        if self.cfg.reorg_policy == "pause":
            self.paused = True
        self._push(self.now + delay, APPLY)

    def apply_schedule_at(self, t_ms: float, result: ScheduleResult) -> None:
        """Plan a partitioning change at an absolute instant (pre-run).

        The fabric's global rescheduler uses this to stage a node's
        migration cuts before the engine runs: each planned schedule goes
        live at exactly ``t_ms`` (the receiver's warm-up charge is folded
        into ``t_ms`` by the caller).  Unlike :meth:`apply_schedule`, any
        number of changes can be staged, and they do not consume the
        single ``_pending_schedule`` reorg slot.  Staged applies and a
        live tick-driven controller are not reconciled against each
        other (last install wins, and a staged apply does not honor a
        reorg blackout's pause) — the fabric refuses that combination.

        In-flight batches at a cut drain exactly like a reorganization:
        ``_install`` bumps the epoch so their COMPLETE events go stale,
        while their completions (stamped at launch) stand.  Queued
        requests carry onto the new partitioning; requests for a model
        the new partitioning no longer serves park in ``unrouted`` and
        surface as conservation drops the fabric can hand back.
        """
        self._apply_plan.append(result)
        self._push(t_ms, APPLY, len(self._apply_plan))

    def _handle_tick(self, t: float) -> None:
        obs = self._flush_window(t)
        result = self.on_tick(t, obs, self) if self.on_tick else None
        resched = result is not None
        self.ticks.append((t, resched))
        if self._log_on:
            self.log.append(TickSpan("tick", t, resched))
        if resched:
            self.apply_schedule(result)
        nxt = t + self.cfg.period_ms
        if nxt < self.cfg.horizon_ms - 1e-6:
            self._push(nxt, TICK)

    # ---- main loop --------------------------------------------------------

    def run(self) -> SimMetrics:
        self._bind_trace()
        if self.on_tick is not None and self.cfg.period_ms:
            if self.cfg.period_ms < self.cfg.horizon_ms - 1e-6:
                self._push(self.cfg.period_ms, TICK)
        max_clock = self.cfg.horizon_ms * self.cfg.drain_factor
        heap = self._heap
        heappop = heapq.heappop
        arr_l = self._arr_l
        mid_l = self._mid_l
        route = self._route
        track = self.on_tick is not None
        wc = self._win_counts
        n = self._n
        i = 0
        # static runs (no ticks, no pre-queued reorganization) never
        # re-install mid-flight, so the routing structures can be hoisted
        # and the overwhelmingly common single-target append inlined into
        # the loop; _route covers the rest (WRR fan-out, unrouted models,
        # preemption probes, kicks).  A pre-run apply_schedule() shows up
        # as a non-empty heap here and disables the hoist.
        static = not track and not heap \
            and self._pending_schedule is None
        targets = self._targets
        pri_l = self._pri_l
        preempt_on = self._preempt_on
        while True:
            # merged arrival stream: the next client arrival processes
            # before any heap event at/after it (with the old ARRIVAL
            # sentinels' 1e-12 ingest tolerance on time ties) — no heap
            # traffic for arrivals at all.
            if i < n:
                a = arr_l[i]
                if a <= max_clock and \
                        (not heap or a <= heap[0][0] + 1e-12):
                    self.now = a
                    if static:
                        tgt = targets.get(mid_l[i])
                        if tgt is not None and len(tgt) == 1:
                            entry = tgt[0]
                            rt = entry[0]
                            q = entry[1]
                            buf = q.buf
                            if preempt_on:
                                p = pri_l[i]
                                qp = q.pri
                                if len(buf) == q.head or qp[-1] <= p:
                                    buf.append(i)
                                    qp.append(p)
                                else:
                                    q.insert_by_priority(i, p)
                                if rt.inflight is not None \
                                        and rt.inflight_prio > p:
                                    self._maybe_preempt(rt, i)
                            else:
                                buf.append(i)
                            if not rt.pending and rt.inflight is None:
                                self._kick(rt, a)
                        else:
                            route(i)
                    else:
                        m = mid_l[i]
                        wc[m] = wc.get(m, 0) + 1
                        route(i)
                    i += 1
                    continue
            if not heap:
                break
            ev = heappop(heap)
            t = ev[0]
            if t > max_clock:
                break
            self.now = t
            kind = ev[1]
            if kind == COMPLETE:
                if ev[3] != self.epoch:
                    continue  # stale: pre-reorg batch on a retired gpu-let
                rt = self.lets[ev[4]]
                if ev[5] != rt.gen:
                    continue  # stale: the batch was preempted
                rt.pending = False
                rt.inflight = None
                rt.inflight_reqs = None
                if not self.paused:
                    self._walk(rt)
            elif kind == WAKE:
                if ev[3] != self.epoch:
                    continue
                rt = self.lets[ev[4]]
                rt.pending = False
                if rt.inflight is None and not self.paused:
                    self._walk(rt)
            elif kind == APPLY:
                if ev[3]:
                    # staged migration cut (apply_schedule_at)
                    self._install(self._apply_plan[ev[3] - 1])
                    if self._log_on:
                        self.log.append(ApplySpan("apply", t))
                elif self._pending_schedule is not None:
                    self._install(self._pending_schedule)
                    self._pending_schedule = None
                    if self._log_on:
                        self.log.append(ApplySpan("apply", t))
            elif kind == TICK:
                self._handle_tick(t)
        # route any tail arrivals that never got processed (overload
        # guard: the drain clock ran out first); the clock stays put.
        while i < n:
            if track:
                m = mid_l[i]
                wc[m] = wc.get(m, 0) + 1
            route(i)
            i += 1
        self._arr_idx = i
        if self.on_tick is not None and self.cfg.period_ms:
            # tail window (no tick fires at the horizon itself); may be
            # shorter than one period when the horizon isn't a multiple.
            self._flush_window(self.cfg.horizon_ms)
        # conservation: anything still queued at shutdown is a drop.
        models = self.trace.models
        status_l, mid_l = self._status_l, self._mid_l
        log = self.log if self._log_on else None
        tlr_l = self._tlr_l if self._tl_on else None
        queues = [q for rt in self.lets for q in rt.queues.values()]
        queues += list(self.unrouted.values())
        for q in queues:
            for j in q.drain():
                if status_l[j] == PENDING:
                    status_l[j] = UNSERVED
                    if tlr_l is not None:
                        tlr_l[j] = self.now
                        self._tlc_l[j] = CAUSE_DROP_SHUTDOWN
                    if log is not None:
                        log.append(DropSpan("drop", self.now,
                                            models[mid_l[j]]))
        self._sweep_pools()
        self._scatter_back()
        return self.metrics()

    def _sweep_pools(self) -> None:
        """Conservation for streams cut off mid-decode (drain clock ran
        out): anything still in a decode pool is an UNSERVED drop."""
        if not self._streams_on:
            return
        status_l, mid_l = self._status_l, self._mid_l
        models = self.trace.models
        log = self.log if self._log_on else None
        tlr_l = self._tlr_l if self._tl_on else None
        for rt in self.lets:
            for dm in rt.dstreams.values():
                for e in dm:
                    j = e[0]
                    if status_l[j] == PENDING:
                        status_l[j] = UNSERVED
                        if tlr_l is not None:
                            tlr_l[j] = self.now
                            self._tlc_l[j] = CAUSE_DROP_SHUTDOWN
                        if log is not None:
                            log.append(DropSpan("drop", self.now,
                                                models[mid_l[j]]))
                dm.clear()

    # ---- incremental serving (fabric release-frontier epochs) -------------
    #
    # The DAG fabric cannot hand a node its whole trace up front: a stage
    # only becomes dispatchable when its parents complete, possibly on
    # another node.  These three methods run the same event loop as
    # :meth:`run`, but sliced into bounded segments with arrival chunks
    # fed in between — run() itself is untouched, so the classic
    # whole-trace path stays byte-identical.

    def add_arrivals(self, idx: np.ndarray) -> None:
        """Feed newly-released trace rows into a (possibly running) engine.

        Each chunk is sorted by its *current* arrival times and appended
        to the merged arrival stream.  Chunks normally arrive in
        time-order (one per release epoch), but a release stamped behind
        the engine's clock is legal: the ingest loop clamps the clock
        monotonically and the request simply queues with its true (past)
        arrival time, so its SLO age is still measured from release.
        """
        idx = np.asarray(idx, dtype=np.int64)
        if not self._bound:
            # pre-bind: indistinguishable from a submit_trace() chunk
            self._own_chunks.append(idx)
            return
        if idx.size == 0:
            return
        tr = self.trace
        arr = tr.arrival_ms[idx]
        order = np.argsort(arr, kind="stable")
        g = idx[order]
        self._late_chunks.append(g)
        k = g.size
        self._arr_l.extend(arr[order].tolist())
        self._slo_l.extend(tr.slo_ms[g].tolist())
        self._mid_l.extend(tr.model_id[g].tolist())
        self._pri_l.extend(tr.priority[g].astype(np.int64).tolist())
        self._done_l.extend([np.nan] * k)
        self._status_l.extend([PENDING] * k)
        self._preempted_l.extend([False] * k)
        self._gid_l.extend(g.tolist())
        if self._streams_on:
            self._plen_l.extend(tr.prompt_len[g].tolist())
            self._olen_l.extend(tr.output_len[g].tolist())
            self._ttft_l.extend(tr.ttft_slo_ms[g].tolist())
            self._tpot_l.extend(tr.tpot_slo_ms[g].tolist())
            self._ftok_l.extend([np.nan] * k)
            self._tok_l.extend([0] * k)
        if self._tl_on:
            self._tlf_l.extend([np.nan] * k)
            self._tll_l.extend([np.nan] * k)
            self._tli_l.extend([0.0] * k)
            self._tld_l.extend([0.0] * k)
            self._tlr_l.extend([np.nan] * k)
            self._tlc_l.extend([0] * k)
        self._n += k

    def run_until(self, t_stop: float) -> None:
        """Advance the event loop through everything at/before ``t_stop``.

        Arrivals and heap events merge exactly as in :meth:`run` (same
        1e-12 ingest tolerance); WAKE/COMPLETE events past ``t_stop``
        stay queued for the next segment.  Incremental runs don't take
        tick subscribers — the fabric refuses that combination.
        """
        if self.on_tick is not None:
            raise ValueError("incremental serving cannot drive on_tick")
        if not self._bound:
            self._bind_trace()
        heap = self._heap
        heappop = heapq.heappop
        arr_l = self._arr_l
        route = self._route
        i = self._arr_idx
        n = self._n
        while True:
            if i < n:
                a = arr_l[i]
                if a <= t_stop and \
                        (not heap or a <= heap[0][0] + 1e-12):
                    if a > self.now:   # late chunks may arrive in the past
                        self.now = a
                    route(i)
                    i += 1
                    continue
            if not heap or heap[0][0] > t_stop:
                break
            ev = heappop(heap)
            self.now = ev[0]
            kind = ev[1]
            if kind == COMPLETE:
                if ev[3] != self.epoch:
                    continue
                rt = self.lets[ev[4]]
                if ev[5] != rt.gen:
                    continue
                rt.pending = False
                rt.inflight = None
                rt.inflight_reqs = None
                if not self.paused:
                    self._walk(rt)
            elif kind == WAKE:
                if ev[3] != self.epoch:
                    continue
                rt = self.lets[ev[4]]
                rt.pending = False
                if rt.inflight is None and not self.paused:
                    self._walk(rt)
            elif kind == APPLY:
                if ev[3]:
                    self._install(self._apply_plan[ev[3] - 1])
                    if self._log_on:
                        self.log.append(ApplySpan("apply", self.now))
                elif self._pending_schedule is not None:
                    self._install(self._pending_schedule)
                    self._pending_schedule = None
                    if self._log_on:
                        self.log.append(ApplySpan("apply", self.now))
        self._arr_idx = i

    def sync_trace(self) -> None:
        """Push current mirror state into the shared trace (mid-run).

        The DAG fabric's release frontier reads completion stamps off the
        trace between segments.  Completions are stamped at batch
        *launch*, so a stamp whose time lies beyond the engine's clock
        belongs to an in-flight batch and is still revocable by
        preemption — the frontier therefore only acts on stamps at/before
        the segment boundary it has run every engine to (those batches'
        COMPLETE events have fired; nothing can preempt them anymore).
        Revoked stamps are simply overwritten by the next sync.
        """
        if not self._bound:
            return
        g = (np.concatenate([self._gidx] + self._late_chunks)
             if self._late_chunks else self._gidx)
        if not g.size:
            return
        tr = self.trace
        done = np.asarray(self._done_l, dtype=np.float64)
        status = np.asarray(self._status_l, dtype=np.uint8)
        if self._n_evicted:
            keep = status != EVICTED_LOCAL
            g, done, status = g[keep], done[keep], status[keep]
        tr.completion_ms[g] = done
        tr.status[g] = status

    def finish(self) -> SimMetrics:
        """Drain an incremental run and close the books (== run()'s end).

        Runs the loop out to the drain clock, routes tail arrivals,
        applies the conservation sweep, rebuilds the gathered arrays to
        cover late chunks, and scatters results into the shared trace.
        """
        max_clock = self.cfg.horizon_ms * self.cfg.drain_factor
        self.run_until(max_clock)
        route = self._route
        i = self._arr_idx
        while i < self._n:
            route(i)
            i += 1
        self._arr_idx = i
        models = self.trace.models
        status_l, mid_l = self._status_l, self._mid_l
        log = self.log if self._log_on else None
        tlr_l = self._tlr_l if self._tl_on else None
        queues = [q for rt in self.lets for q in rt.queues.values()]
        queues += list(self.unrouted.values())
        for q in queues:
            for j in q.drain():
                if status_l[j] == PENDING:
                    status_l[j] = UNSERVED
                    if tlr_l is not None:
                        tlr_l[j] = self.now
                        self._tlc_l[j] = CAUSE_DROP_SHUTDOWN
                    if log is not None:
                        log.append(DropSpan("drop", self.now,
                                            models[mid_l[j]]))
        self._sweep_pools()
        if self._late_chunks:
            self._gidx = np.concatenate([self._gidx] + self._late_chunks)
            self._late_chunks = []
            self._arr = np.asarray(self._arr_l, dtype=np.float64)
            self._slo = np.asarray(self._slo_l, dtype=np.float64)
            self._mid = np.asarray(self._mid_l, dtype=np.int32)
            self._pri = np.asarray(self._pri_l, dtype=np.int64)
        self._scatter_back()
        return self.metrics()

    def metrics(self) -> SimMetrics:
        # stable key shape regardless of how many reorgs happened: busy time
        # keyed by gpu-let index, summed across epochs (the old cluster.py
        # contract).  Per-epoch detail stays available in ``self.busy_ms``.
        self._flush_busy()
        busy: dict[int, float] = {}
        for (_epoch, idx), ms in self.busy_ms.items():
            busy[idx] = busy.get(idx, 0.0) + ms
        if not self._bound:
            self._bind_trace()
        self._finalize_arrays()
        mid, arr, slo = self._mid, self._arr, self._slo
        done, status = self._done, self._status
        pri, preempted = self._pri, self._preempted
        if self._n_evicted:
            keep = status != EVICTED_LOCAL
            mid, arr, slo = mid[keep], arr[keep], slo[keep]
            done, status = done[keep], status[keep]
            pri, preempted = pri[keep], preempted[keep]
        return collect_arrays(self.trace.models, mid, arr,
                              slo, done, status,
                              pri, preempted,
                              self.cfg.horizon_ms, busy)
