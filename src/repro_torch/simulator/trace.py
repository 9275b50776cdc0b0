"""Struct-of-arrays request trace: the serving hot path's data layout.

A million-request trace as a list of ``Request`` dataclasses costs ~100
bytes and a dict lookup per field access per request — at fabric scale the
simulator spent most of its wall clock chasing object pointers.
:class:`RequestTrace` stores the same information as parallel numpy arrays
(``arrival_ms``, ``slo_ms``, ``model_id``, ``priority``, ``completion_ms``,
``status``, ``preempted``), so the engine and fabric can batch-form,
batch-drop, and batch-account requests with vectorized mask operations,
and hand work between layers as index slices instead of object lists.

``Request`` objects remain the API-edge representation: traces convert
losslessly in both directions (:meth:`from_requests` /
:meth:`write_back`), and :class:`RequestView` gives zero-copy per-request
object access into a trace for tests and diagnostics.

Status codes
------------
Request lifecycle state is one enum on the ``status`` array — a request
cannot be simultaneously dropped and completed by construction (the
scattered ``dropped`` / ``unserved`` per-object bool writes of the object
path collapse into single array stores):

  * ``PENDING``    — not yet resolved (queued, in flight, undispatched).
  * ``COMPLETED``  — served; ``completion_ms`` holds the finish time.
  * ``DROPPED``    — deliberately rejected: SLO already expired at batch
    formation, or hopeless after a failover replay.
  * ``UNSERVED``   — conservation drop: still queued when the engine's
    clock stopped (horizon drain, or a fabric node dying).  The fabric's
    failure-drain path replays exactly these.
  * ``SHED``       — router overload valve dropped it before any node.
  * ``LOST``       — no live node existed at dispatch time (fleet down).

``status >= DROPPED`` is the "dropped" predicate everywhere (and what
``Request.dropped`` maps back to at the object edge).

Stage columns (compound inference)
----------------------------------
A trace can optionally carry *task-graph* columns (:meth:`attach_stages`),
turning each row into one stage of a multi-model job (frontend → detector
→ per-region classifier fan-out → fusion).  ``job_id`` groups stages,
``parent_start``/``n_parents`` encode each stage's parents as a contiguous
row range (jobs are laid out contiguously in topological order), and
``slo_budget_ms`` is the stage's share of the single end-to-end
``job_slo_ms``, decomposed along the critical path
(``core/scenarios.py:critical_path_budgets``).  Non-root stages start with
``arrival_ms = inf``: the fabric's release-frontier pass
(``fabric/fabric.py``) stamps their real arrival at ``max(parent
completions)`` and only then feeds them into dispatch.  Traces *without*
stage columns (``has_stages`` False) take the exact PR-5 code path —
byte-identical results, pinned by the golden suite.

Stream columns (prefill/decode phases)
--------------------------------------
A trace can instead carry *streaming* columns (:meth:`attach_streams`),
turning each row into a generative request: a prefill over
``prompt_len`` tokens that emits the first token, then a decode stream
producing ``output_len`` tokens total.  ``ttft_slo_ms`` bounds
time-to-first-token (the queueing+prefill deadline), ``tpot_slo_ms``
bounds the steady per-token cadence; the row's ``slo_ms`` is the derived
end-to-end deadline (``ttft + output_len * tpot``) so the existing
violation/latency machinery keeps meaning.  The engine stamps
``first_token_ms`` at prefill launch and advances ``tokens_done`` per
decode chunk; ``completion_ms`` remains the last-token stamp.  Traces
*without* stream columns (``has_streams`` False) take the exact
pre-streaming path — byte-identical results, same guarantee as stages.
"""
from __future__ import annotations

from collections.abc import Iterable, Sequence

import numpy as np

from repro_torch.simulator.events import Request

# -- request lifecycle status codes (uint8) ---------------------------------
PENDING, COMPLETED, DROPPED, UNSERVED, SHED, LOST = 0, 1, 2, 3, 4, 5

#: statuses counted as drops (== SLO violations that never completed)
FIRST_DROP_STATUS = DROPPED

STATUS_NAMES = {PENDING: "pending", COMPLETED: "completed",
                DROPPED: "dropped", UNSERVED: "unserved", SHED: "shed",
                LOST: "lost"}


class RequestTrace:
    """Parallel-array request trace; the one source of truth at runtime.

    All mutable per-request state lives here.  Layers share a trace and
    pass ``int64`` index arrays: the router hands each node an index
    slice, node engines stamp completions straight into the shared
    arrays, and fleet metrics reduce over them once at the end.
    """

    __slots__ = ("models", "model_index", "arrival_ms", "slo_ms",
                 "model_id", "priority", "completion_ms", "status",
                 "preempted", "job_id", "stage_id", "parent_start",
                 "n_parents", "slo_budget_ms", "job_slo_ms",
                 "job_arrival_ms", "node_id", "_edges", "prompt_len",
                 "output_len", "ttft_slo_ms", "tpot_slo_ms",
                 "first_token_ms", "tokens_done", "obs")

    def __init__(self, models: Sequence[str], arrival_ms: np.ndarray,
                 slo_ms: np.ndarray, model_id: np.ndarray,
                 priority: np.ndarray | None = None,
                 completion_ms: np.ndarray | None = None,
                 status: np.ndarray | None = None,
                 preempted: np.ndarray | None = None):
        n = len(arrival_ms)
        self.models = list(models)
        self.model_index = {m: i for i, m in enumerate(self.models)}
        self.arrival_ms = np.asarray(arrival_ms, dtype=np.float64)
        self.slo_ms = np.asarray(slo_ms, dtype=np.float64)
        self.model_id = np.asarray(model_id, dtype=np.int32)
        self.priority = (np.zeros(n, dtype=np.int16) if priority is None
                         else np.asarray(priority, dtype=np.int16))
        self.completion_ms = (np.full(n, np.nan)
                              if completion_ms is None
                              else np.asarray(completion_ms,
                                              dtype=np.float64))
        self.status = (np.zeros(n, dtype=np.uint8) if status is None
                       else np.asarray(status, dtype=np.uint8))
        self.preempted = (np.zeros(n, dtype=bool) if preempted is None
                          else np.asarray(preempted, dtype=bool))
        # stage columns stay None for plain single-model traces — every
        # consumer checks ``has_stages`` before touching them, so the
        # classic path never pays for (or observes) the DAG machinery.
        self.job_id = None            # int64; -1 for single-model rows
        self.stage_id = None          # int32; -1 for single-model rows
        self.parent_start = None      # int64 first-parent row; -1 = root
        self.n_parents = None         # int32 fan-in count; 0 = root
        self.slo_budget_ms = None     # float64 pristine per-stage budget
        self.job_slo_ms = None        # float64 end-to-end job SLO (per row)
        self.job_arrival_ms = None    # float64 pristine job arrival
        self.node_id = None           # int32 dispatch stamp; -1 = none
        self._edges = None
        # stream columns stay None for classic one-shot traces — every
        # consumer checks ``has_streams`` before touching them, so the
        # classic path never pays for (or observes) phase machinery.
        self.prompt_len = None        # int32 prefill tokens
        self.output_len = None        # int32 total generated tokens (>= 1)
        self.ttft_slo_ms = None       # float64 time-to-first-token SLO
        self.tpot_slo_ms = None       # float64 per-output-token SLO
        self.first_token_ms = None    # float64 first-token stamp; NaN = none
        self.tokens_done = None       # int32 tokens generated so far
        # observability timeline (repro.obs.attach_timeline); None = off —
        # every layer checks ``obs is not None`` once per batch/dispatch,
        # so the hot path pays a single branch when forensics are off.
        self.obs = None

    def __len__(self) -> int:
        return len(self.arrival_ms)

    # ---- task-graph (stage) columns ---------------------------------------

    @property
    def has_stages(self) -> bool:
        """True if this trace carries task-graph columns."""
        return self.job_id is not None

    def attach_stages(self, job_id: np.ndarray, stage_id: np.ndarray,
                      parent_start: np.ndarray, n_parents: np.ndarray,
                      slo_budget_ms: np.ndarray, job_slo_ms: np.ndarray,
                      job_arrival_ms: np.ndarray) -> None:
        """Attach task-graph columns, making each row one job stage.

        Parents of row ``i`` are the contiguous row range
        ``[parent_start[i], parent_start[i] + n_parents[i])`` — the
        builder lays each job's stages out contiguously in topological
        order, so any fan-in is a single range.  Single-model rows mixed
        into the same trace use ``job_id = -1`` / ``n_parents = 0``.
        ``job_arrival_ms``/``job_slo_ms`` snapshot the client-side job
        deadline: the router mutates ``arrival_ms``/``slo_ms`` with
        network shifts, so end-to-end accounting needs the pristine copy.
        """
        n = len(self)
        cols = (job_id, stage_id, parent_start, n_parents, slo_budget_ms,
                job_slo_ms, job_arrival_ms)
        if any(len(c) != n for c in cols):
            raise ValueError("stage columns must match trace length")
        self.job_id = np.asarray(job_id, dtype=np.int64)
        self.stage_id = np.asarray(stage_id, dtype=np.int32)
        self.parent_start = np.asarray(parent_start, dtype=np.int64)
        self.n_parents = np.asarray(n_parents, dtype=np.int32)
        self.slo_budget_ms = np.asarray(slo_budget_ms, dtype=np.float64)
        self.job_slo_ms = np.asarray(job_slo_ms, dtype=np.float64)
        self.job_arrival_ms = np.asarray(job_arrival_ms, dtype=np.float64)
        self.node_id = np.full(n, -1, dtype=np.int32)
        self._edges = None
        staged = self.n_parents > 0
        if bool(staged.any()):
            ps, np_ = self.parent_start[staged], self.n_parents[staged]
            rows = np.flatnonzero(staged)
            if (ps < 0).any() or (ps + np_ > rows).any():
                raise ValueError(
                    "parents must be earlier rows of the same trace")
            child, parent = self.stage_edges()
            if not np.array_equal(self.job_id[child], self.job_id[parent]):
                raise ValueError("parent rows must belong to the same job")
        if ((self.parent_start >= 0) != staged).any():
            raise ValueError("parent_start and n_parents disagree on roots")

    def stage_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Expanded parent edges ``(child_rows, parent_rows)``.

        Edges are grouped by child in ascending row order (children's
        parent ranges are contiguous), which is what the release
        frontier's ``reduceat`` reductions and the router's fan-out
        ``bincount`` both want.  Cached — stage topology is immutable.
        """
        if self._edges is None:
            np_ = self.n_parents.astype(np.int64)
            total = int(np_.sum())
            child = np.repeat(np.arange(len(self), dtype=np.int64), np_)
            starts = np.cumsum(np_) - np_
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(starts, np_))
            parent = np.repeat(self.parent_start, np_) + within
            self._edges = (child, parent)
        return self._edges

    # ---- streaming (prefill/decode) columns -------------------------------

    @property
    def has_streams(self) -> bool:
        """True if this trace carries prefill/decode stream columns."""
        return self.prompt_len is not None

    def attach_streams(self, prompt_len: np.ndarray,
                       output_len: np.ndarray, ttft_slo_ms: np.ndarray,
                       tpot_slo_ms: np.ndarray) -> None:
        """Attach streaming columns, making each row a generative stream.

        ``output_len`` counts *all* generated tokens including the one
        emitted by prefill, so ``output_len == 1`` degenerates to a
        prefill-only request.  The builder is expected to set the row's
        ``slo_ms`` to the derived end-to-end deadline
        (``ttft_slo_ms + output_len * tpot_slo_ms``); this method does
        not overwrite it so callers can tighten or loosen deliberately.
        Stream and stage columns are mutually exclusive — the engine's
        continuous-batching walk has no release frontier.
        """
        n = len(self)
        cols = (prompt_len, output_len, ttft_slo_ms, tpot_slo_ms)
        if any(len(c) != n for c in cols):
            raise ValueError("stream columns must match trace length")
        if self.has_stages:
            raise ValueError("stream and stage columns are exclusive")
        prompt_len = np.asarray(prompt_len, dtype=np.int32)
        output_len = np.asarray(output_len, dtype=np.int32)
        if n and ((prompt_len < 1).any() or (output_len < 1).any()):
            raise ValueError("prompt_len and output_len must be >= 1")
        ttft = np.asarray(ttft_slo_ms, dtype=np.float64)
        tpot = np.asarray(tpot_slo_ms, dtype=np.float64)
        if n and ((ttft <= 0).any() or (tpot <= 0).any()):
            raise ValueError("TTFT/TPOT SLOs must be positive")
        self.prompt_len = prompt_len
        self.output_len = output_len
        self.ttft_slo_ms = ttft
        self.tpot_slo_ms = tpot
        self.first_token_ms = np.full(n, np.nan)
        self.tokens_done = np.zeros(n, dtype=np.int32)

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_streams(cls, streams: Iterable[tuple[str, np.ndarray, float]],
                     start_ms: float = 0.0) -> "RequestTrace":
        """Merge per-model arrival-time arrays into one sorted trace.

        ``streams`` yields ``(model, arrival_times_ms, slo_ms)``; the
        result is stably sorted by arrival (ties keep stream order),
        matching ``events.merge_sorted`` on the equivalent object lists.
        """
        models: list[str] = []
        times: list[np.ndarray] = []
        slos: list[np.ndarray] = []
        mids: list[np.ndarray] = []
        index: dict[str, int] = {}
        for model, ts, slo in streams:
            ts = np.asarray(ts, dtype=np.float64)
            if model not in index:
                index[model] = len(models)
                models.append(model)
            mid = index[model]
            times.append(ts + start_ms if start_ms else ts)
            slos.append(np.full(ts.size, float(slo)))
            mids.append(np.full(ts.size, mid, dtype=np.int32))
        if not times:
            return cls([], np.empty(0), np.empty(0),
                       np.empty(0, dtype=np.int32))
        arrival = np.concatenate(times)
        order = np.argsort(arrival, kind="stable")
        return cls(models, arrival[order], np.concatenate(slos)[order],
                   np.concatenate(mids)[order])

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "RequestTrace":
        """Object-edge adapter: snapshot a list of ``Request``\\ s.

        Preserves order (no sorting) so :meth:`write_back` can copy
        results back into the same objects positionally.
        """
        n = len(requests)
        models: list[str] = []
        index: dict[str, int] = {}
        arrival = np.empty(n)
        slo = np.empty(n)
        mid = np.empty(n, dtype=np.int32)
        prio = np.empty(n, dtype=np.int16)
        done = np.full(n, np.nan)
        status = np.zeros(n, dtype=np.uint8)
        preempted = np.zeros(n, dtype=bool)
        for i, r in enumerate(requests):
            k = index.get(r.model)
            if k is None:
                k = index[r.model] = len(models)
                models.append(r.model)
            mid[i] = k
            arrival[i] = r.arrival_ms
            slo[i] = r.slo_ms
            prio[i] = r.priority
            sc = r.status_code
            if sc == COMPLETED and r.completion_ms is None:
                sc = -1   # inconsistent hand-edit: fall back to the bools
            if sc >= 0:
                # round-trip path: carry the exact code, so SHED/LOST
                # survive trace -> objects -> trace (they are
                # indistinguishable from DROPPED in the bool projection)
                status[i] = sc
                if sc == COMPLETED:
                    done[i] = r.completion_ms
            elif r.dropped:
                status[i] = UNSERVED if r.unserved else DROPPED
            elif r.completion_ms is not None:
                status[i] = COMPLETED
                done[i] = r.completion_ms
            preempted[i] = r.preempted
        return cls(models, arrival, slo, mid, prio, done, status, preempted)

    # ---- object-edge conversion -------------------------------------------

    def write_back(self, requests: Sequence[Request]) -> None:
        """Copy array state into ``requests`` (positional; same order as
        :meth:`from_requests`).  Lists converted once (`tolist`) so the
        per-request loop touches Python scalars, not numpy ones."""
        arrival = self.arrival_ms.tolist()
        slo = self.slo_ms.tolist()
        done = self.completion_ms.tolist()
        status = self.status.tolist()
        priority = self.priority.tolist()
        preempted = self.preempted.tolist()
        for i, r in enumerate(requests):
            st = status[i]
            r.arrival_ms = arrival[i]
            r.slo_ms = slo[i]
            r.priority = priority[i]
            r.completion_ms = done[i] if st == COMPLETED else None
            r.dropped = st >= FIRST_DROP_STATUS
            r.unserved = st == UNSERVED
            r.status_code = st
            r.preempted = preempted[i]

    def to_requests(self) -> list[Request]:
        """Materialize plain ``Request`` objects (API edges, small runs)."""
        out = [Request(model=self.models[m], arrival_ms=0.0, slo_ms=0.0)
               for m in self.model_id.tolist()]
        self.write_back(out)
        return out

    def view(self, i: int) -> "RequestView":
        return RequestView(self, int(i))

    def views(self, idx: np.ndarray | None = None) -> list["RequestView"]:
        ids = range(len(self)) if idx is None else idx.tolist()
        return [RequestView(self, int(i)) for i in ids]

    # ---- vectorized predicates --------------------------------------------

    @property
    def dropped(self) -> np.ndarray:
        return self.status >= FIRST_DROP_STATUS

    @property
    def completed(self) -> np.ndarray:
        return self.status == COMPLETED

    def violated(self, idx: np.ndarray | None = None) -> np.ndarray:
        """Dropped, or completed past the SLO (the paper counts both)."""
        if idx is None:
            st, done = self.status, self.completion_ms
            arr, slo = self.arrival_ms, self.slo_ms
        else:
            st, done = self.status[idx], self.completion_ms[idx]
            arr, slo = self.arrival_ms[idx], self.slo_ms[idx]
        late = np.zeros(len(st), dtype=bool)
        ok = st == COMPLETED
        late[ok] = (done[ok] - arr[ok]) > slo[ok]
        return (st >= FIRST_DROP_STATUS) | late


class RequestView:
    """Zero-copy per-request object facade over a :class:`RequestTrace`.

    Implements the ``Request`` read/write surface (model, arrival_ms,
    slo_ms, completion_ms, dropped, unserved, preempted, priority,
    latency_ms, violated) so tests and diagnostics can treat trace rows
    as objects.  Mutations go straight to the arrays.
    """

    __slots__ = ("_t", "_i")

    def __init__(self, trace: RequestTrace, i: int):
        self._t = trace
        self._i = i

    @property
    def model(self) -> str:
        return self._t.models[self._t.model_id[self._i]]

    @property
    def arrival_ms(self) -> float:
        return float(self._t.arrival_ms[self._i])

    @arrival_ms.setter
    def arrival_ms(self, v: float) -> None:
        self._t.arrival_ms[self._i] = v

    @property
    def slo_ms(self) -> float:
        return float(self._t.slo_ms[self._i])

    @slo_ms.setter
    def slo_ms(self, v: float) -> None:
        self._t.slo_ms[self._i] = v

    @property
    def priority(self) -> int:
        return int(self._t.priority[self._i])

    @priority.setter
    def priority(self, v: int) -> None:
        self._t.priority[self._i] = v

    @property
    def status(self) -> int:
        return int(self._t.status[self._i])

    @property
    def completion_ms(self) -> float | None:
        if self._t.status[self._i] != COMPLETED:
            return None
        return float(self._t.completion_ms[self._i])

    @property
    def dropped(self) -> bool:
        return bool(self._t.status[self._i] >= FIRST_DROP_STATUS)

    @property
    def unserved(self) -> bool:
        return bool(self._t.status[self._i] == UNSERVED)

    @property
    def preempted(self) -> bool:
        return bool(self._t.preempted[self._i])

    @property
    def first_token_ms(self) -> float | None:
        if not self._t.has_streams:
            return None
        v = float(self._t.first_token_ms[self._i])
        return None if v != v else v

    @property
    def tokens_done(self) -> int:
        return (int(self._t.tokens_done[self._i])
                if self._t.has_streams else 0)

    @property
    def latency_ms(self) -> float | None:
        done = self.completion_ms
        return None if done is None else done - self.arrival_ms

    @property
    def violated(self) -> bool:
        if self.dropped:
            return True
        lat = self.latency_ms
        return lat is not None and lat > self.slo_ms

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"RequestView({self.model!r}, t={self.arrival_ms:.3f}, "
                f"status={STATUS_NAMES.get(self.status, self.status)})")
