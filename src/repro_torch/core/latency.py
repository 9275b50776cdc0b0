"""The L(b, p) latency function and derived scheduling quantities.

The paper profiles L(b, p) — batch-b inference latency on a partition of
size p — on hardware (Fig. 3) and feeds it to the scheduler (Table 2).  This
module provides the analytic, calibrated stand-in for those measurements
(CPU-only container; see DESIGN.md §2) and every derived quantity the
schedulers need:

  * ``latency_ms(prof, b, p)``            — L(b, p)
  * ``max_batch_under_slo(prof, p, slo)`` — argmax_b L(b,p) <= slo   (Alg.1 l.27)
  * ``max_rate(prof, p)``                 — sustainable req/s of a gpu-let
  * ``min_required_partition(prof, rate)``— p_req  (Alg.1 l.10)
  * ``max_efficient_partition(prof)``     — p_eff, the knee (Alg.1 l.9, Fig.8)
  * ``LatencyProvider.admit(entries, p)`` — the completion-time-aware
    duty-cycle admission test (the only implementation; the module-level
    ``duty_cycle_feasible`` and ``LatencyMemo`` delegate to it)

Latency model::

    L(b, p) = t0 + b*flops/(peak * eff * min(p, par(b))) + bytes(b)/BW

The ``min(p, par(b))`` term produces Fig. 3's knee: a small batch saturates
at par(b) < 1 and extra partition is wasted (flat region), while batch 32
keeps using resource.  bytes(b) = weights + b*activations: the weight-read
term is partition-independent, matching the observation that small-batch
latency barely moves with p.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

from repro_torch.core.hardware import AcceleratorSpec, RTX_2080TI
from repro_torch.core.profiles import ModelProfile

#: Partition sizes (percent) available to the scheduler.  The paper splits
#: one GPU into at most two gpu-lets with ratios from
#: {(2:8),(4:6),(5:5),(6:4),(8:2)} plus the unsplit GPU (§3.2, §6).
PARTITION_SIZES: tuple[int, ...] = (20, 40, 50, 60, 80, 100)

#: Allowed (left, right) splits of a 100% GPU into two gpu-lets.
SPLIT_PAIRS: tuple[tuple[int, int], ...] = (
    (20, 80), (40, 60), (50, 50), (60, 40), (80, 20))

#: Batch sizes considered by the scheduler (paper sweeps up to 32; >32 makes
#: the SLO "unrealistically long", §6.1).
BATCH_SIZES: tuple[int, ...] = tuple(range(1, 33))
MAX_BATCH = 32

#: Prompt length the calibrated one-shot L(b, p) corresponds to.  A
#: streaming request's *prefill* over this many tokens costs exactly
#: L(b, p) (flash_attention regime: compute scales with prompt tokens);
#: a *decode step* re-reads the weights/KV but computes only one token
#: per stream (decode_attention regime), so its compute term is 1/REF of
#: the prefill's while the memory term survives whole — decode is
#: HBM-bound and barely benefits from partition size past the bandwidth
#: knee, prefill is compute-bound and scales with it.
REF_PROMPT_TOKENS = 512

#: Fraction of t0 charged per decode step: launch overhead is mostly
#: amortized across steps (graph-replay style) but not free.
DECODE_T0_FRAC = 0.25


def raw_compute_ms(prof: ModelProfile, batch: int, p: float,
                   acc: AcceleratorSpec = RTX_2080TI) -> float:
    """Compute-roofline term at efficiency 1.0 (used by calibration)."""
    p_eff = min(p, prof.parallelism(batch))
    p_eff = max(p_eff, 1e-3)
    gflops = prof.flops_per_req * batch
    return gflops / (acc.peak_tflops * 1e3 * p_eff) * 1e3  # ms


def memory_ms(prof: ModelProfile, batch: int, p: float,
              acc: AcceleratorSpec = RTX_2080TI) -> float:
    """HBM-traffic term.

    MPS compute provisioning does not partition memory bandwidth (the paper
    notes bandwidth isolation only arrives with Ampere/MIG), so the weight
    read is partition-independent; we model a mild bandwidth penalty for very
    small partitions since fewer SMs issue fewer outstanding loads.
    """
    bw_frac = 0.5 + 0.5 * min(1.0, 2.0 * p)  # 0.7 at p=0.2 .. 1.0 at p>=0.5
    mb = prof.weight_mb + prof.act_mb_per_req * batch
    return mb / (acc.hbm_gbs * bw_frac)  # MB/(GB/s) -> ms


def latency_ms(prof: ModelProfile, batch: int, p: float,
               acc: AcceleratorSpec = RTX_2080TI) -> float:
    """L(b, p): batch-``batch`` latency (ms) on partition fraction ``p``."""
    if batch <= 0:
        return 0.0
    return (prof.t0_ms
            + raw_compute_ms(prof, batch, p, acc) / prof.efficiency
            + memory_ms(prof, batch, p, acc))


def max_batch_under_slo(prof: ModelProfile, p: float, slo_ms: float,
                        intf_factor: float = 1.0,
                        acc: AcceleratorSpec = RTX_2080TI,
                        headroom: float = 0.5,
                        offset_ms: float = 0.0) -> int:
    """Delegates to the single cap-search on :class:`LatencyProvider`."""
    return AnalyticGPULatency(acc).max_batch_under_slo(
        prof, p, slo_ms, intf_factor, headroom, offset_ms)


def max_rate(prof: ModelProfile, p: float, intf_factor: float = 1.0,
             acc: AcceleratorSpec = RTX_2080TI) -> float:
    """Max sustainable request rate (req/s) of a gpu-let of size ``p``.

    With duty-cycle pipelining the gpu-let executes back-to-back batches of
    size b: throughput = b / L.  The interference factor enters only the SLO
    *admission* check (Alg. 1 line 28: ``L(b, p) + intf <= SLO``) — it trims
    the admissible batch but does not deflate the booked throughput; the
    scheduler's burst headroom absorbs the actual runtime slowdown.
    """
    best = 0.0
    for b in BATCH_SIZES:
        lat = latency_ms(prof, b, p, acc)
        if intf_factor * lat <= 0.5 * prof.slo_ms:
            best = max(best, b / (lat / 1e3))
    return best


def rate_curve(prof: ModelProfile, intf_factor: float = 1.0,
               acc: AcceleratorSpec = RTX_2080TI,
               sizes: Sequence[int] = PARTITION_SIZES) -> list[tuple[int, float]]:
    """(partition %, max rate) points — the curve of Fig. 8."""
    return [(s, max_rate(prof, s / 100.0, intf_factor, acc)) for s in sizes]


def max_efficient_partition(prof: ModelProfile,
                            acc: AcceleratorSpec = RTX_2080TI) -> int:
    """p_eff: the knee of the rate-vs-partition curve (Fig. 8).

    MAXEFFICIENTPARTITION "calculates the curvature at the profiled gpulet
    size and uses the gpulet size at the knee" — we use the discrete second
    difference of the normalized curve and take its maximum (the point where
    marginal gain drops fastest).  Falls back to the smallest partition that
    achieves >=90% of the full-GPU rate when the curve is near-linear.
    """
    pts = rate_curve(prof, acc=acc)
    # prepend the origin so a curve that is already flat at the smallest
    # profiled size puts its knee *at* that size (e.g. tiny models).
    sizes = [0] + [s for s, _ in pts]
    rates = [0.0] + [r for _, r in pts]
    full = rates[-1] if rates[-1] > 0 else 1.0
    norm = [r / full for r in rates]
    # knee by max negative curvature of normalized rate vs normalized size
    best_i, best_curv = len(sizes) - 1, -math.inf
    for i in range(1, len(sizes) - 1):
        ds0 = (sizes[i] - sizes[i - 1]) / 100.0
        ds1 = (sizes[i + 1] - sizes[i]) / 100.0
        d0 = (norm[i] - norm[i - 1]) / ds0
        d1 = (norm[i + 1] - norm[i]) / ds1
        curv = d0 - d1  # concavity: drop in marginal gain at i
        if curv > best_curv:
            best_curv, best_i = curv, i
    if best_curv <= 1e-6:  # near-linear: every % helps equally
        for s, n in zip(sizes, norm):
            if n >= 0.90:
                return s
        return 100
    return sizes[best_i]


def min_required_partition(prof: ModelProfile, rate: float,
                           intf_factor: float = 1.0,
                           acc: AcceleratorSpec = RTX_2080TI) -> int | None:
    """p_req: smallest partition sustaining ``rate`` req/s, or None."""
    for s in PARTITION_SIZES:
        if max_rate(prof, s / 100.0, intf_factor, acc) >= rate:
            return s
    return None


@dataclasses.dataclass(frozen=True)
class Admission:
    """Result of the completion-time-aware duty-cycle admission test.

    All per-entry sequences are aligned with the *input* entry order (the
    EDF launch reordering happens internally):

      * ``batches``        — batch size b_i = ceil(rate_i * duty)
      * ``offsets_ms``     — launch offset of model i within the cycle (the
        serialization wait behind earlier, tighter-SLO batches)
      * ``est_latency_ms`` — offset_i + intf_i * L(b_i, p): the in-cycle
        *completion* time the scheduler promises.  A request therefore
        finishes within duty + est_latency_ms of arriving, and admission
        guarantees that bound <= SLO_i.
    """

    ok: bool
    duty_ms: float
    batches: tuple[int, ...]
    offsets_ms: tuple[float, ...]
    est_latency_ms: tuple[float, ...]


class LatencyProvider:
    """Pluggable L(b, p) source for the schedulers.

    The default (`AnalyticGPULatency`) is the calibrated analytic model of
    the paper's 2080 Ti testbed; `core/tpulets.RooflineLatency` derives
    L(b, p) from the compiled dry-run's roofline terms instead (a tpu-let =
    a sub-mesh; p = fraction of the pod).  Everything the schedulers need is
    expressed through this interface.
    """

    #: partition sizes (%) this substrate supports
    partition_sizes: tuple[int, ...] = PARTITION_SIZES
    #: allowed (left, right) splits of a whole device
    split_pairs: tuple[tuple[int, int], ...] = SPLIT_PAIRS
    batch_sizes: tuple[int, ...] = BATCH_SIZES
    max_batch: int = MAX_BATCH

    def latency_ms(self, prof: ModelProfile, batch: int, p: float) -> float:
        raise NotImplementedError

    # ---- generic derived quantities (paper Alg. 1 inputs) -----------------

    def max_batch_under_slo(self, prof, p, slo_ms, intf_factor=1.0,
                            headroom=0.5, offset_ms=0.0) -> int:
        """argmax_b  offset + intf * L(b, p) <= headroom * slo  (0 if none).

        ``headroom`` reserves budget for batch *building* time: with
        duty-cycled execution a request waits up to one duty cycle before
        its batch runs (Fig. 1), so admission uses L(b,p) <= SLO/2 as in
        Nexus.  ``offset_ms`` is the model's launch offset within the cycle
        (models later in the EDF walk wait behind earlier batches); the
        engine passes it when deriving catch-up batch caps so a catch-up
        batch cannot blow the SLO of a model that launches late.
        """
        best = 0
        budget = headroom * slo_ms - offset_ms
        for b in self.batch_sizes:
            if intf_factor * self.latency_ms(prof, b, p) <= budget:
                best = b
        return best

    def max_rate(self, prof, p, intf_factor=1.0) -> float:
        best = 0.0
        for b in self.batch_sizes:
            lat = self.latency_ms(prof, b, p)
            if intf_factor * lat <= 0.5 * prof.slo_ms and lat > 0:
                best = max(best, b / (lat / 1e3))
        return best

    def rate_curve(self, prof, intf_factor=1.0):
        return [(s, self.max_rate(prof, s / 100.0, intf_factor))
                for s in self.partition_sizes]

    def max_efficient_partition(self, prof) -> int:
        pts = self.rate_curve(prof)
        sizes = [0] + [s for s, _ in pts]
        rates = [0.0] + [r for _, r in pts]
        full = rates[-1] if rates[-1] > 0 else 1.0
        norm = [r / full for r in rates]
        best_i, best_curv = len(sizes) - 1, -math.inf
        for i in range(1, len(sizes) - 1):
            ds0 = (sizes[i] - sizes[i - 1]) / 100.0
            ds1 = (sizes[i + 1] - sizes[i]) / 100.0
            d0 = (norm[i] - norm[i - 1]) / ds0
            d1 = (norm[i + 1] - norm[i]) / ds1
            curv = d0 - d1
            if curv > best_curv:
                best_curv, best_i = curv, i
        if best_curv <= 1e-6:
            for s, n in zip(sizes[1:], norm[1:]):
                if n >= 0.90:
                    return s
            return 100
        return sizes[best_i]

    def min_required_partition(self, prof, rate, intf_factor=1.0):
        for s in self.partition_sizes:
            if self.max_rate(prof, s / 100.0, intf_factor) >= rate:
                return s
        return None

    # ---- prefill/decode phase costs (streaming lifecycle) -----------------

    def phase_split(self, prof, batch, p) -> tuple[float, float]:
        """``(compute_ms, memory_ms)`` decomposition of L(b, p) - t0.

        The default assumes a compute-leaning 60/40 split; providers that
        know their roofline terms override with the exact decomposition
        (:class:`AnalyticGPULatency` does).
        """
        body = self.latency_ms(prof, batch, p) - prof.t0_ms
        if body < 0.0:
            body = 0.0
        return 0.6 * body, 0.4 * body

    def prefill_ms(self, prof, batch, p,
                   prompt_tokens: float = REF_PROMPT_TOKENS) -> float:
        """Prefill cost of a batch of streams with ``prompt_tokens`` each.

        Compute scales with the prompt length (the calibrated L(b, p)
        *is* the prefill at :data:`REF_PROMPT_TOKENS`); the memory term
        (weights + activations) is prompt-independent at this fidelity.
        """
        comp, mem = self.phase_split(prof, batch, p)
        return prof.t0_ms + comp * (prompt_tokens / REF_PROMPT_TOKENS) + mem

    def decode_step_ms(self, prof, batch, p) -> float:
        """One decode step: every live stream in the batch gains a token.

        The weights/KV stream through HBM once per step (full memory
        term) while only one token per stream is computed (compute term
        / REF_PROMPT_TOKENS) — the step is bandwidth-bound, so batching
        decodes amortizes the read and a bigger partition buys little.
        """
        comp, mem = self.phase_split(prof, batch, p)
        return (DECODE_T0_FRAC * prof.t0_ms
                + comp / REF_PROMPT_TOKENS + mem)

    def max_decode_batch(self, prof, p, tpot_slo_ms,
                         intf_factor: float = 1.0) -> int:
        """Largest decode batch whose step keeps every stream's TPOT SLO
        (0 if even a solo stream cannot hold cadence)."""
        best = 0
        for b in self.batch_sizes:
            if intf_factor * self.decode_step_ms(prof, b, p) <= tpot_slo_ms:
                best = b
        return best

    def stream_occupancy(self, prof, p, prompt_tokens, output_tokens,
                         tpot_slo_ms, batch: int = 8,
                         decode_concurrency: float | None = None) -> float:
        """How much busier one streaming request keeps a gpu-let than the
        single L(b, p) launch a phase-oblivious scheduler books for it.

        Per-request service = amortized prefill + the decode tail.  The
        tail amortizes over the decode batch that actually forms, which
        is the *smaller* of the TPOT-feasible cap and the number of
        streams concurrently in decode (``decode_concurrency``, e.g.
        ``rate * decode_lifetime``) — a low-rate model pays near-solo
        decode steps no matter how large the cap is.  Phase-aware
        provisioning scales a model's booked rate by this factor so
        decode work is counted.
        """
        b = min(batch, self.max_batch)
        base = self.latency_ms(prof, b, p) / b
        if base <= 0:
            return 1.0
        pre = self.prefill_ms(prof, b, p, prompt_tokens) / b
        bd = self.max_decode_batch(prof, p, tpot_slo_ms)
        if bd <= 0:
            bd = 1
        if decode_concurrency is not None:
            bd = max(1, min(bd, int(decode_concurrency)))
        tail = max(output_tokens - 1.0, 0.0)
        dec = tail * self.decode_step_ms(prof, bd, p) / bd
        occ = (pre + dec) / base
        return occ if occ > 1.0 else 1.0

    #: duty-cycle search grid resolution (candidate cycles per tightest SLO)
    duty_grid: int = 24

    def admit(self, entries, p, intf_factor=1.0, streams=None) -> Admission:
        """Completion-time-aware duty-cycle admission (the single core).

        ``entries`` is [(profile, rate_req_s), ...]; ``intf_factor`` is
        either one factor applied to every model or a per-entry sequence
        aligned with ``entries``.  Searches duty cycles D over a grid up to
        the tightest SLO; for each candidate the models are walked in EDF
        order (tightest SLO first — exactly the engine's in-cycle launch
        order) accumulating real launch offsets, and admission requires,
        with completion_i = offset_i + intf_i * L(b_i, p):

          (a) b_i = ceil(rate_i * D) <= max_batch;
          (b) D + completion_i <= SLO_i for every model — batch build plus
              the *serialized* in-cycle execution fits the SLO (this is
              where the old test was serialization-blind: it assumed every
              batch launched at the cycle start); and
          (c) completion_last <= D — the execution pipeline keeps up.

        Offsets count predecessors' interference-inflated latencies: a
        batch behind a slowed-down batch really does launch later, so the
        pipeline check (c) inherits the inflation too (a deliberate
        departure from Alg. 1's "interference enters the SLO check only",
        which under-books shared cycles).

        ``streams`` (optional, aligned with ``entries``) marks streaming
        models: entry i with ``streams[i] = (prompt_tokens,
        output_tokens, tpot_slo_ms)`` is admitted on its *prefill* cost
        against ``prof.slo_ms`` read as the TTFT deadline, and the
        steady-state decode load it adds per cycle — ``rate * duty *
        (output_tokens - 1)`` tokens at the best TPOT-feasible decode
        batch — is charged into the pipeline check (c), so a cycle whose
        decode tail starves prefill is rejected.  ``streams=None`` (or
        all-``None`` entries) takes the exact pre-streaming path.
        """
        n = len(entries)
        if n == 0:
            return Admission(True, 0.0, (), (), ())
        if streams is not None and len(streams) != n:
            raise ValueError("one stream spec (or None) per entry required")
        if isinstance(intf_factor, (int, float)):
            factors = [float(intf_factor)] * n
        else:
            factors = [float(f) for f in intf_factor]
            if len(factors) != n:
                raise ValueError("one interference factor per entry required")
        order = sorted(range(n), key=lambda i: entries[i][0].slo_ms)
        slo_min = entries[order[0]][0].slo_ms
        for k in range(self.duty_grid, 0, -1):
            duty = slo_min * k / self.duty_grid
            batches = [0] * n
            offsets = [0.0] * n
            ests = [0.0] * n
            t, ok = 0.0, True
            for i in order:
                prof, rate = entries[i]
                b = max(1, math.ceil(rate * duty / 1e3))
                if b > self.max_batch:
                    ok = False
                    break
                sp = streams[i] if streams is not None else None
                if sp is None:
                    exec_ms = self.latency_ms(prof, b, p)
                else:
                    exec_ms = self.prefill_ms(prof, b, p, sp[0])
                done = t + factors[i] * exec_ms
                if duty + done > prof.slo_ms:
                    ok = False
                    break
                batches[i], offsets[i], ests[i] = b, t, done
                t = done
            if ok and streams is not None:
                # steady-state decode occupancy shares the execution slot
                for i in order:
                    sp = streams[i]
                    if sp is None:
                        continue
                    ptok, otok, tpot = sp
                    prof, rate = entries[i]
                    bd = self.max_decode_batch(prof, p, tpot, factors[i])
                    if bd == 0:
                        ok = False
                        break
                    toks = rate * duty / 1e3 * max(otok - 1.0, 0.0)
                    t += (factors[i] * toks
                          * self.decode_step_ms(prof, bd, p) / bd)
            if ok and t <= duty:
                return Admission(True, duty, tuple(batches),
                                 tuple(offsets), tuple(ests))
        return Admission(False, 0.0, (), (), ())

    def duty_cycle_feasible(self, entries, p, intf_factor=1.0):
        """(feasible, duty_ms, batches) view of :meth:`admit`."""
        adm = self.admit(entries, p, intf_factor)
        return adm.ok, adm.duty_ms, list(adm.batches)


class AnalyticGPULatency(LatencyProvider):
    """The paper-testbed latency model (module functions above)."""

    def __init__(self, acc: AcceleratorSpec = RTX_2080TI):
        self.acc = acc

    def latency_ms(self, prof, batch, p):
        return latency_ms(prof, batch, p, self.acc)

    def phase_split(self, prof, batch, p):
        """Exact roofline decomposition (no 60/40 approximation)."""
        return (raw_compute_ms(prof, batch, p, self.acc) / prof.efficiency,
                memory_ms(prof, batch, p, self.acc))


class LatencyMemo(LatencyProvider):
    """Memoizing :class:`LatencyProvider` for simulator hot paths.

    The discrete-event engine evaluates L(b, p) once per batch launch; the
    analytic model is cheap but not free, and the lookups repeat heavily
    (few distinct (model, batch, partition) triples per run).  Entries are
    keyed by profile *name*, so one memo instance must only ever see one
    profile set — the engine creates its own per run.  All derived
    quantities (batch caps, ``admit``) come from the shared
    ``LatencyProvider`` implementations on top of the memoized L(b, p);
    only the cap search carries its own result cache.
    """

    def __init__(self, acc: AcceleratorSpec = RTX_2080TI,
                 inner: LatencyProvider | None = None):
        self.acc = acc
        self.inner = inner or AnalyticGPULatency(acc)
        self.partition_sizes = self.inner.partition_sizes
        self.split_pairs = self.inner.split_pairs
        self.batch_sizes = self.inner.batch_sizes
        self.max_batch = self.inner.max_batch
        self._lat: dict[tuple, float] = {}
        self._cap: dict[tuple, int] = {}
        self._split: dict[tuple, tuple[float, float]] = {}

    def latency_ms(self, prof: ModelProfile, batch: int, p: float) -> float:
        key = (prof.name, batch, p)
        v = self._lat.get(key)
        if v is None:
            v = self._lat[key] = self.inner.latency_ms(prof, batch, p)
        return v

    def phase_split(self, prof: ModelProfile, batch: int,
                    p: float) -> tuple[float, float]:
        key = (prof.name, batch, p)
        v = self._split.get(key)
        if v is None:
            v = self._split[key] = self.inner.phase_split(prof, batch, p)
        return v

    def max_batch_under_slo(self, prof: ModelProfile, p: float,
                            slo_ms: float, intf_factor: float = 1.0,
                            headroom: float = 0.5,
                            offset_ms: float = 0.0) -> int:
        key = (prof.name, p, slo_ms, intf_factor, headroom, offset_ms)
        v = self._cap.get(key)
        if v is None:
            v = self._cap[key] = super().max_batch_under_slo(
                prof, p, slo_ms, intf_factor, headroom, offset_ms)
        return v


def duty_cycle_feasible(entries: Sequence[tuple[ModelProfile, float]],
                        p: float, intf_factor: float = 1.0,
                        acc: AcceleratorSpec = RTX_2080TI,
                        ) -> tuple[bool, float, list[int]]:
    """Module-level view of :meth:`LatencyProvider.admit` (see there).

    Kept for callers that only need (feasible, duty_ms, batches) of the
    analytic GPU model; the completion-time-aware admission core itself
    lives in exactly one place, ``LatencyProvider.admit``.
    """
    return AnalyticGPULatency(acc).duty_cycle_feasible(entries, p,
                                                       intf_factor)
