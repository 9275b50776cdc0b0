"""The serving loop: open-loop arrivals, FIFO by due time, one loop a side.

Each side of a configuration (a model on a gpu-let) is served by a loop of
its own, on a thread of its own, inside its partition when its percent is
under 100 (``repro_torch.launch.partition``: the partition's context is
current on that thread only).  The loop is work-conserving: whenever the
model is free it takes the length bucket whose oldest waiting request is
due first, fills a batch with that bucket's waiting requests up to the
stream's cap, and calls the model's entry.  With nothing waiting it sleeps
until the next due time.  A request's latency runs from its due time to
the host holding its output (the ``.cpu()`` of the argmax), so a stall
counts against every request behind it.

Only requests due in ``[0, seconds)`` arrive.  After the last, the loop
drains the backlog until it is empty or the stream's SLO past the window
has gone (the cut); a request not done by the cut has failed.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from bench import traffic


@dataclasses.dataclass
class Batch:
    length: int
    rids: np.ndarray
    dispatch: float      # seconds from the window's start
    launched: float      # the entry's launches all issued
    done: float          # the output on the host


@dataclasses.dataclass
class Side:
    """One model served on one gpu-let, and what its loop recorded."""
    name: str
    entry_spec: dict     # the configuration file's model entry
    stream: dict         # the traffic file's stream of this model
    sched: traffic.Schedule
    model: object        # the port's Model
    pool: torch.Tensor   # the input pool (weights.input_pool)
    part: object = None  # the partition, under 100%
    dispatch: np.ndarray = None
    done: np.ndarray = None
    outputs: dict = dataclasses.field(default_factory=dict)
    batches: list = dataclasses.field(default_factory=list)
    waits: list = dataclasses.field(default_factory=list)  # (from, to)
    lateness: list = dataclasses.field(default_factory=list)

    @property
    def slo_s(self) -> float:
        return self.stream["slo_ms"] / 1e3

    @property
    def decoder(self) -> bool:
        return self.entry_spec["fields"].get("has_decoder", True)

    def context(self):
        return self.part if self.part is not None else \
            contextlib.nullcontext()

    def inputs(self, rids) -> torch.Tensor:
        """The batch's frames (B, L, d) or token ids (B, L) from the pool."""
        length = int(self.sched.length[rids[0]])
        offs = torch.tensor(self.sched.offset[rids], device=self.pool.device)
        idx = offs[:, None] + torch.arange(length, device=self.pool.device)
        return self.pool[idx]

    def entry(self, rids):
        """The timed path: the port's prefill (a decoder: the first token)
        or forward (an encoder: a label a frame).  Returns (outputs on
        the host, the time its launches were all issued)."""
        model = self.model
        x = self.inputs(rids)
        vocab = self.entry_spec["fields"]["vocab_size"]
        if self.decoder:
            cache = model.init_cache(x.shape[0], x.shape[1])
            logits, _ = model.prefill(x, cache)
            out = logits[:, -1:, :vocab].argmax(-1)
        else:
            logits = model.forward(frame_embeds=x)
            out = logits[..., :vocab].argmax(-1)
        launched = time.perf_counter()
        return out.cpu().numpy(), launched


def warm_up(side: Side):
    """One batch of each size that is a power of two up to the cap, and of
    the cap, in each length bucket of the stream: the shapes the window
    uses, so nothing is first run inside it."""
    with torch.inference_mode(), side.context():
        for length in side.stream["lengths"]:
            n = traffic.cap(side.stream, length)
            sizes = sorted({1 << k for k in range(n.bit_length())
                            if 1 << k <= n} | {n})
            rids = np.flatnonzero(side.sched.length == length)
            if len(rids) == 0:
                rids = np.array([0])
            for b in sizes:
                side.entry(np.resize(rids, b))
        if side.pool.is_cuda:
            torch.cuda.synchronize()


def serve_side(side: Side, t0: float, seconds: float):
    due, length = side.sched.due, side.sched.length
    n = len(due)
    side.dispatch = np.full(n, np.nan)
    side.done = np.full(n, np.nan)
    waiting = {int(L): collections.deque() for L in side.stream["lengths"]}
    cut = seconds + side.slo_s
    i = 0
    clock = time.perf_counter
    with torch.inference_mode(), side.context():
        while True:
            now = clock() - t0
            while i < n and due[i] <= now:
                waiting[int(length[i])].append(i)
                i += 1
            heads = [(due[q[0]], L) for L, q in waiting.items() if q]
            if not heads:
                if i == n:
                    break
                time.sleep(max(0.0, due[i] - now))
                woke = clock() - t0
                side.waits.append((now, woke))
                side.lateness.append(woke - due[i])
                continue
            if now >= cut:
                break
            q = waiting[min(heads)[1]]
            k = min(traffic.cap(side.stream, int(length[q[0]])), len(q))
            rids = np.array([q.popleft() for _ in range(k)])
            start = clock() - t0
            out, launched = side.entry(rids)
            end = clock() - t0
            side.dispatch[rids] = start
            side.done[rids] = end
            for j, r in enumerate(rids):
                side.outputs[int(r)] = out[j]
            side.batches.append(Batch(int(length[rids[0]]), rids, start,
                                      launched - t0, end))


def serve(sides: list[Side], seconds: float) -> float:
    """Serve every side, each on a thread of its own, from one start.
    Returns the start (``time.perf_counter``) the sides' times count
    from."""
    errors = []

    def run(side, t0):
        try:
            serve_side(side, t0, seconds)
        except BaseException as e:  # re-raised in the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(s, t0), name=s.name)
               for s in sides]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return t0


def failed(side: Side, seconds: float) -> np.ndarray:
    """Requests not done by the cut."""
    cut = seconds + side.slo_s
    return ~(side.done <= cut)


def latency_s(side: Side, seconds: float) -> np.ndarray:
    """Each request's latency; a failed one counts at the cut."""
    cut = seconds + side.slo_s
    lat = side.done - side.sched.due
    bad = failed(side, seconds)
    lat[bad] = cut - side.sched.due[bad]
    return lat
