"""Interference on the H100, measured: co-run factors, solo features, and
the paper's linear predictor fitted from them (paper §3.2, §4.4).

The card's counterpart of the profiling half of ``core/interference.py``.
There the ground truth (``true_interference_factors``) and the features
(``solo_features``) are analytic functions of a 2080 Ti.  Here both come
from the card (``launch/profile_interference.py``):

  * the co-run table (``results/h100_corun.jsonl``): one line per co-run of
    two models' captured decode steps on the two sides of a carve of the
    SMs (``core.h100lets.CARVES``), each side's solo and co-run ms and its
    factor, co-run over solo.  Index 0 of each list is the carve's left
    side (``carve`` percent), 1 its right side;
  * the features (``results/h100_features.jsonl``): per (arch, percent,
    batch) the share of the HBM rate one decode step uses alone on that
    partition, ``dram_share`` = the step's bytes (``step_bytes``) over its
    L(b, p) over 3.35 TB/s, and the L2 share where a counter gave one
    (``l2`` null otherwise, with ``l2_reason``; the fit then sees zeros and
    gives the L2 columns zero coefficients).

Both loaders refuse records of two cards, a cell measured twice and a
missing cell.  A lookup at a batch between measured sizes uses the next
measured size up (the graph of that batch, padded), as
``h100lets.MeasuredLatency`` does; above the largest it raises.

:class:`MeasuredInterferenceModel` is the paper's predictor reading these
features; :func:`fit_measured` fits it as ``fit_default_model`` fits the
analytic one.  ``simulator/h100engine.py`` replays with the co-run table
as its ground truth.
"""
from __future__ import annotations

import dataclasses
import json
import math
from bisect import bisect_left

import numpy as np

from repro_torch.core.h100lets import CARVES, carve_of
from repro_torch.core.interference import FEATURE_BATCH, InterferenceModel
from repro_torch.core.latency import PARTITION_SIZES
from repro_torch.models.config import ATTN_KINDS

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
#: batches of each side in the co-run grid
CORUN_BATCHES: tuple[int, ...] = (1, 8, 32)
CONV_K = 4  # the SSM and RG-LRU blocks' depthwise conv width
FAST = 1.18  # Fig. 6: the paper's share of pairs below 18% overhead


# ------------------------------------------------------------- bytes ----


def param_count(cfg) -> tuple[int, int]:
    """(bf16 / model-dtype, fp32) parameter counts of the port's ``Model``
    of ``cfg``: the norms, the SSM's ``a_log`` / ``dt_bias`` / ``d_skip``,
    the RG-LRU's ``lam`` and the MoE router are fp32, everything else the
    model dtype."""
    d, v = cfg.d_model, cfg.padded_vocab
    norm = d * (2 if cfg.norm == "layernorm" else 1)
    # embedding and head (the audio encoder: its head alone); final norm
    wide, fp32 = (1 if cfg.arch_type == "audio" else 2) * v * d, norm
    for kind in cfg.layer_types():
        fp32 += norm
        if kind in ATTN_KINDS:
            hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            wide += d * dh * (hq + 2 * hkv) + hq * dh * d
        elif kind == "ssm":
            di, n, nh = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads
            wide += d * (2 * di + 2 * n + nh) + CONV_K * di + di * d
            fp32 += 3 * nh
        else:  # rglru
            w = cfg.lru_width or d
            wide += 2 * d * w + CONV_K * w + 2 * w * w + w * d
            fp32 += w
        if kind == "moe":  # routed and shared experts, SwiGLU; the router
            fp32 += norm + d * cfg.n_experts
            wide += 3 * d * cfg.moe_d_ff * (cfg.n_experts
                                            + cfg.n_shared_experts)
            if cfg.moe_dense_residual:
                wide += 3 * d * cfg.d_ff
        elif kind != "ssm":
            fp32 += norm
            wide += (3 if cfg.activation == "swiglu" else 2) * d * cfg.d_ff
    return wide, fp32


def step_bytes(cfg, batch: int, ctx: int, dtype_bytes: int = 2) -> dict:
    """Bytes one decode step at ``batch`` moves with ``ctx`` positions
    cached, or, for an encoder-only ``cfg`` (no decode step), one forward
    over ``ctx`` frames: each read once, each write once.

    ``weights``: every parameter but the token-embedding table (an MoE
    step reads every expert: its dispatch buffer has rows for each); an
    encoder's every parameter, its head included.
    ``per_request``: one row of that table, the cache or state the step
    reads (K and V of ``ctx`` + 1 positions, the new one included, a
    hybrid's at most its window; the SSM and RG-LRU conv and recurrent
    states) and what it writes (one K and V slot; the new states); an
    encoder's ``ctx`` x d_model frame inputs and ``ctx`` x padded_vocab
    logits.
    ``total`` = weights + batch x per_request."""
    wide, fp32 = param_count(cfg)
    d = cfg.d_model
    if not cfg.has_decoder:
        weights = wide * dtype_bytes + fp32 * 4
        per_req = ctx * (d + cfg.padded_vocab) * dtype_bytes
        return {"weights": weights, "per_request": per_req,
                "total": weights + batch * per_req}
    weights = (wide - cfg.padded_vocab * d) * dtype_bytes + fp32 * 4
    per_req = d * dtype_bytes
    for kind in cfg.layer_types():
        if kind in ATTN_KINDS:
            slot = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
            seen = (min(ctx + 1, cfg.local_window) if kind == "attn"
                    else ctx + 1)
            per_req += slot * seen + slot
        elif kind == "ssm":
            state = (CONV_K - 1) * cfg.ssm_d_inner * dtype_bytes + (
                cfg.ssm_n_heads * cfg.ssm_d_state * cfg.ssm_headdim * 4)
            per_req += 2 * state
        else:
            w = cfg.lru_width or d
            per_req += 2 * ((CONV_K - 1) * w * dtype_bytes + w * 4)
    return {"weights": weights, "per_request": per_req,
            "total": weights + batch * per_req}


def features_from_grid(lbp_records, batches, *, l2_reason: str) -> list[dict]:
    """One feature record per (arch, percent, batch in ``batches``) of an
    L(b, p) grid (``profile_partitions`` records): the step's bytes over
    its measured time, as a share of the HBM rate.  ``l2`` is null with
    ``l2_reason``: the L2 share is not measured."""
    out = []
    for r in lbp_records:
        if r["batch"] not in batches:
            continue
        nbytes = r["weight_bytes"] + r["batch"] * r["bytes_per_req"]
        out.append({
            "card": r["card"], "power_limit_w": r["power_limit_w"],
            "torch": r.get("torch"), "cuda": r.get("cuda"),
            "arch": r["arch"], "percent": r["percent"], "sms": r["sms"],
            "carve": r.get("carve"), "side": r.get("side"),
            "batch": r["batch"], "step_ms": r["step_ms"], "bytes": nbytes,
            "dram_share": nbytes / (r["step_ms"] * 1e-3) / HBM_BYTES_PER_S,
            "l2": None, "l2_reason": l2_reason})
    return out


# ------------------------------------------------------------ tables ----


def _up(batches: tuple[int, ...], batch: int, what: str) -> int:
    """The measured batch a ``batch`` runs as: the next size up."""
    i = bisect_left(batches, batch)
    if batch < 1 or i == len(batches):
        raise ValueError(f"{what}: batch {batch} is outside the measured "
                         f"1-{batches[-1]}")
    return batches[i]


def _one_card(cards: set, path: str):
    if len(cards) != 1:
        raise ValueError(f"{path}: records from {len(cards)} cards "
                         f"{sorted(cards, key=str)}; a table is one card's")
    (card, power), = cards
    return f"{card}, {power} W"


def _read(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class CorunTable:
    """Measured co-run factors by (carve, left arch, left batch, right
    arch, right batch)."""

    def __init__(self, records: list[dict], source: str = "table"):
        self.records = records
        self.cells: dict[tuple, dict] = {}
        cards = set()
        for n, r in enumerate(records, 1):
            cards.add((r["card"], r["power_limit_w"]))
            key = (int(r["carve"]), r["arch"][0], int(r["batch"][0]),
                   r["arch"][1], int(r["batch"][1]))
            if key in self.cells:
                raise ValueError(f"{source}:{n}: co-run {key} is measured "
                                 "twice")
            if not all(f > 0 and math.isfinite(f) for f in r["factor"]):
                raise ValueError(f"{source}:{n}: co-run {key} has factors "
                                 f"{r['factor']}")
            self.cells[key] = r
        self.card = _one_card(cards, source)
        self.archs = sorted({k[1] for k in self.cells}
                            | {k[3] for k in self.cells})
        self.batches = tuple(sorted({k[2] for k in self.cells}
                                    | {k[4] for k in self.cells}))
        missing = [(c, a, ba, b, bb) for c in CARVES for a in self.archs
                   for ba in self.batches for b in self.archs
                   for bb in self.batches
                   if (c, a, ba, b, bb) not in self.cells]
        if missing or {k[0] for k in self.cells} != set(CARVES):
            raise ValueError(f"{source}: {len(missing)} missing co-run "
                             f"cells of carves {CARVES}, e.g. "
                             f"{missing[:3]}")
        self.source = source

    def factor(self, arch: str, percent: int, batch: int, partner: str,
               partner_batch: int, position: int = 0) -> float:
        """Measured slowdown of ``arch`` at ``batch`` on the ``percent``
        side of its card (``position`` 0 the first gpu-let, 1 the second)
        with ``partner`` at ``partner_batch`` in flight on the other."""
        b = _up(self.batches, batch, arch)
        pb = _up(self.batches, partner_batch, partner)
        carve, side = carve_of(percent, position)
        if side == "left":
            return self.cells[carve, arch, b, partner, pb]["factor"][0]
        return self.cells[carve, partner, pb, arch, b]["factor"][1]


class FeatureTable:
    """Measured solo features by (arch, percent, batch)."""

    def __init__(self, records: list[dict], source: str = "table"):
        self.records = records
        self.cells: dict[tuple, dict] = {}
        cards = set()
        for n, r in enumerate(records, 1):
            cards.add((r["card"], r["power_limit_w"]))
            key = (r["arch"], int(r["percent"]), int(r["batch"]))
            if key in self.cells:
                raise ValueError(f"{source}:{n}: features {key} measured "
                                 "twice")
            self.cells[key] = r
        self.card = _one_card(cards, source)
        self.archs = sorted({k[0] for k in self.cells})
        self.batches = tuple(sorted({k[2] for k in self.cells}))
        missing = [(a, p, b) for a in self.archs for p in PARTITION_SIZES
                   for b in self.batches if (a, p, b) not in self.cells]
        if missing or FEATURE_BATCH not in self.batches:
            raise ValueError(f"{source}: {len(missing)} missing feature "
                             f"cells (batch {FEATURE_BATCH} among them: "
                             f"{FEATURE_BATCH not in self.batches}), e.g. "
                             f"{missing[:3]}")
        self.source = source

    def at(self, arch: str, percent: int, batch: int) -> tuple[float, float]:
        """(l2 share, DRAM share); an L2 share not measured is 0."""
        r = self.cells[arch, percent, _up(self.batches, batch, arch)]
        return (r["l2"] or 0.0), r["dram_share"]


def corun_summary(corun: CorunTable) -> dict:
    """The factors' distribution over every co-run side (paper Fig. 6):
    the share under ``FAST``, p10 / median / p90, the worst side, and the
    median by the side's SM count and by arch and batch."""
    sides = [(f, r["arch"][i], r["batch"][i], r["sms"][i], r["arch"][1 - i],
              r["batch"][1 - i]) for r in corun.records
             for i, f in enumerate(r["factor"])]
    factors = np.asarray([s[0] for s in sides])

    def medians(key) -> dict:
        groups: dict = {}
        for s in sides:
            groups.setdefault(key(s), []).append(s[0])
        return {k: float(np.median(v)) for k, v in sorted(groups.items())}

    worst = max(sides)
    return {"sides": len(sides),
            "share_under_1.18": float(np.mean(factors < FAST)),
            "p10": float(np.percentile(factors, 10)),
            "median": float(np.median(factors)),
            "p90": float(np.percentile(factors, 90)),
            "worst": {"factor": worst[0], "arch": worst[1],
                      "batch": worst[2], "sms": worst[3],
                      "partner": worst[4], "partner_batch": worst[5]},
            "median_by_sms": medians(lambda s: str(s[3])),
            "median_by_arch_batch": medians(lambda s: f"{s[1]} b{s[2]}")}


def load_corun(path: str) -> CorunTable:
    return CorunTable(_read(path), source=path)


def load_features(path: str) -> FeatureTable:
    return FeatureTable(_read(path), source=path)


# --------------------------------------------------------- predictor ----


@dataclasses.dataclass
class MeasuredInterferenceModel(InterferenceModel):
    """The paper's linear predictor over the card's measured features: the
    features of a model on a partition are those measured alone there at
    ``FEATURE_BATCH``, in place of the analytic 2080 Ti ``solo_features``."""

    features: FeatureTable | None = None

    def predict_pair(self, prof_a, p_a, prof_b, p_b, acc=None) -> float:
        l2a, mema = self.features.at(prof_a.name, round(p_a * 100),
                                     FEATURE_BATCH)
        l2b, memb = self.features.at(prof_b.name, round(p_b * 100),
                                     FEATURE_BATCH)
        return self.predict(l2a, l2b, mema, memb)


def pairs_dataset(corun: CorunTable, features: FeatureTable
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The paper's profiling dataset, as ``profile_pairs_dataset`` builds
    it: two samples a co-run (one a side), features at the co-run's
    batches, in the table's order."""
    feats, targs = [], []
    for r in corun.records:
        (al, ar), (bl, br), (pl, pr) = r["arch"], r["batch"], r["percent"]
        l2l, meml = features.at(al, pl, bl)
        l2r, memr = features.at(ar, pr, br)
        feats.append([l2l, l2r, meml, memr])
        targs.append(r["factor"][0])
        feats.append([l2r, l2l, memr, meml])
        targs.append(r["factor"][1])
    return np.asarray(feats), np.asarray(targs)


def fit_measured(corun: CorunTable, features: FeatureTable,
                 train_frac: float = 0.7, seed: int = 0
                 ) -> tuple[MeasuredInterferenceModel, dict]:
    """Fit on a seeded split as ``fit_default_model`` does; the same
    stats (relative error on the held-out part)."""
    feats, targs = pairs_dataset(corun, features)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(feats))
    n_train = int(len(feats) * train_frac)
    tr, va = idx[:n_train], idx[n_train:]
    model = MeasuredInterferenceModel(features=features)
    rms = model.fit(feats[tr], targs[tr])
    pred = np.array([model.predict(*f) for f in feats[va]])
    rel_err = np.abs(pred - targs[va]) / targs[va]
    stats = dict(
        rms_train=rms,
        n_train=len(tr), n_val=len(va),
        p90_rel_err=float(np.percentile(rel_err, 90)),
        p95_rel_err=float(np.percentile(rel_err, 95)),
        mean_rel_err=float(np.mean(rel_err)),
    )
    return model, stats


__all__ = ["CORUN_BATCHES", "CorunTable", "FeatureTable",
           "MeasuredInterferenceModel", "corun_summary",
           "features_from_grid", "fit_measured",
           "load_corun", "load_features", "pairs_dataset", "param_count",
           "step_bytes"]
