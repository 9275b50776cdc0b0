"""Multi-model serving plan: the paper's scheduler over h100-lets.

Takes an L(b, p) results file measured on SM partitions of an H100
(``launch/profile_partitions.py``; ``results/h100_lbp.jsonl``), or the
labelled synthetic table when none is given, and places the requested
model mix on a cluster of cards with Elastic Partitioning (Alg. 1).  With
``--max-scale`` it reports the largest schedulable multiple of the mix for
Elastic Partitioning and for Squishy Bin Packing (SBP, whole cards only,
the paper's baseline) and their ratio, then plans at 99% of the elastic
maximum.  It prints each model's SLO and L(32, 100%) and, per card, the
split with each gpu-let's models, batch, duty cycle and estimated latency.

``--replay`` serves the placement through the event engine: Poisson
arrivals from ``--seed`` over ``--horizon-s`` seconds, interference off
(the partitions' SMs are disjoint), at 60% of the elastic maximum with
``--max-scale`` or at ``--rates`` as given.  It prints one JSON line and
exits nonzero unless every request completed or was dropped.  The cluster
is the scheduler's arithmetic over one card's measured table, so it needs
no card, and everything here runs on the CPU:

  python -m repro_torch.launch.serve --results results/h100_lbp.jsonl \\
      --rates yi-9b=1,chatglm3-6b=1,mamba2-780m=4,recurrentgemma-2b=2 \\
      --gpus 4 --max-scale --replay

The counterpart of the JAX package's ``launch/serve.py`` and of
``benchmarks/tpulet_serving.py::serve_end_to_end``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.core.h100lets import (SLO_BATCH, SYNTHETIC_MIX,
                                       load_catalog, synthetic_catalog)
from repro_torch.core.hardware import H100_SXM, ClusterSpec
from repro_torch.core.sbp import SquishyBinPacking
from repro_torch.launch.partition import target_sms

CARD_SMS = 132  # an H100 SXM
SEARCH_HI = 1 << 16
PLAN_SHARE = 0.99     # of the elastic maximum, for the printed plan
REPLAY_SHARE = 0.6    # of the elastic maximum, for the replay


def parse_rates(text: str) -> dict[str, float]:
    rates = {}
    for part in text.split(","):
        arch, r = part.split("=")
        rates[arch.strip()] = float(r)
    return rates


def catalog(results: str | None):
    """(profiles, provider, source)."""
    if results:
        profiles, provider = load_catalog(results)
        return profiles, provider, results
    profiles, provider = synthetic_catalog()
    return profiles, provider, "synthetic (not measured)"


def cluster_of(n_gpus: int) -> ClusterSpec:
    return ClusterSpec(accelerator=H100_SXM, n_devices=n_gpus)


def max_scales(profiles, provider, rates, n_gpus: int) -> dict:
    """The largest schedulable multiple of ``rates`` for each scheduler."""
    out = {}
    for name, cls in (("elastic", ElasticPartitioning),
                      ("sbp", SquishyBinPacking)):
        sched = cls({m: profiles[m] for m in rates}, cluster=cluster_of(
            n_gpus), lat=provider)
        out[name] = sched.max_scale(rates, 0.0, SEARCH_HI)
    return out


def plan(profiles, provider, rates, n_gpus: int):
    sched = ElasticPartitioning({m: profiles[m] for m in rates},
                                cluster=cluster_of(n_gpus), lat=provider)
    return sched.schedule(rates)


def serve_end_to_end(profiles, provider, rates, *, n_gpus: int = 4,
                     horizon_s: float = 20.0, seed: int = 0):
    """Run an h100-let schedule through the event engine; returns (metrics,
    schedule)."""
    from repro_torch.simulator import (EngineConfig, EventHeapEngine,
                                       PoissonArrivals)
    from repro_torch.simulator.events import merge_sorted
    result = plan(profiles, provider, rates, n_gpus)
    horizon_ms = horizon_s * 1e3
    gen = PoissonArrivals(seed=seed)
    reqs = merge_sorted([
        gen.constant(m, r, profiles[m].slo_ms, horizon_ms)
        for m, r in rates.items()])
    eng = EventHeapEngine(
        profiles,
        EngineConfig(horizon_ms=horizon_ms, acc=H100_SXM, lat=provider,
                     interference=False),
        schedule=result)
    eng.submit(reqs)
    return eng.run(), result


def replay_summary(met, result, rates) -> dict:
    return {"total": met.total, "completed": met.completed,
            "dropped": met.dropped,
            "violation_rate": met.violation_rate,
            "goodput_req_s": met.goodput_req_s,
            "offered_req_s": sum(rates.values()),
            "gpulets_used": sum(1 for let in result.gpulets
                                if not let.is_free),
            "conserved": met.completed + met.dropped == met.total}


def _sms(provider, percent: int) -> int:
    return provider.sms.get(percent) or (
        CARD_SMS if percent == 100 else target_sms(percent, CARD_SMS))


def print_plan(result, provider, n_gpus: int):
    print(f"schedulable: {result.schedulable}  unplaced: {result.unplaced}")
    for gpu in result.gpus:
        split = "+".join(f"{let.size}%" for let in gpu.lets)
        parts = []
        for let in gpu.lets:
            where = f"{let.size}% = {_sms(provider, let.size)} SMs"
            if let.is_free:
                parts.append(f"[{where}: free]")
            else:
                ass = "; ".join(
                    f"{a.model} r={a.rate:.1f}/s b={a.batch} "
                    f"duty={a.duty_ms:.2f}ms L={a.est_latency_ms:.2f}ms"
                    for a in let.assignments)
                parts.append(f"[{where}: {ass}]")
        print(f"  card {gpu.gpu_id} ({split}): " + " ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default=None,
                    help="L(b, p) JSONL from profile_partitions (default: "
                         "the synthetic table)")
    ap.add_argument("--rates", default=None,
                    help="comma list arch=req_per_s (default: the "
                         "synthetic mix)")
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--max-scale", action="store_true",
                    help="report the max schedulable multiple of --rates "
                         "for elastic and SBP")
    ap.add_argument("--replay", action="store_true",
                    help="serve the placement through the event engine")
    ap.add_argument("--horizon-s", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    profiles, provider, source = catalog(args.results)
    rates = (parse_rates(args.rates) if args.rates
             else {m: r for m, r in SYNTHETIC_MIX.items()
                   if args.results is None})
    unknown = sorted(set(rates) - set(profiles))
    if unknown or not rates:
        raise SystemExit(f"{unknown or 'no rates'}: not in {source} "
                         f"(have: {sorted(profiles)})")

    print(f"== h100-let serving plan: {args.gpus} card(s), {len(rates)} "
          f"model(s); L(b, p) from {source} ({provider.card}) ==")
    for arch in rates:
        prof = profiles[arch]
        print(f"  {arch:<20} SLO={prof.slo_ms:8.3f} ms  "
              f"L({SLO_BATCH},100%)="
              f"{provider.latency_ms(prof, SLO_BATCH, 1.0):8.3f} ms  "
              f"rate={rates[arch]:g}/s")
    print("max rate (req/s) under SLO / 2 by partition, and the knee "
          "p_eff (Alg. 1's max efficient partition):")
    for arch in rates:
        prof = profiles[arch]
        curve = "  ".join(f"{p}%: {r:7.1f}"
                          for p, r in provider.rate_curve(prof))
        print(f"  {arch:<20} {curve}  p_eff="
              f"{provider.max_efficient_partition(prof)}%")
    summary = {}
    if args.max_scale:
        lam = max_scales(profiles, provider, rates, args.gpus)
        total = sum(rates.values())
        ratio = lam["elastic"] / lam["sbp"] if lam["sbp"] else None
        print(f"max schedulable scale: elastic {lam['elastic']:.3f}x "
              f"({lam['elastic'] * total:.1f} req/s), SBP "
              f"{lam['sbp']:.3f}x ({lam['sbp'] * total:.1f} req/s), "
              f"elastic / SBP "
              f"{'n/a (SBP admits none)' if ratio is None else f'{ratio:.3f}'}"
              " (paper, 2080 Ti: 2.026)")
        summary = {"elastic_max_scale": lam["elastic"],
                   "sbp_max_scale": lam["sbp"], "elastic_over_sbp": ratio}
        plan_rates = {m: r * lam["elastic"] * PLAN_SHARE
                      for m, r in rates.items()}
        replay_rates = {m: r * lam["elastic"] * REPLAY_SHARE
                        for m, r in rates.items()}
    else:
        plan_rates = replay_rates = rates
    print_plan(plan(profiles, provider, plan_rates, args.gpus), provider,
               args.gpus)
    if not args.replay:
        return 0
    met, result = serve_end_to_end(profiles, provider, replay_rates,
                                   n_gpus=args.gpus,
                                   horizon_s=args.horizon_s, seed=args.seed)
    line = {"replay": replay_summary(met, result, replay_rates),
            "horizon_s": args.horizon_s, "seed": args.seed,
            "source": source, **summary}
    print(json.dumps(line))
    return 0 if line["replay"]["conserved"] and met.total > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
