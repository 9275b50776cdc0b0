"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number the output check compared, beside its limit, as the
last lines of standard error also give them.  Exits non-zero and prints
no result without a CUDA card (or fewer than the cell asks for), outside
a checkout that holds the port, or if JAX or the JAX package got loaded.

Build and kernel caches stay inside the checkout: the port builds its
kernels into ``src/repro_torch/_build/``; PyTorch's extension and Triton
caches are pointed at ``bench/.cache/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    cache = ROOT / "bench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def fail(msg: str, code: int = 2):
    print(f"bench/run.py: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no port at {ROOT / 'src' / 'repro_torch'}: run from a "
             "checkout of the repository")
    _environment()
    from bench import cell as cell_mod
    from bench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
    torch.zeros(1, device="cuda")  # the card's context, counted with it
    try:
        out = cell_mod.run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START)
    except ImportError as e:
        fail(str(e), 3)
    for name, v in out["check"].items():
        bound = "at least" if name.startswith("sampled_") else "at most"
        print(f"check {name}: {v['value']} ({bound} {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
