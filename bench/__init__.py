"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints one
JSON line.  Everything a cell is made of is found by name:

  * ``configs/<config>.json``: the models as they are run (the port's
    ``ModelConfig`` fields), the gpu-let percent of each side, and the
    limit of the output check; a model's ``reference`` names its plain
    reference module (``reference/model.py`` where it names none), which
    also says which leaves its weights have and how each is drawn;
  * ``traffic/<traffic>.json``: one stream of requests a model (rate,
    lengths and their weights, batch cap, SLO), read by the one generator
    in ``traffic.py``;
  * ``metrics/<metric>.py``: one reader a metric, ``read(run)``, which
    returns a number or None when the run holds nothing to read.

The yardstick lives here and nowhere in the program: the arrival
generator, the serving loop, the weights and inputs made from the seed,
the FLOP and byte formulas and the peaks, the reduction of the profiler's
trace, and a plain float32 reference of every model family
(``reference/``; its interface in ``reference/__init__.py``).
Nothing under ``bench/`` imports ``jax`` or the JAX package, and the
reference imports nothing of the port.
"""
