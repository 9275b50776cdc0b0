"""A training step leaves nothing that only reference cycles hold.

The first call of ``torch.utils.checkpoint.checkpoint`` imports
``torch._dynamo``.  Done on the step's stack, that import's garbage cycles
reach the step's frames, which keep the blocks' activations and the logits
alive until Python's collector runs; ``models/transformer.py`` imports it
before any step.  The pytest process has imported it already, so each case
runs in a fresh interpreter.  The dry run's train records must not move
with the collector either (``launch/dryrun.py::_FlopsOutsideKernels``).
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST_STEP = """
import gc, json, sys
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import token_batches
from repro_torch.models.model import Model
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train import make_train_step

def cyclic_tensors():
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    found = [list(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    gc.set_debug(0)
    gc.garbage.clear()
    gc.collect()
    return found

cfg = get_smoke_config(sys.argv[1])
model = Model(cfg, dtype=torch.float32, device="cpu").init(
    torch.Generator().manual_seed(0))
step = make_train_step(model, OptimConfig())
batch = next(token_batches(cfg.vocab_size, 2, 64, 1))
gc.collect()
gc.disable()
n_modules = len(sys.modules)
step(batch)
imported = len(sys.modules) - n_modules
after_step = cyclic_tensors()
# the probe sees a tensor that only a cycle holds
loop = [torch.zeros(3)]
loop.append(loop)
del loop
print(json.dumps({"imported": imported, "after_step": after_step,
                  "planted": cyclic_tensors()}))
"""

DRY_RUN = """
import gc, json
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models.model import Model

cfg = get_smoke_config("yi-9b")
model = Model(cfg, dtype=torch.float32, device="meta")
kind, args = specs.step_specs(cfg, "train", 2, 64, model=model)
step, arguments = dryrun.build_step(model, kind, args, 64)
peaks = []
for collect in (False, True, False, True):
    if collect:  # a young-generation collection at every allocation
        gc.enable()
        gc.set_threshold(1, 1, 1)
    else:
        gc.disable()
    peaks.append(dryrun.trace(step, arguments)["memory"]["peak_bytes"])
print(json.dumps(peaks))
"""


def fresh(code: str, *args: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_first_train_step_leaves_no_tensor_in_cyclic_garbage(arch):
    """A fresh process's first ``make_train_step`` step, the collector
    off: afterwards no tensor is garbage that only a cycle holds, and the
    step imported no module."""
    rec = fresh(FIRST_STEP, arch)
    assert rec["after_step"] == []
    assert rec["imported"] == 0
    assert rec["planted"] == [[3]]


def test_dry_run_train_peak_does_not_move_with_the_collector():
    """The dry run's train record of a fresh process: the same peak with
    the collector off and with it running at every allocation, the first
    step as the later ones."""
    peaks = fresh(DRY_RUN)
    assert len(set(peaks)) == 1, peaks
