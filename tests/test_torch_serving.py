"""The port's serving entry point on the CPU, and its freedom from JAX."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.serving import executor  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_executor_answers_every_request_deterministically():
    kw = dict(requests=5, batch=2, prompt_lens=(6, 9), output_len=4, seed=7,
              device="cpu", smoke=True)
    first = executor.serve("yi-9b", **kw)
    second = executor.serve("yi-9b", **kw)
    vocab = 1024  # the smoke config's vocab_size
    assert [r.rid for r in first.results] == list(range(5))
    for r in first.results:
        assert len(r.tokens) == 4
        assert all(0 <= t < vocab for t in r.tokens)
        assert r.ttft_ms > 0 and r.decode_ms_per_token > 0
    assert first.all_finite
    # prompt lengths 6, 9, 6, 9, 6 in batches of <= 2 of equal length
    assert first.prefill_batches == 3 and first.decode_steps == 3 * 3
    assert [r.tokens for r in first.results] == \
        [r.tokens for r in second.results]


def test_batches_group_equal_prompt_lengths():
    reqs = executor.make_requests(7, (3, 5, 3), 2, 100, seed=0)
    batches = executor.make_batches(reqs, 2)
    assert sorted(r.rid for b in batches for r in b) == list(range(7))
    for b in batches:
        assert 1 <= len(b) <= 2
        assert len({len(r.prompt) for r in b}) == 1
    assert [len(b) for b in batches] == [2, 2, 1, 2]


def test_executor_cli_runs_without_jax_or_the_jax_package():
    """The executor, run in a fresh interpreter, loads no ``jax`` module and
    no ``repro`` / ``repro.*`` module (``repro_torch`` shares the prefix)."""
    code = (
        "import sys\n"
        "from repro_torch.serving import executor\n"
        "executor.main(['--smoke', '--device', 'cpu', '--requests', '2',\n"
        "               '--batch', '2', '--prompt-lens', '5',\n"
        "               '--output-len', '3'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 2 and summary["device"] == "cpu"


def test_profile_windows_on_the_cpu_report_no_device_numbers():
    from repro_torch.serving import profile
    reps = profile.run("yi-9b", batch=2, prompt_len=9, steps=2, seed=0,
                       device="cpu", smoke=True, trace_dir=None)
    assert [r["window"] for r in reps] == ["prefill", "decode"]
    for r in reps:
        assert r["wall_ms_per_step"] > 0 and r["device"] == "cpu"
        assert r["device_busy_ms_per_step"] == "not measured"
    # the device busy time is the union of the kernels' intervals
    assert profile._busy_us([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        executor.serve("yi-9b", requests=1, prompt_lens=(4,), output_len=2,
                       smoke=True)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the smoke exits nonzero and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == ""


IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_import_no_jax_and_no_jax_package():
    files = [ROOT / "chip_smoke.py", *(ROOT / "src" / "repro_torch").rglob(
        "*.py")]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT.search(f.read_text())]
    assert not offenders
