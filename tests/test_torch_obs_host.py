"""The port's host spans (``repro_torch.obs.host``) on the CPU: what a
profiled step records, and that nothing records without a profiler."""
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs import host  # noqa: E402

B, S = 2, 9
MIXER = {"attn_mlp": "attention", "attn": "attention", "moe": "attention",
         "ssm": "ssm", "rglru": "rglru", "mamba2": "ssm"}
FEED = {"attn_mlp": "mlp", "attn": "mlp", "moe": "moe", "rglru": "mlp",
        "mamba2": "moe"}
# the parts inside the MoE layer, and inside the upstream Mamba-2 mixer
# over a sequence (its decode step has none)
MOE_PARTS = ["route", "dispatch", "experts", "combine", "shared"]
MAMBA2_PARTS = ["conv", "ssd_scan", "gated_norm"]


def _model(arch):
    cfg = get_smoke_config(arch)
    return Model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))


def _prompt(model):
    return torch.randint(0, model.cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))


@torch.inference_mode()
def _prefill(model, tokens):
    cache = model.init_cache(B, S + 2)
    return model.prefill(tokens, cache)


@torch.inference_mode()
def _entry(model):
    """The served entry: an encoder's forward, else a prefill then one
    decode step."""
    if not model.cfg.has_decoder:
        frames = frontend.audio_frame_embeddings(
            torch.Generator().manual_seed(2), B, S, model.cfg, device="cpu",
            dtype=model.dtype)
        model.forward(frame_embeds=frames)
        return
    logits, cache = _prefill(model, _prompt(model))
    model.decode_step(cache, logits.argmax(-1))


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*args)
    return host.spans()


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def _block_children(kind):
    names = ["norm", MIXER[kind]]
    if kind != "ssm":
        names += ["norm", FEED[kind]]
    return names


def _attention_children(decode, cached, rope=True):
    if decode:
        names = ["rope", "ring_write", "decode_attention"]
    else:
        names = ["rope", "flash"] + (["ring_write"] if cached else [])
    return names if rope else names[1:]


def _inner(name, kind, decode, cfg):
    """The spans a block's part holds."""
    if name == "attention":
        return _attention_children(decode, cfg.has_decoder,
                                   cfg.position_embedding == "rope")
    if name == "moe":
        return MOE_PARTS
    if name == "ssm" and kind == "mamba2" and not decode:
        return MAMBA2_PARTS
    return []


@pytest.mark.parametrize("arch", ["yi-9b", "hubert-xlarge",
                                  "deepseek-moe-16b", "mamba2-780m",
                                  "recurrentgemma-2b",
                                  "granite-4.0-h-small"])
def test_a_profiled_step_records_its_tree(arch):
    model = _model(arch)
    _entry(model)  # the profiler off: a new session below
    spans = _profiled(_entry, model)
    me = threading.current_thread().name
    assert {s.thread for s in spans} == {me}
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    steps = [i for i in roots if spans[i].name == "step"]
    decoder = model.cfg.has_decoder
    assert [spans[i].name for i in roots] == (
        ["init_cache", "step", "step"] if decoder else ["step"])
    assert [spans[i].args for i in steps] == (
        [("prefill", B, S, 0), ("decode", B, S + 1, 1)] if decoder
        else [("forward", B, S, 0)])
    kinds = model.cfg.layer_types()
    for serial, i in enumerate(steps):
        decode = serial == 1
        kids = _children(spans, i)
        assert [spans[j].name for j in kids] == \
            ["embed"] + ["block"] * len(kinds) + ["head"]
        blocks = kids[1:-1]
        assert [spans[j].args for j in blocks] == list(enumerate(kinds))
        for j, kind in zip(blocks, kinds):
            inner = _children(spans, j)
            assert [spans[k].name for k in inner] == \
                _block_children(kind)
            for k in inner:
                assert [spans[m].name for m in _children(spans, k)] == \
                    _inner(spans[k].name, kind, decode, model.cfg)
    # every span inside its parent, siblings one after another
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end and s.parent < i
    for i in [None] + list(range(len(spans))):
        sib = [spans[j] for j in range(len(spans)) if spans[j].parent == i]
        assert all(a.end <= b.start for a, b in zip(sib, sib[1:]))


def test_nothing_records_without_a_profiler():
    model = _model("yi-9b")
    _prefill(model, _prompt(model))  # off: a new session below
    before = _profiled(_prefill, model, _prompt(model))
    assert [s.name for s in before if s.parent is None] == \
        ["init_cache", "step"]
    _entry(model)
    assert host.spans() == before
    # a span outside any recorded step records nothing
    assert host.open("norm") is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert host.open("norm") is False
    assert host.spans() == before


def test_a_second_profiler_session_replaces_the_first():
    yi, hubert = _model("yi-9b"), _model("hubert-xlarge")
    _prefill(yi, _prompt(yi))
    first = _profiled(_entry, yi)
    assert any(s.args[:1] == ("decode",) for s in first)
    _prefill(yi, _prompt(yi))  # off
    second = _profiled(_entry, hubert)
    assert [s.args for s in second if s.name == "step"] == \
        [("forward", B, S, 0)]
    assert host.spans() == second


def test_two_threads_keep_separate_trees():
    model = _model("yi-9b")
    tokens = _prompt(model)
    _prefill(model, tokens)  # off: a new session below
    errors = []

    def loop():
        try:
            for _ in range(3):
                _prefill(model, tokens)
        except Exception as e:  # re-raised below
            errors.append(e)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=loop, name=n) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = host.spans()
    n_layers = model.cfg.n_layers
    for name in "ab":
        mine = [i for i, s in enumerate(spans) if s.thread == name]
        steps = [i for i in mine if spans[i].name == "step"]
        assert [spans[i].args[3] for i in steps] == [0, 1, 2]
        for i in steps:
            assert sum(spans[j].name == "block"
                       for j in _children(spans, i)) == n_layers
        # every parent on the span's own thread
        assert all(spans[spans[i].parent].thread == name for i in mine
                   if spans[i].parent is not None)
    assert len(spans) == sum(1 for s in spans if s.thread in "ab")


def test_profile_windows_report_host_spans():
    from repro_torch.serving import profile as prof
    reps = prof.run("yi-9b", batch=2, prompt_len=9, steps=2, seed=0,
                    device="cpu", smoke=True, trace_dir=None)
    assert [r["window"] for r in reps] == ["prefill", "decode"]
    n_layers = get_smoke_config("yi-9b").n_layers
    for r, steps in zip(reps, (1, 2)):
        spans = r["host_spans"]
        assert {"step", "block", "rope", "ring_write"} <= set(spans)
        assert spans["step"]["count"] == steps
        assert spans["block"]["count"] == steps * n_layers
        assert spans["rope"]["count"] == steps * n_layers
        for v in spans.values():
            assert v["self_ms_per_step"] >= 0
        # the step's self time is its own: less than its whole length
        assert spans["step"]["self_ms_per_step"] < r["wall_ms_per_step"]
    assert "init_cache" in reps[0]["host_spans"]
    assert "flash" in reps[0]["host_spans"]
    assert "decode_attention" in reps[1]["host_spans"]
