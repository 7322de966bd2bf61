"""The port's sampler switch and ``--decode-steps`` on the launcher
(``repro_torch.launch.serve``), on the CPU at smoke size: ``--sampler`` and
``REPRO_FUSED_SAMPLING`` pick the top-k / top-p filter in both engines,
``run_static`` included, with the same streams either way; ``--decode-steps
N`` serves the streams of N=1 and prints its dispatch line; the engine takes
``decode_steps``, ``sanitize`` and ``fused_sampling`` as JAX's does."""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.fused_sampling import ops as fused_ops
from repro_torch.kernels.fused_sampling import ref as fused_ref
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine
from repro_torch.serving.sampling import fused_sampling_enabled

torch.set_num_threads(2)

SAMPLED = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
           "12", "--gen-len", "6", "--temperature", "0.8", "--top-k", "20",
           "--top-p", "0.9"]


@pytest.fixture
def filters(monkeypatch):
    """Count the calls of the two filters the sampler can take."""
    calls = {"fused": 0, "ref": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(fused_ops, "filter_logits",
                        counted("fused", fused_ops.filter_logits))
    monkeypatch.setattr(fused_ref, "filter_logits_ref",
                        counted("ref", fused_ref.filter_logits_ref))
    return calls


def test_fused_sampling_enabled_follows_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_FUSED_SAMPLING", raising=False)
    assert fused_sampling_enabled()
    for value, want in (("0", False), ("", False), ("1", True)):
        monkeypatch.setenv("REPRO_FUSED_SAMPLING", value)
        assert fused_sampling_enabled() is want


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_sampler_switch_picks_the_filter_with_the_same_streams(
        engine, filters, monkeypatch):
    """The kernel's filter by default; the sort-based oracle under
    ``REPRO_FUSED_SAMPLING=0`` or ``--sampler ref``; ``--sampler fused``
    beats the environment. Every run emits the same tokens. (Fused decode
    selects in the head's own epilogue, so the continuous engine is run
    unfused here.)"""
    argv = SAMPLED + ["--engine", engine]
    if engine == "continuous":
        argv.append("--no-fused-decode")
    monkeypatch.delenv("REPRO_FUSED_SAMPLING", raising=False)
    runs = {}
    for name, env, flag, want in (
            ("default", None, [], "fused"),
            ("env 0", "0", [], "ref"),
            ("--sampler ref", None, ["--sampler", "ref"], "ref"),
            ("--sampler fused over env 0", "0", ["--sampler", "fused"],
             "fused")):
        if env is None:
            monkeypatch.delenv("REPRO_FUSED_SAMPLING", raising=False)
        else:
            monkeypatch.setenv("REPRO_FUSED_SAMPLING", env)
        before = dict(filters)
        runs[name] = serve.main(argv + flag)["tokens"]
        other = "ref" if want == "fused" else "fused"
        assert filters[want] > before[want], name
        assert filters[other] == before[other], name
    ref = runs["default"]
    for name, toks in runs.items():
        np.testing.assert_array_equal(toks, ref, err_msg=name)


def test_decode_steps_flag_serves_the_n1_streams(capsys):
    base = SAMPLED + ["--engine", "continuous", "--gen-len", "9"]
    one = serve.main(base)
    capsys.readouterr()
    four = serve.main(base + ["--decode-steps", "4"])
    out = capsys.readouterr().out
    np.testing.assert_array_equal(four["tokens"], one["tokens"])
    assert one["decode_dispatches"] == one["steps"]
    assert four["decode_dispatches"] < four["steps"]
    assert (f"decode-steps=4: {four['decode_dispatches']} host dispatches "
            f"for {four['steps']} decode steps") in out
    assert "decode-steps=" not in out.split("decode-steps=4")[0]


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "static", "--decode-steps", "4"],
     "--decode-steps requires --engine continuous"),
    (["--engine", "continuous", "--decode-steps", "0"],
     "--decode-steps must be >= 1")])
def test_decode_steps_flag_is_refused_where_it_cannot_apply(argv, msg,
                                                            capsys):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err


@pytest.fixture(scope="module")
def model():
    return Model.init(smoke_config("llama3.2-3b"),
                      torch.Generator().manual_seed(0), device="cpu")


def test_engine_options_follow_jax(model, monkeypatch):
    """``sanitize`` and ``fused_sampling`` default to the environment and
    an argument beats it; ``decode_steps`` must be >= 1; tp is not
    ported."""
    kw = dict(num_slots=2, num_pages=8, page_size=4)
    monkeypatch.setenv("REPRO_FUSED_SAMPLING", "0")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    eng = ContinuousEngine(model, **kw)
    assert not eng.fused_sampling and eng.sanitize
    eng = ContinuousEngine(model, fused_sampling=True, sanitize=False,
                           decode_steps=16, **kw)
    assert eng.fused_sampling and not eng.sanitize
    assert eng.decode_steps == 16 and eng.trace_stats() == {
        "variants": 0, "traces": 0, "excess": 0}
    with pytest.raises(ValueError, match="decode_steps"):
        ContinuousEngine(model, decode_steps=0, **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousEngine(model, tp=2, decode_steps=4, sanitize=True, **kw)
