"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``) on its
continuous engine: ``tests/test_sanitize.py``'s thirteen tests on the port
(llama smoke, fp32 weights converted from the JAX init), plus the JAX
engine's stream for the clean run and JAX's own message for the same seeded
fault in four cases. Every seeded violation must raise ``SanitizerError``
naming JAX's invariant."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as jax_sanitize
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_cache import PageAllocator as JaxPageAllocator
from repro_torch import tree
from repro_torch.analysis.sanitize import (SanitizerError, check_allocator,
                                           check_engine, check_prefix,
                                           check_slots)
from repro_torch.configs import smoke_config
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import PageAllocator

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dense():
    """(port model, JAX model, JAX params) sharing one set of fp32
    weights."""
    arch = dataclasses.replace(jax_smoke_config("llama3.2-3b"),
                               dtype="float32", param_dtype="float32")
    model = build_model(arch)
    params = model.init(jax.random.key(0))
    t_arch = dataclasses.replace(smoke_config("llama3.2-3b"),
                                 dtype="float32")
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return t_model, model, params


def _requests(vocab, n=4, gen=5, seed=7):
    """JAX's trace: a shared 9-token prefix on even requests, greedy and
    sampled in turn."""
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(5, vocab, 9)))
    reqs = []
    for i in range(n):
        prompt = (shared + list(map(int, rng.integers(5, vocab, 3)))
                  if i % 2 == 0 else
                  list(map(int, rng.integers(5, vocab,
                                             int(rng.integers(4, 12))))))
        sp = SamplingParams() if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=10, seed=50 + i)
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=gen,
                            sampling=sp))
    return reqs


def _jax_requests(reqs):
    return [JaxRequest(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
            for r in reqs]


ENGINE = dict(num_slots=2, num_pages=24, page_size=4, max_seq_len=48)


def _engine(model, **kw):
    return ContinuousEngine(model, **dict(ENGINE, **kw))


def _jax_engine(dense, **kw):
    return JaxEngine(dense[1], dense[2], **dict(ENGINE, **kw))


def _vocab(dense):
    return dense[0].arch.vocab_size


# ----------------------------------------------------------- do no harm -----

def test_sanitize_clean_run_is_token_identical(dense):
    model = dense[0]
    reqs = _requests(_vocab(dense))
    plain = _engine(model).run(_requests(_vocab(dense)))
    checked = _engine(model, sanitize=True).run(reqs)
    jax_res = _jax_engine(dense, sanitize=True).run(_jax_requests(reqs))
    for r in reqs:
        assert checked[r.uid]["tokens"] == plain[r.uid]["tokens"]
        assert checked[r.uid]["tokens"] == jax_res[r.uid]["tokens"]
        assert len(checked[r.uid]["tokens"]) == 5


def test_sanitize_env_opt_in(dense, monkeypatch):
    model = dense[0]
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert _engine(model).sanitize
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not _engine(model).sanitize
    # an explicit argument beats the environment
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert not _engine(model, sanitize=False).sanitize


# ---------------------------------------------------- injected violations ---

def _leaky(engine):
    """A free() that silently drops one hold: the classic leak."""
    allocator = engine.scheduler.allocator
    orig_free = allocator.free
    leaked = []

    def leaky_free(pages):
        if pages and not leaked:
            leaked.append(pages[0])     # this page's hold is never dropped
            pages = pages[1:]
        orig_free(pages)
    allocator.free = leaky_free
    return leaked


def _desync(engine):
    """A finish() that forgets to return the slot to the free list."""
    sched = engine.scheduler
    orig_finish = sched.finish
    broken = []

    def bad_finish(seq):
        orig_finish(seq)
        if not broken:
            broken.append(sched._free_slots.pop())   # lose the slot
    sched.finish = bad_finish
    return broken


def test_injected_refcount_leak_detected(dense):
    eng = _engine(dense[0], sanitize=True)
    leaked = _leaky(eng)
    with pytest.raises(SanitizerError, match="refcount|conservation"):
        eng.run(_requests(_vocab(dense)))
    assert leaked


def test_injected_slot_desync_detected(dense):
    eng = _engine(dense[0], sanitize=True)
    broken = _desync(eng)
    with pytest.raises(SanitizerError, match="neither running nor free"):
        eng.run(_requests(_vocab(dense)))
    assert broken


def _nan_model(model):
    return Model(model.arch, tree.map(
        lambda t: t * float("nan") if t.is_floating_point() else t,
        model.params))


def test_injected_nan_params_detected(dense):
    """NaN weights make NaN logits: the finite probe must trip on the first
    final prefill chunk; without the sanitizer the engine serves them
    silently."""
    nan_model = _nan_model(dense[0])
    reqs = _requests(_vocab(dense), n=2)
    silent = _engine(nan_model).run([
        Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        for r in reqs])
    assert all(len(r["tokens"]) > 0 for r in silent.values())  # no error!
    with pytest.raises(SanitizerError, match="finite"):
        _engine(nan_model, sanitize=True).run(reqs)


# ----------------------------------------------------- per-invariant units --

def test_allocator_conservation_leaked_page():
    a = PageAllocator(8)
    pages = a.alloc(3)
    check_allocator(a)
    del a._refs[pages[1]]               # page now in neither free nor refs
    with pytest.raises(SanitizerError, match="leak"):
        check_allocator(a)


def test_allocator_conservation_double_tracking():
    a = PageAllocator(8)
    pages = a.alloc(2)
    a._free.append(pages[0])            # free while still refcounted
    with pytest.raises(SanitizerError, match="both free and refcounted"):
        check_allocator(a)


def test_allocator_conservation_duplicate_free():
    a = PageAllocator(8)
    a._free.append(a._free[0])
    with pytest.raises(SanitizerError, match="duplicate"):
        check_allocator(a)


def test_refcount_accounting_detects_unbacked_ref(dense):
    eng = _engine(dense[0], sanitize=True)
    res = eng.run(_requests(_vocab(dense), n=2))
    assert len(res) == 2
    check_engine(eng)                   # clean after a full trace
    page = eng.scheduler.allocator.alloc(1)[0]   # ref'd, no visible holder
    with pytest.raises(SanitizerError, match="no visible holder"):
        check_engine(eng)
    eng.scheduler.allocator.free([page])
    check_engine(eng)


def test_slot_consistency_free_slot_with_pages(dense):
    eng = _engine(dense[0])
    eng.run(_requests(_vocab(dense), n=2))
    slot = eng.scheduler._free_slots[0]
    eng.scheduler.cache.seq_lens[slot] = 3
    with pytest.raises(SanitizerError, match="seq_len"):
        check_slots(eng)


def test_slot_consistency_seq_len_drift(dense):
    """A seq_len that disagrees with the sequence's lifecycle stage."""
    eng = _engine(dense[0])
    caught = []
    orig = eng.scheduler.finish

    def tamper(seq):
        other = [s for s in eng.scheduler.running if s != seq.slot]
        if not caught and other:
            eng.scheduler.cache.seq_lens[other[0]] += 2
            with pytest.raises(SanitizerError, match="seq_len"):
                check_slots(eng)
            eng.scheduler.cache.seq_lens[other[0]] -= 2
            caught.append(other[0])
        orig(seq)

    eng.scheduler.finish = tamper
    eng.run(_requests(_vocab(dense)))
    assert caught


def test_prefix_holds_drift_detected(dense):
    eng = _engine(dense[0])
    eng.run(_requests(_vocab(dense)))
    prefix = eng.scheduler.prefix
    assert prefix is not None and prefix._holds, "trace cached nothing"
    check_prefix(prefix, eng.scheduler.allocator)
    page = next(iter(prefix._holds))
    prefix._holds[page] += 1            # incremental map drifts from entries
    with pytest.raises(SanitizerError, match="drifted"):
        check_prefix(prefix, eng.scheduler.allocator)


def test_prefix_children_drift_detected(dense):
    eng = _engine(dense[0])
    eng.run(_requests(_vocab(dense)))
    prefix = eng.scheduler.prefix
    assert prefix._full, "trace cached no full pages"
    entry = next(iter(prefix._full.values()))
    entry.children += 1
    with pytest.raises(SanitizerError, match="children"):
        check_prefix(prefix, eng.scheduler.allocator)


# ------------------------------------------- the same fault, JAX's message --

def _message(fn, error):
    with pytest.raises(error) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("fault", ["refcount_leak", "slot_desync",
                                   "nan_params", "leaked_page"])
def test_message_equals_jax_for_the_same_fault(dense, fault):
    """The port's SanitizerError text equals JAX's, word for word, for one
    seeded fault on each side (the same trace, so the same pages, slots and
    requests)."""
    reqs = _requests(_vocab(dense))
    if fault == "leaked_page":
        def run(allocator_cls):
            a = allocator_cls(8)
            pages = a.alloc(3)
            del a._refs[pages[1]]
            module = check_allocator if allocator_cls is PageAllocator \
                else jax_sanitize.check_allocator
            module(a)
        port = lambda: run(PageAllocator)               # noqa: E731
        ref = lambda: run(JaxPageAllocator)             # noqa: E731
    else:
        inject = {"refcount_leak": _leaky, "slot_desync": _desync,
                  "nan_params": lambda eng: None}[fault]
        model = _nan_model(dense[0]) if fault == "nan_params" else dense[0]
        j_params = jax.tree.map(lambda a: (a * jnp.nan).astype(a.dtype),
                                dense[2]) if fault == "nan_params" \
            else dense[2]
        eng = _engine(model, sanitize=True)
        j_eng = JaxEngine(dense[1], j_params, sanitize=True, **ENGINE)
        inject(eng)
        inject(j_eng)
        port = lambda: eng.run(reqs)                    # noqa: E731
        ref = lambda: j_eng.run(_jax_requests(reqs))    # noqa: E731
    got = _message(port, SanitizerError)
    want = _message(ref, jax_sanitize.SanitizerError)
    assert got == want
    assert got.startswith("[sanitize:")
