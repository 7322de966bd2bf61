"""The port's checkpoint manager and the trainer's checkpoint/restart on
the CPU:

- JAX's four manager tests (``tests/test_checkpoint.py``) mirrored:
  round trip, keep-N garbage collection, asynchronous save, no partial
  checkpoint counted;
- bfloat16 leaves round-trip bitwise (stored as their uint16 bits);
- ``save_async`` has the state on the host before it returns: a state
  changed in place right after the call restores as it was;
- the file format is JAX's: a trainer state written by the port (llama
  smoke, bf16 params, fp32 master weights) reads back through JAX's
  ``CheckpointManager`` bitwise, with the leaf paths, shapes and dtypes
  of JAX's own trainer state; and a smoke run of JAX's launcher, stopped
  at step 2, resumes in the port's launcher with the losses of JAX's
  uninterrupted run (float32 on both sides without master weights, within
  1e-5 relative);
- a run of the port's launcher killed in its sixth step resumes from its
  newest checkpoint with losses bitwise those of an uninterrupted run;
- the launcher checkpoints stacks whose layers differ within a period
  (jamba, llama4) in JAX's layout at the arch's period, and resumes.
"""
import dataclasses
import json
import shutil
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.models.convert import load_state_, state_to_jax
from repro_torch.models.transformer import period_length
from repro_torch.train.steps import build_train_step

torch.set_num_threads(2)

ARGS = ["--arch", "llama3.2-3b", "--smoke", "--batch", "2", "--seq", "32"]


def _state(scale=1.0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) * scale,
                       "b": torch.ones(4) * scale},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(10, _state(), extra={"data_step": 10})
    out = mgr.restore()
    assert out["step"] == 10 and out["extra"]["data_step"] == 10
    assert torch.equal(out["state"]["params"]["w"], _state()["params"]["w"])
    assert out["state"]["opt"]["step"].dtype == torch.int32


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    steps = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(steps) == 2 and steps[-1].endswith("4".zfill(10))


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(5, _state())
    mgr.wait()
    assert mgr.latest_step() == 5


def test_no_partial_checkpoints(tmp_path):
    """tmp dirs never count as checkpoints (atomic rename commit)."""
    mgr = CheckpointManager(tmp_path)
    (Path(tmp_path) / "tmp.99").mkdir()
    assert mgr.latest_step() is None


def test_bf16_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 5, generator=g).bfloat16()
    x[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40]).bfloat16()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": {"x": x}})
    meta = json.loads((tmp_path / "step_0000000001" / "manifest.json")
                      .read_text())
    assert meta["leaves"]["a/x"] == {"dtype": "bfloat16", "shape": [37, 5]}
    got = mgr.restore()["state"]["a"]["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_save_async_snapshots_before_it_returns(tmp_path):
    state = _state()
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, state)
    state["params"]["w"].add_(100.0)       # the next step, in place
    state["opt"]["step"].add_(1)
    mgr.wait()
    out = mgr.restore()["state"]
    assert torch.equal(out["params"]["w"], _state()["params"]["w"])
    assert int(out["opt"]["step"]) == 7


def _port_state():
    arch = smoke_config("llama3.2-3b")
    run = RunConfig(arch=arch, shape=ShapeConfig("t", 32, 2, "train"),
                    zero1=False)
    return arch, build_train_step(run, device="cpu").init(0)


def test_port_checkpoint_reads_in_jax_as_jax_state(tmp_path):
    """The port writes a bf16 llama smoke state; JAX's manager reads every
    leaf bitwise, and the tree has JAX's trainer state's paths, shapes and
    dtypes (``repro.train.steps`` init of the same config)."""
    arch, state = _port_state()
    CheckpointManager(tmp_path).save(
        4, state_to_jax(state, period_length(arch)), extra={"data_step": 4})
    got = JaxManager(tmp_path).restore()
    assert got["step"] == 4 and got["extra"] == {"data_step": 4}
    want = state_to_jax(state)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got["state"]))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t, want)))
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        g = flat_g[path]
        if w.dtype == torch.bfloat16:
            assert g.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                g.view(np.uint16), w.view(torch.int16).numpy().view(
                    np.uint16))
        else:
            np.testing.assert_array_equal(g, w.numpy())
    from repro.configs import smoke_config as jax_smoke
    jrun = JaxRunConfig(arch=jax_smoke("llama3.2-3b"), shape=JaxShapeConfig(
        "t", seq_len=32, global_batch=2, kind="train"), zero1=False)
    shapes = jax.eval_shape(jax_build_train_step(jrun).init, 0)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(shapes))
    assert flat_j.keys() == flat_g.keys()
    for path, s in flat_j.items():
        assert (s.shape, str(s.dtype)) == (flat_g[path].shape,
                                           str(flat_g[path].dtype)), path


@pytest.mark.parametrize("arch_id", ["jamba-v0.1-52b",
                                     "llama4-maverick-400b-a17b"])
def test_launcher_checkpoints_a_stack_of_mixed_layers(arch_id, tmp_path,
                                                      capsys):
    """A stack whose layers differ within a period (jamba's attention,
    mamba and MoE layers; llama4's dense and MoE layers) checkpoints
    through the launcher in JAX's layout at the arch's period: JAX's
    manager reads the paths, shapes and dtypes of JAX's own trainer state,
    and the launcher resumes from it."""
    import repro_torch.launch.train as port_train
    argv = ["--arch", arch_id, "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    port_train.main(argv + ["--steps", "2"])
    got = JaxManager(tmp_path).restore()
    assert got["step"] == 2
    from repro.configs import smoke_config as jax_smoke
    jrun = JaxRunConfig(arch=jax_smoke(arch_id), shape=JaxShapeConfig(
        "t", seq_len=16, global_batch=2, kind="train"), zero1=False)
    shapes = jax.eval_shape(jax_build_train_step(jrun).init, 0)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(shapes))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got["state"]))
    assert flat_j.keys() == flat_g.keys()
    for path, s in flat_j.items():
        assert (s.shape, str(s.dtype)) == (flat_g[path].shape,
                                           str(flat_g[path].dtype)), path
    capsys.readouterr()
    out = port_train.main(argv + ["--steps", "3"])["history"]
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in out] == [2]


def _fp32(module, monkeypatch):
    """Make ``module``'s launcher build float32 smoke configs."""
    real = module.smoke_config
    monkeypatch.setattr(module, "smoke_config", lambda n: dataclasses.replace(
        real(n), dtype="float32", param_dtype="float32"))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, capsys):
    """JAX's launcher trains 4 steps (a checkpoint at step 2); the step-4
    checkpoint is removed, as if JAX's run had died after step 2, and the
    port's launcher resumes from step 2 with the losses of JAX's steps 3
    and 4."""
    import repro.launch.train as jax_train
    import repro_torch.launch.train as port_train
    _fp32(jax_train, monkeypatch)
    _fp32(port_train, monkeypatch)
    # float32 without a master copy: with one, JAX's init aliases the
    # float32 params to the master weights and its donated step refuses
    # the same buffer twice
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--no-master-weights"]
    want = jax_train.main(ARGS + ["--steps", "4"] + ckpt)["history"]
    assert JaxManager(tmp_path).latest_step() == 4
    shutil.rmtree(tmp_path / "step_0000000004")
    got = port_train.main(ARGS + ["--steps", "4", "--device", "cpu"]
                          + ckpt)["history"]
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in got] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want[2:]], rtol=1e-5)


class _Killed(Exception):
    pass


def test_kill_and_resume_gives_the_uninterrupted_losses(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """The launcher killed as it starts step 6 (index 5, after the
    asynchronous saves at 2 and 4, whose write is let finish: in a process
    that dies it may not, and the restart would take step 2's) restarts
    from its newest complete checkpoint; every loss from there on is
    bitwise the uninterrupted run's."""
    import repro_torch.launch.train as port_train
    argv = ARGS + ["--steps", "6", "--device", "cpu"]
    full = port_train.main(argv)["history"]
    real = port_train.train_loop
    managers = []

    class Recorded(CheckpointManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            managers.append(self)
    monkeypatch.setattr(port_train, "CheckpointManager", Recorded)

    def dying(step_fn, state, data, cfg, start_step=0, **kw):
        def step(st, batch, n=[start_step]):
            if n[0] == 5:
                raise _Killed
            n[0] += 1
            return step_fn(st, batch)
        return real(step, state, data, cfg, start_step=start_step, **kw)
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    monkeypatch.setattr(port_train, "train_loop", dying)
    with pytest.raises(_Killed):
        port_train.main(argv + ckpt)
    managers[0].wait()
    monkeypatch.setattr(port_train, "train_loop", real)
    capsys.readouterr()
    got = port_train.main(argv + ckpt)["history"]
    assert "resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in got] == [4, 5]
    assert [h["loss"] for h in got] == [h["loss"] for h in full[4:]]


def test_restore_copies_into_the_state_tensors():
    """``load_state_`` keeps every tensor's address (a captured step stays
    valid) and refuses a leaf of another shape or dtype."""
    _, state = _port_state()
    ptrs = [t.data_ptr() for t in jax.tree.leaves(state)]
    tree = state_to_jax(state)
    tree["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    load_state_(state, tree)
    assert [t.data_ptr() for t in jax.tree.leaves(state)] == ptrs
    assert int(state["opt"]["step"]) == 5
    tree["opt"]["step"] = torch.tensor(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        load_state_(state, tree)
