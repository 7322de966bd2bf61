"""Guards on the port as a package: it imports neither JAX nor the JAX
package, its entry points default to the card, its kernel wrappers take
the plain path for CPU tensors without counting a launch, and
``chip_smoke.py`` refuses to report a result without a card."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"

torch.set_num_threads(2)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20      # every submodule imported


def test_port_sources_and_chip_smoke_name_no_jax_imports():
    files = list((SRC / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, m)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step
    arch = smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model.init(arch, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(arch, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke"])
    run = RunConfig(arch=smoke_config("bert-large"), zero1=False,
                    shape=ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(run)


def test_kernel_wrappers_take_plain_path_for_cpu_tensors():
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.fused_sampling import ops as filt_ops
    for counts in (attn_ops.LAUNCHES, filt_ops.LAUNCHES):
        for k in counts:
            counts[k] = 0
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(6, 4, 2, 8)).astype(np.float32))
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    out = attn_ops.paged_decode_attention(q, kp, kp, pt,
                                          torch.tensor([5, 3],
                                                       dtype=torch.int32))
    assert out.shape == q.shape and torch.isfinite(out).all()
    out = attn_ops.paged_prefill_attention(q, kp, kp, pt[0], 0, 2)
    assert out.shape == q.shape
    lg = torch.from_numpy(rng.normal(size=(2, 300)).astype(np.float32))
    out = filt_ops.filter_logits(lg, torch.tensor([5, 0], dtype=torch.int32),
                                 torch.tensor([1.0, 0.5]))
    assert torch.isinf(out[0]).sum() == 295
    tok = filt_ops.draw_tokens(out, torch.tensor([3, 4]),
                               torch.tensor([10, 11], dtype=torch.int32))
    assert tok.dtype == torch.int32 and torch.isfinite(out[0, tok[0]])
    assert set(attn_ops.LAUNCHES.values()) == {0}
    assert set(filt_ops.LAUNCHES.values()) == {0}


def test_kernel_sources_exist_for_the_build():
    from repro_torch.kernels import _build
    names = set(_build.sources())
    assert names == {"paged_attention", "sampling", "residual_norm",
                     "head_tokens", "residual_layernorm", "bias_gelu",
                     "fused_lamb", "gated_rmsnorm", "flash_attention",
                     "scale_mask_softmax"}
    assert _build.BUILD_DIR == REPO / "build" / "repro_torch"
    for src in _build.sources().values():
        text = src.read_text()
        assert "src/repro/kernels/" in text       # names the TPU kernel
        assert "bound" in text.lower()


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    runs = [subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                           cwd=REPO, env=_env(), capture_output=True,
                           text=True, timeout=120)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               env=env, capture_output=True, text=True,
                               timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_every_port_module_has_a_docstring():
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if m.ispkg:
            continue
        mod = __import__(m.name, fromlist=["_"])
        assert (mod.__doc__ or "").strip(), m.name
