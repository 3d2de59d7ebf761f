"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, and its entry points never carry on quietly
on the CPU when no device was asked for and no CUDA device exists."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                       re.MULTILINE)


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    for mod in ("core/multipliers.py", "core/lowrank.py", "core/approx.py", "quant/affine.py",
                "kernels/_build.py", "kernels/approx_matmul/ops.py",
                "kernels/approx_matmul/ref.py", "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py", "configs/base.py", "configs/granite_3_2b.py",
                "models/layers.py", "models/attention.py", "models/transformer.py",
                "serve/engine.py", "serve/cache.py", "serve/scheduler.py", "bridge.py",
                "launch/serve.py", "core/logic.py", "kernels/approx_mul_eltwise/ops.py",
                "kernels/approx_mul_eltwise/ref.py", "quant/qat.py", "train/optim.py",
                "train/loop.py", "train/compression.py", "train/checkpoint.py",
                "train/fault.py", "train/tree.py", "data/synthetic.py", "launch/train.py",
                "configs/paper_cnns.py", "data/loader.py", "core/metrics.py", "core/hwcost.py",
                "models/cnn.py", "paper/table_v.py", "paper/table_vi_vii.py",
                "paper/table_viii.py", "paper/kernel_bench.py", "examples/quickstart.py",
                "examples/lenet_mnist_qat.py", "paper/ablation_removal.py",
                "examples/approx_qat_lm.py"):
        assert f"repro_torch/{mod}" in names, mod
    assert (ROOT / "chip_smoke.py").is_file()
    srcs = {p.name for p in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")}
    assert srcs == {"approx_matmul.cu", "paged_attention.cu", "approx_mul_eltwise.cu"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: imports JAX or the JAX package"


def test_scan_catches_what_it_should():
    for bad in ("import jax\n", "from jax import numpy\n", "import jax.numpy as jnp\n",
                "from repro.core import approx\n", "import repro\n", "  import repro.models\n"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch\n", "from repro_torch.core import approx\n", "# jax\n"):
        assert not FORBIDDEN.search(ok), ok


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.device import NoCudaDeviceError, resolve_device
    from repro_torch.launch import serve as launch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSession
    from repro_torch.train.loop import init_state, train_loop
    from repro_torch.train.optim import OptConfig

    _no_cuda(monkeypatch)
    cfg = reduced_config(get_config("granite-3-2b"))
    with pytest.raises(NoCudaDeviceError):
        resolve_device()
    with pytest.raises(NoCudaDeviceError):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(NoCudaDeviceError):
        ServeSession(cfg, params)
    with pytest.raises(NoCudaDeviceError):
        launch.main(["--reduced", "--requests", "1"])
    with pytest.raises(NoCudaDeviceError):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(NoCudaDeviceError):
        init_state(cfg, OptConfig())
    with pytest.raises(NoCudaDeviceError):
        train_loop(cfg, OptConfig(), iter(()), steps=1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_launcher_serves_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--reduced", "--device", "cpu", "--requests", "3", "--new", "4",
                           "--exec", "approx"])
    assert len(results) == 3
    assert all(1 <= len(r.tokens) <= 4 for r in results.values())
    out = capsys.readouterr().out
    assert "kernel launches: approx_matmul 0, paged_attention 0" in out


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import importlib.util

    _no_cuda(monkeypatch)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
    assert np.isfinite(mod.bound(1e9, 1e12, mod.INT8_OPS_PER_S)[0])
