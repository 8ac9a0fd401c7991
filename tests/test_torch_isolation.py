"""The port stands alone: no JAX, nothing of ``repro``, no CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import models
from repro_torch.cluster import launch_mp
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import train_adloco
from repro_torch.data import MarkovTokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_no_file_imports_jax_or_repro():
    bad = [(str(p.relative_to(ROOT)), m) for p in _port_files()
           for m in _imported(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_every_module_loads_no_jax():
    names = list(_module_names())
    for name in ("repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.mamba_scan.ops",
                 "repro_torch.kernels.mamba_scan.kernel",
                 "repro_torch.core.adloco",
                 "repro_torch.kernels.gradstats.ops",
                 "repro_torch.launch.train"):
        assert name in names
    code = ("import importlib, sys\n"
            f"for m in {names!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] "
            f"in {FORBIDDEN!r}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_module_imports_alone_in_a_fresh_module_state():
    """Each module imports first, with no other module of the port
    loaded: an import cycle that only shows in one import order (ROADMAP
    3.6) fails here.  One subprocess; only ``torch`` stays loaded."""
    names = list(_module_names())
    code = ("import importlib, sys, traceback\n"
            "import torch\n"
            "bad = []\n"
            f"for m in {names!r}:\n"
            "    for k in [k for k in sys.modules\n"
            "              if k.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[k]\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except Exception:\n"
            "        bad.append((m, traceback.format_exc(limit=1)))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("microllama-300m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_paged_cache(cfg, 2, 4, 4)
    assert models.init_params(cfg, device="cpu").device.type == "cpu"
    ssm = reduced(get_config("falcon-mamba-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_params(ssm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_paged_cache(ssm, 2, 4, 4)
    # training: the loop, the data streams and the launcher
    params = lm.param_dict(models.init_params(cfg, device="cpu"))
    acfg = AdLoCoConfig(num_init_trainers=1, nodes_per_gpu=1,
                        num_outer_steps=1, num_inner_steps=1)
    streams = [MarkovTokenStream(cfg.vocab_size, 8, device="cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_adloco(lambda p, b: models.loss_fn(p, b, cfg), [params],
                     streams, acfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MarkovTokenStream(cfg.vocab_size, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main([])
    # the multi-process launcher raises before it spawns a process
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_mp.main(["--procs", "2", "--rounds", "1"])
