"""The port stands alone: importing it (or chip_smoke.py) loads neither JAX
nor the JAX package, and its entry points need the card unless asked for
the CPU."""

import os
import subprocess
import sys

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import pyramidkv_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
new = set(sys.modules) - before
bad = sorted(n for n in new if n == "jax" or n.startswith("jax.")
             or n == "pyramidkv_tpu" or n.startswith("pyramidkv_tpu."))
assert not bad, bad
assert "pyramidkv_tpu_torch.engine" in new
# the trained checkpoint's tokenizer, needle helpers and loader too
for m in ("train", "train.tokenizer", "train.data", "train.checkpoint"):
    assert "pyramidkv_tpu_torch." + m in new, m
print("ok")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_engine_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from pyramidkv_tpu_torch.config import (CompressionSpec, EngineSpec,
                                            ModelSpec)
    from pyramidkv_tpu_torch.engine import Engine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(ModelSpec.tiny(), CompressionSpec(), EngineSpec(), {})


def test_trained_loader_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from pyramidkv_tpu_torch.train import load_checkpoint

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint()
    spec, params = load_checkpoint(device="cpu")
    assert spec.head_dim == 32 and params["embed"].device.type == "cpu"
