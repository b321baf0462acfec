"""The port's boundary: it imports no JAX and nothing of the JAX package,
and its entry points run on the card unless told otherwise."""

import ast
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import device
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.vision.models import resnet

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom jax import numpy as jnp\n"
                 "import paddle_tpu.models.llama\n")
    assert [n for n in _imports(f) if _forbidden(n)] == [
        "jax", "paddle_tpu.models.llama"]
    assert not _forbidden("paddle_tpu_torch.models")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, an entry point called with no device raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.generate(params, [[1, 2, 3]], cfg, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet.resnet50(num_classes=1000, data_format="NHWC")


def test_resnet_and_converter_default_to_cuda(monkeypatch):
    """Layers build on ``device.get_device()``, CUDA unless ``set_device``
    named another; with ``set_device("cpu")`` a model builds on the CPU,
    and the converter without a device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.get_device() == "cuda"
    prev = device.set_device("cpu")
    try:
        model = resnet.resnet18(num_classes=10)
    finally:
        device.set_device(prev)
    assert all(p.device.type == "cpu" for p in model.parameters())
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_state_from_numpy(model, state)
