"""The port's boundary: it imports no JAX, nothing of the JAX package and
nothing of ``benchmarks/`` (whose modules import one another by bare
name), and its entry points run on the card unless told otherwise."""

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
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "benchmarks",
             *sorted(p.stem for p in (ROOT / "benchmarks").glob("*.py")))


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
    scanned = {str(f.relative_to(ROOT / "paddle_tpu_torch")) for f in files
               if f.is_relative_to(ROOT / "paddle_tpu_torch")}
    assert {"hapi/model.py", "hapi/callbacks.py", "hapi/model_summary.py",
            "io/__init__.py", "metric/__init__.py", "framework/io.py",
            "vision/datasets/__init__.py", "vision/models/lenet.py",
            "optimizer/lr.py", "nn/clip.py", "core/tensor.py",
            "core/dtype.py", "core/autograd.py", "device.py", "flags.py",
            "enforce.py", "framework/random.py", "ops/registry.py",
            "ops/dispatch.py", "ops/creation.py", "ops/math.py",
            "ops/logic.py", "ops/reduction.py", "ops/manipulation.py",
            "ops/linalg.py", "ops/special.py", "ops/tail.py",
            "ops/_tensor_methods.py", "_C_ops.py", "autograd/__init__.py",
            "fft.py", "experiments/op_corpus.py", "version.py",
            "sysconfig.py", "utils/__init__.py", "utils/dlpack.py",
            "utils/cpp_extension/__init__.py", "amp/debugging.py",
            "experiments/runtime_llama_opts.py", "distributed/env.py",
            "distributed/_comm.py", "parallel/mesh.py", "parallel/sharded.py",
            "distributed/fleet/meta_parallel/parallel_layers/mp_layers.py",
            "ops/ring_attention.py", "experiments/mesh_train.py",
            "distributed/collective.py", "distributed/parallel.py",
            "distributed/communication/__init__.py",
            "distributed/communication/stream.py",
            "distributed/fleet/fleet.py", "distributed/fleet/base/topology.py",
            "distributed/fleet/base/distributed_strategy.py",
            "distributed/fleet/base/role_maker.py",
            "distributed/fleet/meta_optimizers/strategy_optimizers.py",
            "distributed/fleet/meta_optimizers/dygraph_optimizer/"
            "hybrid_parallel_optimizer.py",
            "distributed/fleet/meta_optimizers/dygraph_optimizer/"
            "dygraph_sharding_optimizer.py",
            "distributed/fleet/utils/hybrid_parallel_util.py",
            "distributed/fleet/utils/sequence_parallel_utils.py",
            "distributed/fleet/meta_parallel/tensor_parallel.py",
            "distributed/fleet/meta_parallel/parallel_layers/random.py",
            "distributed/fleet/recompute/recompute.py",
            "distributed/sharding/group_sharded.py",
            "experiments/fleet_dp.py"} <= scanned
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom jax import numpy as jnp\n"
                 "import paddle_tpu.models.llama\n"
                 "from benchmarks import dot_variants\n"
                 "from flash_micro import timeit\n")
    assert [n for n in _imports(f) if _forbidden(n)] == [
        "jax", "paddle_tpu.models.llama", "benchmarks", "flash_micro"]
    assert not _forbidden("paddle_tpu_torch.models")
    assert not _forbidden("paddle_tpu_torch.experiments.dot_variants")


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


def test_high_level_api_defaults_to_cuda(monkeypatch, tmp_path):
    """The high-level API's entry points (a model built for ``Model``, a
    bare ``DataLoader``, ``load``, ``summary``) run on the card unless
    ``set_device`` named another device: without CUDA they raise."""
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LeNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(pt.io.DataLoader(MNIST(mode="test", synthetic_size=4),
                                   batch_size=2)))
    pt.save({"w": torch.ones(2)}, str(tmp_path / "w.pd"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.load(str(tmp_path / "w.pd"))
    assert pt.load(str(tmp_path / "w.pd"), return_numpy=True)["w"].tolist() \
        == [1.0, 1.0]
    prev = device.set_device("cpu")
    try:
        net = LeNet()
        model = pt.Model(net)
        model.prepare(pt.optimizer.Adam(parameters=net.parameters()),
                      pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    finally:
        device.set_device(prev)
    x = np.zeros((2, 1, 28, 28), np.float32)
    y = np.zeros((2, 1), np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.train_batch([x], [y])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.summary(net, (1, 1, 28, 28))


def test_tensor_core_defaults_to_cuda(monkeypatch):
    """``to_tensor`` and the creation ops run on the card unless
    ``set_device`` or ``place`` names the CPU: without CUDA they raise."""
    import paddle_tpu_torch as pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.get_device() == "cuda"
    for make in (lambda: pt.to_tensor([1.0]), lambda: pt.ones([2]),
                 lambda: pt.randn([2]), lambda: pt.linspace(0, 1, 3),
                 lambda: pt.fft.fftfreq(4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert pt.to_tensor([1.0], place="cpu").device.type == "cpu"
    prev = device.set_device("cpu")
    try:
        assert pt.arange(3).device.type == "cpu"
    finally:
        device.set_device(prev)


def test_mesh_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, the distributed entry points called with no device
    raise instead of running on the CPU and gloo: ``init_parallel_env``,
    ``create_hybrid_mesh`` and both ``make_sharded_train_step``s (which
    also refuse a mesh of another device)."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import create_hybrid_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_parallel_env()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_hybrid_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.make_sharded_train_step(llama.LlamaConfig.tiny(), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bert.make_sharded_train_step(bert.BertConfig.tiny(), None)
    with pytest.raises(ValueError, match="device"):
        llama.make_sharded_train_step(llama.LlamaConfig.tiny(), None,
                                      device="cpu")
