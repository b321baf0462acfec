"""Version metadata (port of ``paddle_tpu/version.py``, the counterpart of
Paddle's generated ``paddle/version.py``).

The JAX package reports ``"False"`` for CUDA and cuDNN because it has
neither; the port runs on CUDA, so ``cuda()`` is ``torch.version.cuda``
and ``cudnn()`` the version of the cuDNN torch loads (``"False"`` on a
CPU-only build of torch, as Paddle reports without CUDA).
"""

import torch

from . import __version__ as full_version

major, minor, patch = (full_version.split(".") + ["0", "0"])[:3]
rc = 0
istaged = True
commit = "torch-cuda"
with_pip = False
xpu_version = "False"
cuda_version = torch.version.cuda or "False"
cudnn_version = str(torch.backends.cudnn.version() or "False")


def cuda() -> str:
    return cuda_version


def cudnn() -> str:
    return cudnn_version


def show() -> None:
    print(f"paddle_tpu_torch {full_version} (commit {commit}); backend: "
          f"PyTorch {torch.__version__}, CUDA {cuda()}, cuDNN {cudnn()}")
