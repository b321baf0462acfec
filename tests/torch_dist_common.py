"""Shared by ``test_torch_collective.py``, ``test_torch_data_parallel.py``
and ``test_torch_group_sharded.py``: one world of 2 gloo ranks on the CPU,
started once a process by the port's ``distributed.spawn``
(``experiments.fleet_dp.world_cases``: the collectives, then
``DataParallel`` and ``SyncBatchNorm``, then ZeRO, sequence parallelism
and the hybrid clip), on inputs drawn here from one numpy seed. Each file
holds its part of the ranks' results against the JAX package on the same
inputs.
"""

import atexit
import functools
import os
import pickle
import shutil
import tempfile

import numpy as np

W = 2
# the reference's test model: 6 x Linear(16, 16), and the per-layer bytes
# of its fp32 payload, for bucket sizes of 2, 3 and all the layers
MLP_LAYERS, MLP_WIDTH = 6, 16
LAYER_MB = (MLP_WIDTH * MLP_WIDTH + MLP_WIDTH) * 4 / 2 ** 20
SIZES = (2 * LAYER_MB, 3 * LAYER_MB, 25)
B, S, H, F = 2, 4, 8, 16  # the sequence-parallel cases


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


@functools.lru_cache(maxsize=None)
def inputs():
    rng = np.random.RandomState(0)
    mlp = [(_f32(rng, MLP_WIDTH, MLP_WIDTH, scale=0.3),
            _f32(rng, MLP_WIDTH, scale=0.1)) for _ in range(MLP_LAYERS)]
    partial = [(_f32(rng, 8, 8, scale=0.3), _f32(rng, 8, scale=0.1))
               for _ in range(2)]
    # one batch in both layouts (NHWC the transpose of NCHW), so the
    # reference's NCHW BatchNorm2D answers both
    nchw = {"data_format": "NCHW",
            "x": _f32(rng, 4, 3, 5, 5, scale=2.0, shift=1.0),
            "cot": _f32(rng, 4, 3, 5, 5),
            "weight": (rng.rand(3) + 0.5).astype(np.float32),
            "bias": _f32(rng, 3)}
    nhwc = dict(nchw, data_format="NHWC",
                x=np.ascontiguousarray(nchw["x"].transpose(0, 2, 3, 1)),
                cot=np.ascontiguousarray(nchw["cot"].transpose(0, 2, 3, 1)))
    # the last again inside a DataParallel, which hands it its group
    bn = [nchw, nhwc, dict(nhwc, wrapped=True)]
    dp = (mlp, _f32(rng, 8, MLP_WIDTH), SIZES, partial, _f32(rng, 4, 8), bn)
    lin = (_f32(rng, 16, 4, scale=0.3), _f32(rng, 4, scale=0.1))
    r42 = np.random.RandomState(42)  # the reference test's batches
    steps = [(r42.randn(8, 16).astype(np.float32),
              r42.randn(8, 4).astype(np.float32)) for _ in range(3)]
    sp = {"x": _f32(rng, B, S, H), "cot": _f32(rng, B, S, H),
          "cot_by_rank": [_f32(rng, B, S, H) for _ in range(W)],
          "x_by_rank": [_f32(rng, B, S, H) for _ in range(W)],
          "wc": _f32(rng, H, F, scale=0.3), "bc": _f32(rng, F, scale=0.1),
          "wr": _f32(rng, F, H, scale=0.3), "br": _f32(rng, H, scale=0.1),
          "ln_w": (rng.rand(H) + 0.5).astype(np.float32),
          "ln_b": _f32(rng, H)}
    clip = {"clip_norm": 1.0,
            "grads": {"col_w": _f32(rng, H, F), "col_b": _f32(rng, F),
                      "row_w": _f32(rng, F, H), "row_b": _f32(rng, H),
                      "ln_w": _f32(rng, H), "ln_b": _f32(rng, H)}}
    return {"dp": dp, "lin": lin, "steps": steps, "sp": sp, "clip": clip}


@functools.lru_cache(maxsize=None)
def world():
    """Every rank's results (rank order); the saved ZeRO files stay until
    the process exits."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.experiments import fleet_dp

    inp = inputs()
    tmp = tempfile.mkdtemp(prefix="fleet_world_")
    atexit.register(shutil.rmtree, tmp, True)
    D.spawn(fleet_dp.world_cases, nprocs=W, timeout=240,
            args=(tmp, inp["dp"], (inp["lin"], inp["steps"], tmp, inp["sp"],
                                   inp["clip"])))
    out = []
    for r in range(W):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
