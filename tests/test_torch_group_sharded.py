"""The port's ZeRO by ownership (``distributed/sharding/group_sharded.py``,
``fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py``),
sequence parallelism (``fleet/utils/sequence_parallel_utils.py``) and the
hybrid clip, on 2 gloo ranks on the CPU (``tests/torch_dist_common.py``),
against the JAX package on the same numpy weights and batches.

- ``group_sharded_parallel`` at ``os``, ``os_g`` and ``p_g_os`` (and
  ``os_g`` offloaded) over sharding 2, each rank on its half of the
  reference test's batches: the losses and parameters of 3 AdamW steps
  equal the reference's unsharded run (fp32, 1e-6); each rank's optimizer
  state is its slice's; at ``p_g_os`` the parameters hold nothing between
  steps; offloaded state is moved to the host after every step; the file
  of ``save_group_sharded_model`` loads back into an unsharded model and
  optimizer.
- At mp 2: the four sequence ops forward and backward against numpy's
  split, concatenation and sum; the column -> row sequence-parallel pair
  against the reference's dense ``ColumnParallelLinear`` ->
  ``RowParallelLinear`` (output and every gradient); a marked LayerNorm's
  gradient after ``register_sequence_parallel_allreduce_hooks`` against
  the reference's global one, and without the hooks it differs (the
  mutation the hooks exist for).
- ``HybridParallelClipGrad`` at mp 2 on a column, a row and a LayerNorm's
  local gradients against the reference's ``ClipGradByGlobalNorm`` on the
  whole ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as pp
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JColumn,
)
from paddle_tpu.distributed.fleet.meta_parallel import (
    RowParallelLinear as JRow,
)
from paddle_tpu_torch.device import set_device
from torch_dist_common import W, inputs, world

LEVELS = [("os", False), ("os_g", False), ("p_g_os", False), ("os_g", True)]
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ranks():
    return [r["sharded"] for r in world()]


@pytest.fixture(scope="module")
def unsharded():
    """The reference's unsharded AdamW run (``tests/test_sharding_sp.py``'s
    ``_train_steps`` on the whole batches)."""
    w, b = inputs()["lin"]
    m = jpaddle.nn.Linear(16, 4)
    m.weight.set_value(w)
    m.bias.set_value(b)
    opt = jpaddle.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=m.parameters())
    losses = []
    for x, y in inputs()["steps"]:
        loss = jpaddle.mean((m(jpaddle.to_tensor(x))
                             - jpaddle.to_tensor(y)) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    moments = [{k: np.asarray(v) for k, v in opt._accumulators[id(p)].items()}
               for p in (m.weight, m.bias)]
    return losses, m.weight.numpy(), m.bias.numpy(), moments


@pytest.mark.parametrize("level,offload", LEVELS)
def test_zero_level_equals_unsharded_training(ranks, unsharded, level,
                                              offload):
    losses, w, b, _ = unsharded
    for res in ranks:
        got = res["zero"][(level, offload)]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        np.testing.assert_allclose(got["weight"], w, **TOL)
        np.testing.assert_allclose(got["bias"], b, **TOL)


@pytest.mark.parametrize("level,offload", LEVELS)
def test_each_rank_holds_only_its_slices(ranks, level, offload):
    for res in ranks:
        assert res["mode"] == "sharding"
        got = res["zero"][(level, offload)]
        assert got["slices"] == [16 * 4 // W, 4 // W]
        assert [sizes for sizes in got["state"].values()] == [
            {"moment1": n, "moment2": n} for n in got["slices"]]
        between = [0, 0] if level == "p_g_os" else [16 * 4, 4]
        assert got["between"] == [between] * 3
        # offloaded: each slice's two moments moved to the host every step
        assert got["host_moves"] == (3 * 2 * 2 if offload else 0)
        assert got["on_host"]


@pytest.mark.parametrize("level,offload", LEVELS)
def test_saved_model_loads_into_the_unsharded_state(ranks, unsharded,
                                                    level, offload):
    _, w, b, moments = unsharded
    path = ranks[0]["zero"][(level, offload)]["path"]
    prev = set_device("cpu")
    try:
        state = pp.load(f"{path}/model.pdparams")
        lin = pp.nn.Linear(16, 4)
        lin.set_state_dict({k: v for k, v in zip(
            lin.state_dict(), state.values())})
        np.testing.assert_allclose(lin.weight.detach().numpy(), w, **TOL)
        np.testing.assert_allclose(lin.bias.detach().numpy(), b, **TOL)
        opt_state = pp.load(f"{path}/model.pdopt")
        assert opt_state["@step"] == 3
        got = [v for k, v in opt_state.items() if k.endswith(".moment1")]
        for g, m in zip(got, moments):
            np.testing.assert_allclose(np.asarray(g), m["moment1"], **TOL)
    finally:
        set_device(prev)


def _seq(a, r):
    k = a.shape[1] // W
    return a[:, r * k:(r + 1) * k]


def test_sequence_ops_forward_and_backward(ranks):
    sp = inputs()["sp"]
    x, cot = sp["x"], sp["cot"]
    for r, res in enumerate(ranks):
        ops = res["sp"]
        y, g = ops["scatter"]
        np.testing.assert_array_equal(y, _seq(x, r))
        np.testing.assert_array_equal(g, cot)
        y, g = ops["gather"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(g, _seq(cot, r))
        y, g = ops["all_gather"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(g, _seq(sum(sp["cot_by_rank"]), r),
                                   **TOL)
        y, g = ops["reduce_scatter"]
        np.testing.assert_allclose(y, _seq(sum(sp["x_by_rank"]), r), **TOL)
        np.testing.assert_array_equal(g, cot)


def test_column_row_pair_equals_the_dense_layers(ranks):
    sp = inputs()["sp"]
    h, f = sp["wc"].shape
    col = JColumn(h, f, gather_output=False)
    row = JRow(f, h, input_is_parallel=True)
    for p, k in ((col.weight, "wc"), (col.bias, "bc"), (row.weight, "wr"),
                 (row.bias, "br")):
        p.set_value(sp[k])
    x = jpaddle.to_tensor(sp["x"], stop_gradient=False)
    y = row(jpaddle.nn.functional.relu(col(x)))
    (y * jpaddle.to_tensor(sp["cot"])).sum().backward()
    want = {"y": y.numpy(), "x_grad": x.grad.numpy(),
            "wc_grad": col.weight.grad.numpy(),
            "bc_grad": col.bias.grad.numpy(),
            "wr_grad": row.weight.grad.numpy(),
            "br_grad": row.bias.grad.numpy()}
    for res in ranks:
        pair = res["sp"]["pair"]
        assert pair["hooks"] == 1 and pair["marked"] == [False] * 3 + [True]
        for k, v in want.items():
            np.testing.assert_allclose(pair[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_marked_layer_norm_gradient_is_global_only_with_the_hooks(ranks):
    sp = inputs()["sp"]
    ln = jpaddle.nn.LayerNorm(sp["x"].shape[-1])
    ln.weight.set_value(sp["ln_w"])
    ln.bias.set_value(sp["ln_b"])
    x = jpaddle.to_tensor(sp["x"])
    (ln(x) * jpaddle.to_tensor(sp["cot"])).sum().backward()
    want = (ln.weight.grad.numpy(), ln.bias.grad.numpy())
    for res in ranks:
        hooked, bare = res["sp"]["layer_norm"][True], \
            res["sp"]["layer_norm"][False]
        for got, v in zip(hooked, want):
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5)
        # without the hooks each rank holds its shard's share only
        for got, v in zip(bare, want):
            assert not np.allclose(got, v, rtol=1e-2, atol=1e-2)


def test_hybrid_clip_equals_the_global_norm_clip(ranks):
    c = inputs()["clip"]
    order = ("col_w", "col_b", "row_w", "row_b", "ln_w", "ln_b")
    pairs = [(jpaddle.to_tensor(np.zeros_like(c["grads"][k])),
              jnp.asarray(c["grads"][k])) for k in order]
    want = jpaddle.nn.ClipGradByGlobalNorm(c["clip_norm"])(pairs)
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in c["grads"].values()))
    assert norm > c["clip_norm"]  # the clip scales
    for res in ranks:
        got = res["clip"]
        assert got["distributed"] == {"col_w": True, "col_b": True,
                                      "row_w": True, "row_b": False,
                                      "ln_w": False, "ln_b": False}
        for k, (_, g) in zip(order, want):
            np.testing.assert_allclose(got[k], np.asarray(g), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_lamb_under_zero_is_refused():
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.distributed.fleet.meta_optimizers\
        .dygraph_optimizer import ShardOwner

    prev = set_device("cpu")
    try:
        lin = pp.nn.Linear(2, 2)
        opt = pp.optimizer.Lamb(parameters=lin.parameters())
        with pytest.raises(NotImplementedError, match="trust ratio"):
            ShardOwner(opt, Group([0, 1]), 1)
        with pytest.raises(ValueError, match="level must be one of"):
            pp.distributed.group_sharded_parallel(lin, opt, level="zero9")
    finally:
        set_device(prev)


def test_tensor_parallel_broadcasts_the_replicated_parameters(ranks):
    for r, res in enumerate(ranks):
        got = res["tensor_parallel"]
        # column weight and bias, row weight: the ranks' own shards
        assert [d for d, _ in got] == [True, True, True, False, False,
                                       False]
        assert [v for d, v in got if d] == [float(r + 1)] * 3
        assert [v for d, v in got if not d] == [1.0] * 3


def test_world_of_one_group_sharded_is_the_optimizer():
    """At a world of one, every ZeRO level steps as the optimizer alone
    (one slice a parameter, the whole of it), and a scaler comes back
    wrapped in ``GroupShardedScaler``."""
    import torch

    from paddle_tpu_torch.distributed.sharding import GroupShardedScaler

    prev = set_device("cpu")
    try:
        w, b = inputs()["lin"]
        x, y = (torch.from_numpy(a) for a in inputs()["steps"][0])
        got = []
        for level in (None, "os", "os_g", "p_g_os"):
            lin = pp.nn.Linear(16, 4)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(w))
                lin.bias.copy_(torch.from_numpy(b))
            opt = pp.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=lin.parameters())
            if level is not None:
                scaler = pp.amp.GradScaler()
                lin, opt, sc = pp.distributed.group_sharded_parallel(
                    lin, opt, level=level, scaler=scaler)
                assert isinstance(sc, GroupShardedScaler)
                assert sc._scaler is scaler
            for _ in range(2):
                ((lin(x) - y) ** 2).mean().backward()
                opt.step()
                opt.clear_grad()
            if level == "p_g_os":
                opt._owner.gather_params()
            got.append(torch.cat([lin.weight.detach().reshape(-1),
                                  lin.bias.detach()]))
        for g in got[1:]:
            assert torch.equal(g, got[0])
    finally:
        set_device(prev)
