"""The port's tensor-parallel layers (``paddle_tpu_torch/distributed/
fleet/meta_parallel/parallel_layers/mp_layers.py``) against the JAX
package's, at mp 2, on the CPU.

The JAX layers run eagerly on a 2-device mesh (``create_hybrid_mesh(mp=2)``
over the virtual CPU devices), where GSPMD places their whole weights;
their weights cross as numpy to the port's layers in 2 spawned gloo ranks
(``experiments.mesh_train.tp_layers``), each holding its slice. Outputs,
input gradients and the weights' gradients (gathered whole) of a seeded
weighted sum, fp32, within 1e-5: ``VocabParallelEmbedding``,
``ColumnParallelLinear`` (gathered), the Megatron pair (column without the
gather into row with a parallel input), ``RowParallelLinear`` (slicing a
replicated input) and ``ParallelCrossEntropy`` with an ignored label.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu.parallel import create_hybrid_mesh, set_mesh
from paddle_tpu_torch.experiments import mesh_train

TOL = dict(rtol=1e-5, atol=1e-5)
V, H, F_, B = 16, 8, 12, 3


def _jax_side(r):
    set_mesh(create_hybrid_mesh(mp=2, devices=__import__("jax").devices()[:2]))
    try:
        pt.seed(11)
        emb = VocabParallelEmbedding(V, H)
        col = ColumnParallelLinear(H, F_, gather_output=True)
        col_p = ColumnParallelLinear(H, F_, gather_output=False)
        row = RowParallelLinear(F_, H, input_is_parallel=False)
        row_p = RowParallelLinear(F_, H, input_is_parallel=True)
        ce = ParallelCrossEntropy()
        # the pair shares weights with the lone layers (the port's too)
        for a, b in ((col_p.weight, col.weight), (col_p.bias, col.bias),
                     (row_p.weight, row.weight), (row_p.bias, row.bias)):
            a.set_value(b.numpy())
        # biases off zero, so their gradients and sums are exercised
        col.bias.set_value(r.standard_normal(F_).astype(np.float32))
        col_p.bias.set_value(col.bias.numpy())
        row.bias.set_value(r.standard_normal(H).astype(np.float32))
        row_p.bias.set_value(row.bias.numpy())
        weights = {"emb": emb.weight.numpy(), "col_w": col.weight.numpy(),
                   "col_b": col.bias.numpy(), "row_w": row.weight.numpy(),
                   "row_b": row.bias.numpy()}
        x = r.standard_normal((B, H)).astype(np.float32)
        x2 = r.standard_normal((B, F_)).astype(np.float32)
        ids = np.array([[0, 7, 8], [15, 3, 9]], np.int64)
        labels = np.array([[1, 9, 15, -100], [0, 8, 7, 12]], np.int64)
        cot = {"emb": r.standard_normal((2, 3, H)).astype(np.float32),
               "col": r.standard_normal((B, F_)).astype(np.float32),
               "mlp": r.standard_normal((B, H)).astype(np.float32),
               "row": r.standard_normal((B, H)).astype(np.float32),
               "logits": r.standard_normal((2, 4, V)).astype(np.float32)}
        out = {}

        def run(layer_out, c, inputs):
            pt.sum(pt.multiply(layer_out, pt.to_tensor(c))).backward()
            return layer_out.numpy(), [t.grad.numpy() for t in inputs]

        e = emb(pt.to_tensor(ids))
        out["emb"], (out["emb_grad"],) = run(e, cot["emb"], [emb.weight])
        xt = pt.to_tensor(x, stop_gradient=False)
        out["col"], (out["col_x_grad"], out["col_w_grad"],
                     out["col_b_grad"]) = run(col(xt), cot["col"],
                                              [xt, col.weight, col.bias])
        xt = pt.to_tensor(x, stop_gradient=False)
        out["mlp"], (out["mlp_x_grad"], out["mlp_col_w_grad"],
                     out["mlp_row_w_grad"]) = run(
            row_p(pt.nn.functional.relu(col_p(xt))), cot["mlp"],
            [xt, col_p.weight, row_p.weight])
        x2t = pt.to_tensor(x2, stop_gradient=False)
        out["row"], (out["row_x_grad"], out["row_w_grad"],
                     out["row_b_grad"]) = run(row(x2t), cot["row"],
                                              [x2t, row.weight, row.bias])
        lg = pt.to_tensor(cot["logits"], stop_gradient=False)
        loss = ce(lg, pt.to_tensor(labels))
        pt.sum(loss).backward()
        out["ce"], out["ce_grad"] = loss.numpy(), lg.grad.numpy()
        return (weights, x, x2, ids, labels, cot), out
    finally:
        set_mesh(None)


@pytest.fixture(scope="module")
def run():
    args, ref = _jax_side(np.random.RandomState(0))
    port = mesh_train.spawn(mesh_train.tp_layers, 2, args=args,
                            timeout=120)[0]
    return ref, port


@pytest.mark.parametrize("key", [
    "emb", "emb_grad", "col", "col_x_grad", "col_w_grad", "col_b_grad",
    "mlp", "mlp_x_grad", "mlp_col_w_grad", "mlp_row_w_grad", "row", "row_x_grad", "row_w_grad",
    "row_b_grad", "ce", "ce_grad"])
def test_layer_matches_the_reference(run, key):
    ref, port = run
    np.testing.assert_allclose(np.asarray(port[key]), np.asarray(ref[key]),
                               **TOL)


def test_ignored_label_scores_zero(run):
    ref, port = run
    assert port["ce"].shape == (2, 4, 1)
    assert port["ce"][0, 3, 0] == 0.0
    assert not port["ce_grad"][0, 3].any()
