"""The port's ``vision.ops`` against the JAX package's, on the CPU.

Every operator runs on both packages on the same seeded numpy inputs in
fp32: outputs, and the gradients of ``sum(out * w)`` (w fixed, random)
with respect to each float input of ``roi_align``, ``roi_pool``,
``psroi_pool``, ``box_coder`` and ``deform_conv2d``, within 1e-5 (atol
and rtol: the packages sum in other orders). ``nms`` keeps exactly the
same indices in the same order, int32 both sides, with scores and
without, category-aware and with ``top_k``; ``prior_box``,
``distribute_fpn_proposals`` and ``generate_proposals`` (host numpy on
both sides) are equal. ``DeformConv2D`` carries the JAX layer's
``state_dict`` by ``layer_state_from_numpy``. The JAX side of the
differentiable operators runs as one ``jit.to_static`` program a case,
the RoI operators' boxes and counts held as constants of the program
(they are read on the host: ``boxes_num``, and ``roi_align``'s adaptive
sampling ratio from the largest box). The reference's
own cases (``tests/test_api_round4.py``, ``test_api_round5.py``,
``test_api_round7.py``) run on the port.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JNF
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as port
import paddle_tpu_torch.vision.ops as TO
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.nn import functional as TNF

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _boxes(seed, n, size=32.0, min_wh=1.0, max_wh=None):
    rng = np.random.RandomState(seed)
    max_wh = max_wh or size / 2
    xy = rng.rand(n, 2) * size * 0.8
    wh = min_wh + rng.rand(n, 2) * (max_wh - min_wh)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _jax(fn, arrays, grad_of, static):
    xs = [paddle.to_tensor(a, stop_gradient=i not in grad_of)
          for i, a in enumerate(arrays)]
    run = paddle.jit.to_static(fn) if static else fn
    outs = _outs(run(*xs))
    loss = None
    for k, o in enumerate(outs):
        term = (o * paddle.to_tensor(_np(90 + k, *o.shape))).sum()
        loss = term if loss is None else loss + term
    if grad_of:
        loss.backward()
    return ([np.asarray(o.numpy()) for o in outs],
            [xs[i].grad.numpy() for i in grad_of])


def _port(fn, arrays, grad_of):
    xs = [torch.from_numpy(a.copy()).requires_grad_(i in grad_of)
          for i, a in enumerate(arrays)]
    outs = _outs(fn(*xs))
    loss = sum((o * torch.from_numpy(_np(90 + k, *o.shape))).sum()
               for k, o in enumerate(outs))
    if grad_of:
        loss.backward()
    return ([o.detach().numpy() for o in outs],
            [xs[i].grad.numpy() for i in grad_of])


def _same(jfn, tfn, arrays, grad_of=(), static=False, tol=TOL):
    (jo, jg), (to, tg) = (_jax(jfn, arrays, grad_of, static),
                          _port(tfn, arrays, grad_of))
    assert len(jo) == len(to) and len(jg) == len(tg)
    for a, b in zip(to + tg, jo + jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)
    return to, tg


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def test_box_area_and_iou():
    a, b = _boxes(1, 9), _boxes(2, 7)
    _same(lambda x: JO.box_area(x), lambda x: TO.box_area(x), [a])
    _same(lambda x, y: JO.box_iou(x, y), lambda x, y: TO.box_iou(x, y),
          [a, b])


NMS_CASES = {
    "scores_0.3": dict(n=80, thr=0.3, scores=True),
    "scores_0.5": dict(n=80, thr=0.5, scores=True),
    "scores_0.7": dict(n=120, thr=0.7, scores=True),
    "no_scores": dict(n=60, thr=0.4, scores=False),
    "top_k": dict(n=80, thr=0.5, scores=True, top_k=7),
    "categories": dict(n=100, thr=0.5, scores=True, classes=4),
    "categories_top_k": dict(n=100, thr=0.3, scores=True, classes=5,
                             top_k=12),
    "tied_scores": dict(n=50, thr=0.5, scores="tied"),
    "one_box": dict(n=1, thr=0.5, scores=True),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_equal(case):
    c = NMS_CASES[case]
    boxes = _boxes(3, c["n"], size=20.0, min_wh=2.0, max_wh=12.0)
    rng = np.random.RandomState(4)
    scores = None
    if c["scores"] == "tied":
        scores = (rng.randint(0, 4, c["n"]) / 4).astype(np.float32)
    elif c["scores"]:
        scores = rng.rand(c["n"]).astype(np.float32)
    cats = (rng.randint(0, c["classes"], c["n"]).astype(np.int64)
            if "classes" in c else None)
    kw = dict(iou_threshold=c["thr"], top_k=c.get("top_k"),
              categories=list(range(c.get("classes", 1))))
    jt = paddle.to_tensor
    a = JO.nms(jt(boxes), scores=None if scores is None else jt(scores),
               category_idxs=None if cats is None else jt(cats), **kw)
    b = TO.nms(torch.from_numpy(boxes),
               scores=None if scores is None else torch.from_numpy(scores),
               category_idxs=None if cats is None else torch.from_numpy(
                   cats), **kw)
    assert b.dtype == torch.int32 and a.numpy().dtype == np.int32
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert 0 < len(b) <= c["n"]


def test_nms_empty():
    out = TO.nms(torch.zeros((0, 4)), 0.5)
    assert out.shape == (0,) and out.dtype == torch.int32


CODER_CASES = {
    "encode": dict(code_type="encode_center_size", t3=False),
    "encode_pixels": dict(code_type="encode_center_size", t3=False,
                          box_normalized=False),
    "decode": dict(code_type="decode_center_size", t3=False),
    "decode_3d_axis0": dict(code_type="decode_center_size", t3=True,
                            axis=0),
    "decode_3d_axis1": dict(code_type="decode_center_size", t3=True,
                            axis=1, box_normalized=False),
    # a 3-D target decodes whatever code_type says
    "encode_3d": dict(code_type="encode_center_size", t3=True, axis=0),
}


@pytest.mark.parametrize("case", sorted(CODER_CASES))
def test_box_coder(case):
    c = dict(CODER_CASES[case])
    t3 = c.pop("t3")
    M, Nt = 6, 5
    prior = _boxes(5, M, size=1.0, min_wh=0.1, max_wh=0.5)
    var = np.abs(_np(6, M, 4, scale=0.2)) + 0.05
    if t3:  # the priors run along axis 0 (axis=0) or axis 1 (axis=1)
        shape = (M, Nt, 4) if c.get("axis", 0) == 0 else (Nt, M, 4)
        target = _np(7, *shape, scale=0.5)
    elif c["code_type"] == "encode_center_size":
        target = _boxes(8, M, size=1.0, min_wh=0.1, max_wh=0.5)
    else:
        target = _np(7, M, 4, scale=0.5)

    def jfn(p, v, t):
        return JO.box_coder(p, v, t, **c)
    _same(jfn, lambda p, v, t: TO.box_coder(p, v, t, **c),
          [prior, var, target], grad_of=(0, 2), static=True)


PRIOR_CASES = {
    "ssd38": dict(fmap=(38, 38), image=300, min_sizes=[30.0],
                  max_sizes=[60.0], aspect_ratios=[2.0], flip=True,
                  clip=True, steps=(8.0, 8.0)),
    "ssd3": dict(fmap=(3, 3), image=300, min_sizes=[213.0],
                 max_sizes=[264.0], aspect_ratios=[2.0, 3.0], flip=True,
                 clip=True),
    "plain": dict(fmap=(4, 6), image=64, min_sizes=[16.0, 24.0]),
    "order": dict(fmap=(2, 2), image=32, min_sizes=[8.0], max_sizes=[16.0],
                  aspect_ratios=[2.0], min_max_aspect_ratios_order=True,
                  offset=0.25, variance=(0.1, 0.2, 0.3, 0.4)),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_box_equal(case):
    c = dict(PRIOR_CASES[case])
    fh, fw = c.pop("fmap")
    im = c.pop("image")
    feat = np.zeros((1, 1, fh, fw), np.float32)
    img = np.zeros((1, 3, im, im), np.float32)
    ja, jb = JO.prior_box(paddle.to_tensor(feat), paddle.to_tensor(img),
                          **c)
    ta, tb = TO.prior_box(torch.from_numpy(feat), torch.from_numpy(img),
                          **c)
    np.testing.assert_array_equal(ta.numpy(), ja.numpy())
    np.testing.assert_array_equal(tb.numpy(), jb.numpy())


YOLO_CASES = {
    "clip": dict(A=3, C=4, H=5, W=6, kw={}),
    "no_clip_scaled": dict(A=2, C=3, H=4, W=4,
                           kw=dict(clip_bbox=False, scale_x_y=1.05)),
    "iou_aware": dict(A=3, C=2, H=3, W=5,
                      kw=dict(iou_aware=True, iou_aware_factor=0.4)),
    "low_thresh": dict(A=1, C=5, H=2, W=3, kw=dict(downsample_ratio=16)),
}


@pytest.mark.parametrize("case", sorted(YOLO_CASES))
def test_yolo_box(case):
    c = YOLO_CASES[case]
    A, C, H, W = c["A"], c["C"], c["H"], c["W"]
    ch = A * (5 + C) + (A if c["kw"].get("iou_aware") else 0)
    x = _np(9, 2, ch, H, W, scale=1.5)
    img = np.array([[96, 128], [80, 64]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23][:2 * A]
    kw = dict(c["kw"])
    ja = paddle.jit.to_static(_bound(
        JO.yolo_box, paddle.to_tensor(img), anchors, C, 0.4, **kw))(
            paddle.to_tensor(x))
    ta = TO.yolo_box(torch.from_numpy(x), torch.from_numpy(img), anchors, C,
                     0.4, **kw)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert (ta[1].numpy() == 0).any()  # low-confidence rows zeroed


# ---------------------------------------------------------------------------
# RoI operators
# ---------------------------------------------------------------------------

def _bound(op, *consts, **kw):
    """``op(x, *consts, **kw)`` as a function of ``x`` alone (a ``def``:
    ``to_static`` does not take a lambda with keywords)."""
    def f(x):
        return op(x, *consts, **kw)
    return f


def _rois(seed, counts, size, scale_max=0.6):
    return np.concatenate([_boxes(seed + i, n, size=size, min_wh=0.5,
                                  max_wh=size * scale_max)
                           for i, n in enumerate(counts)])


ALIGN_CASES = {
    "aligned_sr2": dict(out=3, sr=2, aligned=True, scale=0.5),
    "aligned_adaptive": dict(out=(2, 3), sr=-1, aligned=True, scale=0.25),
    "unaligned_sr1": dict(out=4, sr=1, aligned=False, scale=1.0),
    "unaligned_adaptive": dict(out=2, sr=0, aligned=False, scale=0.5),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_roi_align(case):
    c = ALIGN_CASES[case]
    x = _np(10, 2, 3, 9, 11)
    counts = np.array([3, 2], np.int32)
    boxes = _rois(11, counts, size=20.0)
    boxes[0] = [-3.0, -2.0, 25.0, 30.0]  # past the image: clipped
    kw = dict(output_size=c["out"], spatial_scale=c["scale"],
              sampling_ratio=c["sr"], aligned=c["aligned"])
    _same(_bound(JO.roi_align, paddle.to_tensor(boxes), counts, **kw),
          _bound(TO.roi_align, torch.from_numpy(boxes), counts, **kw), [x],
          grad_of=(0,), static=True)


def test_roi_align_chunked(monkeypatch):
    """The RoIs gathered a few at a time give the one-chunk result."""
    x = _np(12, 2, 4, 8, 8)
    counts = np.array([4, 3], np.int32)
    boxes = torch.from_numpy(_rois(13, counts, size=16.0))
    xt = torch.from_numpy(x)
    whole = TO.roi_align(xt, boxes, counts, 3, 0.5)
    monkeypatch.setattr(TO, "_CHUNK_ELEMS", 4 * 6 * 6 * 2)
    np.testing.assert_array_equal(
        TO.roi_align(xt, boxes, counts, 3, 0.5).numpy(), whole.numpy())
    assert TO.roi_pool(xt, boxes, counts, 2, 0.5).shape == (7, 4, 2, 2)


@pytest.mark.parametrize("out,scale", [(2, 1.0), ((3, 2), 0.5), (4, 0.25)])
def test_roi_pool(out, scale):
    x = _np(14, 2, 3, 10, 12)
    counts = np.array([2, 4], np.int32)
    boxes = _rois(15, counts, size=24.0)
    boxes[1] = [5.0, 5.0, 5.2, 5.1]  # floored at 1 px
    kw = dict(output_size=out, spatial_scale=scale)
    _same(_bound(JO.roi_pool, paddle.to_tensor(boxes), counts, **kw),
          _bound(TO.roi_pool, torch.from_numpy(boxes), counts, **kw), [x],
          grad_of=(0,), static=True)


@pytest.mark.parametrize("out,scale,out_c", [(2, 1.0, 3), ((3, 2), 0.5, 2),
                                             (3, 0.25, 1)])
def test_psroi_pool(out, scale, out_c):
    ph, pw = (out, out) if isinstance(out, int) else out
    x = _np(16, 2, out_c * ph * pw, 9, 10)
    counts = np.array([3, 2], np.int32)
    boxes = _rois(17, counts, size=20.0 / scale * 0.5)
    boxes[2] = [-4.0, 1.0, 60.0, 3.0]  # past the image on three sides
    kw = dict(output_size=out, spatial_scale=scale)
    _same(_bound(JO.psroi_pool, paddle.to_tensor(boxes),
                 paddle.to_tensor(counts), **kw),
          _bound(TO.psroi_pool, torch.from_numpy(boxes), counts, **kw), [x],
          grad_of=(0,), static=True)


def test_distribute_fpn_proposals_equal():
    rois = np.concatenate([_boxes(18, 30, size=600.0, min_wh=4.0,
                                  max_wh=500.0),
                           np.array([[0, 0, 20, 20], [0, 0, 900, 900]],
                                    np.float32)])
    for kw in (dict(), dict(pixel_offset=True)):
        ja = JO.distribute_fpn_proposals(paddle.to_tensor(rois), 2, 5, 4,
                                         224, **kw)
        ta = TO.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4,
                                         224, rois_num=[32], **kw)
        for a, b in zip(ta[0], ja[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(ta[1].numpy(), ja[1].numpy())
        assert ta[1].dtype == torch.int64
        for a, b in zip(ta[2], ja[2]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            assert a.dtype == torch.int32


def _anchors(H, W, A, stride=8):
    anchors = np.zeros((H, W, A, 4), np.float32)
    for y in range(H):
        for x_ in range(W):
            for a in range(A):
                cx, cy, s = x_ * stride + 4, y * stride + 4, stride * (a + 1)
                anchors[y, x_, a] = [cx - s / 2, cy - s / 2, cx + s / 2,
                                     cy + s / 2]
    return anchors


@pytest.mark.parametrize("kw", [
    dict(pre_nms_top_n=40, post_nms_top_n=10, nms_thresh=0.5),
    dict(pre_nms_top_n=30, post_nms_top_n=20, nms_thresh=0.7,
         pixel_offset=True, min_size=0.5),
    dict(pre_nms_top_n=1000, post_nms_top_n=1000, nms_thresh=0.3,
         min_size=3.0)])
def test_generate_proposals_equal(kw):
    N, A, H, W = 2, 3, 6, 5
    scores = np.random.RandomState(19).rand(N, A, H, W).astype(np.float32)
    deltas = _np(20, N, 4 * A, H, W, scale=0.3)
    anchors = _anchors(H, W, A)
    var = np.full_like(anchors, 1.0)
    var[..., 2:] = 0.5
    img = np.array([[48, 40], [36, 44]], np.float32)
    args = [scores, deltas, img, anchors, var]
    ja = JO.generate_proposals(*[paddle.to_tensor(a) for a in args],
                               return_rois_num=True, **kw)
    ta = TO.generate_proposals(*[torch.from_numpy(a) for a in args],
                               return_rois_num=True, **kw)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ta[2].dtype == torch.int32
    with pytest.raises(NotImplementedError):
        TO.generate_proposals(*[torch.from_numpy(a) for a in args], eta=0.5)


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

DEFORM_CASES = {
    "v1": dict(N=2, C=4, H=7, W=6, Co=5, k=3, kw=dict(padding=1)),
    "v1_bias": dict(N=1, C=3, H=6, W=6, Co=4, k=3, bias=True,
                    kw=dict(padding=1)),
    "v2_bias": dict(N=2, C=4, H=6, W=7, Co=6, k=3, bias=True, mask=True,
                    kw=dict(padding=1)),
    "v2_groups": dict(N=1, C=4, H=8, W=6, Co=6, k=3, mask=True, bias=True,
                      kw=dict(padding=1, groups=2, deformable_groups=2)),
    "strided_dilated": dict(N=2, C=2, H=9, W=8, Co=3, k=(3, 2), bias=True,
                            kw=dict(stride=2, padding=(2, 1),
                                    dilation=(2, 1))),
}


def _deform_inputs(c):
    kh, kw_ = (c["k"], c["k"]) if isinstance(c["k"], int) else c["k"]
    kw = c["kw"]
    sh, sw = (kw.get("stride", 1),) * 2 if isinstance(
        kw.get("stride", 1), int) else kw["stride"]
    ph, pw = (kw.get("padding", 0),) * 2 if isinstance(
        kw.get("padding", 0), int) else kw["padding"]
    dh, dw = (kw.get("dilation", 1),) * 2 if isinstance(
        kw.get("dilation", 1), int) else kw["dilation"]
    Ho = (c["H"] + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (c["W"] + 2 * pw - (dw * (kw_ - 1) + 1)) // sw + 1
    dg, g = kw.get("deformable_groups", 1), kw.get("groups", 1)
    K = kh * kw_
    arrays = [_np(21, c["N"], c["C"], c["H"], c["W"]),
              _np(22, c["N"], dg * K * 2, Ho, Wo, scale=1.3),
              _np(23, c["Co"], c["C"] // g, kh, kw_, scale=0.4)]
    if c.get("bias"):
        arrays.append(_np(24, c["Co"]))
    if c.get("mask"):
        arrays.append(np.random.RandomState(25).rand(
            c["N"], dg * K, Ho, Wo).astype(np.float32))
    return arrays


@pytest.mark.parametrize("case", sorted(DEFORM_CASES))
def test_deform_conv2d(case):
    c = DEFORM_CASES[case]
    arrays = _deform_inputs(c)
    kw = c["kw"]
    bias, mask = c.get("bias", False), c.get("mask", False)

    def call(op):
        def f(x, off, w, *rest):
            return op(x, off, w, bias=rest[0] if bias else None,
                      mask=rest[-1] if mask else None, **kw)
        return f
    _same(call(JO.deform_conv2d), call(TO.deform_conv2d), arrays,
          grad_of=tuple(range(len(arrays))), static=True)


def test_deform_conv2d_layer_carried():
    paddle.seed(71)
    jl = JO.DeformConv2D(4, 6, 3, stride=1, padding=1, deformable_groups=2)
    tl = TO.DeformConv2D(4, 6, 3, stride=1, padding=1, deformable_groups=2)
    assert list(tl.state_dict()) == list(jl.state_dict())
    layer_state_from_numpy(tl, {k: np.asarray(v.numpy())
                                for k, v in jl.state_dict().items()},
                           device="cpu")
    x = _np(26, 2, 4, 8, 8)
    off = _np(27, 2, 2 * 2 * 9, 8, 8, scale=0.5)
    mask = np.random.RandomState(28).rand(2, 2 * 9, 8, 8).astype(np.float32)
    for m in (None, mask):
        a = jl(paddle.to_tensor(x), paddle.to_tensor(off),
               mask=None if m is None else paddle.to_tensor(m))
        b = tl(torch.from_numpy(x), torch.from_numpy(off),
               mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), **TOL)


def test_names():
    assert TO.__all__ == JO.__all__ and len(TO.__all__) == 13


# ---------------------------------------------------------------------------
# the reference's own cases, on the port
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


class TestReferenceCases:
    def test_deform_conv2d_zero_offsets_equals_conv(self):
        rng = np.random.RandomState(21)
        x = rng.randn(2, 4, 7, 7).astype(np.float32)
        w = rng.randn(6, 4, 3, 3).astype(np.float32)
        b = rng.randn(6).astype(np.float32)
        off = np.zeros((2, 2 * 9, 7, 7), np.float32)
        got = TO.deform_conv2d(_t(x), _t(off), _t(w), bias=_t(b), padding=1)
        ref = TNF.conv2d(_t(x), _t(w), bias=_t(b), padding=1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        jref = JNF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                          bias=paddle.to_tensor(b), padding=1).numpy()
        np.testing.assert_allclose(got.numpy(), jref, rtol=1e-4, atol=1e-4)

    def test_deform_conv2d_v2_mask_scales(self):
        rng = np.random.RandomState(22)
        x = rng.randn(1, 2, 5, 5).astype(np.float32)
        w = rng.randn(3, 2, 3, 3).astype(np.float32)
        off = np.zeros((1, 18, 5, 5), np.float32)
        full = TO.deform_conv2d(_t(x), _t(off), _t(w), padding=1,
                                mask=_t(np.ones((1, 9, 5, 5), np.float32)))
        half = TO.deform_conv2d(_t(x), _t(off), _t(w), padding=1,
                                mask=_t(np.full((1, 9, 5, 5), 0.5,
                                                np.float32)))
        np.testing.assert_allclose(half.numpy(), full.numpy() * 0.5,
                                   rtol=1e-5, atol=1e-5)

    def test_deform_conv2d_bias_with_mask(self):
        rng = np.random.RandomState(23)
        x = rng.randn(1, 2, 5, 5).astype(np.float32)
        w = rng.randn(3, 2, 3, 3).astype(np.float32)
        b = rng.randn(3).astype(np.float32)
        off = np.zeros((1, 18, 5, 5), np.float32)
        ones = np.ones((1, 9, 5, 5), np.float32)
        with_b = TO.deform_conv2d(_t(x), _t(off), _t(w), bias=_t(b),
                                  padding=1, mask=_t(ones)).numpy()
        no_b = TO.deform_conv2d(_t(x), _t(off), _t(w), padding=1,
                                mask=_t(ones)).numpy()
        np.testing.assert_allclose(
            with_b - no_b, np.broadcast_to(b.reshape(1, -1, 1, 1),
                                           with_b.shape),
            rtol=1e-4, atol=1e-5)

    def test_prior_box_geometry(self):
        boxes, var = TO.prior_box(torch.zeros(1, 1, 2, 2),
                                  torch.zeros(1, 3, 32, 32), min_sizes=[16])
        assert tuple(boxes.shape) == (2, 2, 1, 4)
        np.testing.assert_allclose(boxes.numpy()[0, 0, 0],
                                   [0.0, 0.0, 0.5, 0.5], atol=1e-6)
        np.testing.assert_allclose(var.numpy()[0, 0, 0],
                                   [0.1, 0.1, 0.2, 0.2])

    def test_prior_box_min_max_order(self):
        feat, img = torch.zeros(1, 1, 1, 1), torch.zeros(1, 3, 32, 32)
        kw = dict(min_sizes=[8], max_sizes=[16], aspect_ratios=[2.0])
        b_def, _ = TO.prior_box(feat, img, **kw)
        b_mm, _ = TO.prior_box(feat, img, min_max_aspect_ratios_order=True,
                               **kw)
        wdef = (b_def.numpy()[0, 0, :, 2] - b_def.numpy()[0, 0, :, 0]) * 32
        wmm = (b_mm.numpy()[0, 0, :, 2] - b_mm.numpy()[0, 0, :, 0]) * 32
        np.testing.assert_allclose(wdef[0], 8, atol=1e-4)
        np.testing.assert_allclose(wmm[1], np.sqrt(8 * 16), atol=1e-4)
        assert set(np.round(wdef, 3)) == set(np.round(wmm, 3))

    def test_yolo_box_decode_single_cell(self):
        x = np.zeros((1, 6, 1, 1), np.float32)
        x[0, 4] = 10.0
        x[0, 5] = 10.0
        boxes, scores = TO.yolo_box(_t(x), _t(np.array([[32, 32]],
                                                       np.int32)),
                                    [16, 16], 1, 0.5, downsample_ratio=32,
                                    clip_bbox=False)
        np.testing.assert_allclose(boxes.numpy()[0, 0],
                                   [8.0, 8.0, 24.0, 24.0], atol=1e-3)
        assert scores.numpy()[0, 0, 0] > 0.99

    def test_yolo_box_multicell_grid_alignment(self):
        H = W = 2
        x = np.zeros((1, 6, H, W), np.float32)
        x[0, 4] = 10.0
        x[0, 5] = 10.0
        boxes, _ = TO.yolo_box(_t(x), _t(np.array([[64, 64]], np.int32)),
                               [32, 32], 1, 0.5, downsample_ratio=32,
                               clip_bbox=False)
        b = boxes.numpy().reshape(H, W, 4)
        for i in range(H):
            for j in range(W):
                cx, cy = 64 * (j + 0.5) / W, 64 * (i + 0.5) / H
                np.testing.assert_allclose(
                    b[i, j], [cx - 16, cy - 16, cx + 16, cy + 16], atol=1e-3)

    def test_yolo_box_iou_aware(self):
        def sig(v):
            return 1.0 / (1.0 + np.exp(-v))
        iou_logit, factor = 1.2, 0.5
        x = np.zeros((1, 8, 1, 1), np.float32)
        x[0, 0] = iou_logit
        x[0, 5] = 2.0
        x[0, 6] = 0.7
        img = np.array([[64, 64]], np.int32)
        boxes, scores = TO.yolo_box(_t(x), _t(img), [(10, 10)], 2,
                                    conf_thresh=0.01, iou_aware=True,
                                    iou_aware_factor=factor)
        conf = sig(2.0) ** (1 - factor) * sig(iou_logit) ** factor
        np.testing.assert_allclose(scores.numpy()[0, 0, 0], sig(0.7) * conf,
                                   rtol=1e-5)
        b2, s2 = TO.yolo_box(_t(x[:, 1:]), _t(img), [(10, 10)], 2,
                             conf_thresh=0.01, iou_aware=False)
        np.testing.assert_allclose(s2.numpy()[0, 0, 0], sig(0.7) * sig(2.0),
                                   rtol=1e-5)
        np.testing.assert_allclose(boxes.numpy(), b2.numpy(), rtol=1e-5)

    def test_distribute_fpn_and_psroi(self):
        rois = _t(np.array([[0, 0, 20, 20], [0, 0, 220, 220],
                            [0, 0, 500, 500]], np.float32))
        outs, restore, nums = TO.distribute_fpn_proposals(rois, 2, 5, 4, 224)
        sizes = [int(n.numpy()[0]) for n in nums]
        assert sum(sizes) == 3 and sizes[0] >= 1 and sizes[-1] >= 1
        cat = np.concatenate([o.numpy() for o in outs if o.shape[0]])
        np.testing.assert_allclose(cat[restore.numpy()], rois.numpy())
        x = np.zeros((1, 4, 4, 4), np.float32)
        for c in range(4):
            x[0, c] = c
        out = TO.psroi_pool(_t(x), _t(np.array([[0, 0, 3, 3]], np.float32)),
                            _t(np.array([1], np.int32)), 2).numpy()
        np.testing.assert_allclose(out[0, 0].reshape(-1), [0, 1, 2, 3])

    def test_generate_proposals(self):
        rng = np.random.RandomState(3)
        N, A, H, W = 1, 3, 4, 4
        scores = rng.rand(N, A, H, W).astype(np.float32)
        deltas = (rng.randn(N, 4 * A, H, W) * 0.1).astype(np.float32)
        anchors = _anchors(H, W, A)
        rois, probs, num = TO.generate_proposals(
            _t(scores), _t(deltas), _t(np.array([[32, 32]], np.float32)),
            _t(anchors), _t(np.ones_like(anchors)), pre_nms_top_n=20,
            post_nms_top_n=5, nms_thresh=0.7, min_size=1.0,
            return_rois_num=True)
        r = rois.numpy()
        assert r.shape[1] == 4 and 1 <= r.shape[0] <= 5
        assert int(num.numpy()[0]) == r.shape[0]
        assert (r[:, 0] >= 0).all() and (r[:, 2] <= 32).all()
        assert (r[:, 2] > r[:, 0]).all() and (r[:, 3] > r[:, 1]).all()
        assert (np.diff(probs.numpy().ravel()) <= 1e-6).all()

    def test_deform_layer_matches_functional(self):
        port.seed(71)
        rng = np.random.RandomState(0)
        layer = TO.DeformConv2D(4, 6, 3, stride=1, padding=1,
                                deformable_groups=2)
        x = _t(rng.randn(2, 4, 8, 8).astype("float32"))
        off = _t((0.5 * rng.randn(2, 2 * 2 * 9, 8, 8)).astype("float32"))
        y = layer(x, off)
        assert list(y.shape) == [2, 6, 8, 8]
        ref = TO.deform_conv2d(x, off, layer.weight, layer.bias, stride=1,
                               padding=1, deformable_groups=2)
        np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                                   rtol=1e-6)

    def test_deform_layer_v2_mask_modulation(self):
        port.seed(72)
        rng = np.random.RandomState(1)
        layer = TO.DeformConv2D(3, 5, 3, padding=1)
        x = _t(rng.randn(1, 3, 6, 6).astype("float32"))
        off = torch.zeros(1, 18, 6, 6)
        ones, zeros = torch.ones(1, 9, 6, 6), torch.zeros(1, 9, 6, 6)
        np.testing.assert_allclose(layer(x, off, mask=ones).detach().numpy(),
                                   layer(x, off).detach().numpy(), rtol=1e-6)
        out = layer(x, off, mask=zeros).detach().numpy()
        np.testing.assert_allclose(
            out, np.broadcast_to(layer.bias.detach().numpy().reshape(
                1, -1, 1, 1), out.shape), atol=1e-6)


def test_detection_sweep_on_cpu():
    """``chip_smoke.py`` phase 6f(b)'s sweep (``parity.detection_parity``)
    at ``DETECTION_SMALL`` with the CPU standing in for the card: every
    case runs, compares and reports."""
    from paddle_tpu_torch.experiments import parity

    out = parity.detection_parity("cpu", parity.DETECTION_SMALL)
    assert out["prior_box"]["priors"] == 8732
    assert out["nms"]["kept"] > 0 and out["nms_categories"]["kept"] <= 30
    assert [lv["level"] for lv in out["fpn"]["levels"]] == [2, 3, 4, 5]
    assert "grad_max_rel_norm_err" in out["deform_conv2d_8x7x9"]
