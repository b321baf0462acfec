"""``vision.ops``: the detection operators (counterpart of
``paddle_tpu/vision/ops.py``).

Plain PyTorch on the device of the inputs (numpy inputs go to the port's
current device); autograd gives the gradients, as JAX's autodiff does for
the reference. None of these reaches a hand-written kernel: the reference
has no Pallas kernel here either. The stages whose output size depends on
the data run on the host, as in the reference: the greedy sweep of
``nms`` (over a suppression matrix built once on the device),
``distribute_fpn_proposals``, ``generate_proposals`` (numpy, with ``nms``
on the device) and ``prior_box``'s geometry.

The reference's arithmetic is the spec, behaviours included:

- ``nms`` returns int32 indices (JAX runs without x64); ``scores=None``
  ranks boxes by descending index; categories are kept apart by the offset
  ``(max + 1) * category`` (``categories`` is ignored); ``top_k`` slices
  after the sweep. A later box is suppressed when its IoU with a kept box,
  ``inter / max(area_i + area_j - inter, 1e-10)`` in fp32, exceeds the
  threshold.
- ``roi_align`` takes its adaptive ``sampling_ratio`` from the largest RoI
  in the call, so one RoI's output depends on the others; sample points
  are clipped to the image (not zeroed outside it); with
  ``aligned=False`` the RoI size is floored at 1 px.
- ``roi_pool`` is the max over a 2 x 2 grid of nearest-pixel samples in
  each bin, not over the whole bin.
- ``psroi_pool`` averages the pixels whose index lies in [floor(start),
  ceil(end)) of each bin (computed here from an fp64 integral image).
- ``box_coder`` decodes any 3-D target whatever ``code_type`` says;
  encoding pairs targets and priors row by row.
- ``yolo_box`` zeroes low-confidence boxes and scores instead of dropping
  them; with ``iou_aware`` the confidence is ``conf^(1-f) * iou^f``.
- ``distribute_fpn_proposals`` ignores ``rois_num``.
- ``generate_proposals`` raises for ``eta != 1``, clamps ``min_size`` to
  at least 1 px, takes the pre-NMS top-N by raw score before decoding and
  clips the ``exp`` inputs at ``log(1000 / 16)``.
- ``deform_conv2d`` lays offsets out (y, x) per tap, reads 0 at each
  bilinear corner outside the image, and takes ``bias`` before ``mask``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, resolve_device
from ..nn import initializer as I
from ..nn.functional import _div
from ..nn.layer.layers import Layer

__all__ = ["nms", "box_iou", "roi_align", "roi_pool", "box_coder",
           "box_area", "prior_box", "yolo_box", "distribute_fpn_proposals",
           "psroi_pool", "deform_conv2d", "DeformConv2D",
           "generate_proposals"]

# RoIs gathered at once by roi_align / roi_pool: at most this many
# sampled values (RoIs x sample rows x sample columns x channels) a chunk
_CHUNK_ELEMS = 1 << 26
# suppression-matrix rows nms builds at once
_NMS_ROWS = 2048


def _device(*xs):
    """The device of the first tensor among ``xs``, else the current
    device."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(get_device())


def _tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device) if dtype is None else x.to(device, dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _host(x, dtype=None):
    """``x`` as numpy (one device read for a card tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def box_area(boxes, name=None):
    b = _tensor(boxes, _device(boxes))
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def box_iou(boxes1, boxes2, name=None):
    """Pairwise IoU ``[N, M]`` of xyxy boxes."""
    dev = _device(boxes1, boxes2)
    a, b = _tensor(boxes1, dev), _tensor(boxes2, dev)
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area1[:, None] + area2[None, :] - inter,
                               min=1e-10)


def _suppression(bs, iou_threshold):
    """Rows of the upper-triangular ``iou > iou_threshold`` matrix of the
    sorted boxes ``bs`` (row i: the later boxes box i suppresses), built
    on the device ``_NMS_ROWS`` rows at a time and read to the host once."""
    n = bs.shape[0]
    areas = (bs[:, 2] - bs[:, 0]) * (bs[:, 3] - bs[:, 1])
    col = torch.arange(n, device=bs.device)
    rows = []
    for s in range(0, n, _NMS_ROWS):
        r = bs[s:s + _NMS_ROWS]
        lt = torch.maximum(r[:, None, :2], bs[None, :, :2])
        rb = torch.minimum(r[:, None, 2:], bs[None, :, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / torch.clamp(areas[s:s + _NMS_ROWS, None]
                                  + areas[None, :] - inter, min=1e-10)
        rows.append((iou > iou_threshold)
                    & (col[None, :] > col[s:s + _NMS_ROWS, None]))
    return torch.cat(rows).cpu().numpy()


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS: the kept indices (int32) in descending score order."""
    dev = _device(boxes, scores)
    bv = _tensor(boxes, dev)
    n = bv.shape[0]
    sv = (_tensor(scores, dev) if scores is not None
          else torch.arange(n, 0, -1, dtype=torch.float32, device=dev))
    if category_idxs is not None:
        cv = _tensor(category_idxs, dev).to(bv.dtype)
        bv = bv + ((bv.max() + 1.0) * cv)[:, None]
    order = torch.argsort(-sv, stable=True)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    sup = _suppression(bv[order], iou_threshold)
    keep = np.ones(n, bool)
    for i in range(n):  # the sweep, in score order
        if keep[i]:
            keep &= ~sup[i]
    kept = order[torch.from_numpy(keep).to(dev)]
    if top_k is not None:
        kept = kept[:top_k]
    return kept.to(torch.int32)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _image_ids(boxes_num, dev):
    bn = _host(boxes_num).reshape(-1).astype(np.int64)
    return torch.as_tensor(np.repeat(np.arange(len(bn)), bn), device=dev)


def _gather_rows(x, ids, ys, xs):
    """``x[ids[r], :, ys[r, p], xs[r, q]]`` as ``[R, P, Q, C]``."""
    return x[ids[:, None, None], :, ys[:, :, None], xs[:, None, :]]


def _chunks(R, per_roi):
    step = max(1, _CHUNK_ELEMS // max(1, per_roi))
    return range(0, R, step), step


def _adaptive_sampling_ratio(boxes, output_size, spatial_scale=1.0):
    """``roi_align``'s sampling ratio for ``sampling_ratio <= 0``: the
    tallest and the widest RoI of the whole call over the output size,
    rounded up (so one RoI's output depends on the others)."""
    oh, ow = _pair(output_size)
    sizes = _host(boxes, np.float32)
    max_h = float(np.max(sizes[:, 3] - sizes[:, 1])) * spatial_scale
    max_w = float(np.max(sizes[:, 2] - sizes[:, 0])) * spatial_scale
    return max(1, int(np.ceil(max(max_h / oh, max_w / ow))))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: x ``[N, C, H, W]``; boxes ``[R, 4]`` (xyxy, input-image
    coordinates); ``boxes_num`` RoIs per image. Each bin is the mean of
    ``sampling_ratio`` x ``sampling_ratio`` bilinear samples."""
    oh, ow = _pair(output_size)
    dev = _device(x, boxes)
    x, bv = _tensor(x, dev), _tensor(boxes, dev)
    ids = _image_ids(boxes_num, dev)
    sr = (int(sampling_ratio) if sampling_ratio > 0 else
          _adaptive_sampling_ratio(boxes, (oh, ow), spatial_scale))
    N, C, H, W = x.shape
    R = bv.shape[0]
    off = 0.5 if aligned else 0.0
    floor_sz = 1e-3 if aligned else 1.0
    ty = (torch.arange(oh * sr, dtype=torch.float32, device=dev) + 0.5)
    tx = (torch.arange(ow * sr, dtype=torch.float32, device=dev) + 0.5)
    starts, step = _chunks(R, oh * sr * ow * sr * C)
    outs = []
    for s in starts:
        b, idc = bv[s:s + step], ids[s:s + step]
        x1 = b[:, 0] * spatial_scale - off
        y1 = b[:, 1] * spatial_scale - off
        rw = torch.clamp(b[:, 2] * spatial_scale - off - x1, min=floor_sz)
        rh = torch.clamp(b[:, 3] * spatial_scale - off - y1, min=floor_sz)
        yy = y1[:, None] + _div(rh[:, None] * ty[None, :], oh * sr)
        xx = x1[:, None] + _div(rw[:, None] * tx[None, :], ow * sr)
        y0 = torch.clamp(torch.floor(yy), 0, H - 1)
        x0 = torch.clamp(torch.floor(xx), 0, W - 1)
        y1i = torch.clamp(y0 + 1, 0, H - 1)
        x1i = torch.clamp(x0 + 1, 0, W - 1)
        wy = (torch.clamp(yy, 0, H - 1) - y0)[:, :, None, None]
        wx = (torch.clamp(xx, 0, W - 1) - x0)[:, None, :, None]
        y0, x0, y1i, x1i = (t.long() for t in (y0, x0, y1i, x1i))

        def g(yi, xi):
            return _gather_rows(x, idc, yi, xi)
        v = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1i, x0) * wy * (1 - wx)
             + g(y0, x1i) * (1 - wy) * wx + g(y1i, x1i) * wy * wx)
        r = v.shape[0]
        outs.append(v.reshape(r, oh, sr, ow, sr, C).mean((2, 4))
                    .permute(0, 3, 1, 2))
    if not outs:
        return x.new_zeros((0, C, oh, ow))
    return torch.cat(outs)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool: the max over a 2 x 2 grid of nearest-pixel samples in each
    bin (the RoI at least 1 px a side)."""
    oh, ow = _pair(output_size)
    dev = _device(x, boxes)
    x, bv = _tensor(x, dev), _tensor(boxes, dev)
    ids = _image_ids(boxes_num, dev)
    N, C, H, W = x.shape
    R, sr = bv.shape[0], 2
    ty = (torch.arange(oh * sr, dtype=torch.float32, device=dev) + 0.5)
    tx = (torch.arange(ow * sr, dtype=torch.float32, device=dev) + 0.5)
    starts, step = _chunks(R, oh * sr * ow * sr * C)
    outs = []
    for s in starts:
        b, idc = bv[s:s + step], ids[s:s + step]
        x1 = b[:, 0] * spatial_scale
        y1 = b[:, 1] * spatial_scale
        x2 = torch.maximum(b[:, 2] * spatial_scale, x1 + 1)
        y2 = torch.maximum(b[:, 3] * spatial_scale, y1 + 1)
        ys = torch.clamp(y1[:, None] + _div(
            (y2 - y1)[:, None] * ty[None, :], oh * sr), 0, H - 1).long()
        xs = torch.clamp(x1[:, None] + _div(
            (x2 - x1)[:, None] * tx[None, :], ow * sr), 0, W - 1).long()
        v = _gather_rows(x, idc, ys, xs)
        r = v.shape[0]
        outs.append(v.reshape(r, oh, sr, ow, sr, C).amax((2, 4))
                    .permute(0, 3, 1, 2))
    if not outs:
        return x.new_zeros((0, C, oh, ow))
    return torch.cat(outs)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): x has ``out_c * ph * pw``
    channels, and bin (i, j) of each RoI averages its own channel group
    ``c * ph * pw + i * pw + j`` over the pixels it covers."""
    ph, pw = _pair(output_size)
    dev = _device(x, boxes)
    x, bv = _tensor(x, dev), _tensor(boxes, dev)
    ids = _image_ids(boxes_num, dev)
    N, C, H, W = x.shape
    out_c = C // (ph * pw)
    x0 = bv[:, 0] * spatial_scale
    y0 = bv[:, 1] * spatial_scale
    x1 = bv[:, 2] * spatial_scale
    y1 = bv[:, 3] * spatial_scale
    rw = torch.clamp(x1 - x0, min=0.1)
    rh = torch.clamp(y1 - y0, min=0.1)
    i = torch.arange(ph, dtype=torch.float32, device=dev)
    j = torch.arange(pw, dtype=torch.float32, device=dev)
    # each bin's pixel rows [h0, h1) and columns [w0, w1), within the image
    h0 = torch.floor(y0[:, None] + _div(rh[:, None] * i, ph)).clamp(0, H)
    h1 = torch.ceil(y0[:, None] + _div(rh[:, None] * (i + 1), ph)).clamp(0, H)
    w0 = torch.floor(x0[:, None] + _div(rw[:, None] * j, pw)).clamp(0, W)
    w1 = torch.ceil(x0[:, None] + _div(rw[:, None] * (j + 1), pw)).clamp(0, W)
    h1, w1 = torch.maximum(h1, h0), torch.maximum(w1, w0)
    cnt = torch.clamp((h1 - h0)[:, :, None] * (w1 - w0)[:, None, :], min=1)
    # rectangle sums from an fp64 integral image [N, C, H + 1, W + 1]
    S = torch.nn.functional.pad(x.double().cumsum(2).cumsum(3), (1, 0, 1, 0))
    h0, h1, w0, w1 = (t.long() for t in (h0, h1, w0, w1))
    chan = (torch.arange(out_c, device=dev)[:, None, None] * (ph * pw)
            + torch.arange(ph, device=dev)[None, :, None] * pw
            + torch.arange(pw, device=dev)[None, None, :])  # [out_c, ph, pw]
    base = ((ids[:, None, None, None] * C + chan[None]) * (H + 1))

    def at(h, w):  # S at rows h [R, ph] and columns w [R, pw]
        return (base + h[:, None, :, None]) * (W + 1) + w[:, None, None, :]
    flat = S.reshape(-1)
    total = (flat[at(h1, w1)] - flat[at(h0, w1)] - flat[at(h1, w0)]
             + flat[at(h0, w0)])
    return total.to(x.dtype) / cnt[:, None].to(x.dtype)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode or decode boxes against priors (center-size form); a 3-D
    target ``[N, M, 4]`` decodes with the priors broadcast along
    ``axis``."""
    dev = _device(target_box, prior_box, prior_box_var)
    pb = _tensor(prior_box, dev)
    pbv = _tensor(prior_box_var, dev, pb.dtype)
    tb = _tensor(target_box, dev)
    norm = 0.0 if box_normalized else 1.0
    if tb.dim() == 3:
        exp_axis = 1 if axis == 0 else 0
        pb = pb.unsqueeze(exp_axis)
        pbv = pbv.unsqueeze(exp_axis)
        pw = pb[..., 2] - pb[..., 0] + norm
        ph = pb[..., 3] - pb[..., 1] + norm
        pcx = pb[..., 0] + pw / 2
        pcy = pb[..., 1] + ph / 2
        d = tb * pbv
        cx = d[..., 0] * pw + pcx
        cy = d[..., 1] * ph + pcy
        w = torch.exp(d[..., 2]) * pw
        h = torch.exp(d[..., 3]) * ph
        return torch.stack([cx - w / 2, cy - h / 2,
                            cx + w / 2 - norm, cy + h / 2 - norm], dim=-1)
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=1)
        return out / pbv
    d = tb * pbv
    cx = d[:, 0] * pw + pcx
    cy = d[:, 1] * ph + pcy
    w = torch.exp(d[:, 2]) * pw
    h = torch.exp(d[:, 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2,
                        cx + w / 2 - norm, cy + h / 2 - norm], dim=1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD priors of one feature map, from its shape alone (computed on
    the host): per cell one box per (min size, aspect ratio) and the
    sqrt(min * max) box; returns (boxes ``[H, W, P, 4]`` normalized to the
    image, variances of the same shape) on the input's device."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        ms = float(ms)
        ar_boxes = [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars]
        max_box = []
        if max_sizes:
            big = np.sqrt(ms * float(max_sizes[ms_i]))
            max_box = [(big, big)]
        if min_max_aspect_ratios_order:  # (min, max, the other ratios)
            boxes += [ar_boxes[0]] + max_box + ar_boxes[1:]
        else:
            boxes += ar_boxes + max_box
    P = len(boxes)
    cx = (np.arange(fw) + offset) * step_w
    cy = (np.arange(fh) + offset) * step_h
    out = np.zeros((fh, fw, P, 4), np.float32)
    for p, (bw, bh) in enumerate(boxes):
        out[:, :, p, 0] = (cx[None, :] - bw / 2) / iw
        out[:, :, p, 1] = (cy[:, None] - bh / 2) / ih
        out[:, :, p, 2] = (cx[None, :] + bw / 2) / iw
        out[:, :, p, 3] = (cy[:, None] + bh / 2) / ih
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape).copy()
    dev = _device(input, image)
    return torch.from_numpy(out).to(dev), torch.from_numpy(var).to(dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode one YOLOv3 head: x ``[N, A * (5 + C), H, W]`` (with
    ``iou_aware``, A IoU logits first) -> (boxes ``[N, A * H * W, 4]``
    xyxy in image pixels, scores ``[N, A * H * W, C]``), rows in (A, H,
    W) order."""
    dev = _device(x)
    xv = _tensor(x, dev)
    img = _tensor(img_size, dev)
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    A = anchors.shape[0]
    N, _, H, W = xv.shape
    if iou_aware:
        iou = torch.sigmoid(xv[:, :A].reshape(N, A, H, W))
        xv = xv[:, A:]
    v = xv.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    sig = torch.sigmoid
    bx = _div(sig(v[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2 + gx, W)
    by = _div(sig(v[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2 + gy, H)
    a = torch.from_numpy(anchors).to(dev)
    aw = a[:, 0][None, :, None, None]
    ah = a[:, 1][None, :, None, None]
    bw = _div(torch.exp(v[:, :, 2]) * aw, W * downsample_ratio)
    bh = _div(torch.exp(v[:, :, 3]) * ah, H * downsample_ratio)
    conf = sig(v[:, :, 4])
    if iou_aware:
        f = torch.tensor(iou_aware_factor, dtype=torch.float32, device=dev)
        conf = torch.pow(conf, 1.0 - f) * torch.pow(iou, f)
    cls = sig(v[:, :, 5:]) * conf[:, :, None]
    ih = img[:, 0].float()[:, None, None, None]
    iw = img[:, 1].float()[:, None, None, None]
    x0 = (bx - bw / 2) * iw
    y0 = (by - bh / 2) * ih
    x1 = (bx + bw / 2) * iw
    y1 = (by + bh / 2) * ih
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x0 = torch.clamp(x0, zero, iw - 1)
        y0 = torch.clamp(y0, zero, ih - 1)
        x1 = torch.clamp(x1, zero, iw - 1)
        y1 = torch.clamp(y1, zero, ih - 1)
    keep = conf >= conf_thresh
    boxes = (torch.stack([x0, y0, x1, y1], dim=-1) * keep[..., None]
             ).reshape(N, -1, 4)
    scores = (cls * keep[:, :, None]).permute(0, 1, 3, 4, 2).reshape(
        N, -1, class_num)
    return boxes, scores


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels, ``floor(refer_level + log2(sqrt(area) /
    refer_scale))`` clipped to [min_level, max_level], on the host: (the
    RoIs of each level, the index that restores the input order from
    their concatenation, each level's count)."""
    dev = _device(fpn_rois)
    rois = _host(fpn_rois, np.float32)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-12))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-12))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, nums, order = [], [], []
    for L in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == L)[0]
        order.append(idx)
        outs.append(torch.from_numpy(rois[idx]).to(dev))
        nums.append(torch.tensor([len(idx)], dtype=torch.int32, device=dev))
    concat_order = np.concatenate(order) if order else np.zeros((0,))
    restore = np.argsort(concat_order).astype(np.int64)
    return outs, torch.from_numpy(restore).to(dev), nums


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1, or v2 with ``mask`` ``[N, dg * kh * kw,
    Ho, Wo]``: each tap sampled bilinearly at its offset position
    (``offset`` ``[N, dg * kh * kw * 2, Ho, Wo]``, y then x), then one
    grouped contraction with ``weight``."""
    sh, sw = _pair(stride)
    ph_, pw_ = _pair(padding)
    dh, dw = _pair(dilation)
    dev = _device(x, offset, weight)
    xv, ov, wv = (_tensor(t, dev) for t in (x, offset, weight))
    N, C, H, W = xv.shape
    Co, Cg, kh, kw = wv.shape
    Ho = (H + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    K = kh * kw
    dg = deformable_groups
    ar = torch.arange
    oy = ar(Ho, device=dev) * sh - ph_
    ox = ar(Wo, device=dev) * sw - pw_
    ky = ar(kh, device=dev) * dh
    kx = ar(kw, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        Ho, Wo, kh, kw).reshape(Ho, Wo, K).float()
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        Ho, Wo, kh, kw).reshape(Ho, Wo, K).float()
    off = ov.reshape(N, dg, K, 2, Ho, Wo)
    sy = base_y[None, None] + off[:, :, :, 0].permute(0, 1, 3, 4, 2)
    sx = base_x[None, None] + off[:, :, :, 1].permute(0, 1, 3, 4, 2)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    flat = xv.reshape(N, dg, C // dg, H * W)

    def gather(yy, xx):  # [N, dg, C/dg, Ho, Wo, K], 0 outside the image
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(
            N, dg, 1, -1)
        g = torch.gather(flat, 3, idx.expand(N, dg, C // dg, idx.shape[-1]))
        return g.reshape(N, dg, C // dg, Ho, Wo, K) * valid[:, :, None]
    samp = 0.0
    for dy, wyy in ((0, 1 - wy), (1, wy)):
        for dx, wxx in ((0, 1 - wx), (1, wx)):
            g = gather((y0 + dy).long(), (x0 + dx).long())
            samp = samp + g * (wyy * wxx)[:, :, None]
    if mask is not None:
        mval = _tensor(mask, dev).reshape(N, dg, K, Ho, Wo).permute(
            0, 1, 3, 4, 2)
        samp = samp * mval[:, :, None]
    samp = samp.reshape(N, C, Ho, Wo, K).permute(0, 1, 4, 2, 3)
    sampg = samp.reshape(N, groups, C // groups, K, Ho, Wo)
    wg = wv.reshape(groups, Co // groups, Cg, K)
    out = torch.einsum("ngckhw,gock->ngohw", sampg, wg).reshape(N, Co, Ho,
                                                                Wo)
    if bias is not None:
        out = out + _tensor(bias, dev).reshape(1, -1, 1, 1)
    return out


class DeformConv2D(Layer):
    """Layer form of ``deform_conv2d``: owns the weight ``[out, in /
    groups, kh, kw]`` and bias (both uniform in +-1/sqrt(fan_in)), takes
    the offset (and the v2 mask) each call."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 stride=1, padding=0, dilation=1, deformable_groups=1,
                 groups=1, weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        k = 1.0 / np.sqrt(fan_in) if fan_in else 1.0
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, ks[0], ks[1]],
            attr=weight_attr, default_initializer=I.Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-k, k))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            deformable_groups=self._deformable_groups,
            groups=self._groups, mask=mask)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals, per image on the host: the pre-NMS top-N anchors by
    score, their deltas decoded and clipped to the image, boxes under
    ``min_size`` dropped, ``nms`` on the device, the post-NMS top-N kept.
    scores ``[N, A, H, W]``; bbox_deltas ``[N, 4 * A, H, W]``; img_size
    ``[N, 2]`` (h, w); anchors and variances ``[H, W, A, 4]`` or ``[H * W
    * A, 4]``. Returns (rois ``[R, 4]``, probabilities ``[R, 1]``) over the
    batch, and each image's count with ``return_rois_num``."""
    if eta != 1.0:
        raise NotImplementedError(
            "generate_proposals: adaptive-threshold NMS (eta < 1.0) is not "
            "implemented; pass eta=1.0 (a fixed nms_thresh)")
    dev = _device(scores, bbox_deltas)
    sv = _host(scores, np.float32)
    dv = _host(bbox_deltas, np.float32)
    iszv = _host(img_size, np.float32)
    av = _host(anchors, np.float32).reshape(-1, 4)
    varv = _host(variances, np.float32).reshape(-1, 4)
    N, A, H, W = sv.shape
    off = 1.0 if pixel_offset else 0.0
    min_size = max(float(min_size), 1.0)
    all_rois, all_probs, nums = [], [], []
    for n in range(N):
        # rows in (H, W, A) order, the anchors' layout
        s = sv[n].transpose(1, 2, 0).reshape(-1)
        d = dv[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:int(pre_nms_top_n)]
        s, d, a_sel, v_sel = s[order], d[order], av[order], varv[order]
        aw = a_sel[:, 2] - a_sel[:, 0] + off
        ah = a_sel[:, 3] - a_sel[:, 1] + off
        acx = a_sel[:, 0] + 0.5 * aw
        acy = a_sel[:, 1] + 0.5 * ah
        dx, dy, dw, dh = (d[:, 0] * v_sel[:, 0], d[:, 1] * v_sel[:, 1],
                          d[:, 2] * v_sel[:, 2], d[:, 3] * v_sel[:, 3])
        cx = dx * aw + acx
        cy = dy * ah + acy
        bw = np.exp(np.minimum(dw, np.log(1000.0 / 16.0))) * aw
        bh = np.exp(np.minimum(dh, np.log(1000.0 / 16.0))) * ah
        boxes = np.stack([cx - 0.5 * bw, cy - 0.5 * bh,
                          cx + 0.5 * bw - off, cy + 0.5 * bh - off], 1)
        h_img, w_img = iszv[n, 0], iszv[n, 1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w_img - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h_img - off)
        ws = boxes[:, 2] - boxes[:, 0] + off
        hs = boxes[:, 3] - boxes[:, 1] + off
        keep = (ws >= min_size) & (hs >= min_size)
        if pixel_offset:  # the box's centre must lie inside the image
            keep &= ((boxes[:, 0] + 0.5 * ws <= w_img)
                     & (boxes[:, 1] + 0.5 * hs <= h_img))
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            kept = nms(torch.from_numpy(boxes.astype(np.float32)).to(dev),
                       iou_threshold=nms_thresh,
                       scores=torch.from_numpy(s.astype(np.float32)).to(dev))
            ki = kept.cpu().numpy()[:int(post_nms_top_n)]
            boxes, s = boxes[ki], s[ki]
        all_rois.append(boxes)
        all_probs.append(s[:, None])
        nums.append(len(boxes))
    rois = np.concatenate(all_rois, 0).astype(np.float32) if all_rois \
        else np.zeros((0, 4), np.float32)
    probs = np.concatenate(all_probs, 0).astype(np.float32) if all_probs \
        else np.zeros((0, 1), np.float32)
    out = (torch.from_numpy(rois).to(dev), torch.from_numpy(probs).to(dev))
    if return_rois_num:
        return out + (torch.tensor(nums, dtype=torch.int32, device=dev),)
    return out
