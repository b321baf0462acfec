"""The vision and quantization slice on a device (``chip_smoke.py`` phase
6f (a) and (c); (b) is ``parity.detection_parity``).

- ``flowers_fit``: ``vision.recipes``' Flowers-102 fine-tuning through
  ``Model.fit``: first a few steps on one batch through the flat update
  and through its plain version (the losses, parameters and statistics
  agree, and the loss falls); then one epoch with a serial loader and one
  with worker threads: images/s, ms a step, the loader's and
  ``train_batch``'s ms a batch, the launches a step against the
  optimizer's flat groups, the busy share of a profiled run and the
  evaluation accuracy; the serial epoch's batches, as the card received
  them, against the same epoch's transforms run again on the CPU under
  the same seed (bit for bit).
- ``qat_bert``: QAT at BERT-base width (every ``Linear`` of the eager
  encoder and its head under ``FakeQuanterWithAbsMax``), timed steps with
  their launches and device reads, ``convert`` to ``Int8Linear`` and an
  int8 forward against the fp32 one and against the same converted model
  on the CPU, layer by layer (``_against_cpu``); then PTQ
  (``AbsmaxObserver``, a few calibration batches) and its int8 logits
  against the fp32 model's.

Each takes the caller's launch counters (``counts``: a pair of functions
that zero and read them) and profiler (``profile(run)``: a dict with
``device_ms`` and ``wall_ms``, or None); with ``counts=None`` nothing is
counted (a CPU rehearsal).
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
import warnings
from unittest import mock

import numpy as np
import torch

from .. import quantization as Q
from ..device import get_device, resolve_device, set_device
from ..hapi import model as hapi_model
from ..hapi.callbacks import Callback
from ..io import DataLoader
from ..nn import CrossEntropyLoss, Linear
from ..nn.initializer import seed as seed_all
from ..ops.kernels import multi_tensor_update as mtu
from ..vision.datasets import Flowers
from ..vision.recipes import FLOWERS_BATCH, flowers_model, flowers_transforms
from .parity import _timed

__all__ = ["flowers_fit", "qat_bert", "SYNC_WARNING"]

SYNC_WARNING = "called a synchronizing CUDA operation"
# 6f(a): the shuffles' and transforms' seed, the untimed warm steps (cuDNN's
# algorithm choices, the first launches), the loaders' worker threads and
# the profiled steps
FIT_SEED, WARM_STEPS, WORKERS, PROFILED_STEPS = 0, 2, (0, 4), 2
# 6f(a): the flat update against its plain version, ``PLAIN_STEPS`` steps
# from the seed's weights on one batch under deterministic cuDNN: the same
# arithmetic on both paths, so the losses within ``LOSS_ATOL`` and each
# parameter and BN statistic within the update's tolerance by dtype (the
# tolerance phase 2 of chip_smoke.py holds the kernel to)
PLAIN_STEPS, LOSS_ATOL = 3, 1e-3
UPDATE_TOL = {torch.float32: (1e-6, 1e-7), torch.bfloat16: (2.0 ** -7, 1e-7)}
# 6f(c): timed QAT steps, PTQ's calibration batches, and the rows the CPU
# runs of the converted model
QAT_STEPS, CALIB_BATCHES, CPU_ROWS = 3, 4, 1
# 6f(c), the converted model on the device against the CPU. With the
# device's codes fed to it, the CPU's int32 accumulators and logits equal
# the device's bit for bit. Its own codes differ from the device's where
# an fp32 input lies within rounding of a code boundary: one step at most
# (``CODE_STEP``), in at most ``FLIP_SHARE`` of a layer's codes; and these
# flips, cascading through the layers, move the logits by at most
# ``LOGIT_ERR`` of their largest magnitude. At BERT-base width on an H100
# the largest share read 4.07e-5 (69 of 42.9 M codes) and the logits
# moved 1.73e-2 of it (2.07e-2 of 1.20); the bounds are ten and three
# times those readings
CODE_STEP, FLIP_SHARE, LOGIT_ERR = 1, 4e-4, 0.05


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class _Recorder(Callback):
    """Each batch's loss, and the loader's seconds before it (from the end
    of one batch to the start of the next)."""

    def on_epoch_begin(self, epoch, logs=None):
        self.loader_s, self.losses = [], []
        self._t = time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        self.loader_s.append(time.perf_counter() - self._t)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        self._t = time.perf_counter()


def _check(counts, want, what):
    if counts is None:
        return {}
    n = counts[1]()
    for k, c in n.items():
        if c != want.get(k, 0):
            raise AssertionError(f"{k}: {c} launches, wanted "
                                 f"{want.get(k, 0)} ({what})")
    return n


def _zero(counts):
    if counts is not None:
        counts[0]()


def _syncs(dev, fn):
    """The synchronising calls ``fn()`` makes, as
    ``set_sync_debug_mode("warn")`` reports them (None off the card)."""
    if dev.type != "cuda":
        fn()
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def flowers_fit(counts=None, profile=None, train_size=None, test_size=None,
                size=224, resize=256, batch=FLOWERS_BATCH):
    """Phase 6f(a), at the recipe's widths unless the sizes say otherwise
    (the CPU test's). Returns ``(report, {run: launches})``; raises if the
    flat update departs from its plain version or the loss on one batch
    does not fall (``_vs_plain``), a step launches other than one flat
    update a group, a loss is not finite, or the serial epoch's batches
    differ from their CPU replay."""
    seed = FIT_SEED
    dev = resolve_device(get_device())
    t_start, secs = time.perf_counter(), {}

    def mark(name):
        secs[name] = round(time.perf_counter() - t_start, 2)
    train = Flowers(mode="train", synthetic_size=train_size,
                    transform=flowers_transforms(True, size, resize))
    test = Flowers(mode="test", synthetic_size=test_size,
                   transform=flowers_transforms(False, size, resize))
    vs_plain = _vs_plain(train, batch, seed, counts)
    mark("against_plain")
    seed_all(seed)
    model, opt = flowers_model()
    np.random.seed(seed + 1)
    model.fit(train, batch_size=batch, epochs=1, num_iters=WARM_STEPS,
              verbose=0)
    _sync(dev)
    mark("built_and_warm")
    batches = math.ceil(len(train) / batch)
    report, launches, captured = {"batches": batches, "batch": batch,
                                  "images": len(train),
                                  "flat_groups": len(opt._plans),
                                  "against_plain": vs_plain}, {}, []
    real = hapi_model._as_tensor_batch

    def capture(data, device):
        out = real(data, device)
        captured.append([t.clone() for t in out])
        return out
    for nw in WORKERS:
        rec = _Recorder()
        step_s, inner = [], model.train_batch

        def train_batch(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                step_s.append(time.perf_counter() - t0)
        model.train_batch = train_batch
        np.random.seed(seed)
        spy = (mock.patch.object(hapi_model, "_as_tensor_batch", capture)
               if nw == 0 else contextlib.nullcontext())
        _sync(dev)
        _zero(counts)
        t0 = time.perf_counter()
        with spy:
            model.fit(train, batch_size=batch, epochs=1, num_workers=nw,
                      verbose=0, callbacks=[rec])
        _sync(dev)
        wall = time.perf_counter() - t0
        del model.train_batch
        n = _check(counts, {"multi_tensor_update": batches * len(opt._plans)},
                   f"the Flowers epoch with {nw} workers")
        if len(rec.losses) != batches or not all(
                math.isfinite(v) for v in rec.losses):
            raise AssertionError(f"Flowers epoch ({nw} workers): losses "
                                 f"{rec.losses}")
        report[f"workers_{nw}"] = {
            "wall_s": wall, "images_per_s": len(train) / wall,
            "ms_per_step": 1e3 * wall / batches,
            "loader_ms_per_batch": 1e3 * sum(rec.loader_s) / batches,
            "train_batch_ms_per_batch": 1e3 * sum(step_s) / batches,
            "launches_per_step": (n.get("multi_tensor_update", 0) / batches
                                  if counts else None),
            "first_loss": rec.losses[0], "last_loss": rec.losses[-1]}
        launches[f"flowers_fit_workers_{nw}"] = n
        mark(f"workers_{nw}")
    report["replayed_on_cpu"] = _replay(train, batch, seed, captured)
    mark("replayed")
    if profile is not None:
        prof = profile(lambda: model.fit(train, batch_size=batch, epochs=1,
                                         num_iters=PROFILED_STEPS,
                                         verbose=0))
        if prof is not None:
            report.update(
                profiled_steps=PROFILED_STEPS,
                device_ms_per_step=prof["device_ms"] / PROFILED_STEPS,
                profiled_wall_ms_per_step=prof["wall_ms"] / PROFILED_STEPS,
                device_busy_share=prof["device_ms"] / prof["wall_ms"],
                device_split_ms=prof.get("split_ms"),
                device_top=prof.get("top", [])[:6])
        mark("profiled")
    logs = model.evaluate(test, batch_size=batch, verbose=0)
    if not (0.0 <= logs["acc"] <= 1.0 and math.isfinite(logs["loss"])):
        raise AssertionError(f"Flowers evaluate: {logs}")
    report["eval"] = logs
    mark("evaluated")
    report["seconds_to_end_of"] = secs
    return report, launches


def _vs_plain(train, batch, seed, counts):
    """Two models from the seed's weights, ``PLAIN_STEPS`` steps each on
    the same batch (the first ``batch`` images through the training
    transforms under the seed), the second with ``multi_tensor_update``
    replaced by its plain version, under deterministic cuDNN. Raises
    unless the losses agree within ``LOSS_ATOL`` and fall on the repeated
    batch, every parameter and BN statistic agrees within ``UPDATE_TOL``,
    and (counted) the kernel run launches one update a flat group a step
    and the plain run none."""
    np.random.seed(seed)
    x, y = next(iter(DataLoader(train, batch_size=batch, shuffle=False)))
    cudnn, runs = torch.backends.cudnn.deterministic, []
    torch.backends.cudnn.deterministic = True
    try:
        for plain in (False, True):
            seed_all(seed)
            model, opt = flowers_model()
            _zero(counts)
            with (mock.patch.object(mtu, "multi_tensor_update",
                                    mtu.flat_update_plain) if plain
                  else contextlib.nullcontext()):
                losses = [model.train_batch([x], [y])[0][0]
                          for _ in range(PLAIN_STEPS)]
            _check(counts, {} if plain else {
                "multi_tensor_update": PLAIN_STEPS * len(opt._plans)},
                f"{PLAIN_STEPS} Flowers steps, "
                f"{'plain' if plain else 'kernel'} path")
            runs.append((losses, {k: v.detach().clone() for k, v in
                                  model.network.state_dict().items()}))
    finally:
        torch.backends.cudnn.deterministic = cudnn
    (lk, sk), (lp, sp) = runs
    out = {"steps": PLAIN_STEPS, "losses_kernel": lk, "losses_plain": lp,
           "loss_max_abs_err": max(abs(a - b) for a, b in zip(lk, lp)),
           "max_abs_err": max((v.float() - sp[k].float()).abs().max().item()
                              for k, v in sk.items()),
           "bit_identical": lk == lp and all(torch.equal(v, sp[k])
                                             for k, v in sk.items())}
    if not (all(math.isfinite(v) for v in lk + lp)
            and out["loss_max_abs_err"] <= LOSS_ATOL and lk[-1] < lk[0]):
        raise AssertionError(f"Flowers losses on one batch, kernel {lk} "
                             f"and plain {lp}: they must agree within "
                             f"{LOSS_ATOL} and fall")
    for k, got in sk.items():
        rtol, atol = UPDATE_TOL[got.dtype]
        torch.testing.assert_close(got, sp[k], rtol=rtol, atol=atol,
                                   msg=lambda m: f"Flowers {k}, kernel "
                                   f"against plain: {m}")
    return out


def _replay(train, batch, seed, captured):
    """The serial epoch again on the CPU under the same seed (its shuffle
    and every transform's draws): each batch equal, bit for bit, to the
    one the device received."""
    prev = set_device("cpu")
    try:
        np.random.seed(seed)
        loader = DataLoader(train, batch_size=batch, shuffle=True)
        n = 0
        for i, (x, y) in enumerate(loader):
            (cx,), (cy,) = captured[2 * i], captured[2 * i + 1]
            if not (torch.equal(cx.cpu(), x) and torch.equal(cy.cpu(), y)):
                raise AssertionError(f"Flowers batch {i}: the device's "
                                     f"batch differs from its CPU replay")
            n += 1
    finally:
        set_device(prev)
    if n != len(captured) // 2:
        raise AssertionError(f"{n} batches replayed, {len(captured) // 2} "
                             f"received")
    return {"batches": n, "bit_identical": True}


def _linears(model):
    return sum(isinstance(m, Linear) for m in model.modules())


def qat_bert(build, tokens, labels, counts=None, profile=None, layers=12):
    """Phase 6f(c) on ``build()``'s ``(model, optimizer)`` (an eager
    encoder whose ``layers`` layers attend through the fp32 flash
    kernels) at ``tokens`` / ``labels``. Returns ``(report, {run:
    launches})``."""
    dev, steps = tokens.device, QAT_STEPS
    cfg = Q.QuantConfig(activation=Q.quanter(Q.FakeQuanterWithAbsMax),
                        weight=Q.quanter(Q.FakeQuanterWithAbsMax))
    ce = CrossEntropyLoss(ignore_index=-100)
    report, launches = {}, {}

    # the fp32 forward the int8 one is held against
    ref, _ = build()
    ref.eval()
    with torch.no_grad():
        report["fp32_forward_ms"] = _timed(dev, lambda: ref(tokens))[1]
    del ref

    model, opt = build()
    n_linear = _linears(model)
    Q.QAT(cfg).quantize(model)
    quanted = sum(isinstance(m, Q.QuantedLinear) for m in model.modules())
    if quanted != n_linear or _linears(model):
        raise AssertionError(f"QAT wrapped {quanted} of {n_linear} Linear "
                             f"layers")
    report["quanted_linears"] = quanted

    def step():
        loss = ce(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    _zero(counts)
    losses = [step().item()]
    _sync(dev)
    per_step = counts[1]()["multi_tensor_update"] if counts else 0
    if counts and per_step < 1:
        raise AssertionError("the QAT step launched no multi_tensor_update")
    report["syncs_per_step"] = _syncs(dev, step)
    _sync(dev)
    _zero(counts)
    t0 = time.perf_counter()
    timed = [step() for _ in range(steps)]
    _sync(dev)
    wall = time.perf_counter() - t0
    launches["bert_qat"] = _check(counts, {
        "flash_attention_fwd_f32": layers * steps,
        "flash_attention_bwd_f32": layers * steps,
        "multi_tensor_update": per_step * steps}, f"{steps} QAT steps")
    losses += [t.item() for t in timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"QAT losses: {losses}")
    report.update(timed_steps=steps, wall_s=wall,
                  ms_per_step=1e3 * wall / steps,
                  tokens_per_s=tokens.numel() * steps / wall,
                  multi_tensor_update_per_step=per_step, losses=losses)
    if profile is not None:
        prof = profile(step)
        if prof is not None:
            report.update(device_ms_per_step=prof["device_ms"],
                          profiled_step_wall_ms=prof["wall_ms"],
                          device_busy_share=prof["device_ms"]
                          / prof["wall_ms"],
                          device_split_ms=prof.get("split_ms"),
                          device_top=prof.get("top", [])[:6])

    # convert, and the int8 forward
    model.eval()
    Q.QAT(cfg).convert(model)
    ints = sum(isinstance(m, Q.Int8Linear) for m in model.modules())
    if ints != n_linear:
        raise AssertionError(f"convert made {ints} Int8Linear of "
                             f"{n_linear}")
    _zero(counts)
    with torch.no_grad():
        logits = model(tokens)
    _sync(dev)
    launches["bert_qat_int8_forward"] = _check(counts, {
        "flash_attention_fwd_f32": layers}, "the int8 forward")
    with torch.no_grad():
        report["int8_forward_ms"] = _timed(dev, lambda: model(tokens))[1]
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite int8 logits")
    report["int8_against_cpu"] = _against_cpu(model, tokens[:CPU_ROWS])
    del model, opt, logits

    # PTQ: calibrate, convert, and the int8 logits against the fp32 ones
    model, _ = build()
    model.eval()
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.quanter(Q.AbsmaxObserver)))
    ptq.quantize(model)
    gen = np.random.RandomState(7)
    with torch.no_grad():
        for _ in range(CALIB_BATCHES - 1):
            other = torch.from_numpy(gen.permutation(
                tokens.reshape(-1).cpu().numpy()).reshape(tokens.shape)).to(
                    dev)
            model(other)
        fp32 = model(tokens)  # the last calibration batch
    ptq.convert(model)
    with torch.no_grad():
        int8 = model(tokens)
        report["ptq_int8_forward_ms"] = _timed(dev, lambda: model(tokens))[1]
    report["ptq"] = {
        "calibration_batches": CALIB_BATCHES,
        "logit_max_abs_err": float((int8 - fp32).abs().max()),
        "logit_max_abs": float(fp32.abs().max()),
        "top1_agreement": float((int8.argmax(-1) == fp32.argmax(-1))
                                .float().mean())}
    return report, launches


def _against_cpu(model, tokens):
    """The converted model on ``tokens`` on the device, every int8
    product's input codes and int32 accumulators recorded, then twice on
    the CPU: pinned, each ``Int8Linear`` fed the device's codes (its
    accumulators and the logits, which leave the last ``Int8Linear``,
    must equal the device's bit for bit; the codes the CPU computed itself
    show the flips the fp32 layers between two products cause on their
    own), and free, on its own codes (their flips cascade). Raises on a
    differing accumulator or pinned logit, a code more than ``CODE_STEP``
    away, a layer's pinned flips above ``FLIP_SHARE`` of its codes, or
    free logits more than ``LOGIT_ERR`` of their largest magnitude away.
    On the CPU all of it is exact."""
    real, codes, accs = Q.int8_matmul, [], []

    def record(a, b):
        out = real(a, b)
        codes.append(a.cpu())
        accs.append(out.cpu())
        return out
    with mock.patch.object(Q, "int8_matmul", record), torch.no_grad():
        logits = model(tokens).float().cpu()
    pinned_flips, free_flips = [], []  # (codes that differ, largest step)

    def flips(a, into):
        d = (a.to(torch.int16) - codes[len(into)].to(torch.int16)).abs()
        into.append((int((d > 0).sum()), int(d.max())))

    def pinned(a, b):
        j = len(pinned_flips)
        flips(a, pinned_flips)
        acc = real(codes[j], b)
        if not torch.equal(acc, accs[j]):
            raise AssertionError(f"int8 product {j}: the CPU's int32 "
                                 f"accumulators differ from the device's "
                                 f"on the same codes")
        return acc

    def free(a, b):
        flips(a, free_flips)
        return real(a, b)
    prev = set_device("cpu")
    try:
        cpu = copy.deepcopy(model).to("cpu")
        runs = {}
        for name, fn in (("pinned", pinned), ("free", free)):
            with mock.patch.object(Q, "int8_matmul", fn), torch.no_grad():
                runs[name] = cpu(tokens.cpu())
    finally:
        set_device(prev)
    n_codes = [c.numel() for c in codes]
    err = (logits - runs["free"]).abs()
    out = {"rows": int(tokens.shape[0]), "products": len(codes),
           "codes": n_codes, "accumulators_equal": True,
           "pinned_logits_equal": torch.equal(logits, runs["pinned"])}
    for name, fl in (("pinned", pinned_flips), ("free", free_flips)):
        out.update({f"{name}_flips": [f for f, _ in fl],
                    f"{name}_max_code_step": max(s for _, s in fl),
                    f"{name}_max_flip_share": max(
                        f / n for (f, _), n in zip(fl, n_codes))})
    out.update(logit_max_abs_err=float(err.max()),
               logit_max_abs=float(runs["free"].abs().max()),
               top1_agreement=float((logits.argmax(-1) == runs["free"]
                                     .argmax(-1)).float().mean()))
    bad = [k for k, fail in (
        ("pinned_logits_equal", not out["pinned_logits_equal"]),
        ("pinned_max_code_step", out["pinned_max_code_step"] > CODE_STEP),
        ("pinned_max_flip_share", out["pinned_max_flip_share"] > FLIP_SHARE),
        ("logit_max_abs_err", out["logit_max_abs_err"]
         > LOGIT_ERR * out["logit_max_abs"])) if fail]
    if bad:
        raise AssertionError(f"int8 forward, device against CPU: {bad} out "
                             f"of bounds in {out}")
    return out
