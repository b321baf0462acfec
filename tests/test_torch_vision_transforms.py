"""The port's ``vision.transforms`` (and ``vision``'s image backend)
against the JAX package's, on the CPU.

Every transform runs on both packages on the same seeded numpy images,
CHW and HWC, float32 and uint8, each side after the same
``np.random.seed``: the numpy transforms give equal arrays (values, shape
and type), and leave numpy's global state where the reference leaves it
(the next draw is equal), so a seed replays the same crops, flips and
jitters. ``Resize`` and ``RandomResizedCrop``, which the reference
computes with ``jax.image.resize``, agree within 1e-5. The reference's
own cases (``tests/test_api_round4.py``, ``test_api_surface.py``) run on
the port.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.vision as jvision
import paddle_tpu.vision.transforms as J
import paddle_tpu.vision.transforms.functional as JF
import paddle_tpu_torch.vision as tvision
import paddle_tpu_torch.vision.transforms as T
import paddle_tpu_torch.vision.transforms.functional as TF
from paddle_tpu_torch.device import set_device

RESIZE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _img(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "chw":
        return rng.rand(3, 17, 23).astype(np.float32)
    if kind == "hwc":
        return rng.rand(19, 13, 3).astype(np.float32)
    if kind == "hwc_u8":
        return rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    if kind == "gray":
        return rng.rand(11, 14).astype(np.float32)
    if kind == "chw255":  # ColorJitter's 255 range
        return (rng.rand(3, 10, 12) * 255).astype(np.float32)
    raise KeyError(kind)


KINDS = ["chw", "hwc", "hwc_u8", "gray"]


def _both(jt, tt, img, seed=3):
    """Each transform after ``np.random.seed(seed)``, with the next global
    draw after it."""
    np.random.seed(seed)
    a = np.asarray(jt(img.copy()))
    next_a = np.random.rand()
    np.random.seed(seed)
    b = np.asarray(tt(img.copy()))
    next_b = np.random.rand()
    return a, b, next_a, next_b


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# functional
# ---------------------------------------------------------------------------

FUNCTIONAL = [
    ("normalize", dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])),
    ("resize", dict(size=(7, 31))),
    ("resize", dict(size=9)),
    ("resize", dict(size=(30, 8), interpolation="nearest")),
    ("crop", dict(top=2, left=3, height=5, width=6)),
    ("center_crop", dict(output_size=6)),
    ("center_crop", dict(output_size=(4, 9))),
    ("hflip", {}), ("vflip", {}),
    ("pad", dict(padding=2)),
    ("pad", dict(padding=(1, 3), fill=0.5)),
    ("pad", dict(padding=(1, 2, 3, 4), padding_mode="reflect")),
    ("pad", dict(padding=2, padding_mode="edge")),
    ("pad", dict(padding=2, padding_mode="symmetric")),
    ("adjust_brightness", dict(brightness_factor=1.7)),
    ("adjust_contrast", dict(contrast_factor=0.6)),
    ("rotate", dict(angle=90)), ("rotate", dict(angle=-180)),
    ("rotate", dict(angle=33)),
    ("rotate", dict(angle=-20, center=(4.0, 6.0), fill=0.25)),
    ("to_grayscale", {}), ("to_grayscale", dict(num_output_channels=3)),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,kw", FUNCTIONAL,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(FUNCTIONAL)])
def test_functional_equal(name, kw, kind):
    img = _img(kind)
    if name == "normalize" and kind == "gray":
        kw = dict(mean=[0.5], std=[0.2])
    if name == "normalize" and kind.startswith("hwc"):
        kw = dict(kw, data_format="HWC")
    a = np.asarray(getattr(JF, name)(img.copy(), **kw))
    b = getattr(TF, name)(img.copy(), **kw)
    _equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_to_tensor(kind):
    img = _img(kind)
    a = np.asarray(JF.to_tensor(img).numpy())
    b = TF.to_tensor(img)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    _equal(a, b.numpy())


def test_functional_reference_cases():
    """``test_api_surface.py::test_transforms_functional`` and
    ``::test_transforms_dtype_and_hwc`` on the port."""
    img = np.random.RandomState(0).rand(3, 8, 8).astype(np.float32)
    assert TF.resize(img, (4, 4)).shape == (3, 4, 4)
    assert TF.center_crop(img, 4).shape == (3, 4, 4)
    np.testing.assert_allclose(TF.hflip(TF.hflip(img)), img)
    assert TF.rotate(img, 90).shape == (3, 8, 8)
    np.testing.assert_allclose(TF.rotate(TF.rotate(img, 90), -90), img)
    g = TF.to_grayscale(img, 3)
    assert g.shape == (3, 8, 8) and np.allclose(g[0], g[1])

    dark = np.zeros((4, 4, 3), np.uint8)
    dark[0, 0, 0] = 1
    out = TF.to_tensor(dark).numpy()
    np.testing.assert_allclose(out.max(), 1 / 255.0, rtol=1e-5)
    hdr = np.full((3, 4, 4), 2.0, np.float32)  # a float > 1 stays unscaled
    np.testing.assert_allclose(TF.to_tensor(hdr).numpy(), hdr)
    hwc = np.ones((4, 5, 3), np.float32)
    out = TF.normalize(hwc, [1, 1, 1], [2, 2, 2], data_format="HWC")
    assert out.shape == (4, 5, 3)
    np.testing.assert_allclose(out, 0.0)


# ---------------------------------------------------------------------------
# the transform classes
# ---------------------------------------------------------------------------

NUMPY_TRANSFORMS = {
    "to_tensor": lambda M: M.ToTensor(),
    "to_tensor_hwc": lambda M: M.ToTensor(data_format="HWC"),
    "normalize": lambda M: M.Normalize(0.5, 0.25),
    "transpose": lambda M: M.Transpose((1, 0, 2)),
    "center_crop": lambda M: M.CenterCrop((5, 7)),
    "random_crop": lambda M: M.RandomCrop(6),
    "random_crop_padded": lambda M: M.RandomCrop((9, 5), padding=2,
                                                 pad_if_needed=True),
    "hflip": lambda M: M.RandomHorizontalFlip(0.5),
    "hflip_always": lambda M: M.RandomHorizontalFlip(1.0),
    "vflip": lambda M: M.RandomVerticalFlip(0.7),
    "brightness": lambda M: M.BrightnessTransform(0.4),
    "pad": lambda M: M.Pad((1, 2, 3, 4), fill=7),
    "pad_reflect": lambda M: M.Pad(2, padding_mode="reflect"),
    "grayscale": lambda M: M.Grayscale(3),
    "color_jitter": lambda M: M.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "color_jitter_bc": lambda M: M.ColorJitter(0.5, 0.2),
    "rotation": lambda M: M.RandomRotation(25),
    "rotation_expand": lambda M: M.RandomRotation((10, 80), expand=True,
                                                  fill=0.5),
    "rotation_center": lambda M: M.RandomRotation(40, center=(3.0, 4.0)),
}


@pytest.mark.parametrize("kind", ["chw", "hwc", "hwc_u8", "chw255"])
@pytest.mark.parametrize("name", sorted(NUMPY_TRANSFORMS))
def test_numpy_transform_equal(name, kind):
    img = _img(kind)
    make = NUMPY_TRANSFORMS[name]
    for seed in (3, 11):
        a, b, na, nb = _both(make(J), make(T), img, seed)
        _equal(a, b)
        assert na == nb  # the same draws, in the same order


RESIZE_TRANSFORMS = {
    "resize_int": lambda M: M.Resize(9),
    "resize_up": lambda M: M.Resize((31, 40)),
    "resize_mixed": lambda M: M.Resize((8, 29)),
    "random_resized_crop": lambda M: M.RandomResizedCrop(8),
    "random_resized_crop_wide": lambda M: M.RandomResizedCrop(
        (12, 20), scale=(0.3, 0.9), ratio=(0.5, 2.0)),
    "random_resized_crop_fallback": lambda M: M.RandomResizedCrop(
        10, scale=(5.0, 6.0)),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(RESIZE_TRANSFORMS))
def test_resize_transforms_close(name, kind):
    img = _img(kind)
    make = RESIZE_TRANSFORMS[name]
    for seed in (3, 11):
        a, b, na, nb = _both(make(J), make(T), img, seed)
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, **RESIZE_TOL)
        assert na == nb


def test_flowers_pipeline_close():
    """The PaddleClas training and evaluation pipelines at Flowers-102's
    sample shape (3 x 96 x 96), a few samples under one seed."""
    rng = np.random.RandomState(5)
    imgs = rng.rand(4, 3, 96, 96).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]

    def pipes(M):
        train = M.Compose([M.RandomResizedCrop(56), M.RandomHorizontalFlip(),
                           M.Normalize(mean=mean, std=std)])
        test = M.Compose([M.Resize(64), M.CenterCrop(56),
                          M.Normalize(mean=mean, std=std)])
        return train, test
    for (jt, tt) in zip(pipes(J), pipes(T)):
        np.random.seed(9)
        a = [np.asarray(jt(x)) for x in imgs]
        np.random.seed(9)
        b = [tt(x) for x in imgs]
        for x, y in zip(a, b):
            assert x.shape == y.shape == (3, 56, 56)
            np.testing.assert_allclose(y, x, **RESIZE_TOL)


def test_reference_transform_cases():
    """``test_api_round4.py``'s transform cases on the port."""
    img = np.ones((3, 4, 4), np.float32)
    assert T.Pad(2)(img).shape == (3, 8, 8)
    assert T.Pad((1, 2))(img).shape == (3, 8, 6)
    g = T.Grayscale(1)(img)
    assert g.shape == (1, 4, 4)
    np.testing.assert_allclose(g, 1.0, rtol=1e-5)

    img = np.random.RandomState(0).rand(3, 16, 16).astype(np.float32)
    outs = []
    for _ in range(2):
        np.random.seed(77)
        outs.append((T.ColorJitter(0.3, 0.3, 0.3, 0.1)(img),
                     T.RandomRotation(25)(img), T.RandomResizedCrop(8)(img)))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    assert outs[0][2].shape[-2:] == (8, 8)

    img = np.ones((1, 10, 20), np.float32)
    np.random.seed(5)
    out = T.RandomRotation((90, 90), expand=True)(img)
    assert abs(out.shape[1] - 20) <= 1 and abs(out.shape[2] - 10) <= 1
    assert out.sum() >= img.sum() * 0.85
    np.random.seed(5)
    assert T.RandomRotation((90, 90), center=(5.0, 5.0))(img).shape == \
        img.shape


def test_names():
    assert T.__all__ == J.__all__
    assert TF.__all__ == JF.__all__
    assert set(jvision.__dict__) >= {"set_image_backend", "image_load"}
    for name in ("datasets", "models", "ops", "transforms",
                 "set_image_backend", "get_image_backend", "image_load"):
        assert hasattr(tvision, name)


# ---------------------------------------------------------------------------
# the image backend
# ---------------------------------------------------------------------------

def test_image_backend():
    prev = tvision.get_image_backend()
    assert prev == jvision.get_image_backend() == "pil"
    tvision.set_image_backend("numpy")
    assert tvision.get_image_backend() == "numpy"
    tvision.set_image_backend(prev)
    with pytest.raises(ValueError):
        tvision.set_image_backend("bogus")
    with pytest.raises(ValueError):
        jvision.set_image_backend("bogus")


def test_image_load(tmp_path, monkeypatch):
    PIL = pytest.importorskip("PIL.Image")
    arr = np.random.RandomState(1).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    PIL.fromarray(arr).save(path)
    for backend in ("cv2", "numpy"):
        a = jvision.image_load(path, backend=backend)
        b = tvision.image_load(path, backend=backend)
        _equal(np.asarray(a), np.asarray(b))
        _equal(arr, np.asarray(b))
    assert isinstance(tvision.image_load(path), PIL.Image)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError):
        jvision.image_load(path)
    with pytest.raises(ImportError):
        tvision.image_load(path)


def test_flowers_fit_recipe_on_cpu():
    """``chip_smoke.py`` phase 6f(a)'s driver at a few images and pixels:
    the recipe's transforms and O2 ResNet-50 through ``Model.fit`` with
    both loaders, the steps on one batch against the plain update (on the
    CPU both are the plain version: bit-identical, and the loss falls),
    and the serial epoch's batches equal, bit for bit, to their replay
    under the same seed."""
    from paddle_tpu_torch.experiments import vision_quant

    report, launches = vision_quant.flowers_fit(
        train_size=40, test_size=12, size=32, resize=36, batch=16)
    plain = report["against_plain"]
    assert plain["bit_identical"] and plain["steps"] == 3
    assert plain["losses_kernel"][-1] < plain["losses_kernel"][0]
    assert report["batches"] == 3 and report["flat_groups"] == 1
    assert report["replayed_on_cpu"] == {"batches": 3, "bit_identical": True}
    assert set(launches) == {"flowers_fit_workers_0", "flowers_fit_workers_4"}
    assert 0.0 <= report["eval"]["acc"] <= 1.0
