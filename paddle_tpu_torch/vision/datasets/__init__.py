"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``).

Nothing is downloaded. A dataset reads local files when given their paths
(MNIST's idx files, the cifar-python archive, an image folder) and raises
if they are missing; with no path it builds the JAX package's synthetic
set, from the same ``RandomState`` seeds, so its arrays equal the
reference's byte for byte (MNIST: 6000 training and 1000 test samples of
``[1, 28, 28]`` float32 in [0, 1] with ``[1]`` int64 labels, one blob per
class). Samples are numpy; ``io.DataLoader`` collates and places them.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Optional

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "DatasetFolder", "ImageFolder"]


def _open(path):
    """A binary file, through gzip when its name ends in ``.gz``."""
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path,
                                                                    "rb")


class MNIST(Dataset):
    """MNIST. With ``image_path``/``label_path`` reads the standard idx-ubyte
    files; otherwise generates a deterministic synthetic set (blobs per class)
    of the same shape ([1, 28, 28] float32 in [0, 1], labels int64)."""

    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform: Optional[Callable] = None, download=True,
                 backend="cv2", synthetic_size=None):
        self.mode = mode.lower()
        self.transform = transform
        if image_path or label_path:
            # both-or-neither: one supplied path with the other omitted is
            # the same typo class as a missing file — silently training on
            # synthetic blobs would mask it
            if not (image_path and label_path):
                raise ValueError(
                    f"{type(self).__name__}: image_path and label_path "
                    f"must be given together (got {image_path!r}, "
                    f"{label_path!r}); omit both for the synthetic "
                    f"offline fallback")
            if not (os.path.exists(image_path) and os.path.exists(label_path)):
                raise FileNotFoundError(
                    f"{type(self).__name__}: image_path/label_path "
                    f"({image_path!r}, {label_path!r}) do not both exist "
                    f"(omit them for the synthetic offline fallback)")
            self.images, self.labels = self._load_idx(image_path, label_path)
            self.synthetic = False
        else:
            n = synthetic_size or (6000 if self.mode == "train" else 1000)
            self.images, self.labels = self._synthesize(n)
            self.synthetic = True

    @staticmethod
    def _load_idx(image_path, label_path):
        with _open(label_path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int64")
        with _open(image_path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols)
        return images.astype("float32") / 255.0, labels

    def _synthesize(self, n):
        rng = np.random.RandomState(42 if self.mode == "train" else 43)
        labels = rng.randint(0, self.NUM_CLASSES, n).astype("int64")
        images = np.zeros((n, 28, 28), "float32")
        # one blob position per class => linearly separable synthetic digits
        for i, lab in enumerate(labels):
            cx, cy = 4 + 2 * (lab % 5) * 2, 6 + (lab // 5) * 12
            yy, xx = np.mgrid[0:28, 0:28]
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0))
            noise = rng.rand(28, 28) * 0.15
            images[i] = np.clip(blob + noise, 0, 1)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx][None, :, :]  # [1, 28, 28]
        label = np.asarray([self.labels[idx]], dtype="int64")
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class _CifarBase(Dataset):
    NUM_CLASSES = 10
    SHAPE = (3, 32, 32)
    LABEL_KEYS = (b"labels", b"fine_labels")

    ARCHIVE_SUPPORTED = True  # cifar pickle-tar parsing (Flowers opts out)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2", synthetic_size=None):
        self.mode = mode.lower()
        self.transform = transform
        if self.ARCHIVE_SUPPORTED and data_file:
            # an EXPLICIT archive path must exist — silently training on
            # synthetic noise because of a typo'd path would look like real
            # training (the synthetic fallback is only for no-path offline
            # use)
            if not os.path.exists(data_file):
                raise FileNotFoundError(
                    f"{type(self).__name__}: data_file {data_file!r} does "
                    f"not exist (omit data_file for the synthetic offline "
                    f"fallback)")
            self.images, self.labels = self._load_archive(data_file)
            self.synthetic = False
            return
        self.synthetic = True
        n = synthetic_size or (5000 if self.mode == "train" else 1000)
        rng = np.random.RandomState(7 if self.mode == "train" else 8)
        self.labels = rng.randint(0, self.NUM_CLASSES, n).astype("int64")
        base = rng.rand(self.NUM_CLASSES, *self.SHAPE).astype("float32")
        self.images = np.clip(
            base[self.labels]
            + rng.rand(n, *self.SHAPE).astype("float32") * 0.3,
            0, 1,
        )

    def _load_archive(self, data_file):
        """Read the standard cifar-python tar.gz: pickled batch dicts with
        ``data`` ([N, 3072] uint8 row-major RGB) and ``labels`` /
        ``fine_labels`` (reference ``Cifar10`` reads the same archive
        member-by-member)."""
        import pickle
        import tarfile

        want_test = self.mode != "train"
        imgs, labs = [], []
        with tarfile.open(data_file, "r:*") as tf:
            for member in sorted(tf.getmembers(), key=lambda m: m.name):
                base = os.path.basename(member.name)
                is_test = base.startswith("test")
                if not member.isfile() or is_test != want_test or (
                        not base.startswith(("data_batch", "test", "train"))):
                    continue
                d = pickle.load(tf.extractfile(member), encoding="bytes")
                if b"data" not in d:
                    continue
                imgs.append(np.asarray(d[b"data"], dtype=np.uint8))
                for k in self.LABEL_KEYS:
                    if k in d:
                        labs.extend(int(v) for v in d[k])
                        break
        if not imgs:
            raise ValueError(
                f"no {'test' if want_test else 'train'} batches with a "
                f"'data' field found in {data_file}")
        images = np.concatenate(imgs).reshape(-1, *self.SHAPE)
        if len(images) != len(labs):
            raise ValueError(
                f"{data_file}: {len(images)} images but {len(labs)} labels "
                f"— a batch is missing one of the {self.LABEL_KEYS} keys")
        return (images.astype("float32") / 255.0,
                np.asarray(labs, dtype="int64"))

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar10(_CifarBase):
    NUM_CLASSES = 10


class Cifar100(_CifarBase):
    NUM_CLASSES = 100


class Flowers(_CifarBase):
    """Flowers-102 (reference ``paddle.vision.datasets.Flowers``); synthetic
    set when no file is given, the same (3, 96, 96)/102-class geometry.
    Its real archive is a tgz of JPEGs + .mat labels — NOT the cifar pickle
    format — so the cifar archive parser is opted out and ``data_file``
    keeps the pre-existing synthetic behavior."""

    ARCHIVE_SUPPORTED = False
    NUM_CLASSES = 102
    SHAPE = (3, 96, 96)

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend="cv2",
                 synthetic_size=None):
        if data_file is not None or label_file is not None \
                or setid_file is not None:
            # loud, not silent: a user pointing at REAL flowers archives
            # must not end up training on synthetic noise (the exact
            # typo'd-path failure mode the MNIST/Cifar file parsers fixed)
            raise NotImplementedError(
                "Flowers archive parsing (tgz of JPEGs + .mat labels) is "
                "not implemented: it builds the "
                "synthetic data ONLY when no files are passed. Drop the "
                "data_file/label_file/setid_file arguments for synthetic "
                "mode, or use DatasetFolder on an extracted image tree.")
        n = synthetic_size or (1020 if mode.lower() == "train" else 102)
        super().__init__(data_file=None, mode=mode, transform=transform,
                         download=download, backend=backend,
                         synthetic_size=n)


class DatasetFolder(Dataset):
    """Image-folder dataset: root/<class>/<img>. Requires numpy-loadable
    images (``.npy``) or pillow if available."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fname),
                                     self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image

            return np.asarray(Image.open(path).convert("RGB"),
                              dtype="float32") / 255.0
        except ImportError:
            raise RuntimeError(
                f"No loader for {path} (install pillow or use .npy)")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = [
            os.path.join(root, f) for f in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, f))
        ]
        self.loader = loader or DatasetFolder._default_loader

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
