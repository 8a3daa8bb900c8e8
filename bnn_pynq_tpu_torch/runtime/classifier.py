"""User-facing classifier API over the port's InferenceEngine.

Port of `bnn_pynq_tpu/runtime/classifier.py`: image preprocessing (resize
to the network's input, binarize or centre), `classify_image(s)`,
`classify_image_details`, `class_name`, `usecPerImage` and the class-name
tables; `available_params` lists artifact files on the search path.
`from_artifact` builds the port's engine and passes `device`, `runtime`,
`route` and `batch_buckets` on to it.

Accepts numpy uint8 arrays ([H,W,C], [H,W], or batches) and PIL images
(anything with `.convert`; PIL itself is not imported).

`classify_images` and `classify_image_details` hand the engine the uint8
batch at the network's input size (a view of the caller's array where it
already is one); the engine uploads it as it is and centres or binarizes
it inside its program. `prepare` is the host preparation, JAX's
contract: centred int8 (or ±1 for bipolar nets).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.utils.profiling import span

MNIST_CLASSES = tuple(str(d) for d in range(10))
CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog",
                   "frog", "horse", "ship", "truck")
SVHN_CLASSES = tuple(str(d) for d in range(10))
# German Traffic Sign Recognition Benchmark class names (43 classes).
GTSRB_CLASSES = (
    "20 km/h", "30 km/h", "50 km/h", "60 km/h", "70 km/h", "80 km/h",
    "end 80 km/h", "100 km/h", "120 km/h", "no overtaking",
    "no overtaking (trucks)", "priority at next intersection",
    "priority road", "give way", "stop", "no traffic both ways",
    "no trucks", "no entry", "danger", "bend left", "bend right",
    "double bend", "uneven road", "slippery road", "road narrows",
    "construction", "traffic signal", "pedestrian crossing",
    "school crossing", "cycles crossing", "snow", "animals",
    "restriction ends", "go right", "go left", "go straight",
    "go right or straight", "go left or straight", "keep right",
    "keep left", "roundabout", "restriction ends (overtaking)",
    "restriction ends (overtaking trucks)")

DATASET_CLASSES = {
    "mnist": MNIST_CLASSES,
    "cifar10": CIFAR10_CLASSES,
    "svhn": SVHN_CLASSES,
    "gtsrb": GTSRB_CLASSES,
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def params_dirs() -> List[str]:
    """Artifact search path: $BNN_PARAMS_DIR, ./artifacts (user-trained),
    ./pretrained (shipped), the last two at the repository root."""
    dirs = []
    if os.environ.get("BNN_PARAMS_DIR"):
        dirs.append(os.environ["BNN_PARAMS_DIR"])
    dirs.append(os.path.join(_repo_root(), "artifacts"))
    dirs.append(os.path.join(_repo_root(), "pretrained"))
    return dirs


def default_params_dir() -> str:
    return params_dirs()[0]


def available_params(network: Optional[str] = None) -> List[str]:
    """Artifact files across the search path, optionally filtered by
    network name."""
    seen = []
    for d in params_dirs():
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith(".npz") and f not in seen:
                seen.append(f)
    if network:
        seen = [f for f in seen if f.startswith(network.lower())]
    return sorted(seen)


def resolve_artifact(name_or_path: str) -> str:
    """A path as it is if it exists, else `<name>.npz` from the search
    path (unchanged when not found, so the loader names it)."""
    if os.path.exists(name_or_path):
        return name_or_path
    fname = name_or_path if name_or_path.endswith(".npz") \
        else name_or_path + ".npz"
    for d in params_dirs():
        cand = os.path.join(d, fname)
        if os.path.exists(cand):
            return cand
    return name_or_path


class Classifier:
    """Image classifier over an InferenceEngine."""

    def __init__(self, engine: InferenceEngine,
                 classes: Optional[Sequence[str]] = None):
        self.engine = engine
        cfg = engine.config
        self.config = cfg
        self.classes = tuple(classes) if classes is not None else \
            DATASET_CLASSES.get(cfg.dataset,
                                tuple(map(str, range(cfg.num_classes))))

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_artifact(cls, name_or_path: str, **engine_kw) -> "Classifier":
        """engine_kw: the engine's `device`, `runtime`, `route` and
        `batch_buckets`."""
        return cls(InferenceEngine.from_artifact(
            resolve_artifact(name_or_path), **engine_kw))

    # -- preprocessing ----------------------------------------------------
    def _to_batch(self, images) -> np.ndarray:
        """PIL image(s) / [H,W,C] / [H,W] / batches → uint8 [B,H,W,C] at
        the network's input size (nearest-neighbour resize)."""
        h, w, c = self.config.input_shape
        if not isinstance(images, np.ndarray):
            if hasattr(images, "convert"):   # single PIL image
                images = [images]
            if isinstance(images, (list, tuple)) and images and \
                    hasattr(images[0], "convert"):
                images = np.stack([
                    np.asarray(im.convert("RGB" if c == 3 else "L"))
                    for im in images])
            else:
                images = np.asarray(images)
        images = np.asarray(images, dtype=np.uint8)
        if images.ndim == 2:
            images = images[None, :, :, None]
        elif images.ndim == 3:
            images = images[None] if images.shape[-1] == c \
                else images[..., None]
        if images.shape[-1] != c:
            if c == 1:
                images = images.mean(axis=-1, keepdims=True).astype(np.uint8)
            else:
                images = np.repeat(images, c, axis=-1)
        if images.shape[1:3] != (h, w):
            images = native.resize_nn(images, h, w)
        return images

    def _batch(self, images) -> np.ndarray:
        """The uint8 batch the engine prepares on the device."""
        with span("bnn.classifier.prepare") as sp:
            with span("bnn.classifier.to_batch") as sb:
                batch = self._to_batch(images)
                sp.rows = sb.rows = batch.shape[0]
        return batch

    def prepare(self, images) -> np.ndarray:
        """Images → the engine's input on the host: centred int8, or ±1
        for bipolar nets."""
        with span("bnn.classifier.prepare") as sp:
            with span("bnn.classifier.to_batch") as sb:
                batch = self._to_batch(images)
                sp.rows = sb.rows = batch.shape[0]
            with span("bnn.classifier.center", batch.shape[0]):
                if self.config.input_kind == "bipolar":
                    flat = batch.reshape(batch.shape[0], -1)
                    return np.where(flat >= 128, 1, -1).astype(np.int8)
                return native.center_int8(batch)

    # -- classification ---------------------------------------------------
    def classify_images(self, images) -> np.ndarray:
        return self.engine.classify(self._batch(images), prepared=False)

    def classify_image(self, image) -> int:
        return int(self.classify_images(image)[0])

    def classify_image_details(self, image) -> np.ndarray:
        """Raw logits for one image."""
        return self.engine.logits(self._batch(image), prepared=False)[0]

    def class_name(self, index: int) -> str:
        return self.classes[int(index)]

    @property
    def usecPerImage(self) -> Optional[float]:
        return self.engine.usecPerImage
