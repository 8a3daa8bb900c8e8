"""Example: load an artifact and classify images — the analogue of the
reference's CIFAR-10/MNIST notebooks.

    python -m bnn_pynq_tpu_torch.examples.classify [artifact] [images.npy]
        [--device cuda|cpu]

Port of `examples/classify.py`. The artifact is a path or the name of a
pretrained network (default cnv-w1a1); without an .npy file it classifies
8 seeded random images. Prints class names and usecPerImage as the
reference notebooks did.
"""

from __future__ import annotations

import argparse

import numpy as np

from bnn_pynq_tpu_torch.runtime.classifier import Classifier


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", nargs="?", default="cnv-w1a1")
    ap.add_argument("images", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    clf = Classifier.from_artifact(args.artifact, device=args.device)
    if args.images:
        imgs = np.load(args.images)
    else:
        imgs = np.random.default_rng(0).integers(
            0, 256, size=(8,) + tuple(clf.config.input_shape)
        ).astype(np.uint8)
    preds = clf.classify_images(imgs)
    for i, p in enumerate(preds):
        print(f"image {i}: class {int(p)} ({clf.class_name(p)})")
    print(f"usecPerImage: {clf.usecPerImage:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
