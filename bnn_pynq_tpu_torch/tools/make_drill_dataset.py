"""Write a deterministic learnable dataset in the canonical raw formats
(MNIST IDX, CIFAR-10 binary, SVHN .mat, the GTSRB tree) for the
end-to-end accuracy drill: ingest → train → compile → eval → gate through
the file formats a user would drop in, on data clearly marked synthetic.

    python -m bnn_pynq_tpu_torch.tools.make_drill_dataset --out DIR \
        [--datasets mnist,cifar10,svhn,gtsrb] [--n-train 16384]
        [--n-test 4096] [--calibrate-offset X]

Port of `tools/make_drill_dataset.py`, with the same arguments and the
same files: the images come from `train/data.py::_synthetic` (fixed
class-dependent templates plus seeded noise), so a correctly wired
trainer reaches ≳99 % test accuracy, which is what the drill asserts:
the pipeline's plumbing, not model quality. `--calibrate-offset` flips a
share of the labels so that the Bayes-optimal accuracy is the dataset's
best reference top-1 (`utils/baseline.py`) plus the offset: a small
positive offset makes the gate decide on margins under 2 %, a negative
one is a designed near miss the gate must catch. Host only (numpy; scipy
for SVHN, Pillow for GTSRB).

Formats: MNIST IDX (big-endian magic 0x803 / 0x801, then uint8 rows);
CIFAR-10 binary data_batch_N.bin (a label byte and 3072 CHW bytes per
record); SVHN cropped digits X [32, 32, 3, N], y [N, 1] in 1..10;
GTSRB Final_Training/Images/<class>/*.ppm with GT-<class>.csv and
Final_Test/Images/*.ppm with GT-final_test.csv (ROI = the full frame).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import struct

import numpy as np

from bnn_pynq_tpu_torch.train.data import _CLASSES, _synthetic
from bnn_pynq_tpu_torch.utils.baseline import REFERENCE_TOP1


def _open(path):
    return gzip.open(path, "wb") if path.endswith(".gz") else open(path, "wb")


def write_idx_images(path, x):
    n, h, w = x.shape
    with _open(path) as f:
        f.write(struct.pack(">IIII", 0x803, n, h, w))
        f.write(np.ascontiguousarray(x, np.uint8).tobytes())


def write_idx_labels(path, y):
    with _open(path) as f:
        f.write(struct.pack(">II", 0x801, len(y)))
        f.write(np.ascontiguousarray(y, np.uint8).tobytes())


def write_cifar_batches(out, x, y, n_batches, prefix="data_batch_",
                        per=None):
    """CIFAR-10 binary: per record 1 label byte + 3072 bytes (RGB planes,
    each 32×32 row-major)."""
    n = len(x)
    per = per or n // n_batches
    chw = x.transpose(0, 3, 1, 2)    # NHWC uint8 → NCHW planes
    rec = np.concatenate(
        [np.asarray(y, np.uint8)[:, None],
         chw.reshape(n, -1).astype(np.uint8)], axis=1)
    for b in range(n_batches):
        part = rec[b * per:(b + 1) * per]
        name = (f"{prefix}{b + 1}.bin" if prefix.startswith("data")
                else f"{prefix}.bin")
        with open(os.path.join(out, name), "wb") as f:
            f.write(part.tobytes())


def write_svhn_mat(out, x, y, split):
    """SVHN cropped-digit .mat: X [32,32,3,N] uint8, y [N,1] in 1..10
    (MATLAB labels; 0 stored as 10)."""
    import scipy.io
    yy = np.asarray(y, np.uint8).copy()
    yy[yy == 0] = 10
    scipy.io.savemat(os.path.join(out, f"{split}_32x32.mat"),
                     {"X": x.transpose(1, 2, 3, 0),
                      "y": yy.reshape(-1, 1)})


def write_gtsrb_tree(out, x_tr, y_tr, x_te, y_te):
    """GTSRB directory layout: Final_Training/Images/<class>/*.ppm with
    per-class GT-<class>.csv ROI annotations (ROI = full frame here),
    Final_Test/Images/*.ppm + GT-final_test.csv."""
    from PIL import Image
    base = os.path.join(out, "GTSRB")
    tr = os.path.join(base, "Final_Training", "Images")
    te = os.path.join(base, "Final_Test", "Images")
    os.makedirs(te, exist_ok=True)
    counters = {}
    rows_by_cls = {}
    for img, cls in zip(x_tr, y_tr):
        cls = int(cls)
        d = os.path.join(tr, f"{cls:05d}")
        os.makedirs(d, exist_ok=True)
        i = counters.get(cls, 0)
        counters[cls] = i + 1
        fn = f"{0:05d}_{i:05d}.ppm"
        Image.fromarray(img).save(os.path.join(d, fn))
        h, w = img.shape[:2]
        rows_by_cls.setdefault(cls, []).append(
            f"{fn};{w};{h};0;0;{w - 1};{h - 1};{cls}")
    hdr = "Filename;Width;Height;Roi.X1;Roi.Y1;Roi.X2;Roi.Y2;ClassId"
    for cls, rows in rows_by_cls.items():
        with open(os.path.join(tr, f"{cls:05d}", f"GT-{cls:05d}.csv"),
                  "w") as f:
            f.write(hdr + "\n" + "\n".join(rows) + "\n")
    test_rows = []
    for i, (img, cls) in enumerate(zip(x_te, y_te)):
        fn = f"{i:05d}.ppm"
        Image.fromarray(img).save(os.path.join(te, fn))
        h, w = img.shape[:2]
        test_rows.append(f"{fn};{w};{h};0;0;{w - 1};{h - 1};{int(cls)}")
    with open(os.path.join(base, "GT-final_test.csv"), "w") as f:
        f.write(hdr + "\n" + "\n".join(test_rows) + "\n")


def flip_labels(y, p, ncls, seed):
    """Randomize a fraction p of labels uniformly over all classes (the
    true class included): the Bayes-optimal accuracy on such data is
    exactly (1 − p) + p/ncls."""
    r = np.random.default_rng(seed)
    y = np.asarray(y).copy()
    m = r.random(len(y)) < p
    y[m] = r.integers(0, ncls, size=int(m.sum()))
    return y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--datasets", default="mnist,cifar10,svhn,gtsrb")
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-test", type=int, default=4096)
    ap.add_argument("--calibrate-offset", type=float, default=None,
                    help="inject label noise so the Bayes-optimal "
                    "accuracy = (max BASELINE.md top-1 for the dataset) "
                    "+ offset; a negative offset is a designed near miss "
                    "the gate must catch. Default: no noise.")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    made = []
    calib = {}
    for name in args.datasets.split(","):
        n_tr, n_te = args.n_train, args.n_test
        if name == "gtsrb":     # thousands of small ppm files: kept lean
            n_tr, n_te = min(n_tr, 4300), min(n_te, 860)
        if name not in _CLASSES:
            raise SystemExit(f"unknown drill dataset {name}")
        ds = _synthetic(name, n_tr, n_te)
        if args.calibrate_offset is not None:
            ncls = _CLASSES[name]
            ref_max = max(v for (n, d), v in REFERENCE_TOP1.items()
                          if d == name)
            bayes = min(0.999, ref_max + args.calibrate_offset)
            p = (1.0 - bayes) / (1.0 - 1.0 / ncls)
            ds.y_train = flip_labels(ds.y_train, p, ncls, seed=11)
            ds.y_test = flip_labels(ds.y_test, p, ncls, seed=12)
            calib[name] = {"ref_max": ref_max, "bayes": round(bayes, 4),
                           "label_noise_p": round(p, 5)}
        if name == "mnist":
            x_tr = ds.x_train.reshape(-1, 28, 28)
            x_te = ds.x_test.reshape(-1, 28, 28)
            write_idx_images(os.path.join(
                args.out, "train-images-idx3-ubyte"), x_tr)
            write_idx_labels(os.path.join(
                args.out, "train-labels-idx1-ubyte"), ds.y_train)
            write_idx_images(os.path.join(
                args.out, "t10k-images-idx3-ubyte"), x_te)
            write_idx_labels(os.path.join(
                args.out, "t10k-labels-idx1-ubyte"), ds.y_test)
        elif name == "cifar10":
            write_cifar_batches(args.out, ds.x_train, ds.y_train, 5)
            write_cifar_batches(args.out, ds.x_test, ds.y_test, 1,
                                prefix="test_batch")
        elif name == "svhn":
            write_svhn_mat(args.out, ds.x_train, ds.y_train, "train")
            write_svhn_mat(args.out, ds.x_test, ds.y_test, "test")
        else:
            write_gtsrb_tree(args.out, ds.x_train, ds.y_train,
                             ds.x_test, ds.y_test)
        made.append(name)
    # a loud provenance marker, so the directory never passes as real data
    with open(os.path.join(args.out, "SYNTHETIC_DRILL.txt"), "w") as f:
        f.write("Deterministic SYNTHETIC stand-in data written by "
                "bnn_pynq_tpu_torch/tools/make_drill_dataset.py for the "
                f"accuracy-pipeline drill. Datasets: {', '.join(made)}. NOT "
                "real MNIST/CIFAR-10; accuracy numbers from this directory "
                "prove pipeline plumbing only.\n")
        if calib:
            f.write("CALIBRATED (label noise sets the Bayes ceiling "
                    f"near BASELINE.md, offset {args.calibrate_offset}): "
                    + json.dumps(calib) + "\n")
    if calib:
        print("calibration:", json.dumps(calib))
    print(f"wrote {', '.join(made)} (train {args.n_train}, "
          f"test {args.n_test}) to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
