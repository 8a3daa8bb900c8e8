"""Raw-format dataset ingestion (copied from
`bnn_pynq_tpu/train/datasets_raw.py`: numpy, scipy, PIL and the standard
library; the port never imports the JAX package) — the rebuild of the reference's pylearn2
dataset drivers (SURVEY.md C13 «bnn/src/training/{mnist,cifar10,svhn,
gtsrb}.py»). The container has no network egress, so these loaders fire
the moment the canonical download files are dropped into a directory;
they convert to the cached `<name>.npz` format that `train.data.load`
resolves, so the Δ≤0.1% accuracy gate (BASELINE.md) runs automatically
once data exists.

Supported raw layouts (place under $BNN_DATA_DIR or ./data):
- MNIST:    train-images-idx3-ubyte[.gz], train-labels-idx1-ubyte[.gz],
            t10k-images-idx3-ubyte[.gz],  t10k-labels-idx1-ubyte[.gz]
- CIFAR-10: cifar-10-batches-bin/{data_batch_1..5.bin, test_batch.bin}
- SVHN:     train_32x32.mat, test_32x32.mat   (cropped-digit format)
- GTSRB:    GTSRB/Final_Training/Images/<class>/*.ppm (+ optional
            GTSRB/Final_Test/Images/*.ppm with GT-final_test.csv)

Every loader validates structural invariants (magic numbers, shapes,
label ranges, class counts) and records a sha256 of each consumed file
in the emitted npz's manifest, so a provenance log exists even when the
canonical upstream checksums aren't distributable with this repo.
"""

from __future__ import annotations

import csv
import gzip
import hashlib
import io
import os
import struct

import numpy as np

from bnn_pynq_tpu_torch.train.data import _search_dirs


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _open_maybe_gz(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _find(name_variants, root: str):
    for v in name_variants:
        p = os.path.join(root, v)
        if os.path.exists(p):
            return p
    return None


# -- MNIST (IDX format) -----------------------------------------------------

def _read_idx(raw: bytes) -> np.ndarray:
    magic, = struct.unpack(">I", raw[:4])
    ndim = magic & 0xFF
    if magic >> 8 != 0x000008:          # unsigned byte type, big-endian
        raise ValueError(f"bad IDX magic {magic:#x}")
    dims = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
    data = np.frombuffer(raw, dtype=np.uint8, offset=4 + 4 * ndim)
    if data.size != int(np.prod(dims)):
        raise ValueError(f"IDX payload {data.size} != dims {dims}")
    return data.reshape(dims)


def load_mnist_raw(root: str) -> dict:
    files = {
        "x_train": ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz",
                    "train-images.idx3-ubyte"],
        "y_train": ["train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz",
                    "train-labels.idx1-ubyte"],
        "x_test": ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz",
                   "t10k-images.idx3-ubyte"],
        "y_test": ["t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz",
                   "t10k-labels.idx1-ubyte"],
    }
    out, manifest = {}, {}
    for key, variants in files.items():
        path = _find(variants, root)
        if path is None:
            raise FileNotFoundError(f"MNIST {key} not found under {root}")
        arr = _read_idx(_open_maybe_gz(path))
        manifest[os.path.basename(path)] = _sha256(path)
        out[key] = arr
    for k in ("x_train", "x_test"):
        if out[k].ndim != 3 or out[k].shape[1:] != (28, 28):
            raise ValueError(f"MNIST {k} shape {out[k].shape} != (N,28,28)")
        out[k] = out[k][..., None]                     # NHWC, C=1
    for k in ("y_train", "y_test"):
        if out[k].max() > 9:
            raise ValueError(f"MNIST {k} labels out of range")
        out[k] = out[k].astype(np.int32)
    out["manifest"] = manifest
    return out


# -- CIFAR-10 (binary batches) ----------------------------------------------

def _read_cifar_bin(path: str):
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % 3073 != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of 3073")
    rows = raw.reshape(-1, 3073)
    y = rows[:, 0].astype(np.int32)
    if y.max() > 9:
        raise ValueError(f"{path}: labels out of range")
    # stored channel-major CHW → NHWC
    x = rows[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), y


def load_cifar10_raw(root: str) -> dict:
    sub = os.path.join(root, "cifar-10-batches-bin")
    base = sub if os.path.isdir(sub) else root
    xs, ys, manifest = [], [], {}
    for i in range(1, 6):
        path = os.path.join(base, f"data_batch_{i}.bin")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        x, y = _read_cifar_bin(path)
        manifest[os.path.basename(path)] = _sha256(path)
        xs.append(x)
        ys.append(y)
    test = os.path.join(base, "test_batch.bin")
    if not os.path.exists(test):
        raise FileNotFoundError(test)
    x_test, y_test = _read_cifar_bin(test)
    manifest[os.path.basename(test)] = _sha256(test)
    return {"x_train": np.concatenate(xs), "y_train": np.concatenate(ys),
            "x_test": x_test, "y_test": y_test, "manifest": manifest}


# -- SVHN (.mat cropped digits) ----------------------------------------------

def load_svhn_raw(root: str) -> dict:
    import scipy.io
    out, manifest = {}, {}
    for split, key in (("train", "train"), ("test", "test")):
        path = os.path.join(root, f"{split}_32x32.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        m = scipy.io.loadmat(path)
        x = m["X"]                                     # [32,32,3,N]
        y = m["y"].reshape(-1).astype(np.int32)
        if x.shape[:3] != (32, 32, 3):
            raise ValueError(f"SVHN X shape {x.shape}")
        y[y == 10] = 0                                 # MATLAB 1..10 → 0..9
        out[f"x_{key}"] = np.ascontiguousarray(x.transpose(3, 0, 1, 2))
        out[f"y_{key}"] = y
        manifest[os.path.basename(path)] = _sha256(path)
    out["manifest"] = manifest
    return out


# -- GTSRB (ppm directories) ---------------------------------------------------

def _read_ppm(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _resize32(img: np.ndarray) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR))


def _roi_crop(img: np.ndarray, row: dict) -> np.ndarray:
    """Crop to the sign's ROI from a GTSRB annotation row (columns
    Roi.X1/Y1/X2/Y2, inclusive pixel coords). The upstream training
    pipeline crops to the annotated ROI before resizing — skipping the
    crop shifts top-1 by more than the Δ≤0.1% gate tolerates (SURVEY.md
    hard-part #2), so the crop is mandatory whenever the columns exist."""
    try:
        x1, y1 = int(row["Roi.X1"]), int(row["Roi.Y1"])
        x2, y2 = int(row["Roi.X2"]), int(row["Roi.Y2"])
    except (KeyError, TypeError, ValueError):
        return img
    h, w = img.shape[:2]
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(w - 1, x2), min(h - 1, y2)
    if x2 <= x1 or y2 <= y1:
        return img
    return img[y1:y2 + 1, x1:x2 + 1]


def load_gtsrb_raw(root: str) -> dict:
    """Training set from class dirs (ROI-cropped via the per-class
    GT-<class>.csv annotations, then bilinear-resized to 32×32); test set
    from the final-test CSV when present, else a held-out shuffled split
    of the training images. The holdout fallback is NOT the canonical
    GTSRB test set — the manifest marks it `test_split=holdout...` so the
    Δ≤0.1% accuracy gate can flag the comparison as non-canonical."""
    base = os.path.join(root, "GTSRB")
    train_dir = os.path.join(base, "Final_Training", "Images")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(train_dir)
    xs, ys = [], []
    n_uncropped = 0
    for cls_name in sorted(os.listdir(train_dir)):
        cls_dir = os.path.join(train_dir, cls_name)
        if not os.path.isdir(cls_dir):
            continue
        cls = int(cls_name)
        rois = {}
        ann = os.path.join(cls_dir, f"GT-{cls_name}.csv")
        if os.path.exists(ann):
            with open(ann, newline="") as f:
                for row in csv.DictReader(f, delimiter=";"):
                    rois[row["Filename"]] = row
        for fn in sorted(os.listdir(cls_dir)):
            if fn.endswith(".ppm"):
                img = _read_ppm(os.path.join(cls_dir, fn))
                if fn in rois:
                    img = _roi_crop(img, rois[fn])
                else:
                    n_uncropped += 1
                xs.append(_resize32(img))
                ys.append(cls)
    if not xs:
        raise FileNotFoundError(f"no .ppm files under {train_dir}")
    x = np.stack(xs).astype(np.uint8)
    y = np.asarray(ys, dtype=np.int32)
    if y.max() > 42:
        raise ValueError("GTSRB labels out of range")

    manifest = {"n_train_ppm": str(len(x)),
                "n_train_uncropped": str(n_uncropped),
                "resize": "bilinear-32x32", "crop": "roi-csv"}
    test_dir = os.path.join(base, "Final_Test", "Images")
    csv_path = _find(["GT-final_test.csv",
                      os.path.join("Final_Test", "GT-final_test.csv")], base)
    if os.path.isdir(test_dir) and csv_path:
        txs, tys = [], []
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f, delimiter=";"):
                p = os.path.join(test_dir, row["Filename"])
                txs.append(_resize32(_roi_crop(_read_ppm(p), row)))
                tys.append(int(row["ClassId"]))
        x_test = np.stack(txs).astype(np.uint8)
        y_test = np.asarray(tys, dtype=np.int32)
        x_train, y_train = x, y
        manifest["test_split"] = "final-test-csv"
    else:
        rng = np.random.default_rng(0)
        perm = rng.permutation(len(x))
        n_test = max(1, len(x) // 10)
        x_test, y_test = x[perm[:n_test]], y[perm[:n_test]]
        x_train, y_train = x[perm[n_test:]], y[perm[n_test:]]
        manifest["test_split"] = ("holdout-10pct-seed0 "
                                  "(NON-CANONICAL: no GT-final_test.csv; "
                                  "baseline-gate comparisons are "
                                  "indicative only)")
    return {"x_train": x_train, "y_train": y_train,
            "x_test": x_test, "y_test": y_test, "manifest": manifest}


_LOADERS = {
    "mnist": load_mnist_raw,
    "cifar10": load_cifar10_raw,
    "svhn": load_svhn_raw,
    "gtsrb": load_gtsrb_raw,
}


def ingest(name: str, root: str = None, out_dir: str = None) -> str:
    """Convert raw files under `root` (default: the data search dirs) to
    the cached `<name>.npz` that `train.data.load` picks up. Returns the
    written path."""
    name = name.lower()
    if name not in _LOADERS:
        raise KeyError(f"unknown dataset {name}")
    roots = [root] if root else _search_dirs()
    last_err = None
    for r in roots:
        if not r or not os.path.isdir(r):
            continue
        try:
            out = _LOADERS[name](r)
            break
        except FileNotFoundError as e:
            last_err = e
    else:
        raise FileNotFoundError(
            f"no raw {name} files under {roots}: {last_err}")

    dest_dir = out_dir or (root if root else roots[0]) or "data"
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, f"{name}.npz")
    manifest = out.pop("manifest", {})
    np.savez_compressed(
        dest, manifest=np.asarray(
            [f"{k}={v}" for k, v in sorted(manifest.items())]), **out)
    return dest
