"""The port's raw-dataset ingest against the JAX package's, on the CPU.

Tiny files in each canonical on-disk format are written as
`tests/test_datasets_raw.py` writes them; both packages' `ingest` convert
them, and every array of the two npz files (images, labels, manifest) must
be equal. The port's copy resolves the port's data search dirs.
"""

import os

import numpy as np
import pytest

from bnn_pynq_tpu.train import datasets_raw as jax_raw
from bnn_pynq_tpu_torch import cli
from bnn_pynq_tpu_torch.train import data as port_data
from bnn_pynq_tpu_torch.train import datasets_raw as port_raw
from test_datasets_raw import _write_idx


def _mnist(root, rng):
    for name, shape in (("train-images-idx3-ubyte.gz", (12, 28, 28)),
                        ("train-labels-idx1-ubyte.gz", (12,)),
                        ("t10k-images-idx3-ubyte", (5, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (5,))):
        high = 256 if len(shape) == 3 else 10
        _write_idx(root / name, rng.integers(0, high, shape).astype(np.uint8),
                   gz=name.endswith(".gz"))


def _cifar10(root, rng):
    d = root / "cifar-10-batches-bin"
    d.mkdir()
    for name, n in [(f"data_batch_{i}.bin", 4) for i in range(1, 6)] + \
            [("test_batch.bin", 3)]:
        y = rng.integers(0, 10, n).astype(np.uint8)
        x = rng.integers(0, 256, (n, 3, 32, 32)).astype(np.uint8)
        np.concatenate([y[:, None], x.reshape(n, -1)], axis=1).tofile(d / name)


def _svhn(root, rng):
    scipy_io = pytest.importorskip("scipy.io")
    for split, n in (("train", 6), ("test", 4)):
        x = rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8)
        y = rng.integers(1, 11, (n, 1)).astype(np.uint8)    # MATLAB 1..10
        scipy_io.savemat(root / f"{split}_32x32.mat", {"X": x, "y": y})


def _gtsrb(root, rng):
    image = pytest.importorskip("PIL.Image")
    base = root / "GTSRB" / "Final_Training" / "Images"
    for cls in (0, 7, 42):
        d = base / f"{cls:05d}"
        d.mkdir(parents=True)
        for j in range(4):
            img = rng.integers(0, 256, (40 + j, 40, 3)).astype(np.uint8)
            image.fromarray(img).save(d / f"{j:05d}_{j:05d}.ppm")
        with open(d / f"GT-{cls:05d}.csv", "w") as f:
            f.write("Filename;Width;Height;Roi.X1;Roi.Y1;Roi.X2;Roi.Y2;"
                    "ClassId\n")
            f.write(f"00000_00000.ppm;40;40;5;6;30;31;{cls}\n")


WRITERS = {"mnist": _mnist, "cifar10": _cifar10, "svhn": _svhn,
           "gtsrb": _gtsrb}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_ingest_matches_jax(tmp_path, name):
    raw = tmp_path / "raw"
    raw.mkdir()
    WRITERS[name](raw, np.random.default_rng(sorted(WRITERS).index(name)))
    want = jax_raw.ingest(name, root=str(raw), out_dir=str(tmp_path / "j"))
    got = port_raw.ingest(name, root=str(raw), out_dir=str(tmp_path / "p"))
    assert os.path.basename(got) == f"{name}.npz"
    with np.load(want) as zj, np.load(got) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)


def test_ingest_resolves_the_ports_search_dirs(tmp_path, monkeypatch):
    _mnist(tmp_path, np.random.default_rng(9))
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path))
    assert port_raw._search_dirs is port_data._search_dirs
    path = port_raw.ingest("mnist")
    assert path == os.path.join(str(tmp_path), "mnist.npz")
    ds = port_data.load("mnist")
    assert not ds.synthetic and ds.x_train.shape == (12, 28, 28, 1)


def test_ingest_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_raw.ingest("mnist", root=str(tmp_path))
    with pytest.raises(KeyError):
        port_raw.ingest("imagenet", root=str(tmp_path))


def test_cli_ingest(tmp_path, capsys):
    _cifar10(tmp_path, np.random.default_rng(10))
    cli.main(["ingest", "cifar10", "--root", str(tmp_path), "--out",
              str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert out.strip() == f"wrote {tmp_path / 'out' / 'cifar10.npz'}"
    with np.load(tmp_path / "out" / "cifar10.npz") as z:
        assert z["x_train"].shape == (20, 32, 32, 3)
