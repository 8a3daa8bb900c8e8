"""Train and compile an artifact for every registered network config.

    python -m bnn_pynq_tpu_torch.tools.make_pretrained --out DIR \
        [--epochs 3] [--device cuda|cpu]

Port of `tools/make_pretrained.py`: each config of
`models/config.py::AVAILABLE_CONFIGS` trained on its dataset
(`train/data.py::load`: `$BNN_DATA_DIR` if it holds the dataset, else the
deterministic synthetic set at 2048 / 512 images) for `--epochs` at batch
64, lr 2e-3 → 1e-4, seed 0, compiled and written as `<DIR>/<name>.npz`
with the validation accuracy, whether the data was synthetic and the
epochs in its meta. Synthetic-data artifacts are functional demos, not
reference-accuracy reproductions. `--out` has no default, and the
repository's own `pretrained/` is refused: the golden and cross-package
tests read the artifacts there. Default device: the card (no CUDA
raises).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from bnn_pynq_tpu_torch.compiler import compile_network, save_artifact
from bnn_pynq_tpu_torch.models.config import AVAILABLE_CONFIGS, get_config
from bnn_pynq_tpu_torch.train import data as data_mod
from bnn_pynq_tpu_torch.train.trainer import train

# the repository's artifacts, which this tool never writes
REPO_PRETRAINED = Path(__file__).resolve().parents[2] / "pretrained"


def check_out(out: str) -> None:
    """Refuse the repository's pretrained/ and anything inside it."""
    path = Path(out).resolve()
    if path == REPO_PRETRAINED or REPO_PRETRAINED in path.parents:
        raise SystemExit(f"--out {out}: the repository's pretrained/ holds "
                         f"the artifacts its tests read; write elsewhere")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    check_out(args.out)

    for name in sorted(AVAILABLE_CONFIGS):
        cfg = get_config(name)
        ds = data_mod.load(cfg.dataset, synthetic_sizes=(2048, 512))
        res = train(cfg, ds, epochs=args.epochs, batch_size=64,
                    lr_start=2e-3, lr_end=1e-4, seed=0, device=args.device)
        compiled = compile_network(
            cfg, res.params, res.batch_stats,
            meta={"val_acc": res.best_val_acc,
                  "synthetic_data": ds.synthetic, "epochs": args.epochs})
        path = os.path.join(args.out, f"{cfg.name}.npz")
        save_artifact(path, compiled)
        print(f"{cfg.name}: val_acc={res.best_val_acc:.3f} "
              f"synthetic={ds.synthetic} -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
