"""Constants of the training model (`bnn_pynq_tpu/train/model.py`) that
the compiler shares with it; the modules themselves are not ported yet."""

# BatchNorm epsilon of the training stack; the compiler folds with it.
BN_EPS = 1e-4
