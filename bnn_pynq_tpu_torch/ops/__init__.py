"""Integer ops on tensors and the wrappers of the CUDA kernels.

Each kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; it never falls back from one to
the other.
"""
