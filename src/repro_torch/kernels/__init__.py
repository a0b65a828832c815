"""Counterpart of ``repro.kernels`` in the PyTorch/CUDA port."""
