"""Counterpart of ``repro.data`` in the PyTorch/CUDA port."""
