"""Counterpart of ``repro.core`` in the PyTorch/CUDA port."""
