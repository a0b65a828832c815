"""Counterpart of ``repro.training`` in the PyTorch/CUDA port."""
