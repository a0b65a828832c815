"""Counterpart of ``repro.models`` in the PyTorch/CUDA port."""
