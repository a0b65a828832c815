"""Counterpart of ``repro.serving`` in the PyTorch/CUDA port."""
