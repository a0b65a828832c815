"""Counterpart of ``repro.launch`` in the PyTorch/CUDA port."""
