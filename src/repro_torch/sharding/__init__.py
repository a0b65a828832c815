"""Counterpart of ``repro.sharding`` in the PyTorch/CUDA port."""
