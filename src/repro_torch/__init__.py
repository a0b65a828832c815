"""PyTorch/CUDA port of the ``repro`` package, for an NVIDIA H100.

Same sub-package layout and file names as ``repro`` (the JAX reference), so
a module's counterpart is found by its path.  The port imports ``torch``,
``numpy`` and the standard library only.  Every kernel that the reference
wrote in Pallas is a CUDA C++ kernel here, under ``repro_torch/csrc``,
compiled at first use (see ``repro_torch.kernels.runtime``).
"""
