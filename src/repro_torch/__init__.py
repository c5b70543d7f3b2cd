"""PyTorch/CUDA port of the Hecate FSSDP system.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, keeps its own copies of the framework-free modules, and runs
its hand-written Hopper kernels (``repro_torch.kernels``) on CUDA tensors.
"""
