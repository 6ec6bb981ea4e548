"""Hand-written Hopper kernels, their plain PyTorch versions and adapters.

``csrc/`` holds the CUDA C++ sources, built by :mod:`.build` at first use.
"""
