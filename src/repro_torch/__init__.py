"""PyTorch/CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

The sub-packages mirror ``repro``'s (``configs``, ``models``, ``kernels``,
``serve``), so the counterpart of each JAX module sits at the same path.
The port imports ``torch`` and never ``jax`` or anything of ``repro``.

Entry points take ``device=None``, meaning the CUDA device; they raise when
CUDA is absent rather than carry on on the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises without CUDA); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
