"""Token data pipeline (port of ``repro.data``)."""

from repro_torch.data.pipeline import (
    DataLoader, MemmapTokenSource, SyntheticTokenSource, make_batch_fn)

__all__ = ["DataLoader", "MemmapTokenSource", "SyntheticTokenSource",
           "make_batch_fn"]
