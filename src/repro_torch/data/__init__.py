"""Token data pipeline (port of ``repro.data``)."""

from repro_torch.data.pipeline import (
    DataLoader, SyntheticTokenSource, make_batch_fn)

__all__ = ["DataLoader", "SyntheticTokenSource", "make_batch_fn"]
