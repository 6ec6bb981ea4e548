"""Open-loop Poisson arrivals at ``rate`` requests a second: exponential
gaps, scaled so the ``floor(rate * seconds)`` requests of a run of
``seconds`` fall due over exactly their count over the rate."""

import numpy as np


def count(mix: dict, seconds: float) -> int:
    return max(1, int(mix["rate"] * seconds))


def gaps(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The first request due at 0, the last at ``n / rate``."""
    rate = mix["rate"]
    out = rng.exponential(1.0 / rate, n)
    out[0] = 0.0
    if n > 1:
        out[1:] *= (n / rate) / out[1:].sum()
    return out
