"""An offline batch job: all ``requests`` requests due at the start."""

import numpy as np


def count(mix: dict, seconds: float) -> int:
    return int(mix["requests"])


def gaps(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.zeros(n)
