"""Shared constants of the port's PRNG chains."""
from repro_torch.analysis.salts import LAT_SALT, NOISE_SALT

__all__ = ["LAT_SALT", "NOISE_SALT"]
