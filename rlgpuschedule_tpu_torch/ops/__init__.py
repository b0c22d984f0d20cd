"""Device ops of the port that are not part of a model."""
from .gae import compute_gae

__all__ = ["compute_gae"]
