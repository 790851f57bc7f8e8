"""Step factories (port of :mod:`repro.train`; serving only so far)."""
from .step import make_serve_step

__all__ = ["make_serve_step"]
