"""Fréchet Audio Distance in JAX.

A ground-up JAX/XLA re-design of gibiansky/frechet-audio-distance-exported:
same seven model variants and public API, run on the GPU — batched
static-shape pipelines, matmul-DFT frontends, on-device streaming
statistics, and mesh data parallelism.
"""

from .fad import FrechetAudioDistance

__version__ = "0.1.0"

__all__ = ["FrechetAudioDistance", "__version__"]
