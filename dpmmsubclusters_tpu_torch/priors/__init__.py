from .base import Family
from .niw import GAUSSIAN, GaussianFamily

__all__ = ["Family", "GAUSSIAN", "GaussianFamily"]
