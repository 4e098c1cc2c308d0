from .base import Family
from .dirichlet import MULTINOMIAL, MultinomialFamily
from .niw import GAUSSIAN, GaussianFamily

__all__ = ["Family", "GAUSSIAN", "GaussianFamily", "MULTINOMIAL",
           "MultinomialFamily"]
