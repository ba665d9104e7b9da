"""Concrete curve parameter records."""

from .params import BLS12_377, BLS12_381, PALLAS, WEIERSTRASS_CURVES
