"""Concrete curve parameter records."""

from .params import (BLS12_377, BLS12_381, ED_ON_BLS12_377, EDWARDS_CURVES, PALLAS,
                     WEIERSTRASS_CURVES, example_fields)
