"""Pure-Python big-integer oracle: the ground truth of the port's checks.

A copy of `montgomery_tpu/bigint/` (field, Weierstrass and twisted Edwards
curves, Pippenger), so that the port and its GPU run need nothing of the
JAX package.
"""

from .field import Field
from .msm import msm, msm_naive
from .twisted_edwards import EdwardsParams, EdwardsPoint, TwistedEdwardsCurve
from .weierstrass import AffinePoint, CurveParams, Endomorphism, WeierstrassCurve
