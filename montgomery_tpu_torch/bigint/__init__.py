"""Pure-Python big-integer oracle: the ground truth of the port's checks.

A copy of the Weierstrass part of `montgomery_tpu/bigint/` (field, curve,
Pippenger), so that the port and its GPU run need nothing of the JAX
package.
"""

from .field import Field
from .msm import msm, msm_naive
from .weierstrass import AffinePoint, CurveParams, Endomorphism, WeierstrassCurve
