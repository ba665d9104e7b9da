"""Curves with a != 0, as test witnesses of the general-a group law.

No curve of `concrete` (nor of the JAX package's) has a != 0. These two
public prime-order curves with a = -3 fit limb counts the Weierstrass
kernels are built at, so the tests and `chip_smoke.py` drive the general-a
paths on them: NIST P-256 (secp256r1, 9 limbs of 32 bits) and NIST P-384
(secp384r1, 13 limbs). Constants from SEC 2 v2 (sections 2.4.2 and 2.5.1)
and FIPS 186-4 (appendix D.1.2.3 and D.1.2.4). Both have cofactor 1, no
endomorphism, and p = 3 mod 4. They are not served (`serve.get_curve`) and
not in `concrete`.
"""

from __future__ import annotations

from ..bigint.weierstrass import CurveParams

_P256_P = 2**256 - 2**224 + 2**192 + 2**96 - 1
_P384_P = 2**384 - 2**128 - 2**96 + 2**32 - 1

P256 = CurveParams(
    label="p-256",
    modulus=_P256_P,
    order=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    cofactor=1,
    a=_P256_P - 3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    generator=(
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    ),
)

P384 = CurveParams(
    label="p-384",
    modulus=_P384_P,
    order=int(
        "0xffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372ddf"
        "581a0db248b0a77aecec196accc52973",
        16,
    ),
    cofactor=1,
    a=_P384_P - 3,
    b=int(
        "0xb3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
        "c656398d8a2ed19d2a85c8edd3ec2aef",
        16,
    ),
    generator=(
        int(
            "0xaa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
            "5502f25dbf55296c3a545e3872760ab7",
            16,
        ),
        int(
            "0x3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
            "0a60b1ce1d7e819d7a431d7c90ea0e5f",
            16,
        ),
    ),
)

GENERAL_A_CURVES = {P256.label: P256, P384.label: P384}
