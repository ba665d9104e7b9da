"""Concrete curve parameter records.

A copy of the curves of `montgomery_tpu/concrete/params.py` (public curve
standards: BLS12-377, BLS12-381, Pallas, ed-on-bls12-377) and of its
example fields.
"""

from __future__ import annotations

from ..bigint.field import Field
from ..bigint.twisted_edwards import EdwardsParams
from ..bigint.weierstrass import CurveParams, Endomorphism

# --- BLS12-377 (reference concrete/bls12-377.params.ts) ---

BLS12_377_P = int(
    "0x01ae3a4617c510eac63b05c06ca1493b1a22d9f300f5138f1ef3622fba094800"
    "170b5d44300000008508c00000000001",
    16,
)
BLS12_377_Q = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001

BLS12_377 = CurveParams(
    label="bls12-377",
    modulus=BLS12_377_P,
    order=BLS12_377_Q,
    cofactor=0x170B5D44300000000000000000000000,
    a=0,
    b=1,
    generator=(
        int(
            "0x008848defe740a67c8fc6225bf87ff5485951e2caa9d41bb188282c8bd37cb5c"
            "d5481512ffcd394eeab9b16eb21be9ef",
            16,
        ),
        int(
            "0x01914a69c5102eff1f674f5d30afeec4bd7fb348ca3e52d96d182ad44fb82305"
            "c2fe3d3634a9591afd82de55559c8ea6",
            16,
        ),
    ),
    endomorphism=Endomorphism(
        beta=int(
            "0x1ae3a4617c510eabc8756ba8f8c524eb8882a75cc9bc8e359064ee822fb5bffd"
            "1e945779fffffffffffffffffffffff",
            16,
        ),
        lam=0x12AB655E9A2CA55660B44D1E5C37B00114885F32400000000000000000000000,
    ),
)

# --- BLS12-381 (reference concrete/bls12-381.params.ts) ---

BLS12_381_P = int(
    "0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
BLS12_381_Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_MINUS_Z = 0xD201000000010000
# lambda = z^2 - 1 (usable directly, not negated); beta is the matching cube root
BLS12_381 = CurveParams(
    label="bls12-381",
    modulus=BLS12_381_P,
    order=BLS12_381_Q,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    a=0,
    b=4,
    generator=(
        int(
            "0x17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb",
            16,
        ),
        int(
            "0x08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1",
            16,
        ),
    ),
    endomorphism=Endomorphism(
        beta=int(
            "0x1a0111ea397fe699ec02408663d4de85aa0d857d89759ad4897d29650fb85f9b"
            "409427eb4f49fffd8bfd00000000aaac",
            16,
        ),
        lam=_MINUS_Z**2 - 1,
    ),
)

# --- Pallas (reference concrete/pasta.params.ts) ---

PALLAS_P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
PALLAS_Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# lambda = 5^((q-1)/3) mod q; beta = (5^((p-1)/3))^2 mod p (pasta.params.ts:24-37)
_PALLAS_LAMBDA = pow(5, (PALLAS_Q - 1) // 3, PALLAS_Q)
_PALLAS_BETA = pow(pow(5, (PALLAS_P - 1) // 3, PALLAS_P), 2, PALLAS_P)

PALLAS = CurveParams(
    label="pallas",
    modulus=PALLAS_P,
    order=PALLAS_Q,
    cofactor=1,
    a=0,
    b=5,
    generator=(
        1,
        0x1B74B5A30A12937C53DFA9F06378EE548F655BD4333D477119CF7A23CAED2ABB,
    ),
    endomorphism=Endomorphism(beta=_PALLAS_BETA, lam=_PALLAS_LAMBDA),
)

# --- ed-on-bls12-377 (reference concrete/ed-on-bls12-377.params.ts) ---
# base field = BLS12-377 scalar field

ED_ON_BLS12_377 = EdwardsParams(
    label="ed-on-bls12-377",
    modulus=BLS12_377_Q,
    order=0x4AAD957A68B2955982D1347970DEC005293A3AFC43C8AFEB95AEE9AC33FD9FF,
    cofactor=4,
    d=3021,
    generator=(
        0x9F1B5A5BAF6ACF06FED91C9AE9EBFA06068DD2835790980894E2328F3EBCA05,
        0x9A20DF36571AC3CD906B256080BA8454453C177AAF3131BB50A67BF1A806781,
    ),
)

WEIERSTRASS_CURVES = {c.label: c for c in (BLS12_377, BLS12_381, PALLAS)}
EDWARDS_CURVES = {ED_ON_BLS12_377.label: ED_ON_BLS12_377}


# --- example fields for the field tests (reference concrete/example-fields.ts) ---

def example_fields() -> dict[str, Field]:
    """The thirteen example fields of montgomery_tpu's `example_fields`. In
    32-bit limbs (n = ceil((bits + 6) / 32)) small, babybear and goldilocks
    need 1, 2 and 3 limbs, bls12377 12, bls12381 13, and the others 9."""
    p_small = 101
    p_babybear = (1 << 31) - 1
    p_goldilocks = (1 << 64) - (1 << 32) + 1
    p_25519 = (1 << 255) - 19
    p_secp256k1 = (1 << 256) - (1 << 32) - 0b1111010001
    p_secq256k1 = (1 << 256) - 0x14551231950B75FC4402DA1732FC9BEBF
    return {
        "pastaFp": Field(PALLAS_P),
        "pastaFq": Field(PALLAS_Q),
        "small": Field(p_small),
        "babybear": Field(p_babybear),
        "goldilocks": Field(p_goldilocks),
        "f25519": Field(p_25519),
        "secp256k1": Field(p_secp256k1),
        "secq256k1": Field(p_secq256k1),
        "bls12381": Field(BLS12_381_P),
        "bls12381Scalar": Field(BLS12_381_Q),
        "bls12377": Field(BLS12_377_P),
        "edBls12377": Field(BLS12_377_Q),
        "edBls12377Scalar": Field(ED_ON_BLS12_377.order),
    }
