"""montgomery_tpu_torch GLV digits against montgomery_tpu, integer for integer.

Scalars are drawn from numpy with a fixed seed plus the edge values 0, 1
and q - 1 and the edge scalars of `glv_edge_scalars` (q - 2, 2^252 and
scalars s whose s g / 2^m lies within 2^-20 of an integer); the same
(20, N) 13-bit limb planes go to both packages. The JAX side runs eagerly
in the suite's callback kernel mode (its fused `glv_digits_{c}` formula).
The kernel's constants (`GlvDevice.kernel_words`) are checked for each GLV
curve the port defines: its limb counts are among those `glv_digits.cu`
is instantiated at, and its 32-bit column sums cannot overflow.
"""

import numpy as np
import pytest
import torch

from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.scalar.device import digits_glv_device as jax_digits
from montgomery_tpu.scalar.device import glv_device as jax_glv_device
from montgomery_tpu.scalar.glv import glv_params as jax_glv_params
from montgomery_tpu_torch import concrete, interop
from montgomery_tpu_torch.scalar.device import (GLV_SHAPES, GlvDevice, digits_glv_device, glv_device,
                                                ints_to_limbs_np)
from montgomery_tpu_torch.scalar.glv import glv_params
from montgomery_tpu_torch.testing.generators import glv_edge_scalars

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

Q = BLS12_377.order
LAM = BLS12_377.endomorphism.lam


@pytest.fixture(scope="module")
def ctx():
    rng = np.random.default_rng(77)
    raw = rng.integers(0, 256, size=13 * 32, dtype=np.uint8).tobytes()
    gd = glv_device(glv_params(Q, LAM), w=13)
    scalars = [0, 1, Q - 1] + [int.from_bytes(raw[32 * i:32 * (i + 1)], "little") % Q for i in range(13)]
    scalars += glv_edge_scalars(gd, Q)
    limbs = ints_to_limbs_np(scalars, Q.bit_length(), 13, 20)
    jgd = jax_glv_device(jax_glv_params(Q, LAM), w=13)
    return scalars, limbs, gd, jgd


def test_glv_constants_match_jax(ctx):
    _, _, gd, jgd = ctx
    for name in ("ns", "m_limbs", "k0", "nu", "nw", "g1_limbs", "g2_limbs", "coef0", "coef1", "max_bits_eff"):
        assert getattr(gd, name) == getattr(jgd, name), name


@pytest.mark.parametrize("c", [4, 11, 13])
def test_digits_match_jax(ctx, c):
    scalars, limbs, gd, jgd = ctx
    got = digits_glv_device(gd, interop.scalars_from_jax(limbs, device="cpu"), c)
    want = np.asarray(jax_digits(jgd, limbs, c))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert (got.numpy() == want).all()
    # the digits recombine to s0 + s1 lambda = s (mod q), each digit in range
    d = got.numpy().astype(object)
    N = len(scalars)
    assert np.abs(got.numpy()).max() <= 1 << (c - 1)
    for i, s in enumerate(scalars):
        s0 = sum(int(d[k, i]) << (c * k) for k in range(d.shape[0]))
        s1 = sum(int(d[k, N + i]) << (c * k) for k in range(d.shape[0]))
        assert (s0 + s1 * LAM - s) % Q == 0


def test_digits_reject_bad_window(ctx):
    _, limbs, gd, _ = ctx
    with pytest.raises(ValueError):
        digits_glv_device(gd, torch.from_numpy(limbs), 17)


@pytest.mark.parametrize("name", ["BLS12_377", "BLS12_381", "PALLAS"])
def test_kernel_words_instantiated(name, monkeypatch):
    """Each GLV curve's constants at w = 13 have limb counts that
    glv_digits.cu is instantiated at, and their column sums stay below
    2^32 (the truncated product, unsigned) and 2^31 (the residuals,
    signed); constants of other sizes, or a column that could overflow,
    are refused before any launch."""
    C = getattr(concrete, name)
    gd = glv_device(glv_params(C.order, C.endomorphism.lam), w=13)
    assert GLV_SHAPES[gd.kernel_shape] == {"BLS12_377": "BLS12-377", "BLS12_381": "BLS12-381",
                                           "PALLAS": "Pallas"}[name]
    assert gd.k0 == gd.ns - 1 and gd.khi - gd.k0 == gd.nu + 2
    msb, res = gd.column_bounds()
    assert 0 < msb < 1 << 32 and 0 < res < 1 << 31
    words = gd.kernel_words(13)
    assert words.dtype == np.int32 and len(words) == 10 + 2 * 24 + 4 + 4 + 4 * 24
    assert list(words[:10]) == [gd.ns, gd.k0, gd.khi, gd.nu, gd.nw, 12, 13, 13, gd.num_windows(13),
                                gd.max_bits_eff]
    with pytest.raises(NotImplementedError, match="instantiated"):
        glv_device(gd.g, w=12).kernel_words(13)
    monkeypatch.setattr(GlvDevice, "column_bounds", lambda self: (msb, 1 << 31))
    with pytest.raises(ValueError, match="overflow"):
        gd.kernel_words(13)
