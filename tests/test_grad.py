"""Gradients of the PLF node: JAX autodiff of the XLA op vs a float64
analytic oracle.

The node is multilinear in its operands between rescales (the 2^32
factor is locally constant), so every cotangent has a closed form; the
oracle below evaluates it in NumPy float64, independently of JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.ops.plf_xla import plf_lane_major

S, C = 4, 4
ROWS = S * C


def _case(seed, n_pad=512, underflow=True):
    rng = np.random.default_rng(seed)
    x1 = (rng.random((ROWS, n_pad)) * 0.99 + 0.01).astype(np.float32)
    x2 = (rng.random((ROWS, n_pad)) * 0.99 + 0.01).astype(np.float32)
    if underflow:
        x1[:, 1::7] *= np.float32(1e-8)
        x2[:, 1::7] *= np.float32(1e-8)
    left = rng.random((C, S, S)).astype(np.float32)
    right = rng.random((C, S, S)).astype(np.float32)
    ev = rng.random((S, S)).astype(np.float32)
    r = rng.standard_normal((ROWS, n_pad)).astype(np.float32)
    return x1, x2, left, right, ev, r


def _oracle_grads(x1, x2, left, right, ev, r, fac):
    """Cotangents of sum(x3 * r) in float64 (fac: per-site 2^32 or 1)."""
    f = np.float64
    x1 = x1.astype(f).reshape(S, C, -1)
    x2 = x2.astype(f).reshape(S, C, -1)
    L_, R_, E = left.astype(f), right.astype(f), ev.astype(f)
    u1 = np.einsum("cka,acn->kcn", L_, x1)
    u2 = np.einsum("cka,acn->kcn", R_, x2)
    p = u1 * u2
    g3 = r.astype(f).reshape(S, C, -1) * fac[None, None, :]
    gp = np.einsum("ka,acn->kcn", E, g3)
    gu1, gu2 = gp * u2, gp * u1
    return {
        "x1": np.einsum("cka,kcn->acn", L_, gu1).reshape(ROWS, -1),
        "x2": np.einsum("cka,kcn->acn", R_, gu2).reshape(ROWS, -1),
        "left": np.einsum("kcn,acn->cka", gu1, x1),
        "right": np.einsum("kcn,acn->cka", gu2, x2),
        "ev": np.einsum("kcn,acn->ka", p, g3),
    }


@pytest.mark.parametrize("underflow", [False, True])
def test_vjp_matches_autodiff(underflow):
    """jax.grad through the node op equals the float64 closed form,
    rescaled sites and padding included."""
    x1, x2, left, right, ev, r = _case(3, underflow=underflow)
    n = x1.shape[-1] - 37          # exercise the padding guard

    def loss(x1, x2, left, right, ev):
        x3, _ = plf_lane_major(x1, x2, left, right, ev, n)
        return jnp.sum(x3 * r)

    got = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x1, x2, left, right, ev)))
    _, mask = plf_lane_major(x1, x2, left, right, ev, n)
    mask = np.asarray(mask)
    assert mask.any() == underflow
    fac = np.where(mask == 1, 2.0 ** 32, 1.0)
    want = _oracle_grads(x1, x2, left, right, ev, r, fac)
    for name, g in zip(("x1", "x2", "left", "right", "ev"), got):
        g, w = np.asarray(g, np.float64), want[name]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-6 * np.abs(w).max(),
                                   err_msg=f"grad {name}")


def test_vjp_forward_matches_kernel():
    """The value under autodiff is the forward op verbatim."""
    x1, x2, left, right, ev, _ = _case(5)
    n = x1.shape[-1]
    direct = plf_lane_major(x1, x2, left, right, ev, n)
    (x3, sc), _vjp = jax.vjp(
        lambda a: plf_lane_major(a, x2, left, right, ev, n),
        jnp.asarray(x1))
    np.testing.assert_array_equal(np.asarray(x3), np.asarray(direct[0]))
    np.testing.assert_array_equal(np.asarray(sc), np.asarray(direct[1]))
