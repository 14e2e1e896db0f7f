"""The port's batched small-SPD Cholesky solve (kernel 1).

On the CPU: the plain version against ``torch.linalg.solve``, the JAX
package's jnp ``chol_solve`` and its Pallas kernel in interpret mode, and
the wrapper's checks.  The CUDA kernel is held against the plain version on
a card by the jax-free tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.ops import smallchol as jsmallchol
from forging_control_tpu_torch.ops import build, smallchol


def _random_spd(rng, B, N):
    A = rng.randn(B, N, N)
    H = A @ np.transpose(A, (0, 2, 1)) + N * np.eye(N)
    g = rng.randn(B, N)
    return H, g


CASES = [(N, B) for N in (5, 10, 25) for B in (32, 300)]


@pytest.mark.parametrize("N,B", CASES)
def test_torch_chol_plain_matches_linalg_and_jax(N, B):
    """Bounds of the JAX package's tests/test_ops.py: 1e-9/1e-10 against
    the LAPACK solve; the same recurrence as JAX's jnp solve, so 1e-12."""
    H, g = _random_spd(np.random.RandomState(N * 1000 + B), B, N)
    got = smallchol.chol_solve_torch(torch.from_numpy(H), torch.from_numpy(g))
    want = torch.linalg.solve(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-10)
    want_jax = np.asarray(jsmallchol.chol_solve(jnp.asarray(H), jnp.asarray(g)))
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("B", [32, 300])
def test_torch_chol_plain_matches_pallas_interpret(B):
    """Against the TPU kernel itself (interpret mode), including a batch
    that is not a multiple of its 128-lane tile; bound of test_ops.py."""
    H, g = _random_spd(np.random.RandomState(2), B, 10)
    want = np.asarray(jsmallchol.chol_solve_pallas(
        jnp.asarray(H), jnp.asarray(g), interpret=True))
    got = smallchol.chol_solve_torch(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9)


def test_torch_chol_plain_gradients_match_jax():
    """The plain version is differentiable (port of test_ops.py's
    vmap-grad test): finite gradients equal to JAX's to rounding."""
    import jax
    H, g = _random_spd(np.random.RandomState(1), 8, 6)
    want = jax.grad(lambda a, b: jnp.sum(jsmallchol.chol_solve(a, b) ** 2),
                    argnums=(0, 1))(jnp.asarray(H), jnp.asarray(g))
    Ht = torch.from_numpy(H).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    (smallchol.chol_solve_torch(Ht, gt) ** 2).sum().backward()
    for got, w in zip((Ht.grad, gt.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def test_torch_chol_dispatch_on_cpu_uses_plain():
    H, g = _random_spd(np.random.RandomState(3), 6, 7)
    Ht = torch.from_numpy(H).reshape(2, 3, 7, 7)
    gt = torch.from_numpy(g).reshape(2, 3, 7)
    launches = build.LAUNCHES.copy()
    got = smallchol.chol_solve(Ht, gt)
    assert got.shape == (2, 3, 7)
    assert torch.equal(got, smallchol.chol_solve_torch(Ht, gt))
    assert build.LAUNCHES == launches


def test_torch_chol_kernel_wrapper_refuses_cpu_tensors():
    H, g = _random_spd(np.random.RandomState(4), 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        smallchol.chol_solve_cuda(torch.from_numpy(H), torch.from_numpy(g))
