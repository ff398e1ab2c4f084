"""Dense covariances from outside the factor form: gs2pc_torch.ops.eig3 and
ops.covariance against the JAX package's, rotmat_to_quat, and
Gaussians.from_covariances held on the Sigma its factors give back
(eigenvector signs may differ between eigh implementations, Sigma may
not)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs2pc.models.gaussians import Gaussians as JaxGaussians
from gs2pc.ops import covariance as jax_cov
from gs2pc.ops import eig3 as jax_eig3
from gs2pc.ops.quaternion import quat_to_rotmat as jax_quat_to_rotmat
from gs2pc.ops.quaternion import rotmat_to_quat as jax_rotmat_to_quat
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops import covariance, eig3
from gs2pc_torch.ops.linalg3 import bmm33_nt, eig_recompose3
from gs2pc_torch.ops.quaternion import quat_to_rotmat, rotmat_to_quat

torch.set_num_threads(1)


def _covs(kind: str, n: int = 256, seed: int = 0) -> np.ndarray:
    """Symmetric 3x3 matrices R diag(l) R^T at 3DGS scales, l = exp(2 s)
    with s in [-5, -2] (psd); with the smallest l of every other row
    negative, down to -1e-3 (nonpsd); or s I plus a relative 1e-6
    perturbation (isotropic).

    The scale matters: the closed-form eigenvalues carry an error of a few
    ulps of the largest eigenvalue, and the repair's keep mask compares the
    smallest one, clamped to 1e-7, with 1e-8.  Where the largest eigenvalue
    nears 1 that error outgrows the clamp, and a float32 repair's mask is
    decided by rounding (ROADMAP Queue C)."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jax_quat_to_rotmat(jnp.asarray(q, jnp.float32)), np.float64)
    lam = np.sort(np.exp(2.0 * r.uniform(-5.0, -2.0, (n, 3))), axis=1)
    if kind == "nonpsd":
        lam[::2, 0] = -r.uniform(1e-6, 1e-3, n // 2 + n % 2)
    elif kind == "isotropic":
        lam = lam[:, 2:3] * (1.0 + 1e-6 * r.normal(size=(n, 3)))
    sigma = np.einsum("nij,nj,nkj->nik", R, lam, R)
    return (0.5 * (sigma + sigma.transpose(0, 2, 1))).astype(np.float32)


@pytest.mark.parametrize("kind", ["psd", "nonpsd", "isotropic"])
def test_eigvals_sym3_matches_jax(kind):
    sigma = _covs(kind)
    want = np.asarray(jax_eig3.eigvals_sym3(jnp.asarray(sigma)))
    got = eig3.eigvals_sym3(torch.tensor(sigma)).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * scale).all()
    np.testing.assert_array_equal(eig3.min_eigval_sym3(torch.tensor(sigma)).numpy(), got[:, 0])
    if kind == "nonpsd":
        assert (got[:, 0] < 0).any() and (got[:, 0] > 0).any()


@pytest.mark.parametrize("kind", ["psd", "nonpsd", "isotropic"])
def test_validate_covariance_matrices_matches_jax(kind):
    sigma = _covs(kind, seed=1)
    jc, jkeep = jax_cov.validate_covariance_matrices(jnp.asarray(sigma))
    tc, tkeep = covariance.validate_covariance_matrices(torch.tensor(sigma))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        covariance.non_posdef_mask(torch.tensor(sigma)).numpy(),
        np.asarray(jax_cov.non_posdef_mask(jnp.asarray(sigma))))
    mask = np.arange(sigma.shape[0]) % 2 == 0
    np.testing.assert_array_equal(
        covariance.regularise_covariances(torch.tensor(sigma), torch.tensor(mask)).numpy(),
        np.asarray(jax_cov.regularise_covariances(jnp.asarray(sigma), jnp.asarray(mask))))


def test_clamp_and_recompose():
    """The eigen-clamp leaves no eigenvalue below eps, and recomposes a
    clamped PSD matrix unchanged."""
    sigma = torch.tensor(_covs("nonpsd", seed=2))
    fixed = covariance.clamp_covariances(sigma, epsilon=1e-6)
    assert float(torch.linalg.eigvalsh(fixed.double()).min()) >= 1e-6 * 0.9
    w, v = torch.linalg.eigh(fixed)
    torch.testing.assert_close(eig_recompose3(v, w), fixed, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        covariance.clamp_covariances(sigma, epsilon=1e-6).numpy(),
        np.asarray(jax_cov.clamp_covariances(jnp.asarray(sigma.numpy()), epsilon=1e-6)),
        rtol=1e-5, atol=1e-6)


def test_eigh_in_chunks_changes_nothing(monkeypatch):
    """eigh3 solves the matrices EIGH_CHUNK at a time (the card's batched
    solver refuses 65536 at once): the same values as one batch."""
    sigma = torch.tensor(_covs("nonpsd", n=100, seed=6))
    whole = torch.linalg.eigh(sigma)
    monkeypatch.setattr(covariance, "EIGH_CHUNK", 7)
    chunked = covariance.eigh3(sigma)
    assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])
    g = Gaussians.from_covariances(np.zeros((100, 3)), sigma.numpy(), np.zeros((100, 3)),
                                   np.ones(100), device="cpu")
    monkeypatch.setattr(covariance, "EIGH_CHUNK", 1 << 14)
    h = Gaussians.from_covariances(np.zeros((100, 3)), sigma.numpy(), np.zeros((100, 3)),
                                   np.ones(100), device="cpu")
    assert torch.equal(g.rots, h.rots) and torch.equal(g.keep_mask, h.keep_mask)


@pytest.mark.parametrize("kind", ["psd", "nonpsd"])
def test_from_covariances_matches_jax(kind):
    """Sigma rebuilt from the factors within 1e-5 relative of JAX's, the
    keep masks equal, the rotations proper."""
    n = 256
    r = np.random.default_rng(3)
    sigma = _covs(kind, n, seed=4)
    xyz = r.normal(size=(n, 3)).astype(np.float32)
    colours = r.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = r.uniform(0, 1, n).astype(np.float32)
    jg = JaxGaussians.from_covariances(xyz, sigma, colours, opac)
    tg = Gaussians.from_covariances(xyz, sigma, colours, opac, device="cpu")
    np.testing.assert_array_equal(tg.keep_mask.numpy(), np.asarray(jg.keep_mask))
    M = tg.covariance_factors()
    got = bmm33_nt(M, M).numpy()
    want = np.asarray(jg.covariances())
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale).all()
    if kind == "psd":  # without the repair's 5e-7 I, the factors give Sigma back
        raw = Gaussians.from_covariances(xyz, sigma, colours, opac, validate=False,
                                         device="cpu").covariance_factors()
        assert (np.abs(bmm33_nt(raw, raw).numpy() - sigma) <= 1e-5 * scale).all()
    np.testing.assert_allclose(torch.linalg.det(tg.rotation_matrices()).numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tg.xyz.numpy(), xyz)
    assert tg.num_gaussians == n and tg.shs is None


def test_rotmat_to_quat_matches_jax():
    """tests/test_core_math.py's near-pi cases and a random batch."""
    near_pi = np.stack([np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                        np.diag([-1.0, -1.0, 1.0])]).astype(np.float32)
    q = rotmat_to_quat(torch.tensor(near_pi))
    np.testing.assert_allclose(quat_to_rotmat(q).numpy(), near_pi, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(jax_rotmat_to_quat(jnp.asarray(near_pi))),
                               atol=1e-7)
    r = np.random.default_rng(5)
    q0 = r.normal(size=(256, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    R = np.asarray(jax_quat_to_rotmat(jnp.asarray(q0)))
    got = rotmat_to_quat(torch.tensor(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_rotmat_to_quat(jnp.asarray(R))),
                               rtol=1e-6, atol=1e-6)
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(quat_to_rotmat(torch.tensor(got)).numpy(), R, atol=2e-5)
