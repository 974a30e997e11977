"""The port's GP priors of MEFISTO's smooth factors (muon_tpu_torch.ops.gp:
T24 ``rbf_kernel``, T25 ``kg_grad``, the grid score ``gp_hyper``, the Kg
steps ``gp_group``; the DTW warping of models/mofa.py) held to the JAX
package's functions on the same inputs.

The reference runs under ``jax.enable_x64(False)``. Kernel matrices agree to
float32 rounding (exp of the same argument: atol 1e-6); gradients and Kg
after the reference's 10 steps at 1e-5 (both differentiate one float32
Cholesky factor); the grid's choice exactly, on covariates whose best grid
point stands apart; the warping exactly (host numpy in both).
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from muon_tpu.models import mofa as jm
except ImportError:
    jax = jnp = jm = None

from muon_tpu_torch.models import mofa as tm
from muon_tpu_torch.ops import gp
from test_torch_mofa import _launched, _t, cuda  # noqa: F401


def _points(seed=0, n=40, p=1, G=2):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, size=(n, p)).astype(np.float32)
    g = (rng.integers(0, G, n)).astype(np.float32)
    return c, g


def _hyper(K=3, seed=1, G=2):
    rng = np.random.default_rng(seed)
    ells = rng.uniform(0.1, 0.6, K).astype(np.float32)
    scales = rng.uniform(0.2, 0.9, K).astype(np.float32)
    X = rng.normal(size=(K, G, G)).astype(np.float32)
    return ells, scales, X


# ---------------------------------------------------------------------------
# T24 and T25: the plain twins against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", ["none", "independent", "learned"])
@pytest.mark.parametrize("p", [1, 2])
def test_rbf_kernel_plain_matches_reference(groups, p):
    c, g = _points(2, p=p)
    ells, scales, X = _hyper()
    Kg = np.asarray(jm._normalize_kg(jnp, jnp.asarray(X[0])))
    with jax.enable_x64(False):
        ref = np.asarray(jm._rbf_kernel(
            jnp, jnp.asarray(c), ells[0], scales[0],
            gvec=None if groups == "none" else jnp.asarray(g),
            Kg=jnp.asarray(Kg) if groups == "learned" else None))
    got = gp.rbf_kernel(_t(c), _t(c), _t(ells[:1]), _t(scales[:1]),
                        None if groups == "none" else _t(g), None if groups == "none" else _t(g),
                        _t(Kg[None]) if groups == "learned" else None, same=True)
    assert got.shape == (1, 40, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-6, atol=1e-6)


def test_kernel_matrices_match_reference_with_and_without_kg():
    c, g = _points(3)
    ells, scales, X = _hyper()
    with jax.enable_x64(False):
        Kg = np.asarray(jax.vmap(lambda x: jm._normalize_kg(jnp, x))(jnp.asarray(X)))
        for kg in (None, Kg):
            ref = np.asarray(jm._gp_kmat_fn()(jnp.asarray(c), jnp.asarray(ells),
                                              jnp.asarray(scales), jnp.asarray(g),
                                              None if kg is None else jnp.asarray(kg)))
            got = gp.kernel_matrices(_t(c), _t(ells), _t(scales), _t(g),
                                     None if kg is None else _t(kg))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gp.normalize_kg(_t(X)).numpy(), Kg, rtol=1e-6, atol=1e-6)


def test_rbf_kernel_between_two_point_sets():
    # the sparse path's K_nm: no diagonal term, rows and columns apart
    c, g = _points(4, n=30)
    cu, gu = c[::3].copy(), g[::3].copy()
    ells, scales, _ = _hyper(K=2)
    got = gp.rbf_kernel(_t(c), _t(cu), _t(ells), _t(scales), _t(g), _t(gu)).numpy()
    d2 = ((c[:, None, :] - cu[None, :, :]) ** 2).sum(-1)
    for f in range(2):
        ref = scales[f] * np.exp(-0.5 * d2 / ells[f] ** 2) * (g[:, None] == gu[None, :])
        np.testing.assert_allclose(got[f], ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Kg needs the group labels"):
        gp.rbf_kernel(_t(c), _t(cu), _t(ells), _t(scales), Kg=torch.eye(2)[None].repeat(2, 1, 1))


def test_kg_grad_plain_matches_jax_grad():
    # the gradient of Σ dK·K(Kg) in Kg, against jax.grad through the
    # reference's kernel
    c, g = _points(5, n=35, G=3)
    ells, scales, X = _hyper(K=2, G=3)
    dK = np.random.default_rng(6).normal(size=(2, 35, 35)).astype(np.float32)
    Kg = np.asarray(jax.vmap(lambda x: jm._normalize_kg(jnp, x))(jnp.asarray(X)))
    with jax.enable_x64(False):
        def loss(kg, f):
            K = jm._rbf_kernel(jnp, jnp.asarray(c), ells[f], scales[f], gvec=jnp.asarray(g),
                               Kg=kg)
            return jnp.sum(jnp.asarray(dK[f]) * K)
        ref = np.stack([np.asarray(jax.grad(loss)(jnp.asarray(Kg[f]), f)) for f in range(2)])
    got = gp.kg_grad(_t(dK), _t(c), _t(c), _t(ells), _t(scales), _t(g), _t(g), 3)
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_rbf_kg_function_differentiates_like_the_plain_build():
    c, g = _points(7, n=25)
    ells, scales, X = _hyper(K=3)
    Kg = gp.normalize_kg(_t(X)).requires_grad_(True)
    K = gp.RBFKg.apply(Kg, _t(c), _t(ells), _t(scales), _t(g))
    w = torch.randn(K.shape, generator=torch.Generator().manual_seed(0))
    (a,) = torch.autograd.grad((K * w).sum(), Kg)
    Kg2 = Kg.detach().clone().requires_grad_(True)
    K2 = gp.rbf_kernel_plain(_t(c), _t(c), _t(ells), _t(scales), _t(g), _t(g), Kg2, same=True)
    (b,) = torch.autograd.grad((K2 * w).sum(), Kg2)
    torch.testing.assert_close(K, K2)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the hyperparameters
# ---------------------------------------------------------------------------


def _smooth_moments(seed=8, n=70, G=2):
    """Factors that are smooth in the covariate, at three separated
    lengthscales, with their posterior variances."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    Zm = np.stack([np.sin(2 * np.pi * t), np.cos(7 * np.pi * t), 0.3 * rng.normal(size=n)], 1)
    Zv = np.full((n, 3), 0.05)
    return t[:, None], (np.arange(n) % G).astype(np.float32), Zm.astype(np.float32), \
        Zv.astype(np.float32)


@pytest.mark.parametrize("groups", [False, True], ids=["one_group", "two_groups"])
def test_gp_hyper_picks_the_reference_grid_point(groups):
    c, g, Zm, Zv = _smooth_moments()
    g = g if groups else np.zeros_like(g)
    ells = np.geomspace(0.05, 1.0, 10).astype(np.float32)
    scales = np.linspace(0.05, 0.95, 5).astype(np.float32)
    with jax.enable_x64(False):
        re_, rs_ = jm._gp_hyper_fn()(*(jnp.asarray(a) for a in (c, Zm, Zv, ells, scales, g)))
    ge_, gs_ = gp.gp_hyper(*(_t(a) for a in (c, Zm, Zv, ells, scales, g)))
    np.testing.assert_array_equal(ge_.numpy(), np.asarray(re_))
    np.testing.assert_array_equal(gs_.numpy(), np.asarray(rs_))
    assert len(set(ge_.tolist())) == 3  # three separated lengthscales


def test_gp_group_steps_match_the_reference():
    # 10 normalised steps on X from I: Kg and X at 1e-5
    c, g, Zm, Zv = _smooth_moments(9)
    ells = np.array([0.2, 0.1, 0.5], np.float32)
    scales = np.array([0.8, 0.6, 0.3], np.float32)
    X0 = np.tile(np.eye(2, dtype=np.float32)[None], (3, 1, 1))
    with jax.enable_x64(False):
        rX, rKg = jm._gp_group_fn()(*(jnp.asarray(a) for a in (c, Zm, Zv, ells, scales, g, X0)))
    gX, gKg = gp.gp_group(*(_t(a) for a in (c, Zm, Zv, ells, scales, g, X0)))
    np.testing.assert_allclose(gKg.numpy(), np.asarray(rKg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gX.numpy(), np.asarray(rX), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.diagonal(gKg.numpy(), axis1=1, axis2=2), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# warping: host numpy, the reference's own code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("open_begin, open_end", [(True, True), (False, False), (True, False)])
def test_warp_groups_match_the_reference(open_begin, open_end):
    rng = np.random.default_rng(10)
    t = np.repeat(np.linspace(0, 1, 25), 3)
    groups = np.tile([0, 1, 2], 25)
    cov = np.where(groups == 1, t ** 2, np.where(groups == 2, np.sqrt(t), t))
    Zm = np.stack([np.sin(2 * np.pi * t), np.cos(2 * np.pi * t)], 1) + 0.05 * rng.normal(size=(75, 2))
    ref = jm._warp_groups(cov, groups, Zm, 0, open_begin, open_end)
    got = tm._warp_groups(cov, groups, Zm, 0, open_begin, open_end)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[groups == 0], cov[groups == 0])


# ---------------------------------------------------------------------------
# on the card: T24 and T25 against their plain versions (skips without one)
# ---------------------------------------------------------------------------


def _card_points(cuda, n, p, G, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = torch.rand((n, p), generator=gen, device=cuda)
    g = torch.randint(0, G, (n,), generator=gen, device=cuda).float()
    return c, g


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, p, G", [(300, 300, 1, 2), (1000, 129, 2, 3), (70, 70, 1, 1)])
@pytest.mark.parametrize("groups", ["none", "independent", "learned"])
def test_gpu_rbf_kernel_matches_plain(cuda, n, m, p, G, groups):
    # exp of the same float32 argument: within 2 ulps of 1 (atol 2.5e-7)
    a, ga = _card_points(cuda, n, p, G)
    b, gb = (a, ga) if m == n else _card_points(cuda, m, p, G, seed=1)
    F = 4
    ells = torch.linspace(0.05, 0.8, F, device=cuda)
    scales = torch.linspace(0.1, 0.9, F, device=cuda)
    Kg = gp.normalize_kg(torch.randn((F, G, G), device=cuda)) if groups == "learned" else None
    g_a, g_b = (None, None) if groups == "none" else (ga, gb)
    same = m == n
    got = _launched("gp_rbf_kernel", lambda: gp.rbf_kernel(a, b, ells, scales, g_a, g_b, Kg, same))
    ref = gp.rbf_kernel_plain(a, b, ells, scales, g_a, g_b, Kg, same)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=2.5e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, G", [(300, 300, 2), (1000, 129, 3), (257, 257, 1)])
def test_gpu_kg_grad_matches_plain(cuda, n, m, G):
    # another order of float32 sums: within 1e-5 of Σ|dK|·exp(...)
    a, ga = _card_points(cuda, n, 1, G)
    b, gb = (a, ga) if m == n else _card_points(cuda, m, 1, G, seed=2)
    F = 3
    ells = torch.tensor([0.1, 0.3, 0.9], device=cuda)
    scales = torch.tensor([0.5, 0.7, 0.2], device=cuda)
    dK = torch.randn((F, n, m), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    got = _launched("gp_kg_grad", lambda: gp.kg_grad(dK, a, b, ells, scales, ga, gb, G))
    ref = gp.kg_grad_plain(dK, a, b, ells, scales, ga, gb, G)
    scale = gp.kg_grad_plain(dK.abs(), a, b, ells, scales, ga, gb, G)
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(got, gp.kg_grad(dK, a, b, ells, scales, ga, gb, G))  # the same bits


@pytest.mark.gpu
def test_gpu_gp_group_matches_cpu(cuda):
    # the Kg steps through T24 forward and T25 backward on the card, through
    # the plain build on the CPU
    c, g, Zm, Zv = _smooth_moments(11, n=200)
    args = (c, Zm, Zv, np.array([0.2, 0.1, 0.5], np.float32),
            np.array([0.8, 0.6, 0.3], np.float32), g,
            np.tile(np.eye(2, dtype=np.float32)[None], (3, 1, 1)))
    Xc, Kc = gp.gp_group(*(_t(x) for x in args))
    Xg, Kgg = gp.gp_group(*(_t(x).to(cuda) for x in args))
    torch.testing.assert_close(Kgg.cpu(), Kc, rtol=1e-4, atol=1e-4)
