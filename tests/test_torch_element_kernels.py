# coding=utf-8
"""K1: the port's element chain (plain PyTorch version, which the CUDA kernel
is held to on the card) against the JAX package's Pallas element kernel
``hessian_and_force_pallas`` (interpret mode on the CPU).

Tolerance: rtol 1e-5 / atol 1e-6, with rtol taken relative to each tet's
block magnitude (max |entry| of its 3×3 block).  Both sides evaluate the same
formulas in the same order in float32, but entries of a block cancel: a small
entry carries the rounding of its large neighbours, so even the JAX kernel
misses an entrywise 1e-5 against a float64 evaluation on some entries, while
block-relative differences stay below 3e-6.  The JAX package's own kernel
tests scale by magnitude the same way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.pallas_kernels import hessian_and_force_pallas
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import build_object
from fem_tpu_torch.ops import element
from fem_tpu_torch.ops.element_kernels import (
    hessian_and_force,
    hessian_and_force_plain,
)
from fem_tpu_torch.utils.config import ObjectConfig

torch.set_num_threads(1)


def _grid_object(sub, E=4e4):
    cfg = ObjectConfig(
        subdivisions=sub, side_length=0.2, center=(0.4, 0.6, 0.4), E=E
    )
    v, f, t = pmesh.construct_3d_grid_mesh(cfg)
    return build_object(cfg, v, f, t, device="cpu")


def _deformed_pos(obj, state, seed, squash):
    """Random deformation.  With ``squash`` the body is first compressed
    uniformly to 4% of its size, so every tet has det F ≈ 6.4e-5 — below
    the 1e-4 clamp while F stays well conditioned (a sliver tet would be
    ill conditioned, and float32 rounding would then dominate any
    comparison) — and the last tet's vertex 3 is mirrored through its face
    plane, so that tet is inverted (det F < 0)."""
    rng = np.random.default_rng(seed)
    pos = state.pos.numpy().astype(np.float64)
    scale = 0.04 if squash else 1.0
    c = pos.mean(axis=0, keepdims=True)
    pos = c + scale * (pos - c + rng.uniform(-0.01, 0.01, pos.shape))
    if squash:
        idx = obj.element_indices.numpy()[-1]
        p0, p1, p2, p3 = (pos[i] for i in idx)
        n = np.cross(p1 - p0, p2 - p0)
        n /= np.linalg.norm(n)
        pos[idx[3]] = p3 - 2.0 * np.dot(p3 - p0, n) * n
    return pos.astype(np.float32)


def _jax(obj, pos):
    k, h = hessian_and_force_pallas(
        jnp.asarray(pos), jnp.asarray(obj.element_indices.numpy()),
        jnp.asarray(obj.ref_inv.numpy()), jnp.asarray(obj.volume.numpy()),
        obj.mu, obj.s_lambda,
    )
    return np.asarray(k), np.asarray(h)


def assert_blocks_close(got, ref, rtol, atol):
    """|got − ref| ≤ atol + rtol·max|ref_e| for every entry of block e."""
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    err = np.abs(got - ref)
    bad = err > atol + rtol * scale
    assert not bad.any(), (
        f"{bad.sum()} entries off; worst block-relative error "
        f"{(err / scale).max():.3g}"
    )


def _det_f(obj, pos):
    f = element.deformation_gradients(
        torch.as_tensor(pos), obj.element_indices, obj.ref_inv
    )
    return torch.linalg.det(f.double()).numpy()


@pytest.mark.parametrize(
    "sub,seed,squash", [(3, 0, False), (3, 1, True), (4, 2, True)]
)
def test_element_chain_matches_pallas(sub, seed, squash):
    obj, state = _grid_object(sub)
    pos = _deformed_pos(obj, state, seed, squash)
    if squash:
        det = _det_f(obj, pos)
        assert 0.0 < det[0] < 1e-4, det[0]  # the clamp is exercised
        assert det[-1] < 0.0  # an inverted tet
    k, h = hessian_and_force(
        torch.as_tensor(pos), obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )
    jk, jh = _jax(obj, pos)
    assert k.shape == jk.shape == (obj.element_cnt, 3, 3)
    assert np.isfinite(k.numpy()).all() and np.isfinite(h.numpy()).all()
    assert_blocks_close(k.numpy(), jk, rtol=1e-5, atol=1e-6)
    assert_blocks_close(h.numpy(), jh, rtol=1e-5, atol=1e-6)


def test_two_logarithms():
    """K clamps det F at 1e-4 and the rhs uses log(det F²): for an inverted
    tet K takes the clamped log while the force stays finite and equals the
    |det F| form."""
    obj, state = _grid_object(3)
    pos = _deformed_pos(obj, state, 1, True)
    p = torch.as_tensor(pos)
    k, h = hessian_and_force_plain(
        p, obj.element_indices, obj.ref_inv, obj.volume, obj.mu, obj.s_lambda
    )
    e = obj.element_cnt - 1
    f = element.deformation_gradients(p, obj.element_indices, obj.ref_inv)[e].double()
    r = obj.ref_inv[e].double()
    vol = float(obj.volume[e])
    mu, lam = obj.mu, obj.s_lambda
    f_inv_t = torch.linalg.inv(f).T
    det = torch.linalg.det(f)
    assert det < 0
    blk = (
        mu * r + (mu - lam * np.log(1e-4)) * f_inv_t @ r.T @ f_inv_t
        + lam * torch.trace(torch.linalg.inv(f) @ r) * f_inv_t
    )
    np.testing.assert_allclose(k[e].double(), -vol * blk @ r.T, rtol=2e-4)
    p_stress = mu * f + (lam * torch.log(torch.abs(det)) - mu) * f_inv_t
    np.testing.assert_allclose(h[e].double(), -vol * p_stress @ r.T, rtol=2e-4)


def test_split_functions_agree_with_the_fused_chain():
    obj, state = _grid_object(3)
    p = torch.as_tensor(_deformed_pos(obj, state, 3, False))
    args = (p, obj.element_indices, obj.ref_inv, obj.volume, obj.mu, obj.s_lambda)
    k, h = hessian_and_force_plain(*args)
    torch.testing.assert_close(element.hessian_blocks(*args), k, rtol=0, atol=0)
    torch.testing.assert_close(
        element.implicit_force_columns(*args), h, rtol=0, atol=0
    )


def test_wrapper_rejects_unported_options():
    """Every material and ``robust`` run since ROADMAP M11; a material the
    JAX package does not know raises, as its ``energy_density`` does."""
    obj, state = _grid_object(3)
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume, 1.0, 1.0)
    for material in ("rubber", "stvk:2", "neo_hookean:0.5"):
        with pytest.raises(ValueError, match="unknown material"):
            hessian_and_force(*args, material=material)
    with pytest.raises(ValueError, match="mooney_rivlin beta"):
        hessian_and_force(*args, material="mooney_rivlin:1.5")
    k, h = hessian_and_force(*args, robust=True, material="stvk")
    assert torch.isfinite(k).all() and torch.isfinite(h).all()
