# coding=utf-8
"""The port's host-side build (mesher copy, element data, assembly plan,
state conversion) against the JAX package on the same inputs."""

import os

import numpy as np
import pytest
import torch

from fem_tpu.models import mesh as jmesh
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops.assembly import build_gather_plan as jax_build_gather_plan
from fem_tpu.utils.config import ObjectConfig as JaxObjectConfig
from fem_tpu_torch import convert
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import build_object
from fem_tpu_torch.utils.config import ObjectConfig, read_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(sub):
    cfg = ObjectConfig(subdivisions=sub, side_length=0.2, center=(0.4, 0.6, 0.4))
    return cfg, pmesh.construct_3d_grid_mesh(cfg)


def test_grid_mesh_matches():
    for sub in (3, 4):
        cfg, (v, f, t) = _grid(sub)
        jv, jf, jt = jmesh.construct_3d_grid_mesh(
            JaxObjectConfig(subdivisions=sub, side_length=0.2)
        )
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(t, jt)


def test_2d_mesh_matches():
    cfg = ObjectConfig(subdivisions=5)
    for got, ref in zip(
        pmesh.construct_2d_mesh(cfg),
        jmesh.construct_2d_mesh(JaxObjectConfig(subdivisions=5)),
    ):
        np.testing.assert_array_equal(got, ref)


def test_cube_stl_mesher_matches():
    """The mesher copy gives the JAX package's nodes and tets for the
    repository's cube (uncached on both sides, so each really meshes)."""
    path = os.path.join(REPO, "assets", "cube.stl")
    sv, sf = pmesh.load_surface_mesh(path)
    jsv, jsf = jmesh.load_surface_mesh(path)
    np.testing.assert_array_equal(sv, jsv)
    np.testing.assert_array_equal(sf, jsf)
    nodes, tets = pmesh.delaunay_tetrahedralize(sv, sf, 0.35)
    jnodes, jtets = jmesh.delaunay_tetrahedralize(jsv, jsf, 0.35)
    np.testing.assert_array_equal(nodes, jnodes)
    np.testing.assert_array_equal(tets, jtets)
    assert pmesh._MESHER_VERSION == jmesh._MESHER_VERSION


def test_flagship_config_parses_alike():
    from fem_tpu.utils.config import read_config as jax_read_config

    path = os.path.join(REPO, "configs", "demo_spot.json")
    got, ref = read_config(path), jax_read_config(path)
    assert got.objects[0].__dict__ == ref.objects[0].__dict__
    assert got.blocks[0].__dict__ == ref.blocks[0].__dict__
    for field in ("dim", "delta_time", "sim_count", "implicit_method",
                  "preconditioned", "g_dir", "cg_precond"):
        assert getattr(got, field) == getattr(ref, field)


@pytest.mark.parametrize("sub", [3, 4])
def test_build_object_matches(sub):
    cfg, (v, f, t) = _grid(sub)
    obj, state = build_object(cfg, v, f, t, device="cpu")
    jcfg = JaxObjectConfig(
        subdivisions=sub, side_length=0.2, center=(0.4, 0.6, 0.4)
    )
    jobj, jstate = jax_build_object(jcfg, v, f, t)
    np.testing.assert_array_equal(
        obj.element_indices.numpy(), np.asarray(jobj.element_indices)
    )
    for name in ("ref_inv", "volume", "mass", "rest_pos"):
        np.testing.assert_allclose(
            getattr(obj, name).numpy(), np.asarray(getattr(jobj, name)),
            rtol=1e-6, atol=1e-6, err_msg=name,
        )
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos), atol=1e-6)
    plan = jax_build_gather_plan(np.asarray(jobj.element_indices), jobj.particle_cnt)
    np.testing.assert_array_equal(obj.plan.idx.numpy(), plan)
    for name in ("dim", "particle_cnt", "element_cnt", "mu", "s_lambda", "damping"):
        assert getattr(obj, name) == getattr(jobj, name), name


def test_csr_plan_holds_the_padded_plan():
    cfg, (v, f, t) = _grid(3)
    obj, _ = build_object(cfg, v, f, t, device="cpu")
    idx, ptr, rows = (x.numpy() for x in (obj.plan.idx, obj.plan.ptr, obj.plan.rows))
    sentinel = t.size
    assert ptr[0] == 0 and ptr[-1] == rows.size == t.size
    for p in range(obj.particle_cnt):
        padded = idx[p][idx[p] != sentinel]
        np.testing.assert_array_equal(rows[ptr[p]:ptr[p + 1]], padded)
        assert np.all(t.reshape(-1)[padded] == p)


def test_convert_round_trips_jax_arrays():
    cfg, (v, f, t) = _grid(3)
    jobj, jstate = jax_build_object(
        JaxObjectConfig(subdivisions=3, side_length=0.2, center=(0.4, 0.6, 0.4)),
        v, f, t,
    )
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, device="cpu")
    back, back_statics = convert.object_to_arrays(obj)
    for n in convert.OBJECT_ARRAYS:
        np.testing.assert_array_equal(back[n], arrays[n], err_msg=n)
    assert back_statics == {n: statics[n] for n in convert.OBJECT_STATICS}
    state_arrays = {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS}
    state = convert.state_from_arrays(state_arrays, device="cpu")
    for n, a in convert.state_to_arrays(state).items():
        np.testing.assert_array_equal(a, state_arrays[n])
    # Inelastic statics carry across since ROADMAP M14; Rayleigh damping,
    # pins and loads since M13.
    statics["damping_beta"] = 0.05
    n = arrays["rest_pos"].shape[0]
    rng = np.random.default_rng(0)
    arrays.update(
        free_mask=(rng.uniform(size=(n, 1)) > 0.2).astype(np.float32),
        pin_vel=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        static_load=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
    )
    obj = convert.object_from_arrays(arrays, statics, device="cpu")
    assert obj.damping_beta == 0.05
    back, back_statics = convert.object_to_arrays(obj)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    assert back_statics["damping_beta"] == 0.05
