"""The port's geometry core, config loader and grid sizing against the JAX
package on the same numpy inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu import config as jconfig
from nice_slam_tpu.models import grids as jgrids
from nice_slam_tpu.ops import geometry as jgeo
from nice_slam_tpu.slam import tracker as jtracker
from nice_slam_torch import config as tconfig
from nice_slam_torch.models import grids as tgrids
from nice_slam_torch.ops import geometry as tgeo
from nice_slam_torch.ops import integrator
from nice_slam_torch.slam import tracker as ttracker

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize("occupancy", [True, False], ids=["occupancy", "density"])
def test_raw2outputs_matches_jax(occupancy):
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((40, 24, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 5.0, (40, 24)), axis=-1).astype(np.float32)
    rays_d = rng.standard_normal((40, 3)).astype(np.float32)
    ref = jgeo.raw2outputs_nerf_color(jnp.asarray(raw), jnp.asarray(z),
                                      jnp.asarray(rays_d), occupancy=occupancy)
    got = integrator.raw2outputs_nerf_color(torch.tensor(raw), torch.tensor(z),
                                            torch.tensor(rays_d), occupancy=occupancy)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_pose_conversions_match_jax():
    rng = np.random.default_rng(1)
    # unnormalized quaternions, as the tracker descends them
    t = rng.standard_normal((16, 7)).astype(np.float32)
    ref = jax.vmap(jgeo.pose_from_tensor)(jnp.asarray(t))
    got = tgeo.pose_from_tensor(torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    single = tgeo.pose_from_tensor(torch.tensor(t[0]))
    np.testing.assert_allclose(single.numpy(), np.asarray(ref[0]), atol=1e-5)

    RT = np.asarray(ref)
    back_ref = jax.vmap(jgeo.tensor_from_pose)(jnp.asarray(RT))
    back = tgeo.tensor_from_pose(torch.tensor(RT))
    np.testing.assert_allclose(back.numpy(), np.asarray(back_ref), atol=1e-5)


def test_rays_far_and_normalization_match_jax():
    rng = np.random.default_rng(2)
    i = rng.uniform(0, 80, 50).astype(np.float32)
    j = rng.uniform(0, 60, 50).astype(np.float32)
    c2w = np.asarray(jgeo.pose_from_tensor(jnp.asarray(
        np.array([0.9, 0.1, -0.2, 0.3, 0.2, -0.1, 0.4], np.float32))))
    ro_j, rd_j = jgeo.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                   jnp.asarray(c2w), 60.0, 61.0, 39.5, 29.5)
    ro_t, rd_t = tgeo.rays_from_uv(torch.tensor(i), torch.tensor(j),
                                   torch.tensor(c2w), 60.0, 61.0, 39.5, 29.5)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
    bound = np.array([[-2.0, 2.5], [-1.5, 2.0], [-3.0, 1.0]], np.float32)
    far_j = jgeo.ray_aabb_far(ro_j, rd_j, jnp.asarray(bound))
    far_t = tgeo.ray_aabb_far(ro_t, rd_t, torch.tensor(bound))
    np.testing.assert_allclose(far_t.numpy(), np.asarray(far_j), rtol=1e-5)
    p = rng.uniform(-3, 3, (30, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.normalize_3d_coordinate(torch.tensor(p), torch.tensor(bound)).numpy(),
        np.asarray(jgeo.normalize_3d_coordinate(jnp.asarray(p),
                                                jnp.asarray(bound))), atol=1e-6)


@pytest.mark.parametrize("lo,hi,n", [(0.0, 1.0, 32), (-2.9, 8.94, 74),
                                     (-3.5, 3.54, 43), (0.0, 1.0, 16)])
def test_linspace_matches_jnp(lo, hi, n):
    """Bitwise on [0, 1] (the render's sample spacing); within one f32 ulp
    of the endpoints' scale elsewhere (the frustum lattice)."""
    ref = np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi), n))
    got = tgeo.linspace(torch.tensor(lo, dtype=torch.float32),
                        torch.tensor(hi, dtype=torch.float32), n).numpy()
    if (lo, hi) == (0.0, 1.0):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=np.spacing(np.float32(max(abs(lo), hi))))


def test_masked_lower_median_matches_jax():
    rng = np.random.default_rng(3)
    for n_keep in (1, 6, 7):
        x = rng.uniform(0, 10, 12).astype(np.float32)
        mask = np.zeros(12, bool)
        mask[rng.choice(12, n_keep, replace=False)] = True
        ref = jtracker.masked_lower_median(jnp.asarray(x), jnp.asarray(mask))
        got = ttracker.masked_lower_median(torch.tensor(x), torch.tensor(mask))
        assert float(got) == float(ref)


def test_config_and_grid_sizing_match_jax():
    box = os.path.join(ROOT, "configs", "Synthetic", "box.yaml")
    base = os.path.join(ROOT, "configs", "nice_slam.yaml")
    cfg_t = tconfig.load_config(box, base)
    assert cfg_t == jconfig.load_config(box, base)
    # the Replica-room scene the benchmark sizes
    bound = np.array([[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]])
    gl = dict(cfg_t["grid_len"])
    bt = tgrids.round_bound(bound, gl["bound_divisible"])
    np.testing.assert_array_equal(bt, jgrids.round_bound(bound,
                                                         gl["bound_divisible"]))
    shapes = tgrids.grid_shapes(bt, gl, True, 2.0)
    assert shapes == jgrids.grid_shapes(bt, gl, True, 2.0)
    assert shapes["grid_fine"] == (74, 56, 43)
    assert shapes["grid_coarse"] == (11, 8, 7)
