"""The render integrator's autograd Function (``ops/integrator.py``, K7 and
K8 on the card) on the CPU, where it runs its plain forward and its
plain backward, a written-out reverse scan: held against the JAX
package's ``raw2outputs_nerf_color`` and ``jax.vjp`` of a scalar loss of
depth, depth variance and rgb, in occupancy and density mode, with
saturated alpha (occupancy >= 3, where sigmoid(10 o) rounds to 1 and a
backward that divides by 1 - alpha + 1e-10 blows up) and relu exactly at
0.  Forward rtol 1e-5; gradients within 1e-5 of the JAX gradient's
largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops import geometry as jgeo
from nice_slam_torch.ops import integrator


def _inputs(n, s, occupancy, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((n, s, 4)).astype(np.float32)
    if occupancy:
        raw[: n // 4, s // 3:, 3] = rng.uniform(3.0, 6.0, (n // 4, s - s // 3))
    else:
        raw[..., 3] = np.abs(raw[..., 3]) * 3.0
        raw[: n // 4, ::3, 3] = 0.0  # relu exactly at 0
        raw[n // 4: n // 2, s // 2:, 3] = 40.0  # alpha saturates
    z = np.sort(rng.uniform(0.1, 4.0, (n, s)), axis=-1).astype(np.float32)
    rays_d = rng.standard_normal((n, 3)).astype(np.float32)
    cot = rng.standard_normal((n, 5)).astype(np.float32)
    return raw, z, rays_d, cot


def _jax_value_and_grads(raw, z, rays_d, cot, occupancy):
    def loss(r, d):
        depth, var, rgb, _ = jgeo.raw2outputs_nerf_color(r, jnp.asarray(z), d,
                                                         occupancy=occupancy)
        return (jnp.sum(depth * cot[:, 0]) + jnp.sum(var * cot[:, 1])
                + jnp.sum(rgb * cot[:, 2:]))

    outs = jgeo.raw2outputs_nerf_color(jnp.asarray(raw), jnp.asarray(z),
                                       jnp.asarray(rays_d), occupancy=occupancy)
    grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(raw), jnp.asarray(rays_d))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("s", [48, 64])
@pytest.mark.parametrize("occupancy", [True, False], ids=["occupancy", "density"])
def test_function_matches_jax_forward_and_vjp(occupancy, s):
    raw, z, rays_d, cot = _inputs(64, s, occupancy)
    (jd, jv, jc, jw), (jgraw, jgrays) = _jax_value_and_grads(raw, z, rays_d, cot,
                                                            occupancy)
    t_raw = torch.tensor(raw, requires_grad=True)
    t_rays = torch.tensor(rays_d, requires_grad=True)
    depth, var, rgb, w = integrator.raw2outputs_nerf_color(
        t_raw, torch.tensor(z), t_rays, occupancy=occupancy)
    for got, ref in ((depth, jd), (var, jv), (rgb, jc), (w, jw)):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not w.requires_grad
    c = torch.tensor(cot)
    loss = (torch.sum(depth * c[:, 0]) + torch.sum(var * c[:, 1])
            + torch.sum(rgb * c[:, 2:]))
    g_raw, g_rays = torch.autograd.grad(loss, (t_raw, t_rays), allow_unused=True)
    assert np.isfinite(g_raw.numpy()).all()
    np.testing.assert_allclose(g_raw.numpy(), jgraw, rtol=0,
                               atol=1e-5 * np.abs(jgraw).max())
    if occupancy:
        assert g_rays is None
    else:
        np.testing.assert_allclose(g_rays.numpy(), jgrays, rtol=0,
                                   atol=1e-5 * np.abs(jgrays).max())


@pytest.mark.parametrize("occupancy", [True, False], ids=["occupancy", "density"])
def test_plain_backward_matches_autograd_of_plain_forward(occupancy):
    """The written-out reverse scan against autograd of the plain forward,
    on rays that do not saturate (where autograd's cumprod backward, which
    divides, is exact enough to compare with)."""
    raw, z, rays_d, cot = _inputs(32, 20, occupancy, seed=3)
    raw[..., 3] = np.clip(raw[..., 3], -1.0, 1.0)
    t_raw = torch.tensor(raw, requires_grad=True)
    t_rays = torch.tensor(rays_d, requires_grad=True)
    depth, var, rgb, _ = integrator.integrate_fwd_plain(t_raw, torch.tensor(z), t_rays,
                                                        occupancy)
    c = torch.tensor(cot)
    loss = (torch.sum(depth * c[:, 0]) + torch.sum(var * c[:, 1])
            + torch.sum(rgb * c[:, 2:]))
    want = torch.autograd.grad(loss, (t_raw, t_rays), allow_unused=True)
    g_raw, g_rays = integrator.integrate_bwd_plain(
        torch.tensor(raw), torch.tensor(z), torch.tensor(rays_d), depth.detach(),
        c[:, 0], c[:, 1], c[:, 2:], occupancy)
    torch.testing.assert_close(g_raw, want[0], atol=1e-5 * float(want[0].abs().max()),
                               rtol=0)
    if not occupancy:
        torch.testing.assert_close(g_rays, want[1],
                                   atol=1e-5 * float(want[1].abs().max()), rtol=0)


def test_function_raises_on_z_vals_that_require_grad():
    raw, z, rays_d, _ = _inputs(8, 6, True)
    with pytest.raises(ValueError, match="z_vals"):
        integrator.raw2outputs_nerf_color(torch.tensor(raw), torch.tensor(z,
                                          requires_grad=True), torch.tensor(rays_d))


def test_function_without_a_graph_matches_plain():
    """The importance pass's call (no graph) gives the plain forward's
    values, weights included."""
    raw, z, rays_d, _ = _inputs(16, 12, False, seed=5)
    args = (torch.tensor(raw), torch.tensor(z), torch.tensor(rays_d))
    with torch.no_grad():
        got = integrator.raw2outputs_nerf_color(*args, occupancy=False)
    for a, b in zip(got, integrator.integrate_fwd_plain(*args, occupancy=False)):
        assert torch.equal(a, b)


# K7's and K8's launch geometry (integrator.cu indexes its samples so):
# (rays, samples) of tracking, a mapping and a coarse-mapping iteration, an
# iMAP* batch, a render chunk, and shapes off every multiple
GEOMETRY_CASES = [(200, 48), (1000, 48), (1000, 32), (5000, 44), (100_000, 48),
                  (37, 1), (333, 97), (64, 300)]


def _walk(g, n, s):
    """How often K7's and K8's threads reach each (ray, sample) under
    geometry ``g``: thread x of the launch takes ray x // lanes as lane
    x % lanes, which holds sample (t * run + j) * lanes + lane of block j
    of tile t."""
    x = np.arange(g.ctas * g.threads)
    ray, lane = x // g.lanes, x % g.lanes
    blocks = -(-s // g.lanes)
    hits = []
    for t in range(g.tiles):
        for j in range(min(integrator.INTEGRATE_RUN, blocks - t * integrator.INTEGRATE_RUN)):
            i = (t * integrator.INTEGRATE_RUN + j) * g.lanes + lane
            live = (ray < n) & (i < s)
            hits.append(ray[live] * s + i[live])
    return np.bincount(np.concatenate(hits), minlength=n * s)


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("n,s", GEOMETRY_CASES)
def test_integrate_geometry_covers_every_sample_once(n, s, sms):
    """At an H100's 132 SMs, and at 16, where more calls fill the card
    and take 16 lanes a ray."""
    g = integrator.integrate_geometry(n, s, sms)
    assert g.lanes in integrator.INTEGRATE_LANES
    assert g.threads % 32 == 0 and g.rays_per_cta * g.lanes == g.threads
    counts = _walk(g, n, s)
    assert counts.shape == (n * s,) and (counts == 1).all()
    # no lane holds more than the largest template's run, and the tiled
    # path is taken exactly past it
    largest = max(integrator.INTEGRATE_LANES) * integrator.INTEGRATE_RUN
    assert g.per_lane <= integrator.INTEGRATE_RUN
    assert (g.tiles > 1) == (s > largest)


def test_integrate_geometry_spreads_tracking_over_ctas():
    """Tracking's 200 rays x 48 samples: at least 7 CTAs (a thread per
    ray gave 2)."""
    assert integrator.integrate_geometry(200, 48, 132).ctas >= 7
