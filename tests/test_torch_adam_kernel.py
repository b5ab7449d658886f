"""The port's group Adam on the CPU, the path K9 (``csrc/adam.cu``) takes
on the card, against the JAX package's ``group_adam_update`` over 60
steps: three grid groups with frustum masks applied in the step (the
JAX mapper multiplies them into the gradients first), a decoder group
that joins late and is inactive until then, a camera group at lr 0 that
still advances its moments and count, a leaf whose gradient is None
(zero), and the tracker's per-entry lr vector.  Values, moments and
counts within 1e-6 relative (the two packages share the arithmetic,
float32 bias corrections included)."""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from nice_slam_tpu.slam import optim as joptim
from nice_slam_torch.slam.optim import GroupAdam

STEPS = 60
SHAPES = {"grid_middle": (5, 4, 3, 8), "grid_fine": (7, 6, 5, 8),
          "grid_color": (7, 6, 5, 8)}


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_group_adam_with_masks_lr0_and_per_entry_lr_matches_jax():
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    init["dec"] = {"b": rng.standard_normal(8).astype(np.float32),
                   "w": rng.standard_normal((8, 8)).astype(np.float32)}
    init["cams"] = rng.standard_normal((3, 7)).astype(np.float32)
    init["track"] = rng.standard_normal(7).astype(np.float32)
    masks = {k: (rng.uniform(size=s[:3] + (1,)) < 0.6).astype(np.float32)
             for k, s in SHAPES.items()}
    lr_vec = np.array([0.2] * 4 + [1.0] * 3, np.float32) * 1e-3

    jp = {k: (jnp.asarray(v) if not isinstance(v, dict)
              else {a: jnp.asarray(b) for a, b in v.items()}) for k, v in init.items()}
    js = joptim.init_group_adam(jp)
    tp = {k: (torch.tensor(v) if not isinstance(v, dict)
              else {a: torch.tensor(b) for a, b in v.items()}) for k, v in init.items()}
    ours = GroupAdam(tp)
    tmasks = {k: [torch.tensor(m)] for k, m in masks.items()}
    for it in range(STEPS):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        g["dec"] = {"b": rng.standard_normal(8).astype(np.float32),
                    "w": rng.standard_normal((8, 8)).astype(np.float32)}
        g["cams"] = rng.standard_normal((3, 7)).astype(np.float32)
        g["track"] = rng.standard_normal(7).astype(np.float32)
        none_b = it % 3 == 0  # the decoder's bias has no gradient this step
        active = {**{k: True for k in SHAPES}, "dec": it >= 20, "cams": True,
                  "track": True}
        lrs = {"grid_middle": 0.1, "grid_fine": 0.005, "grid_color": 0.005,
               "dec": 0.001, "cams": 0.0}
        jg = {k: jnp.asarray(g[k] * masks[k]) for k in SHAPES}
        jg["dec"] = {"b": jnp.zeros(8) if none_b else jnp.asarray(g["dec"]["b"]),
                     "w": jnp.asarray(g["dec"]["w"])}
        jg["cams"] = jnp.asarray(g["cams"])
        jg["track"] = jnp.asarray(g["track"])
        jp, js = joptim.group_adam_update(jp, jg, js,
                                          dict(lrs, track=jnp.asarray(lr_vec)), active)
        tg = {k: [torch.tensor(g[k])] for k in SHAPES}
        tg["dec"] = [None if none_b else torch.tensor(g["dec"]["b"]),
                     torch.tensor(g["dec"]["w"])]  # sorted-key order: b, w
        tg["cams"] = [torch.tensor(g["cams"])]
        tg["track"] = [torch.tensor(g["track"])]
        ours.step(tg, dict(lrs, track=torch.tensor(lr_vec)), active, tmasks)
    for k in SHAPES:
        _close(tp[k].numpy(), np.asarray(jp[k]))
        _close(ours.mu[k][0].numpy(), np.asarray(js.mu[k]))
        _close(ours.nu[k][0].numpy(), np.asarray(js.nu[k]))
        # masked-out nodes never move
        off = masks[k][..., 0] == 0
        assert np.array_equal(tp[k].numpy()[off], init[k][off])
    for i, leaf in enumerate(("b", "w")):
        _close(tp["dec"][leaf].numpy(), np.asarray(jp["dec"][leaf]))
        _close(ours.mu["dec"][i].numpy(), np.asarray(js.mu["dec"][leaf]))
        _close(ours.nu["dec"][i].numpy(), np.asarray(js.nu["dec"][leaf]))
    for k in ("cams", "track"):
        _close(tp[k].numpy(), np.asarray(jp[k]))
        _close(ours.mu[k][0].numpy(), np.asarray(js.mu[k]))
        _close(ours.nu[k][0].numpy(), np.asarray(js.nu[k]))
    assert np.array_equal(tp["cams"].numpy(), init["cams"])  # lr 0
    assert ours.steps == {k: int(v) for k, v in js.steps.items()}
    assert ours.steps["dec"] == STEPS - 20 and ours.steps["cams"] == STEPS


@pytest.mark.parametrize("inactive", [True, False])
def test_an_inactive_group_is_untouched(inactive):
    p = torch.ones(4)
    ours = GroupAdam({"a": p})
    ours.step({"a": [torch.ones(4)]}, {"a": 0.1}, {"a": not inactive})
    assert torch.equal(p, torch.ones(4)) == inactive
    assert ours.steps["a"] == int(not inactive)
    assert torch.equal(ours.mu["a"][0], torch.zeros(4)) == inactive
