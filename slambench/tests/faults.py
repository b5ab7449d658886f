"""Faults planted underneath the timed path, for showing that the
comparison catches them: ``plant(name, setattr)`` replaces functions of
the system through ``setattr(owner, attribute, value)`` (pytest's
``monkeypatch.setattr``, or one that records what to restore).

  * ``state_unchanged``: the optimiser's step returns the state as it was;
  * ``half_batch``: each loss on half of its rays, doubled (the mean over
    the rest);
  * ``answer_altered``: the rendered depth 1 cm off where it is produced;
  * ``step_flipped``: every optimiser step taken the other way (its norm
    unchanged).
"""

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "step_flipped")


def _halve(fn_name):
    """A loss computed on half of its rays, scaled to the whole."""
    import nice_slam_torch.slam.mapper as M
    import nice_slam_torch.slam.tracker as T

    if fn_name == "tracking":
        orig = T.tracking_loss_sampled

        def tracking_loss_sampled(spec, state, cam, pi, pj, pd, pc, tcfg, rcfg):
            h = pi.shape[0] // 2
            return 2.0 * orig(spec, state, cam, pi[:h], pj[:h], pd[:h], pc[:h], tcfg, rcfg)
        return T, "tracking_loss_sampled", tracking_loss_sampled
    orig = M.mapping_loss

    def mapping_loss(spec, groups, base, colors, depths, fixed, mask, valid, stage, mcfg, rcfg,
                     n, pix_idx=None, gen=None, reg_t=None, devices=None):
        if pix_idx is None:
            pix_idx = torch.randint(0, mcfg.H * mcfg.W, (colors.shape[0], n), generator=gen,
                                    device=colors.device)
        h = n // 2
        if reg_t is not None:
            reg_t = reg_t.reshape(colors.shape[0], n, -1)[:, :h].reshape(-1, reg_t.shape[-1])
        return 2.0 * orig(spec, groups, base, colors, depths, fixed, mask, valid, stage, mcfg,
                          rcfg, h, pix_idx[:, :h], gen, reg_t, devices)
    return M, "mapping_loss", mapping_loss


def plant(name, setattr):
    import nice_slam_torch.slam.mapper as M
    import nice_slam_torch.slam.optim as O
    import nice_slam_torch.slam.tracker as T

    if name == "state_unchanged":
        setattr(O.GroupAdam, "step", lambda self, *a, **k: None)
    elif name == "half_batch":
        for which in ("tracking", "mapping"):
            setattr(*_halve(which))
    elif name == "answer_altered":
        for mod in (M, T):
            orig = mod.render_batch_ray

            def render_batch_ray(*a, __orig=orig, **k):
                depth, unc, color = __orig(*a, **k)
                return depth + 0.01, unc, color  # 1 cm off where the depth is rendered
            setattr(mod, "render_batch_ray", render_batch_ray)
    elif name == "step_flipped":
        orig_step = O.GroupAdam.step

        def step(self, *a, **k):
            before = {g: [p.detach().clone() for p in ps] for g, ps in self.params.items()}
            out = orig_step(self, *a, **k)
            with torch.no_grad():
                for g, ps in self.params.items():
                    for p, b in zip(ps, before[g]):
                        p.copy_(2 * b - p)
            return out
        setattr(O.GroupAdam, "step", step)
    else:
        raise KeyError(name)
