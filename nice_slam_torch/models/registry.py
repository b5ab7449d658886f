"""Model registry: config -> scene model; counterpart of the JAX package's
``models/registry.py``.

The reference routes model construction through a method registry
(src/config.py:5-7,63-79 -> src/conv_onet/config.py:4-33); the port has
one scene-model family, so the registry is a thin dispatch kept for
API parity.
"""

from __future__ import annotations

from typing import Any, Dict

from nice_slam_torch.models.scene import build_scene


def get_model(cfg: Dict[str, Any], nice: bool = True, seed: int = 0,
              device="cuda"):
    """(SceneSpec, SceneState) of the configured model family on
    ``device``: ``nice=True`` the hierarchical-grid NICE stack,
    ``nice=False`` the iMAP* single MLP (reference
    src/conv_onet/config.py:23-32)."""
    return build_scene(cfg, nice=nice, seed=seed, device=device)
