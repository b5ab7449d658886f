"""Config system: YAML files with recursive single-inheritance.

The port's own copy of the loader (same merge semantics as the reference,
src/config.py:10-59): a config file may name a parent via
``inherit_from``; parents are loaded first and recursively dict-merged,
leaves win.  The CLI passes a mode-dependent default base.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Recursively merge ``src`` into ``dst`` (``src`` entries win):
    nested dicts merge key-by-key, everything else is replaced."""
    for k, v in src.items():
        if isinstance(v, dict):
            node = dst.setdefault(k, {})
            if not isinstance(node, dict):
                dst[k] = node = {}
            update_recursive(node, v)
        else:
            dst[k] = v


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving the ``inherit_from`` chain.

    If the file names a parent via ``inherit_from`` that parent is loaded
    (recursively) as the base; otherwise ``default_path`` (the mode base
    yaml) is the base.
    """
    import yaml

    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f) or {}

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # paths relative to the child config's directory as well as CWD
        if not os.path.exists(inherit_from):
            candidate = os.path.join(os.path.dirname(path), inherit_from)
            if os.path.exists(candidate):
                inherit_from = candidate
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return cfg


def get_model(cfg: Dict[str, Any], nice: bool = True, device="cuda"):
    """The scene model's (SceneSpec, SceneState) on ``device`` (reference
    src/config.py:63-79 -> src/conv_onet/config.py:16-33): parameter
    trees and apply functions instead of an nn.Module."""
    from nice_slam_torch.models import registry

    return registry.get_model(cfg, nice=nice, device=device)
