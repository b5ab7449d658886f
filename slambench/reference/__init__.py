"""The benchmark's plain PyTorch reference: ``core`` (cameras, rendering,
losses, Adam, frustum selection) and one module per model family, named
by a configuration's ``model`` key."""
