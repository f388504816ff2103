"""State sync (counterpart of coreth_tpu/sync/)."""
