"""App-level peer networking (counterpart of coreth_tpu/peer/)."""
