"""Block assembly: the port's counterpart of coreth_tpu/miner."""
