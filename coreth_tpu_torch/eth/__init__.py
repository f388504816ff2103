"""Eth node backend + APIs (semantics of coreth eth/ and
internal/ethapi); counterpart of coreth_tpu/eth/."""
