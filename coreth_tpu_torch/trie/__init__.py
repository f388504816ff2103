"""Merkle-Patricia-Trie: the port's counterpart of coreth_tpu/trie."""
