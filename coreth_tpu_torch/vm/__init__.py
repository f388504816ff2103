"""The snowman VM and what it needs: the port's counterpart of
coreth_tpu/vm."""
