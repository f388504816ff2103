"""Chain data: the port's counterpart of coreth_tpu/core (the database
schema, block types and genesis so far)."""
