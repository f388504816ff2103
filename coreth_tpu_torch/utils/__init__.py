"""Shared helpers (semantics of coreth utils/); counterpart of
coreth_tpu/utils/__init__.py.

The reference's one helper here, `enable_compilation_cache`, persists XLA
compilations across processes. The port compiles no XLA program, so it has
no counterpart (ROADMAP "Still to port", item 3b.2 lists it as not to be
ported); the CUDA kernels are cached as shared libraries under
coreth_tpu_torch/_build/ instead.
"""
