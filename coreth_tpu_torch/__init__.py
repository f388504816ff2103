"""PyTorch/CUDA port of coreth_tpu's state commitment.

Module names mirror coreth_tpu/ so each counterpart is easy to find. The
package imports torch and numpy, never jax or coreth_tpu: it keeps its own
copies of the pure-Python modules it needs. Entry points take an explicit
`device`; with none given they run on CUDA and raise when it is absent
(device.resolve).
"""
