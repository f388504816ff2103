"""Out-of-process VM boundary (semantics of coreth plugin/, the
rpcchainvm plugin shape, main.go:33); counterpart of
coreth_tpu/plugin/. Serve a VM's snowman interface over a unix socket so
the consensus engine can live in another process.

    # VM process
    from coreth_tpu_torch.plugin import serve
    serve(vm, "/tmp/coreth.sock")

    # engine process
    from coreth_tpu_torch.plugin import RemoteVM
    remote = RemoteVM("/tmp/coreth.sock")
    blk = remote.build_block(); remote.block_verify(blk.id); ...
"""

from .client import RemoteBlock, RemoteVM, RemoteVMError
from .server import VMServer, serve

__all__ = ["RemoteBlock", "RemoteVM", "RemoteVMError", "VMServer", "serve"]
