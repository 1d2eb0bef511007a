from fugue_tpu_torch.rpc.base import (
    EmptyRPCHandler,
    NativeRPCServer,
    RPCClient,
    RPCFunc,
    RPCHandler,
    RPCServer,
    make_rpc_server,
    to_rpc_handler,
)
