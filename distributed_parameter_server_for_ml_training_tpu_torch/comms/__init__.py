"""Multi-process communication of the port: the wire codec, the gRPC
parameter service and its clients.

The reference's L2 (src/communication/): a 4-RPC gRPC service. This
package exports what the port has: frame v2 (``wire.py``), the service
over any of the port's stores, unsharded or one shard primary
(``service.py``), ``RemoteStore`` (``client.py``) and its per-shard
fan-out ``ShardedRemoteStore`` (``sharded.py``). The JAX package's
replica, fault injector and load generator come with item 9's later
parts. Of ``ps/`` this package imports only the shard partition
(``ps/sharding.py``).
"""

from .client import RemoteStore, SessionLostError
from .service import ParameterService, RawJSON, serve
from .sharded import ShardedRemoteStore
from .wire import decode_tensor_dict, encode_tensor_dict

__all__ = [
    "ParameterService",
    "RawJSON",
    "RemoteStore",
    "SessionLostError",
    "ShardedRemoteStore",
    "decode_tensor_dict",
    "encode_tensor_dict",
    "serve",
]
