"""Multi-process communication of the port: the wire codec, the gRPC
parameter service and its client.

The reference's L2 (src/communication/): a 4-RPC gRPC service. This
package exports only what the port has: frame v2 (``wire.py``), the
service over the port's NumPy store (``service.py``) and ``RemoteStore``
(``client.py``). The JAX package's sharded store, replica, fault injector
and load generator come with the serve tier (ROADMAP §1 item 9). Importing
this package imports grpc, numpy, ml_dtypes and the port's telemetry, and
nothing of ``ps/``.
"""

from .client import RemoteStore, SessionLostError
from .service import ParameterService, RawJSON, serve
from .wire import decode_tensor_dict, encode_tensor_dict

__all__ = [
    "ParameterService",
    "RawJSON",
    "RemoteStore",
    "SessionLostError",
    "decode_tensor_dict",
    "encode_tensor_dict",
    "serve",
]
