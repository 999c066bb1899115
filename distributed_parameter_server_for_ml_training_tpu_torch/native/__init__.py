"""The C++ parameter arena of the port, bound with ctypes.

The host-side hot paths of the parameter server in repo C++
(``native/ps_core.cpp``, shared with the JAX package): a contiguous-arena
parameter store with seqlock fetches and fused decode + staleness-weighted
SGD pushes, plus multithreaded fp16/bf16 casts. The port builds the
library from that source at first use into ``build/torch_native/``
(``bindings.py``) and binds it with ctypes; a failed build raises.
"""

from .bindings import load_library
from .store import NativeParameterStore

__all__ = ["load_library", "NativeParameterStore"]
