"""Helpers of the serve-tier tests (``test_torch_replica.py``,
``test_torch_serve_tier.py``, ``test_torch_loadgen.py``): a shard
primary of either package on 127.0.0.1:0 over a small dict of fp32
tensors, a raw FetchParameters stub, a poll-until helper, and the fake
gRPC context of direct handler calls."""

import time
from concurrent import futures

import grpc
import numpy as np

from distributed_parameter_server_for_ml_training_tpu.comms import (
    replica as JR, service as JS)
from distributed_parameter_server_for_ml_training_tpu.ps.sharding import \
    ShardInfo as JaxShardInfo
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
    replica as PR, service as PS)
from distributed_parameter_server_for_ml_training_tpu_torch.ps.sharding \
    import ShardInfo
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)

SHAPES = {"conv/kernel": (3, 3, 3, 16), "dense/kernel": (16, 10),
          "dense/bias": (10,)}

#: Each package's replica module, by name.
REPLICA = {"jax": JR, "port": PR}


def params() -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def grads(i: int) -> dict:
    rng = np.random.default_rng(100 + i)
    return {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
            for k, s in SHAPES.items()}


def primary(pkg: str = "port"):
    """One sharded (1 of 1) async primary of ``pkg`` on 127.0.0.1:0; the
    shard map names its real address, so topology fallback works.
    Returns (store, service, server, address)."""
    if pkg == "jax":
        store = JaxStore(params(), JaxConfig(mode="async", total_workers=1,
                                             push_codec="none",
                                             staleness_bound=100))
        sharding = JaxShardInfo(0, 1, ["pending"])
        svc = JS.ParameterService(store, sharding=sharding)
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=16),
                             options=JS.GRPC_OPTIONS)
        server.add_generic_rpc_handlers((svc.handlers(),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
    else:
        store = ParameterStore(params(), StoreConfig(
            mode="async", total_workers=1, push_codec="none",
            staleness_bound=100))
        sharding = ShardInfo(0, 1, ["pending"])
        svc = PS.ParameterService(store, sharding=sharding)
        server, port = PS.serve(store, port=0, service=svc,
                                host="127.0.0.1")
    address = f"127.0.0.1:{port}"
    sharding.primaries[0] = address
    return store, svc, server, address


def fetch_stub(address: str):
    """(channel, raw FetchParameters callable) to ``address``."""
    ident = lambda b: b  # noqa: E731
    channel = grpc.insecure_channel(address, options=PS.GRPC_OPTIONS)
    return channel, channel.unary_unary(
        f"/{PS.SERVICE_NAME}/FetchParameters", request_serializer=ident,
        response_deserializer=ident)


def rpc_stub(channel, name: str):
    ident = lambda b: b  # noqa: E731
    return channel.unary_unary(f"/{PS.SERVICE_NAME}/{name}",
                               request_serializer=ident,
                               response_deserializer=ident)


def wait(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


class Ctx:
    """Fake gRPC context of a direct handler call: an abort raises."""

    def abort(self, code, detail):
        raise AssertionError(f"abort {code}: {detail}")
