"""The port's collective byte count (``utils/collective_bytes.py``, the
recorders that ``parallel/multihost.py``'s collectives add to) against the
JAX package's HLO count (``utils/hlo_bytes.py``).

- ``sync_grad_mean_bytes`` at R = 4 and 8 with a 2^20-value gradient, its
  means run over R thread-ranks on gloo: none moves 2 (R-1)/R x 4 x 2^20
  bytes a rank, bf16 half of none, int8 below 0.7 x bf16 (the bar of the
  JAX package's ``test_quantize.py``), and every total equal to the JAX
  harness's on R virtual devices (its bf16 is the half of f32 it reports
  where XLA's CPU backend widens the all-reduce);
- the traffic model: nested recorders, one rank's zeros, a broadcast;
- sync data parallelism over ranks reports ``wire_bytes_per_slot`` for
  none, fp16 and bf16: the rank's all-reduce of the card's mean.
"""

import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.utils.hlo_bytes \
    import sync_grad_mean_bytes as jax_sync_grad_mean_bytes
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import (
    DATA_AXIS, make_global_mesh, make_sync_dp_step, shard_batch_global)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    multihost as mh
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import server_sgd
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import create_train_state
from distributed_parameter_server_for_ml_training_tpu_torch.utils import \
    collective_bytes as cb
from torch_threads import one_torch_thread_per_module  # noqa: F401

SIZE = 2 ** 20


@pytest.mark.parametrize("n", [4, 8])
def test_wire_bytes_below_bf16(n):
    stats = cb.sync_grad_mean_bytes(n, SIZE)
    expect_none = 2 * (n - 1) / n * SIZE * 4
    assert stats["none"] == {"total": int(expect_none),
                             "by_op": {"all-reduce": int(expect_none)},
                             "count": {"all-reduce": 1}}
    assert stats["bf16"]["total"] == stats["none"]["total"] // 2
    assert stats["int8"]["total"] < 0.7 * stats["bf16"]["total"], stats
    # One hop carries an int8 payload (codes and scales) per hop of the
    # reduce-scatter and the all-gather rings.
    assert stats["int8"]["count"] == {"collective-permute": 2 * (n - 1)}


@pytest.mark.parametrize("n", [4, 8])
def test_totals_equal_the_jax_hlo_count(devices, n):
    """Each mode's bytes equal what the JAX harness reads off the HLO of
    the same mean on ``n`` devices (JAX sends an int8 hop's codes and
    scales as two collective-permutes, so only bytes are compared)."""
    got = cb.sync_grad_mean_bytes(n, SIZE)
    want = jax_sync_grad_mean_bytes(n, SIZE)
    for mode in ("none", "bf16", "int8"):
        assert got[mode]["total"] == want[mode]["total"], mode
        assert got[mode]["by_op"] == want[mode]["by_op"], mode


def test_traffic_model_and_nested_recorders():
    assert cb.open_recorders() == ()
    cb.note("all-reduce", 1000, 4)                 # no recorder: nothing
    with cb.record_collectives() as outer:
        cb.note("all-reduce", 1000, 4)
        with cb.record_collectives() as inner:
            cb.note("collective-permute", 96, 2)
            cb.note("broadcast", 1000, 4)
            cb.note("all-reduce", 1000, 1)
            cb.note("collective-permute", 96, 1)
        saved = cb.open_recorders()
    assert inner.summary() == {
        "total": 96 + 750,
        "by_op": {"collective-permute": 96, "broadcast": 750,
                  "all-reduce": 0},
        "count": {"collective-permute": 2, "broadcast": 1, "all-reduce": 1}}
    assert outer.summary()["by_op"] == {"all-reduce": 1500,
                                        "collective-permute": 96,
                                        "broadcast": 750}
    with cb.recording(saved):
        cb.note("all-reduce", 8, 2)
    assert outer.by_op["all-reduce"] == 1508 and cb.open_recorders() == ()
    with pytest.raises(ValueError, match="no traffic model"):
        with cb.record_collectives():
            cb.note("all-to-all", 8, 2)


def test_collectives_count_what_they_move():
    """Over 2 thread-ranks: an all-reduce, a broadcast, a hop each way and
    the differentiable roll's backward, from the tensors' shapes."""
    def rank(group):
        x = torch.full((3, 5), float(group.rank))
        with cb.record_collectives() as rec:
            total = mh.rank_reduce(x, "sum", group)
            mh._broadcast_(x, 0, group)
            back = mh.ring_hop([x[:1].clone()], group, shift=-1)[0]
            y = x.clone().requires_grad_()
            mh.ring_roll_grad([y], 1, group)[0].sum().backward()
        return total, x, back, y.grad, rec.summary()

    for r, (total, x, back, grad, rec) in enumerate(mh.thread_ranks(2, rank)):
        assert torch.equal(total, torch.ones(3, 5))
        assert torch.equal(x, torch.zeros(3, 5)) and torch.equal(back, x[:1])
        assert torch.equal(grad, torch.ones(3, 5))
        assert rec == {"total": 60 + 30 + 20 + 40,
                       "by_op": {"all-reduce": 60, "broadcast": 30,
                                 "collective-permute": 60},
                       "count": {"all-reduce": 1, "broadcast": 1,
                                 "collective-permute": 3}}, r


@pytest.mark.parametrize("compression,itemsize", [("none", 4), ("fp16", 2),
                                                  ("bf16", 2)])
def test_sync_over_ranks_reports_wire_bytes(compression, itemsize):
    """2 ranks x 2 slots of a tiny ResNet: ``wire_bytes_per_slot`` is the
    rank's all-reduce of its card's mean, 2 (R-1)/R x the gradient's bytes
    in the wire dtype, read from the recorder."""
    r = np.random.default_rng(5)
    batch = (r.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8),
             (np.arange(8) % 10).astype(np.int32))

    def rank(group):
        mesh = make_global_mesh(4, "cpu", group=group)
        model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                       axis_name=DATA_AXIS)
        state = mh.replicate_to_mesh(mesh, create_train_state(
            model, server_sgd(0.1)))
        step = make_sync_dp_step(mesh, model, compression=compression,
                                 augment=False)
        _, m = step(state, *shard_batch_global(mesh, batch), 1)
        return m["wire_bytes_per_slot"], sum(
            p.numel() for p in model.parameters())

    for wire, size in mh.thread_ranks(2, rank):
        assert wire == size * itemsize
