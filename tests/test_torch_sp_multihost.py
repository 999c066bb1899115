"""Sequence parallelism over several ranks (``parallel/ring_attention.py``
over ``multihost.ring_roll``, ``models/vit.py``'s token range,
``SPTrainer(group=...)``), with ranks as threads of this process, each
over its own ``ProcessGroupGloo`` (``multihost.thread_ranks``).

- the ring alone over 2 ranks x 2 slots against one rank of 4 slots, the
  dense ring and the flash ring's plain hops, causal and not: the output
  and dq/dk/dv bit-equal (each row's arithmetic is the same, in the same
  hop order), and the bytes of the hops those shapes predict;
- one fp32 ``SPTrainer`` step of vit_tiny, no augmentation, from the JAX
  trainer's initial weights: over 2 thread-ranks x 2 slots (the dense
  ring, 32 px, 16 tokens a slot) against JAX's 4 virtual devices, and
  over 2 thread-ranks x 1 slot (the flash ring with plain hops, 64 px,
  128 tokens a slot) against JAX's 2 devices: the flash ring needs 128
  tokens a slot, so 64 px takes 2 slots in all, as in
  ``test_torch_model_parallel.py``. Both within rtol 1e-4 / atol 1e-5 of
  JAX's step and of the port's one-rank step over the same slots; both
  ranks' parameters bit-identical; the step's collectives the bytes its
  shapes predict;
- a one-block ViT over 2 ranks (whole patch rows) and 16 ranks (the whole
  image embedded, the range kept): logits and gradients, summed over the
  ranks where they are per token, equal one process's;
- rank 0 alone checkpoints, every rank resumes bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.ops.pallas import \
    flash_attention as jfa
from distributed_parameter_server_for_ml_training_tpu.train import \
    model_parallel as jmp
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    cifar
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    multihost as mh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    ring_attention as ra
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import SEQ_AXIS, make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.train import \
    model_parallel as mp
from distributed_parameter_server_for_ml_training_tpu_torch.utils \
    .collective_bytes import record_collectives
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax, params_to_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401

B, T, H, D = 2, 512, 2, 16      # the ring alone: 4 slots of 128 tokens


def _ring(kind, mesh, causal):
    return (ra.make_ring_attention(mesh, causal=causal) if kind == "dense"
            else ra.make_ring_flash_attention(mesh, causal=causal))


def _ring_run(kind, mesh, causal, tokens: slice):
    """Output and q/k/v gradients of the ring over ``tokens`` of seeded
    inputs, and the collectives' bytes."""
    r = np.random.default_rng(3)
    q, k, v, cot = (torch.from_numpy(r.normal(size=(B, T, H, D))
                                     .astype(np.float32))[:, tokens]
                    for _ in range(4))
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    with record_collectives() as rec:
        out = _ring(kind, mesh, causal)(q, k, v)
        (out * cot).sum().backward()
    return [out.detach(), q.grad, k.grad, v.grad], rec.summary()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["dense", "flash"])
def test_ring_over_ranks_bit_equal_to_one_rank(kind, causal):
    want, _ = _ring_run(kind, make_mesh(4, "cpu", axis_names=(SEQ_AXIS,)),
                        causal, slice(None))
    per = T // 2

    def rank(group):
        mesh = mh.make_global_mesh(4, "cpu", axis_names=(SEQ_AXIS,),
                                   group=group)
        return _ring_run(kind, mesh, causal,
                         slice(group.rank * per, (group.rank + 1) * per))

    # A K or V block of a slot: B x 128 tokens x H x D fp32. Forward 3
    # hops of K and V; the dense ring's backward sends their gradients
    # back 3 hops, the flash ring's carries K, V, dK and dV 3 hops and
    # dK, dV a 4th.
    block = B * (T // 4) * H * D * 4
    hops = {"dense": (6, 12 * block), "flash": (7, 20 * block)}[kind]
    for r, (got, rec) in enumerate(mh.thread_ranks(2, rank)):
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            part = b[:, r * per:(r + 1) * per].contiguous()
            assert a.numpy().tobytes() == part.numpy().tobytes(), (r, name)
        assert rec == {"total": hops[1],
                       "by_op": {"collective-permute": hops[1]},
                       "count": {"collective-permute": hops[0]}}


def test_ring_rejects_slots_that_do_not_fill_the_ring():
    q = torch.zeros(3, 1, 8, 1, 4)
    with pytest.raises(ValueError, match="3 slots on each of 2 ranks"):
        ra.ring_attention_local(q, q, q, axis_size=4,
                                group=mh.RankGroup(None, 0, 2, "gloo"))


@pytest.mark.parametrize("ranks", [2, 16])
def test_vit_over_ranks_embeds_its_token_range(ranks):
    """A one-block ViT at 32 px (an 8 x 8 patch grid) over ``ranks`` ranks
    of one slot: 2 ranks embed whole patch rows, 16 ranks (4 tokens a
    rank) the whole image and keep their range. Logits equal one
    process's over 16 slots within 1e-5; the per-token gradients summed
    over the ranks, and the head's on every rank, equal its gradients
    (the pool's backward hands each rank g / R)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        .vit import ViT

    r = np.random.default_rng(9)
    x = torch.from_numpy(r.normal(size=(2, 32, 32, 3)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(2, 10)).astype(np.float32))

    def run(mesh, group=None):
        model = ViT(patch_size=4, hidden_dim=16, depth=1, num_heads=2,
                    num_classes=10, pool="gap", image_size=32,
                    attention_fn=ra.make_ring_attention(mesh),
                    generator=torch.Generator().manual_seed(0),
                    seq_group=group)
        logits = model(x)
        (logits * w).sum().backward()
        return logits.detach(), {n: p.grad for n, p in
                                 model.named_parameters()}

    want, want_g = run(make_mesh(16, "cpu", axis_names=(SEQ_AXIS,)))

    def rank(group):
        return run(mh.make_global_mesh(16, "cpu", axis_names=(SEQ_AXIS,),
                                       group=group), group)

    got = mh.thread_ranks(ranks, rank)
    for logits, grads in got:
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
        for name in ("head.weight", "head.bias"):
            np.testing.assert_allclose(grads[name], want_g[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    for name, g in want_g.items():
        if not name.startswith("head."):
            total = sum(grads[name] for _, grads in got)
            np.testing.assert_allclose(total, g, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


# -- one SPTrainer step ------------------------------------------------------

CASES = {"dense": dict(image=32, ranks=2, slots=4),
         "flash": dict(image=64, ranks=2, slots=2)}


def _configs(slots):
    common = dict(model="vit_tiny", num_workers=slots, learning_rate=0.1,
                  num_epochs=1, batch_size=4, augment=False, num_classes=10,
                  dtype="float32", seed=0)
    return jmp.ModelParallelConfig(**common), \
        mp.ModelParallelConfig(**common, device="cpu")


@pytest.fixture(scope="module", params=["dense", "flash"])
def sp_step(request):
    """One step each: JAX's trainer over ``slots`` devices, the port's over
    one rank of ``slots`` slots and over 2 thread-ranks, from JAX's
    initial weights."""
    kind = request.param
    case = CASES[kind]
    mpatch = pytest.MonkeyPatch()
    if kind == "flash":
        mpatch.setattr(jfa, "flash_preferred", lambda t: True)
        mpatch.setattr(mp, "flash_preferred", lambda t, device: True)
    try:
        ds = cifar.synthetic_imagenet(n_train=4, n_test=4, num_classes=10,
                                      image_size=case["image"], seed=1)
        jcfg, tcfg = _configs(case["slots"])
        jt = jmp.SPTrainer(ds, jcfg)
        init = jax_flatten(jax.device_get(jt.state.params))
        jt.train()
        want = jax_flatten(jax.device_get(jt.state.params))

        one = mp.SPTrainer(ds, tcfg)
        one.model.load_state_dict(params_from_jax(init))
        one.train()

        def rank(group):
            trainer = mp.SPTrainer(ds, _configs(case["slots"])[1],
                                   group=group)
            trainer.model.load_state_dict(params_from_jax(init))
            return trainer, trainer.train()

        ranks = mh.thread_ranks(case["ranks"], rank, timeout=240)
    finally:
        mpatch.undo()
    return dict(kind=kind, case=case, want=want, init=init, one=one,
                ranks=ranks)


def test_sp_step_over_ranks_matches_jax(sp_step):
    want = sp_step["want"]
    for trainer, metrics in sp_step["ranks"]:
        assert trainer.flash == (sp_step["kind"] == "flash")
        assert trainer.global_steps == 1
        got, _ = params_to_jax(trainer.model)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert sum(not np.array_equal(got[k], sp_step["init"][k])
                   for k in want) > 0
        assert metrics["ranks"] == sp_step["case"]["ranks"]


def test_sp_step_over_ranks_matches_one_rank(sp_step):
    want, _ = params_to_jax(sp_step["one"].model)
    for trainer, metrics in sp_step["ranks"]:
        got, _ = params_to_jax(trainer.model)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(trainer.train_loss_per_epoch,
                                   sp_step["one"].train_loss_per_epoch,
                                   rtol=1e-5)
        assert metrics["tokens"] == sp_step["one"].tokens


def test_sp_ranks_end_bit_identical(sp_step):
    (t0, m0), (t1, m1) = sp_step["ranks"]
    for k, v in t0.state.params.items():
        assert v.numpy().tobytes() == t1.state.params[k].numpy().tobytes(), k
    assert t0.train_loss_per_epoch == t1.train_loss_per_epoch
    assert t0.is_chief and not t1.is_chief


def test_sp_step_counts_the_bytes_its_shapes_predict(sp_step):
    """Per layer the ring's hops (as the ring alone: one slot's block a
    hop, whatever the slots a rank), the pooled mean's all-reduce ``[B,
    192]`` and one all-reduce of every gradient but the head's, each 2
    (R-1)/R of its bytes."""
    case = sp_step["case"]
    trainer, metrics = sp_step["ranks"][0]
    n, ranks = case["slots"], case["ranks"]
    tl = trainer.tokens // n
    block = 4 * 3 * tl * 64 * 4          # B x H x tokens a slot x D, fp32
    if sp_step["kind"] == "dense":
        hops, count = 4 * (n - 1) * block, 2 * (n - 1)
    else:
        hops, count = (2 * (n - 1) + 2 * (n - 1) + 2 * n) * block, 2 * n - 1
    hops *= trainer.model.depth
    count *= trainer.model.depth
    frac = 2 * (ranks - 1) / ranks
    body = sum(p.numel() for name, p in trainer.model.named_parameters()
               if not name.startswith("head."))
    reduce = int(frac * 4 * 4 * 192) + int(frac * 4 * body)
    assert metrics["collective_bytes_per_step"] == {
        "total": hops + reduce,
        "by_op": {"collective-permute": hops, "all-reduce": reduce},
        "count": {"collective-permute": count, "all-reduce": 2}}
    assert trainer.collective_bytes_step == \
        metrics["collective_bytes_per_step"]


def test_sp_over_ranks_refuses_an_uneven_split():
    ds = cifar.synthetic_imagenet(n_train=2, n_test=2, num_classes=10,
                                  image_size=32, seed=1)
    _, tcfg = _configs(4)
    with pytest.raises(ValueError, match="divide evenly over 3 processes"):
        mp.SPTrainer(ds, tcfg, group=mh.RankGroup(None, 0, 3, "gloo"))


def test_sp_over_ranks_resumes_from_rank0_checkpoint(tmp_path,
                                                     monkeypatch):
    """Rank 0 alone saves a checkpoint each epoch; every rank restores it
    on ``resume``, and a run resumed from epoch 1 ends bit-equal to the
    uninterrupted one on both ranks (augmentation on)."""
    from distributed_parameter_server_for_ml_training_tpu_torch import \
        checkpoint
    ds = cifar.synthetic_imagenet(n_train=4, n_test=2, num_classes=10,
                                  image_size=32, seed=1)
    saves = []
    save = checkpoint.CheckpointManager.save
    monkeypatch.setattr(checkpoint.CheckpointManager, "save",
                        lambda self, *a, **kw: saves.append(1)
                        or save(self, *a, **kw))

    def run(epochs, where, resume=False):
        def rank(group):
            _, tcfg = _configs(4)
            tcfg.num_epochs, tcfg.augment, tcfg.batch_size = epochs, True, 2
            trainer = mp.SPTrainer(ds, tcfg, group=group)
            trainer.train(checkpoint_dir=str(tmp_path / where),
                          resume=resume)
            return trainer
        return mh.thread_ranks(2, rank, timeout=240)

    full = run(2, "a")
    assert len(saves) == 2                   # 2 epochs, rank 0 only
    run(1, "b")
    resumed = run(2, "b", resume=True)
    for r in range(2):
        assert resumed[r].global_steps == full[r].global_steps == 4
        for k, v in full[r].state.params.items():
            assert v.equal(resumed[r].state.params[k]), (r, k)
        assert resumed[r].train_loss_per_epoch == \
            full[r].train_loss_per_epoch[1:]
