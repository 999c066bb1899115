"""Pipeline parallelism over several ranks (``parallel/pipeline.py`` over
``multihost.stage_hop``, ``PipelineTrainer(group=...)``), with ranks as
threads of this process, each over its own ``ProcessGroupGloo``
(``multihost.thread_ranks``).

- ``stage_hop`` over 2 and 4 thread-ranks: the first rank receives
  nothing forward and the last sends nothing, values arrive unchanged,
  the differentiable form sends the gradients back, and the bytes noted
  are the sent tensors';
- the GPipe apply (output and the gradients of the params and ``x``)
  and one 1F1B step over 2 ranks x 2 stages and 4 ranks x 1 stage,
  against JAX's ``make_pipeline_apply`` and ``make_pipeline_train_step``
  on 4 virtual devices (rtol 2e-4 / atol 1e-6, as
  ``test_torch_pipeline.py`` holds the one-process schedules) and
  bit-equal to the port's one-process pipeline: every stage call is one
  process's, and each stage's microbatches add up in one process's order;
- one fp32 ``PipelineTrainer`` step of vit_tiny over 2 thread-ranks (4
  stages, 2 a rank, 4 microbatches) from JAX's initial weights, against
  JAX's trainer on 4 devices (rtol 1e-4 / atol 1e-5) and bit-equal to the
  port's one-process trainer; the prologue and epilogue bit-identical on
  both ranks (``ranks_identical``), the loss the same on both; the step's
  collective bytes equal ``collective_bytes.pipeline_step_bytes``;
- rank 0 alone checkpoints, in the one-process layout (stages ``[S,
  ...]``); every rank resumes its stages bit-equal;
- a ``(data, model, stage)`` mesh over ranks with dp or tp above 1 still
  raises, naming ROADMAP §1 item 10, sixth part.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    pipeline as jpipe
from distributed_parameter_server_for_ml_training_tpu.train import \
    model_parallel as jmp
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    cifar
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    multihost as mh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    pipeline as pipe
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import STAGE_AXIS, make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.train import \
    model_parallel as mp
from distributed_parameter_server_for_ml_training_tpu_torch.utils import \
    collective_bytes as cb
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import join_rank_rows, params_from_jax, params_to_jax, rank_rows
from torch_threads import one_torch_thread_per_module  # noqa: F401

S, D, M = 4, 16, 8


# -- stage_hop -----------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_stage_hop_hands_over_to_the_neighbour(ranks):
    """Forward to rank + 1 and back to rank - 1, not a ring; a rank that
    neither sends nor receives at a tick makes no call's worth of work."""
    def rank(group):
        x = torch.full((2, 3), float(group.rank))
        with cb.record_collectives() as rec:
            fwd = mh.stage_hop([x, x + 10], group, 1, tag=0)
            back = mh.stage_hop([x], group, -1, tag=1)
            idle = mh.stage_hop([x], group, 1, send=False, recv=False,
                                tag=2)
        return fwd, back, idle, rec.summary()

    got = mh.thread_ranks(ranks, rank)
    for r, (fwd, back, idle, rec) in enumerate(got):
        assert idle is None
        if r == 0:
            assert fwd is None
        else:
            assert torch.equal(fwd[0], torch.full((2, 3), r - 1.0))
            assert torch.equal(fwd[1], torch.full((2, 3), r + 9.0))
        if r == ranks - 1:
            assert back is None
        else:
            assert torch.equal(back[0], torch.full((2, 3), r + 1.0))
        sends = (r < ranks - 1) * 2 + (r > 0)
        assert rec == {"total": sends * 24,
                       "by_op": {"collective-permute": sends * 24},
                       "count": {"collective-permute": (r < ranks - 1)
                                 + (r > 0)}}


def test_stage_hop_grad_sends_the_gradient_back():
    """A model cut between 2 ranks: rank 0 computes ``h = 3x`` and hands
    it over, rank 1 the loss ``sum(h * c)``; rank 0's x gets ``3c``."""
    c = torch.arange(6.0).view(2, 3)

    def rank(group):
        x = torch.ones(2, 3, requires_grad=True)
        (h,) = mh.stage_hop_grad([3 * x], group, 1)
        if group.rank == 1:
            (h * c).sum().backward()
            return h.detach()
        torch.autograd.backward([h], [torch.zeros_like(h)])
        return x.grad

    gx, h = mh.thread_ranks(2, rank)
    assert torch.equal(h, torch.full((2, 3), 3.0))
    assert torch.equal(gx, 3 * c)
    one, = mh.thread_ranks(1, lambda g: mh.stage_hop([c], g, 1))
    assert one[0] is c
    with pytest.raises(ValueError, match="rank \\+ 1 or - 1"):
        mh.thread_ranks(2, lambda g: mh.stage_hop([c], g, 2))


# -- the schedules over ranks -----------------------------------------------

@pytest.fixture(scope="module")
def stacked_np():
    r = np.random.default_rng(0)
    return {"w": r.normal(scale=0.5, size=(S, D, D)).astype(np.float32),
            "b": r.normal(scale=0.1, size=(S, D)).astype(np.float32)}


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _tstage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _jl2(y_pred, y):
    return jnp.mean((y_pred - y) ** 2)


def _tl2(y_pred, y):
    return torch.mean((y_pred - y) ** 2)


def _data():
    r = np.random.default_rng(3)
    return (r.normal(size=(32, D)).astype(np.float32),
            (r.normal(size=(32, D)) * 0.5).astype(np.float32))


def _apply_run(mesh, params, x, y):
    """GPipe's output and the gradients of the l2 loss in the params and
    ``x``."""
    p = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in params.items()}
    xx = torch.from_numpy(x).requires_grad_()
    out = pipe.make_pipeline_apply(mesh, _tstage, M)(p, xx)
    _tl2(out, torch.from_numpy(y)).backward()
    return out.detach(), {k: v.grad for k, v in p.items()}, xx.grad


def _rows(params, rank, ranks):
    per = S // ranks
    return {k: v[rank * per:(rank + 1) * per] for k, v in params.items()}


@pytest.fixture(scope="module")
def references(stacked_np):
    """JAX's apply and 1F1B step on 4 devices, the port's on one rank of 4
    stage slots."""
    x, y = _data()
    jmesh = jax_make_mesh(S, axis_names=("stage",))
    jp = {k: jnp.asarray(v) for k, v in stacked_np.items()}
    japply = jpipe.make_pipeline_apply(jmesh, _jstage, M)
    jout = np.asarray(japply(jp, jnp.asarray(x)))
    jg = jax.grad(lambda p, xx: _jl2(japply(p, xx), jnp.asarray(y)),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    jloss, jgrads = jpipe.make_pipeline_train_step(
        jmesh, _jstage, _jl2, M, schedule="1f1b")(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    mesh = make_mesh(S, "cpu", axis_names=(STAGE_AXIS,))
    one = _apply_run(mesh, stacked_np, x, y)
    one_1f1b = pipe.make_pipeline_train_step(mesh, _tstage, _tl2, M,
                                             schedule="1f1b")(
        {k: torch.from_numpy(v) for k, v in stacked_np.items()},
        torch.from_numpy(x), torch.from_numpy(y))
    return dict(one=one, one_1f1b=one_1f1b,
                jax=(jout, {k: np.asarray(v) for k, v in jg[0].items()},
                     np.asarray(jg[1])),
                jax_1f1b=(float(jloss), {k: np.asarray(v)
                                         for k, v in jgrads.items()}))


@pytest.fixture(scope="module", params=[2, 4], ids=["2x2", "4x1"])
def schedules(request, stacked_np, references):
    """The apply and one 1F1B step over ``ranks`` thread-ranks, beside
    :func:`references`."""
    ranks = request.param
    x, y = _data()

    def rank(group):
        gmesh = mh.make_global_mesh(S, "cpu", axis_names=(STAGE_AXIS,),
                                    group=group)
        mine = _rows(stacked_np, group.rank, ranks)
        with cb.record_collectives() as rec:
            applied = _apply_run(gmesh, mine, x, y)
        step = pipe.make_pipeline_train_step(gmesh, _tstage, _tl2, M,
                                             schedule="1f1b")(
            {k: torch.from_numpy(v) for k, v in mine.items()},
            torch.from_numpy(x), torch.from_numpy(y))
        return applied, step, rec.summary()

    return dict(references, ranks=ranks, got=mh.thread_ranks(ranks, rank))


def _gathered(schedules):
    """The last rank's output, the stages' gradients in stage order, rank
    0's input gradient."""
    applied = [a for a, _, _ in schedules["got"]]
    grads = {k: torch.cat([g[k] for _, g, _ in applied]) for k in ("w", "b")}
    return applied[-1][0], grads, applied[0][2]


def test_gpipe_over_ranks_matches_jax(devices, schedules):
    out, grads, gx = _gathered(schedules)
    jout, jg, jgx = schedules["jax"]
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-4, atol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), jg[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=2e-4, atol=1e-6)


def test_gpipe_over_ranks_bit_equal_to_one_process(schedules):
    out, grads, gx = _gathered(schedules)
    oout, og, ogx = schedules["one"]
    assert torch.equal(out, oout) and torch.equal(gx, ogx)
    for k in grads:
        assert torch.equal(grads[k], og[k]), k
    # The other ranks hand back zeros: their output is not the model's,
    # and their input feeds no stage.
    for r, ((o, _, g), _, _) in enumerate(schedules["got"]):
        if r < schedules["ranks"] - 1:
            assert not o.any()
        if r > 0:
            assert not g.any()


def test_1f1b_over_ranks_matches_jax_and_one_process(devices, schedules):
    jloss, jg = schedules["jax_1f1b"]
    oloss, og = schedules["one_1f1b"]
    grads = {k: torch.cat([step[1][k] for _, step, _ in schedules["got"]])
             for k in ("w", "b")}
    for _, (loss, _), _ in schedules["got"]:
        assert torch.equal(loss, oloss)          # the last rank's, on all
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-7)
    for k in grads:
        assert torch.equal(grads[k], og[k]), k
        np.testing.assert_allclose(grads[k].numpy(), jg[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_gpipe_over_ranks_counts_its_hops(schedules):
    """M microbatches of ``[4, 16]`` fp32 forward to the next rank, and
    their gradients back, where there is a neighbour."""
    ranks = schedules["ranks"]
    for r, (_, _, rec) in enumerate(schedules["got"]):
        hops = M * ((r < ranks - 1) + (r > 0))
        assert rec == {"total": hops * 4 * D * 4,
                       "by_op": {"collective-permute": hops * 4 * D * 4},
                       "count": {"collective-permute": hops}}


def test_gpipe_backward_off_thread_counts_into_the_forward_recorders(
        stacked_np):
    """Autograd may run the backward on a thread of its own (a card's):
    the backward's hops still count into the recorder open at the
    forward."""
    x, y = _data()

    def rank(group):
        mesh = mh.make_global_mesh(S, "cpu", axis_names=(STAGE_AXIS,),
                                   group=group)
        p = {k: torch.from_numpy(v.copy()).requires_grad_()
             for k, v in _rows(stacked_np, group.rank, 2).items()}
        with cb.record_collectives() as rec:
            loss = _tl2(pipe.make_pipeline_apply(mesh, _tstage, M)(
                p, torch.from_numpy(x)), torch.from_numpy(y))
        done = threading.Thread(target=loss.backward)
        done.start()
        done.join(60)
        assert not done.is_alive()
        return rec.summary()["count"], p["w"].grad is not None

    for count, has_grad in mh.thread_ranks(2, rank):
        assert count == {"collective-permute": M} and has_grad


# -- one PipelineTrainer step ----------------------------------------------

def _dataset():
    return cifar.synthetic_imagenet(n_train=8, n_test=8, num_classes=10,
                                    image_size=32, seed=1)


def _configs(**kw):
    common = dict(model="vit_tiny", num_workers=S, learning_rate=0.1,
                  num_epochs=1, batch_size=8, pp_microbatches=4,
                  augment=False, num_classes=10, dtype="float32", seed=0,
                  **kw)
    return jmp.ModelParallelConfig(**common), \
        mp.ModelParallelConfig(**common, device="cpu")


@pytest.fixture(scope="module")
def pp_step():
    """One step each: JAX's trainer on 4 devices, the port's on one rank
    of 4 stage slots and over 2 thread-ranks, from JAX's weights."""
    ds = _dataset()
    jcfg, tcfg = _configs()
    jt = jmp.PipelineTrainer(ds, jcfg)
    init = jax_flatten(jax.device_get(jt.state.params))
    jm = jt.train()
    want = jax_flatten(jax.device_get(jt.state.params))
    one = mp.PipelineTrainer(ds, tcfg)
    one.model.load_state_dict(params_from_jax(init))
    one.train()

    def rank(group):
        trainer = mp.PipelineTrainer(ds, _configs()[1], group=group)
        trainer.model.load_state_dict(params_from_jax(
            rank_rows(init, group.rank, group.size)))
        metrics = trainer.train()
        shared = [v for k, v in trainer.state.params.items()
                  if not k.startswith("stages/")]
        return trainer, metrics, mh.ranks_identical(shared, group)

    ranks = mh.thread_ranks(2, rank, timeout=240)
    return dict(jm=jm, want=want, init=init, one=one, ranks=ranks)


def test_pp_step_over_ranks_matches_jax(devices, pp_step):
    want = pp_step["want"]
    got = join_rank_rows([params_to_jax(t.model)[0]
                          for t, _, _ in pp_step["ranks"]])
    assert set(got) == set(want)
    assert got["stages/block_0/attn/qkv/kernel"].shape == (S, 192, 576)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(got[k], pp_step["init"][k])
    assert moved > 0
    for trainer, metrics, _ in pp_step["ranks"]:
        assert trainer.global_steps == 1
        assert metrics["final_test_accuracy"] == \
            pp_step["jm"]["final_test_accuracy"]
        assert set(metrics) == set(pp_step["jm"]) | {
            "ranks", "collective_bytes_per_step"}


def test_pp_step_over_ranks_bit_equal_to_one_process(pp_step):
    one = pp_step["one"]
    want, _ = params_to_jax(one.model)
    got = join_rank_rows([params_to_jax(t.model)[0]
                          for t, _, _ in pp_step["ranks"]])
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    for trainer, _, _ in pp_step["ranks"]:
        assert trainer.train_loss_per_epoch == one.train_loss_per_epoch
        assert trainer.test_accuracies == one.test_accuracies


def test_pp_ranks_end_identical(pp_step):
    (t0, _, same0), (t1, _, same1) = pp_step["ranks"]
    assert same0 and same1
    assert t0.state.params["stages/block_0/ln1/scale"].shape == (2, 192)
    assert t0.is_chief and not t1.is_chief


def test_pp_step_counts_the_bytes_its_shapes_predict(pp_step):
    """4 microbatches of ``[2, 65, 192]`` fp32 a way, the CLS tokens ``[8,
    1, 192]`` and the prologue's gradients broadcast."""
    for r, (trainer, metrics, _) in enumerate(pp_step["ranks"]):
        prologue = sum(p.numel() for p in trainer.model.prologue.parameters())
        want = cb.pipeline_step_bytes(2, r, 4, 2 * 65 * 192 * 4,
                                      8 * 192 * 4, prologue)
        assert metrics["collective_bytes_per_step"] == want
        assert want["by_op"]["collective-permute"] == 4 * 2 * 65 * 192 * 4


def test_pp_over_ranks_resumes_from_rank0_checkpoint(tmp_path):
    """Rank 0 alone saves, with the stages stacked ``[S, ...]``; every
    rank restores its stages, and a run resumed from epoch 1 ends
    bit-equal to the uninterrupted one (augmentation on)."""
    ds = _dataset()

    def run(epochs, where, resume=False):
        def rank(group):
            _, tcfg = _configs()
            tcfg.num_epochs, tcfg.augment = epochs, True
            trainer = mp.PipelineTrainer(ds, tcfg, group=group)
            trainer.train(checkpoint_dir=str(tmp_path / where),
                          resume=resume)
            return trainer
        return mh.thread_ranks(2, rank, timeout=240)

    full = run(2, "a")
    saved = torch.load(sorted((tmp_path / "a").glob("ckpt_*.pt"))[-1],
                       weights_only=True)["params"]
    whole = join_rank_rows([t.state.params for t in full])
    assert saved["stages/block_0/attn/qkv/kernel"].shape == (S, 192, 576)
    assert set(saved) == set(whole)
    for k, v in whole.items():
        assert torch.equal(saved[k], v), k
    run(1, "b")
    resumed = run(2, "b", resume=True)
    for r in range(2):
        assert resumed[r].global_steps == full[r].global_steps == 2
        for k, v in full[r].state.params.items():
            assert v.equal(resumed[r].state.params[k]), (r, k)
        assert resumed[r].train_loss_per_epoch == \
            full[r].train_loss_per_epoch[1:]


@pytest.mark.parametrize("field", ["dp_degree", "pp_tp_degree"])
def test_composed_pipeline_over_ranks_names_the_sixth_part(field):
    _, tcfg = _configs()
    setattr(tcfg, field, 2)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP §1 item 10, sixth part"):
        mp.PipelineTrainer(_dataset(), tcfg,
                           group=mh.RankGroup(None, 0, 2, "gloo"))


def test_stages_must_divide_over_the_ranks():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="divide evenly over 3 processes"):
        mp.PipelineTrainer(_dataset(), tcfg,
                           group=mh.RankGroup(None, 0, 3, "gloo"))
    mesh = type(make_mesh(S, "cpu"))(S, torch.device("cpu"), STAGE_AXIS,
                                     group=mh.RankGroup(None, 0, 3, "gloo"))
    with pytest.raises(ValueError, match="4 stages do not divide evenly"):
        pipe.make_pipeline_apply(mesh, _tstage, M)
