"""Expert parallelism over several ranks (``parallel/moe.py`` over
``multihost.all_to_all_grad``, ``models/vit.py:SwitchMoEMlp`` holding a
rank's experts, ``MoETrainer(group=...)``), with ranks as threads of this
process, each over its own ``ProcessGroupGloo``
(``multihost.thread_ranks``).

- ``all_to_all`` over 2 and 4 thread-ranks: values and gradients equal
  the permutation of the blocks done in one process, and the bytes noted
  equal the shapes' count;
- the MoE layer over 2 ranks x 2 expert slots, at a generous capacity and
  at one that drops tokens, against JAX's ``make_moe_ffn`` on 4 virtual
  devices (outputs, the four statistics, the gradients of ``sum(out *
  cot) + aux``; rtol 1e-5 / atol 1e-6, as ``test_torch_moe.py`` holds the
  one-process layer) and against the port's one-process 4-slot layer:
  outputs, ``load``, ``drop_frac``, ``aux_loss`` and the expert leaves'
  gradients bit-equal (each row's arithmetic is one process's); the
  router's gradient, summed over the ranks, and ``importance``, summed
  shard by shard then over the ranks, within 1e-5 / 1e-7 (found: ~2e-6
  and ~3e-8 apart);
- one fp32 ``MoETrainer`` step of vit_tiny over 2 thread-ranks (4
  experts, 2 a rank, no augmentation) from JAX's initial weights, against
  JAX's trainer on 4 devices (rtol 1e-4 / atol 1e-5) and the port's
  one-process trainer (found within 3e-8); the replicated leaves
  bit-identical on both ranks; the MoE metrics equal on both; the step's
  collective bytes equal ``collective_bytes.moe_step_bytes``;
- rank 0 alone checkpoints, in the one-process layout; every rank
  resumes its rows bit-equal;
- a ``(data, expert)`` mesh over ranks still raises, naming ROADMAP §1
  item 10, sixth part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    moe as jmoe
from distributed_parameter_server_for_ml_training_tpu.train import \
    model_parallel as jmp
from distributed_parameter_server_for_ml_training_tpu.train.train_state \
    import TrainState
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    cifar
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    moe
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    multihost as mh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import EXPERT_AXIS, make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.train import \
    model_parallel as mp
from distributed_parameter_server_for_ml_training_tpu_torch.utils import \
    collective_bytes as cb
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import (join_rank_rows, params_from_jax, params_to_jax, rank_rows,
            rank_stacked)
from torch_threads import one_torch_thread_per_module  # noqa: F401

E, D, H, N = 4, 16, 32, 64
TOL = dict(rtol=1e-5, atol=1e-6)


# -- all_to_all --------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_all_to_all_is_the_block_permutation(ranks):
    """Rank r's block j lands as block r on rank j; the backward sends
    each block's gradient home; one exchange of ``[2R, 3]`` fp32 moves
    (R-1)/R of its bytes each way."""
    def data(r):
        g = np.random.default_rng(r)
        return (torch.from_numpy(g.normal(size=(2 * ranks, 3))
                                 .astype(np.float32)),
                torch.from_numpy(g.normal(size=(2 * ranks, 3))
                                 .astype(np.float32)))

    def rank(group):
        x, cot = data(group.rank)
        x.requires_grad_()
        with cb.record_collectives() as rec:
            y = mh.all_to_all_grad(x, group)
            (y * cot).sum().backward()
        return y.detach(), x.grad, rec.summary()

    got = mh.thread_ranks(ranks, rank)
    xs = [data(r)[0].view(ranks, 2, 3) for r in range(ranks)]
    cots = [data(r)[1].view(ranks, 2, 3) for r in range(ranks)]
    moved = int((ranks - 1) / ranks * 2 * ranks * 3 * 4)
    for r, (y, gx, rec) in enumerate(got):
        want = torch.cat([xs[j][r] for j in range(ranks)])
        assert torch.equal(y, want)
        assert torch.equal(gx, torch.cat([cots[j][r]
                                          for j in range(ranks)]))
        assert rec == {"total": 2 * moved, "by_op": {"all-to-all": 2 * moved},
                       "count": {"all-to-all": 2}}


def test_all_to_all_over_one_rank_is_the_identity():
    def rank(group):
        x = torch.arange(6.0).view(2, 3)
        with cb.record_collectives() as rec:
            y = mh.all_to_all(x, group)
        return torch.equal(y, x), rec.summary()

    (same, rec), = mh.thread_ranks(1, rank)
    assert same and rec["total"] == 0
    with pytest.raises(ValueError, match="does not split into 2 blocks"):
        mh.thread_ranks(2, lambda g: mh.all_to_all(torch.zeros(3), g))


# -- the MoE layer over 2 ranks x 2 slots -------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, E)


def _layer_run(fn, params, tokens, cot, share):
    """Output, statistics and the gradients of ``sum(out * cot) + aux *
    share`` (each rank's part of the shared aux loss)."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = tokens.clone().requires_grad_()
    out, stats = fn(p, x)
    ((out * cot).sum() + stats["aux_loss"] * share).backward()
    return (out.detach(), {k: v.detach() for k, v in stats.items()},
            {**{k: v.grad for k, v in p.items()}, "tokens": x.grad})


@pytest.fixture(scope="module", params=[64, 3], ids=["generous", "drops"])
def layer(request, jparams):
    """The layer three ways at one capacity: JAX on 4 devices, the port on
    one rank of 4 slots, the port over 2 thread-ranks of 2 slots."""
    cap = request.param
    r = np.random.default_rng(7)
    tokens = r.normal(size=(N, D)).astype(np.float32)
    cot = r.normal(size=(N, D)).astype(np.float32)
    jfn = jmoe.make_moe_ffn(jax_make_mesh(E, axis_names=("expert",)),
                            capacity=cap)

    def jloss(p, x):
        out, st = jfn(p, x)
        return jnp.sum(out * cot) + st["aux_loss"]

    jout, jst = jfn(jparams, jnp.asarray(tokens))
    jg = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(tokens))
    jax_run = (np.asarray(jout), {k: np.asarray(v) for k, v in jst.items()},
               {**{k: np.asarray(v) for k, v in jg[0].items()},
                "tokens": np.asarray(jg[1])})
    params = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    x, c = torch.from_numpy(tokens), torch.from_numpy(cot)
    one = _layer_run(moe.make_moe_ffn(
        make_mesh(E, "cpu", axis_names=(EXPERT_AXIS,)), cap), params, x, c,
        1.0)

    def rank(group):
        mesh = mh.make_global_mesh(E, "cpu", axis_names=(EXPERT_AXIS,),
                                   group=group)
        rows = slice(group.rank * N // 2, (group.rank + 1) * N // 2)
        experts = slice(group.rank * E // 2, (group.rank + 1) * E // 2)
        mine = {k: v if k == "router" else v[experts]
                for k, v in params.items()}
        with cb.record_collectives() as rec:
            got = _layer_run(moe.make_moe_ffn(mesh, cap), mine, x[rows],
                             c[rows], 0.5)
        return got, rec.summary()

    ranks = mh.thread_ranks(2, rank)
    return dict(cap=cap, jax=jax_run, one=one, ranks=ranks)


def _whole(layer):
    """The ranks' outputs and gradients put together: rows and expert
    leaves concatenated, the router's gradient summed."""
    (o0, s0, g0), _ = layer["ranks"][0]
    (o1, s1, g1), _ = layer["ranks"][1]
    grads = {k: torch.cat([g0[k], g1[k]])
             for k in ("w1", "b1", "w2", "b2", "tokens")}
    grads["router"] = g0["router"] + g1["router"]
    return torch.cat([o0, o1]), (s0, s1), grads


def test_layer_over_ranks_matches_jax(devices, layer):
    out, stats, grads = _whole(layer)
    jout, jst, jg = layer["jax"]
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    for st in stats:
        np.testing.assert_array_equal(st["load"].numpy(), jst["load"])
        assert float(st["drop_frac"]) == float(jst["drop_frac"])
        for k in ("importance", "aux_loss"):
            np.testing.assert_allclose(st[k].numpy(), jst[k], **TOL,
                                       err_msg=k)
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), jg[k], **TOL, err_msg=k)
    assert (float(stats[0]["drop_frac"]) > 0) == (layer["cap"] == 3)


def test_layer_over_ranks_matches_one_process(layer):
    out, stats, grads = _whole(layer)
    oout, ost, og = layer["one"]
    assert torch.equal(out, oout)
    for st in stats:
        for k in ("load", "drop_frac", "aux_loss"):
            assert torch.equal(st[k], ost[k]), k
        torch.testing.assert_close(st["importance"], ost["importance"],
                                   rtol=1e-5, atol=1e-7)
    for k in ("w1", "b1", "w2", "b2", "tokens"):
        assert torch.equal(grads[k], og[k]), k
    torch.testing.assert_close(grads["router"], og["router"], rtol=1e-5,
                               atol=1e-5)


def test_layer_over_ranks_counts_its_bytes(layer):
    """Forward and backward: two all_to_alls of ``[2, 4, C, 16]`` fp32
    each way, and the statistics' all-reduce of 2E + 1 values each way."""
    cap = layer["cap"]
    a2a = int(0.5 * 2 * E * cap * D * 4)
    red = int(2 * 0.5 * (2 * E + 1) * 4)
    for _, rec in layer["ranks"]:
        assert rec == {"total": 4 * a2a + 2 * red,
                       "by_op": {"all-reduce": 2 * red,
                                 "all-to-all": 4 * a2a},
                       "count": {"all-reduce": 2, "all-to-all": 4}}


# -- the rows of a rank --------------------------------------------------------

def test_rank_rows_cut_and_join_back():
    flat = {"block_0/moe/router": np.ones((3, 4)),
            "block_0/moe/w1": np.arange(4 * 2.0).reshape(4, 2),
            "stages/block_0/ln1/scale": np.arange(8.0).reshape(4, 2),
            "head/bias": np.zeros(5)}
    assert [k for k in flat if rank_stacked(k)] == [
        "block_0/moe/w1", "stages/block_0/ln1/scale"]
    assert rank_stacked("block_0.moe.b2") and \
        not rank_stacked("block_0.moe.router")
    parts = [rank_rows(flat, r, 2) for r in range(2)]
    assert parts[1]["block_0/moe/w1"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert parts[1]["head/bias"] is flat["head/bias"]
    back = join_rank_rows(parts)
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    t = join_rank_rows([{k: torch.from_numpy(v) for k, v in p.items()}
                        for p in parts])
    assert torch.equal(t["stages/block_0/ln1/scale"],
                       torch.from_numpy(flat["stages/block_0/ln1/scale"]))
    with pytest.raises(ValueError, match="do not divide evenly over 3"):
        rank_rows(flat, 0, 3)


# -- one MoETrainer step ----------------------------------------------------

def _jitted_create_train_state(model, rng, tx, input_shape=(1, 32, 32, 3)):
    """JAX's ``create_train_state`` with its init jitted (op by op, flax's
    init compiles every op)."""
    variables = jax.jit(lambda k: model.init(
        k, np.ones(input_shape, np.float32), train=False))(rng)
    return TrainState.create(apply_fn=model.apply,
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats", {}),
                             tx=tx)


def _dataset(n_train=8):
    return cifar.synthetic_imagenet(n_train=n_train, n_test=8,
                                    num_classes=10, image_size=32, seed=1)


def _configs(**kw):
    common = dict(model="vit_tiny", num_workers=E, learning_rate=0.1,
                  num_epochs=1, batch_size=8, augment=False, num_classes=10,
                  dtype="float32", seed=0, **kw)
    return jmp.ModelParallelConfig(**common), \
        mp.ModelParallelConfig(**common, device="cpu")


@pytest.fixture(scope="module")
def moe_step():
    """One step each: JAX's trainer on 4 devices, the port's on one rank
    of 4 expert slots and over 2 thread-ranks, from JAX's weights."""
    mpatch = pytest.MonkeyPatch()
    mpatch.setattr(jmp, "create_train_state", _jitted_create_train_state)
    try:
        ds = _dataset()
        jcfg, tcfg = _configs()
        jt = jmp.MoETrainer(ds, jcfg)
        init = jax_flatten(jax.device_get(jt.state.params))
        jm = jt.train()
        want = jax_flatten(jax.device_get(jt.state.params))
    finally:
        mpatch.undo()
    one = mp.MoETrainer(ds, tcfg)
    one.model.load_state_dict(params_from_jax(init))
    one.train()

    def rank(group):
        trainer = mp.MoETrainer(ds, _configs()[1], group=group)
        trainer.model.load_state_dict(params_from_jax(
            rank_rows(init, group.rank, group.size)))
        metrics = trainer.train()
        identical = mh.ranks_identical(
            [v for k, v in trainer.state.params.items()
             if not rank_stacked(k)], group)
        return trainer, metrics, identical

    ranks = mh.thread_ranks(2, rank, timeout=240)
    return dict(jt=jt, jm=jm, want=want, init=init, one=one, ranks=ranks)


def _joined(ranks) -> dict:
    return join_rank_rows([params_to_jax(t.model)[0] for t, _, _ in ranks])


def test_moe_step_over_ranks_matches_jax(devices, moe_step):
    want, got = moe_step["want"], _joined(moe_step["ranks"])
    assert set(got) == set(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(got[k], moe_step["init"][k])
    assert moved > 0
    (want_m,) = moe_step["jt"]._moe_step_metrics
    for trainer, metrics, _ in moe_step["ranks"]:
        assert trainer.global_steps == 1 and trainer.capacity == 64
        assert metrics["final_test_accuracy"] == \
            moe_step["jm"]["final_test_accuracy"]
        (got_m,) = trainer._moe_step_metrics
        for k in want_m:
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert set(metrics) == set(moe_step["jm"]) | {
            "ranks", "collective_bytes_per_step"}
        assert metrics["ranks"] == 2


def test_moe_step_over_ranks_matches_one_process(moe_step):
    one = moe_step["one"]
    want, _ = params_to_jax(one.model)
    got = _joined(moe_step["ranks"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    (want_m,) = one._moe_step_metrics
    for trainer, _, _ in moe_step["ranks"]:
        np.testing.assert_allclose(trainer.train_loss_per_epoch,
                                   one.train_loss_per_epoch, rtol=1e-6)
        (got_m,) = trainer._moe_step_metrics
        for k in want_m:
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       rtol=1e-6, err_msg=k)


def test_moe_ranks_end_identical(moe_step):
    (t0, m0, same0), (t1, m1, same1) = moe_step["ranks"]
    assert same0 and same1
    for k, v in t0.state.params.items():
        if not rank_stacked(k):
            assert v.numpy().tobytes() == \
                t1.state.params[k].numpy().tobytes(), k
        else:
            assert v.shape[0] == E // 2
    assert t0.train_loss_per_epoch == t1.train_loss_per_epoch
    assert [{k: float(v) for k, v in m.items()}
            for m in t0._moe_step_metrics] == \
        [{k: float(v) for k, v in m.items()} for m in t1._moe_step_metrics]
    assert t0.is_chief and not t1.is_chief


def test_moe_step_counts_the_bytes_its_shapes_predict(moe_step):
    trainer, metrics, _ = moe_step["ranks"][0]
    replicated = sum(p.numel() for name, p in trainer.model.named_parameters()
                     if not rank_stacked(name))
    want = cb.moe_step_bytes(2, E, trainer.capacity, 192,
                             trainer.model.depth, replicated)
    for trainer, metrics, _ in moe_step["ranks"]:
        assert metrics["collective_bytes_per_step"] == want
        assert trainer.collective_bytes_step == want


def test_moe_over_ranks_resumes_from_rank0_checkpoint(tmp_path):
    """Rank 0 alone saves, in the one-process layout (experts ``[E,
    ...]``); every rank restores its rows, and a run resumed from epoch 1
    ends bit-equal to the uninterrupted one (augmentation on)."""
    ds = _dataset()

    def run(epochs, where, resume=False):
        def rank(group):
            _, tcfg = _configs()
            tcfg.num_epochs, tcfg.augment = epochs, True
            trainer = mp.MoETrainer(ds, tcfg, group=group)
            trainer.train(checkpoint_dir=str(tmp_path / where),
                          resume=resume)
            return trainer
        return mh.thread_ranks(2, rank, timeout=240)

    full = run(2, "a")
    saved = torch.load(sorted((tmp_path / "a").glob("ckpt_*.pt"))[-1],
                       weights_only=True)["params"]
    whole = join_rank_rows([t.state.params for t in full])
    assert saved["block_0/moe/w1"].shape == (E, 192, 768)
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


def test_dp_ep_mesh_over_ranks_names_the_sixth_part():
    _, tcfg = _configs(dp_degree=2)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP §1 item 10, sixth part"):
        mp.MoETrainer(_dataset(16), tcfg,
                      group=mh.RankGroup(None, 0, 2, "gloo"))
    with pytest.raises(NotImplementedError, match="item 10, sixth part"):
        mh.make_global_mesh(8, "cpu", axis_names=("data", "expert"),
                            group=mh.RankGroup(None, 0, 2, "gloo"))
    three = mh.RankGroup(None, 0, 3, "gloo")
    with pytest.raises(ValueError, match="divide evenly over 3 processes"):
        mh.make_global_mesh(E, "cpu", axis_names=(EXPERT_AXIS,),
                            group=three)
    with pytest.raises(ValueError, match="4 experts do not divide evenly"):
        moe.make_moe_ffn(type(make_mesh(E, "cpu"))(
            E, torch.device("cpu"), EXPERT_AXIS, group=three), 8)
