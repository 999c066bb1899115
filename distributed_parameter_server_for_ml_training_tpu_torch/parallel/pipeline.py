"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over the
``stage`` slots of a mesh (counterpart of the JAX package's
``parallel/pipeline.py``).

In the reference the model is S identical stages, stage s's parameters
live on mesh slot s (each leaf stacked ``[S, ...]``), and M microbatches
flow through a ring of ``ppermute`` hops: at tick t stage s works on
microbatch t - s, S + M - 1 ticks in all, bubble ticks computing nothing.
The port runs the S slots on one card in one program: a tick runs each
active stage's ``stage_fn`` on the activation it holds, and the hop to
stage s + 1 is a hand-over of that tensor. The numbers are those of the
stages applied in sequence to each microbatch; the schedule fixes the
order of the work, the activations held and the memory.

- ``make_pipeline_apply``: GPipe's forward ticks, differentiated by
  autograd. With ``remat`` (the default) each stage call runs under
  ``torch.utils.checkpoint`` (``use_reentrant=False``): the backward
  recomputes a stage from its input instead of keeping its activations,
  as ``jax.checkpoint`` does; the recompute runs the same operations on
  the same shapes on the same stream, so a bf16 stage gives the same
  numbers. ``shard_io`` (the reference's sharding of the microbatch axis
  over the stage slots) keeps its default and its divisibility check;
  on one card every microbatch is already on the card, so it changes no
  number.
- ``make_pipeline_train_step(..., schedule="1f1b")``: the fused 1F1B
  schedule from the integer tables of ``build_1f1b_schedule`` (the
  reference's, copied as it is). A forward unit runs without a graph and
  stashes its input in one of S slots (``mb % S``); a backward unit
  recomputes its stage from the stashed input and takes its gradients
  with ``torch.autograd.grad``, so at most S - s microbatches are in
  flight at stage s.

The stacked leaves are split into the stages' views once a step (one
``unbind`` each), so the backward stacks each leaf's gradient once.

dp x pp (``data_axis``, a ``(data, model, stage)`` mesh): the reference
splits each microbatch's rows over the data slots (``x_spec = P(mb_axis,
data_axis)``), each data slot running the stage ring on its rows, and the
shard_map transpose sums the parameters' gradients over the data axis.
On one card the data slots' rows ride together in each stage call (each
slot's ``mb / dp`` rows side by side, as ``ViT.forward_slots`` folds
slots into the batch): every operation is row-wise, so the numbers are
the plain pipeline's, and the sum over the data slots is the batch sum of
the gradient products. A stage function with ``pp_tp_degree`` > 1 is the
TP form of ``EncoderStage`` (``models/vit.py``), whose ``model`` slots
the stage call runs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import collective_bytes
from .mesh import STAGE_AXIS, Mesh
from .multihost import RankGroup, shared_broadcast, stage_hop


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _stages(stacked, n: int) -> list:
    """``[S, ...]`` leaves -> S trees of one stage's views (one ``unbind``
    a leaf)."""
    split = [leaf.unbind(0) for leaf in _leaves(stacked)]
    for leaf in split:
        if len(leaf) != n:
            raise ValueError(f"a stacked leaf holds {len(leaf)} stages, the "
                             f"mesh {n}")
    return [_unflatten(stacked, [leaf[s] for leaf in split])
            for s in range(n)]


def stack_stage_params(per_stage_params: list):
    """``[S]`` list of same-structure param trees -> a tree of ``[S, ...]``
    leaves."""
    first = per_stage_params[0]
    cols = zip(*(_leaves(p) for p in per_stage_params))
    return _unflatten(first, [torch.stack(c) for c in cols])


def _check_mesh(mesh: Mesh, axis: str, data_axis: str | None
                ) -> tuple[int, int]:
    """(stage slots, data slots) of the mesh; over ranks the stage slots
    must divide evenly over them."""
    n = mesh.shape[axis]
    if mesh.group is not None and n % mesh.group.size:
        raise ValueError(f"{n} stages do not divide evenly over "
                         f"{mesh.group.size} ranks")
    return n, 1 if data_axis is None else mesh.shape[data_axis]


def _span(mesh: Mesh, n: int) -> tuple[int, int]:
    """The global indices ``[lo, hi)`` of this rank's stages."""
    per = n // mesh.num_ranks
    return mesh.rank * per, (mesh.rank + 1) * per


def _microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    if x.shape[0] % m:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {m} "
                         f"microbatches")
    return x.view(m, x.shape[0] // m, *x.shape[1:])


def _gpipe(stages: list, x_mb: torch.Tensor, stage_fn: Callable,
           remat: bool) -> list:
    """GPipe's S + M - 1 forward ticks over ``x_mb`` ``[M, mb, ...]``;
    returns the M outputs of the last stage. ``carry[s]`` is what stage s
    holds at the start of a tick."""
    n, m = len(stages), x_mb.shape[0]
    carry: list = [None] * n
    outputs: list = [None] * m
    for t in range(n + m - 1):
        new = [None] * n
        for s in range(n):
            mb = t - s
            if not 0 <= mb < m:
                continue                      # a bubble tick: no compute
            x_in = x_mb[mb] if s == 0 else carry[s]
            if remat:
                y = checkpoint(lambda xx, p=stages[s]: stage_fn(p, xx),
                               x_in, use_reentrant=False)
            else:
                y = stage_fn(stages[s], x_in)
            if s == n - 1:
                outputs[mb] = y
            else:
                new[s + 1] = y                # the hop to stage s + 1
        carry = new
    return outputs


class _RankGPipe(torch.autograd.Function):
    """GPipe over this rank's stages ``[lo, hi)`` of ``n`` (module notes):
    ``apply(cfg, x, *leaves)``, ``cfg = (tree, stage_fn, remat, n, m, lo,
    group)`` with ``tree`` the stacked params' structure and ``leaves``
    its ``[hi - lo, ...]`` leaves."""

    @staticmethod
    def forward(ctx, cfg, x, *leaves):
        tree, stage_fn, remat, n, m, lo, group = cfg
        hi = lo + leaves[0].shape[0]
        x_mb = _microbatches(x, m)
        # One tree of leaf views a stage, each view a leaf of its own.
        own = [[leaf[s].detach().requires_grad_() for leaf in leaves]
               for s in range(hi - lo)]
        saved, outputs = {}, [None] * m
        carry, arrived = {}, None
        for t in range(n + m - 1):
            leaving, new = None, {}
            for s in range(lo, hi):
                mb = t - s
                if not 0 <= mb < m:
                    continue                  # a bubble tick: no compute
                x_in = x_mb[mb] if s == 0 else \
                    arrived if s == lo else carry[s]
                params = _unflatten(tree, own[s - lo])
                if remat:
                    y = stage_fn(params, x_in)
                    saved[s, mb] = x_in
                else:
                    with torch.enable_grad():
                        xx = x_in.detach().requires_grad_()
                        y = stage_fn(params, xx)
                    saved[s, mb] = (xx, y)
                    y = y.detach()
                if s == n - 1:
                    outputs[mb] = y
                elif s == hi - 1:
                    leaving = y               # the hop to the next rank
                else:
                    new[s + 1] = y            # the hop to stage s + 1
            carry = new
            send = hi < n and 0 <= t - (hi - 1) < m
            recv = lo > 0 and 0 <= t + 1 - lo < m
            if send or recv:
                got = stage_hop([x_mb[0] if leaving is None else leaving],
                                group, 1, send=send, recv=recv, tag=2 * t)
                arrived = got[0] if recv else None
        ctx.cfg, ctx.own, ctx.saved = cfg, own, saved
        ctx.x_shape = x.shape
        # The backward may run on autograd's device thread: it counts its
        # hops into the recorders open here.
        ctx.recorders = collective_bytes.open_recorders()
        return torch.cat(outputs) if hi == n else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, gy):
        with collective_bytes.recording(ctx.recorders):
            return _RankGPipe._backward(ctx, gy)

    @staticmethod
    def _backward(ctx, gy):
        tree, stage_fn, remat, n, m, lo, group = ctx.cfg
        own, saved = ctx.own, ctx.saved
        hi = lo + len(own)
        gy_mb = _microbatches(gy.contiguous(), m)
        grads = [[torch.zeros_like(p) for p in leaves] for leaves in own]
        gx_mb: list = [None] * m
        carry, arrived = {}, None
        want_x = ctx.needs_input_grad[1]
        for t in reversed(range(n + m - 1)):
            leaving, new = None, {}
            for s in reversed(range(lo, hi)):
                mb = t - s
                if not 0 <= mb < m:
                    continue
                g_out = gy_mb[mb] if s == n - 1 else \
                    arrived if s == hi - 1 else carry[s]
                take_x = s > 0 or want_x
                with torch.enable_grad():
                    if remat:
                        xx = saved.pop((s, mb)).detach().requires_grad_(
                            take_x)
                        out = stage_fn(_unflatten(tree, own[s - lo]), xx)
                    else:
                        xx, out = saved.pop((s, mb))
                    got = torch.autograd.grad(
                        out, own[s - lo] + ([xx] if take_x else []), g_out,
                        allow_unused=True)
                for acc, g in zip(grads[s - lo], got):
                    if g is not None:
                        acc.add_(g)
                if s == 0:
                    gx_mb[mb] = got[-1] if want_x else None
                elif s == lo:
                    leaving = got[-1]         # back to the previous rank
                else:
                    new[s - 1] = got[-1]
            carry = new
            send = lo > 0 and 0 <= t - lo < m
            recv = hi < n and 0 <= t - 1 - (hi - 1) < m
            if send or recv:
                template = gy_mb[0] if leaving is None else leaving
                got = stage_hop([template], group, -1, send=send,
                                recv=recv, tag=2 * t + 1)
                arrived = got[0] if recv else None
        ctx.own = ctx.saved = None
        gx = None
        if want_x:
            gx = torch.cat(gx_mb) if lo == 0 else gy.new_zeros(ctx.x_shape)
        return (None, gx,
                *[torch.stack(col) for col in zip(*grads)])


def make_pipeline_apply(mesh: Mesh, stage_fn: Callable,
                        num_microbatches: int, axis: str = STAGE_AXIS,
                        data_axis: str | None = None,
                        shard_io: bool | None = None,
                        remat: bool = True) -> Callable:
    """Build ``apply(stacked_params, x) -> y`` running the GPipe schedule
    over the mesh's ``axis`` slots.

    ``stage_fn(one_stage_params, x) -> y`` is one stage (shape and dtype
    kept); ``stacked_params`` a tree (nested dicts) of ``[S, ...]``
    leaves; ``x`` the whole batch ``[B, ...]``, split into
    ``num_microbatches`` equal microbatches, each split over the mesh's
    ``data_axis`` slots when given (module notes). Differentiable by
    autograd in the params and ``x``. ``shard_io``: None = on when the
    microbatch count divides by the stage count; True with a count that
    does not raises, as in the reference (module notes).

    Over the ranks of ``mesh.group``: ``stacked_params`` holds this rank's
    stages' rows, and ``apply`` is :class:`_RankGPipe` (module notes);
    every rank calls it, and runs its backward, in the same order."""
    n, dp = _check_mesh(mesh, axis, data_axis)
    if shard_io and num_microbatches % n:
        raise ValueError(
            f"shard_io needs microbatches ({num_microbatches}) divisible "
            f"by the stage count ({n})")
    if mesh.group is not None:
        lo, hi = _span(mesh, n)

        def rank_apply(stacked_params, x: torch.Tensor) -> torch.Tensor:
            leaves = _leaves(stacked_params)
            if any(leaf.shape[0] != hi - lo for leaf in leaves):
                raise ValueError(f"a stacked leaf holds {leaves[0].shape[0]}"
                                 f" stages, this rank {hi - lo}")
            cfg = (stacked_params, stage_fn, remat, n, num_microbatches,
                   lo, mesh.group)
            return _RankGPipe.apply(cfg, x, *leaves)

        return rank_apply

    def apply(stacked_params, x: torch.Tensor) -> torch.Tensor:
        x_mb = _microbatches(x, num_microbatches)
        if x_mb.shape[1] % dp:
            raise ValueError(f"a microbatch of {x_mb.shape[1]} rows does "
                             f"not split over {dp} data slots")
        ys = _gpipe(_stages(stacked_params, n), x_mb, stage_fn, remat)
        return torch.cat(ys)

    return apply


def build_1f1b_schedule(n_stages: int, n_microbatches: int) -> dict:
    """Simulate the 1F1B schedule and return per-tick tables.

    Greedy policy (prefer backward; forward gated by the classic in-flight
    cap of S-s) reproduces the standard non-interleaved 1F1B timeline. The
    function VERIFIES the schedule as it simulates: in-order processing,
    arrival-before-use, depth-S stash slots (mb % S) never collide, and
    every unit runs exactly once — a bug here raises instead of silently
    mis-training.

    Returns ``{"ticks": T, "act": [T,S] (0 idle/1 fwd/2 bwd),
    "mb": [T,S], "fwd_in": [T,S] (mb arriving on the fwd ring, -1 none),
    "bwd_in": [T,S]}``.
    """
    import numpy as np

    S, M = n_stages, n_microbatches
    act, mb_t, fwd_in, bwd_in = [], [], [], []
    # Per-stage simulator state.
    pend_f = [set() for _ in range(S)]   # arrived fwd inputs (mb ids)
    pend_b = [set() for _ in range(S)]   # arrived output-grads
    pend_f[0] = set(range(M))            # stage 0 reads x directly
    fwd_next = [0] * S                   # in-order forward
    bwd_next = [0] * S                   # in-order backward
    in_flight = [0] * S                  # fwd done, bwd not yet
    # (stage, kind, slot) -> occupying mb, for collision verification
    live: dict = {}
    arrivals_f: dict = {}                # (t, s) -> mb
    arrivals_b: dict = {}
    t = 0
    while any(n < M for n in bwd_next):
        if t > 4 * (S + M):
            raise AssertionError("1F1B schedule did not converge")
        # Deliver arrivals scheduled for this tick into buffers.
        row_fin, row_bin = [-1] * S, [-1] * S
        for s in range(S):
            j = arrivals_f.pop((t, s), None)
            if j is not None:
                key = (s, "x", j % S)
                assert key not in live, f"x slot collision at {key}"
                live[key] = j
                pend_f[s].add(j)
                row_fin[s] = j
            j = arrivals_b.pop((t, s), None)
            if j is not None:
                key = (s, "g", j % S)
                assert key not in live, f"g slot collision at {key}"
                live[key] = j
                pend_b[s].add(j)
                row_bin[s] = j
        row_a, row_m = [0] * S, [-1] * S
        for s in range(S):
            j = bwd_next[s]
            if j < M and j in pend_b[s]:
                # Backward unit: consumes the stashed input + grad slots.
                row_a[s], row_m[s] = 2, j
                pend_b[s].discard(j)
                for kind in ("x", "g"):
                    key = (s, kind, j % S)
                    if key in live:          # stage 0 stashes x too
                        del live[key]
                bwd_next[s] += 1
                in_flight[s] -= 1
                if s > 0:
                    arrivals_b[(t + 1, s - 1)] = j
                continue
            j = fwd_next[s]
            if (j < M and j in pend_f[s]
                    and in_flight[s] < S - s):
                row_a[s], row_m[s] = 1, j
                pend_f[s].discard(j)
                if s == 0:
                    # Stage 0 stashes its own input for the later vjp.
                    key = (s, "x", j % S)
                    assert key not in live, f"x slot collision at {key}"
                    live[key] = j
                fwd_next[s] += 1
                in_flight[s] += 1
                if s < S - 1:
                    arrivals_f[(t + 1, s + 1)] = j
                else:
                    # Last stage computes dy at its fwd tick; its own
                    # backward becomes ready next tick.
                    key = (s, "g", j % S)
                    assert key not in live, f"g slot collision at {key}"
                    live[key] = j
                    pend_b[s].add(j)  # delivered locally, not via ring
        act.append(row_a)
        mb_t.append(row_m)
        fwd_in.append(row_fin)
        bwd_in.append(row_bin)
        t += 1
    assert not live, f"undelivered buffers: {live}"
    for s in range(S):
        assert fwd_next[s] == M and bwd_next[s] == M
    return {"ticks": t,
            "act": np.asarray(act, np.int32),
            "mb": np.asarray(mb_t, np.int32),
            "fwd_in": np.asarray(fwd_in, np.int32),
            "bwd_in": np.asarray(bwd_in, np.int32)}


def _1f1b(stages: list, x_mb: torch.Tensor, y_mb: torch.Tensor, *,
          stage_fn: Callable, loss_fn: Callable, tables: dict,
          n: int | None = None, lo: int = 0,
          group: RankGroup | None = None):
    """The fused 1F1B step over one stage's param trees each (leaves that
    require grad): returns (the sum of the microbatches' losses, each
    stage's summed gradients as a list of leaf lists). Over ranks,
    ``stages`` are this rank's, the global stages ``lo, lo + 1, ...`` of
    ``n``, and the loss sum is None but on the last rank.

    Per stage, depth-S buffers (slot = mb % S): ``x_buf`` the inputs that
    arrived, kept after the forward unit for the backward's recompute;
    ``g_buf`` the output-gradients awaiting the backward unit (the last
    stage seeds its own slot with dy at its forward tick). A tick's
    messages land at the next tick, as the tables' arrivals say; those
    between ranks hop at the end of the tick (module notes)."""
    n = len(stages) if n is None else n
    hi = lo + len(stages)
    last = n - 1
    ticks = int(tables["ticks"])
    leaves = [_leaves(p) for p in stages]
    x_buf = [[None] * n for _ in range(n)]
    g_buf = [[None] * n for _ in range(n)]
    fwd_msg: list = [None] * n          # what stage s sent last tick
    bwd_msg: list = [None] * n
    fwd_in_hop = bwd_in_hop = None      # what the neighbour ranks sent
    grads = [[torch.zeros_like(p) for p in lv] for lv in leaves]
    loss_sum = None
    for t in range(ticks):
        for s in range(lo, hi):
            fin, bin_ = int(tables["fwd_in"][t][s]), int(tables["bwd_in"][t][s])
            if fin >= 0:
                x_buf[s][fin % n] = fwd_in_hop if s == lo else fwd_msg[s - 1]
            if bin_ >= 0:
                g_buf[s][bin_ % n] = bwd_in_hop if s == hi - 1 \
                    else bwd_msg[s + 1]
        new_fwd: list = [None] * n
        new_bwd: list = [None] * n
        for s in range(lo, hi):
            act, mb = int(tables["act"][t][s]), int(tables["mb"][t][s])
            slot = mb % n
            own = stages[s - lo]
            if act == 1:                        # forward unit
                x_in = x_mb[mb] if s == 0 else x_buf[s][slot]
                x_buf[s][slot] = x_in
                with torch.no_grad():
                    y = stage_fn(own, x_in)
                if s == last:
                    with torch.enable_grad():
                        yy = y.detach().requires_grad_()
                        lval = loss_fn(yy, y_mb[mb])
                        (dy,) = torch.autograd.grad(lval, yy)
                    loss_sum = lval.detach() if loss_sum is None \
                        else loss_sum + lval.detach()
                    g_buf[s][slot] = dy
                else:
                    new_fwd[s] = y
            elif act == 2:                      # backward unit
                with torch.enable_grad():
                    xx = x_buf[s][slot].detach().requires_grad_(s > 0)
                    out = stage_fn(own, xx)
                    inputs = leaves[s - lo] + ([xx] if s > 0 else [])
                    got = torch.autograd.grad(out, inputs, g_buf[s][slot],
                                              allow_unused=True)
                for acc, g in zip(grads[s - lo], got):
                    if g is not None:
                        acc.add_(g)
                if s > 0:
                    new_bwd[s] = got[-1]
                x_buf[s][slot] = g_buf[s][slot] = None
        fwd_msg, bwd_msg = new_fwd, new_bwd
        if group is not None and t + 1 < ticks:
            # The messages bound for another rank's stage land next tick.
            send = new_fwd[hi - 1] is not None
            recv = lo > 0 and int(tables["fwd_in"][t + 1][lo]) >= 0
            if send or recv:
                out = new_fwd[hi - 1] if send else x_mb[0]
                got = stage_hop([out], group, 1, send=send, recv=recv,
                                tag=2 * t)
                fwd_in_hop = got[0] if recv else None
            send = lo > 0 and new_bwd[lo] is not None
            recv = hi < n and int(tables["bwd_in"][t + 1][hi - 1]) >= 0
            if send or recv:
                out = new_bwd[lo] if send else x_mb[0]
                got = stage_hop([out], group, -1, send=send, recv=recv,
                                tag=2 * t + 1)
                bwd_in_hop = got[0] if recv else None
    return loss_sum, grads


def _check_homogeneous_stage(stage_fn: Callable, stacked_params,
                             x: torch.Tensor, num_microbatches: int) -> None:
    """Both schedules route every stage's output into the next stage's
    input slot (and, in 1F1B, into buffers shaped like the input), so
    ``stage_fn`` must map a microbatch to the same shape and dtype. The
    check runs the stage on the meta device (shapes only, no FLOPs), as
    the reference's ``jax.eval_shape``, and names the contract."""
    mb = x.shape[0] // num_microbatches
    x_meta = torch.empty((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device="meta")
    one_stage = _tree_map(
        lambda p: torch.empty(tuple(p.shape[1:]), dtype=p.dtype,
                              device="meta"), stacked_params)
    with torch.no_grad():
        out = stage_fn(one_stage, x_meta)
    if not isinstance(out, torch.Tensor) \
            or tuple(out.shape) != tuple(x_meta.shape) \
            or out.dtype != x_meta.dtype:
        got = (f"{out.dtype}{list(out.shape)}"
               if isinstance(out, torch.Tensor) else type(out).__name__)
        raise ValueError(
            f"pipeline stages must be homogeneous: stage_fn must map a "
            f"microbatch of {x_meta.dtype}{list(x_meta.shape)} to the same "
            f"shape/dtype (its output feeds the next stage's input and "
            f"the fixed-shape ring buffers), but it returned {got}. "
            f"Fold any shape change (embedding, head) inside a stage.")


def make_pipeline_train_step(mesh: Mesh, stage_fn: Callable,
                             loss_fn: Callable, num_microbatches: int,
                             schedule: str = "gpipe",
                             axis: str = STAGE_AXIS,
                             remat: bool = True) -> Callable:
    """``step(stacked_params, x, y) -> (loss, stacked_grads)`` under either
    schedule.

    ``loss_fn(y_pred_mb, y_mb) -> scalar`` (a mean over the microbatch);
    the step returns the mean over microbatches, so both schedules give
    the same loss and parameter gradients. ``stacked_grads`` has the
    params' tree and ``[S, ...]`` leaves. Over the ranks of
    ``mesh.group`` the params and gradients are this rank's stages' rows,
    ``x`` and ``y`` the whole batch on every rank, and the loss the last
    rank's on every rank (module notes).

    - ``"gpipe"``: :func:`make_pipeline_apply` and autograd;
    - ``"1f1b"``: the fused schedule (module notes), which always
      recomputes; ``remat=False`` raises, as in the reference.

    ``stage_fn`` must keep shape and dtype; checked once a shape and dtype
    of ``x`` (:func:`_check_homogeneous_stage`)."""
    n, _ = _check_mesh(mesh, axis, None)
    lo, hi = _span(mesh, n)
    m = num_microbatches
    seen: set = set()

    def shared_loss(loss: torch.Tensor) -> torch.Tensor:
        """The last rank's loss on every rank (as it is in one process)."""
        if mesh.group is None:
            return loss
        with torch.no_grad():
            return shared_broadcast(loss, mesh.num_ranks - 1, mesh.group)

    def validated(stacked_params, x):
        key = (tuple(x.shape), x.dtype)
        if key not in seen:
            _check_homogeneous_stage(stage_fn, stacked_params, x, m)
            seen.add(key)

    def trainable(stacked_params) -> list:
        return [p if p.requires_grad else p.detach().requires_grad_()
                for p in _leaves(stacked_params)]

    if schedule == "gpipe":
        apply = make_pipeline_apply(mesh, stage_fn, m, axis=axis,
                                    shard_io=False, remat=remat)

        def gpipe_step(stacked_params, x, y):
            validated(stacked_params, x)
            with torch.enable_grad():
                leaves = trainable(stacked_params)
                y_pred = apply(_unflatten(stacked_params, leaves), x)
                y_pred_mb = _microbatches(y_pred, m)
                y_mb = _microbatches(y, m)
                loss = torch.stack([loss_fn(y_pred_mb[i], y_mb[i])
                                    for i in range(m)]).mean()
                grads = torch.autograd.grad(loss, leaves)
            return shared_loss(loss.detach()), \
                _unflatten(stacked_params, list(grads))

        return gpipe_step

    if schedule != "1f1b":
        raise ValueError(f"schedule must be gpipe|1f1b, got {schedule!r}")
    if not remat:
        raise ValueError(
            "schedule='1f1b' is inherently rematerializing: each backward "
            "unit recomputes its stage from the stashed input; remat=False "
            "has no non-recomputing implementation here")
    tables = build_1f1b_schedule(n, m)

    def f1b_step(stacked_params, x, y):
        validated(stacked_params, x)
        stages = [_tree_map(lambda p: p.detach().requires_grad_(), st)
                  for st in _stages(stacked_params, hi - lo)]
        y_mb = _microbatches(y, m)
        loss_sum, grads = _1f1b(stages, _microbatches(x, m), y_mb,
                                stage_fn=stage_fn, loss_fn=loss_fn,
                                tables=tables, n=n, lo=lo, group=mesh.group)
        stacked = [torch.stack(col) / m for col in zip(*grads)]
        if loss_sum is None:            # not the last rank: its shape only
            with torch.no_grad():
                loss_sum = loss_fn(_microbatches(x, m)[0], y_mb[0])
        return shared_loss(loss_sum / m), _unflatten(stacked_params, stacked)

    return f1b_step
