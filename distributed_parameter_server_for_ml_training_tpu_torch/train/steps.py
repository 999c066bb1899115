"""Train/eval step factories of the port (counterpart of the JAX package's
``train/steps.py``).

The JAX steps are pure functions of (params, batch_stats, batch); here a
step closes over one ``nn.Module`` and loads the flat flax-named params
and batch_stats it is given into that module before running it, so the
interface — and what the store, the codec and the wire see — is the
reference's: flat dicts keyed by flax names, in flax layouts. A module
is not thread-safe, so each worker thread builds its steps over its own
module (``ps/worker.py``).

:func:`make_train_step` is the single-program step of the baseline and
model-parallel trainers (``train/baseline.py``, ``train/model_parallel.py``):
it trains the module's own parameters (and BatchNorm statistics) in
place, and copies nothing from the host, so a CUDA graph can capture it
(``train/device_loop.py``). :func:`make_fused_local_step` is the
``local_sgd`` worker's step: grads, the plain SGD apply and the window
accumulator, all updated in place on the device. ``make_train_step``'s
MoE branch (``moe_aux_weight``) weights the Switch load-balance loss of
the model's ``SwitchMoEMlp`` layers into the loss and reports their
routing statistics.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..data.cifar import (augment_batch, augment_draws, augment_with_draws,
                          standardize, standardizer, to_float)
from ..models.vit import SwitchMoEMlp
from ..utils.pytree import flax_names, to_flax_layout, to_torch_layout


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (worker.py:131 used
    nn.CrossEntropyLoss)."""
    return F.cross_entropy(logits, labels.long())


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def flax_state_loader(model: torch.nn.Module) -> Callable:
    """``load(params, batch_stats=None)``: copy flat flax-named params (and
    batch_stats) into ``model`` in place, converting layouts. Values may be
    tensors or NumPy arrays; names absent from the dicts are left as
    they are. The name mapping is resolved once, here."""
    pnames, snames = flax_names(model)
    device = _model_device(model)
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    pairs = ([(f, state[t]) for t, f in pnames.items()],
             [(f, state[t]) for t, f in snames.items()])

    @torch.no_grad()
    def load(params: Mapping, batch_stats: Mapping | None = None) -> None:
        for targets, flat in zip(pairs, (params, batch_stats or {})):
            for fname, target in targets:
                if fname in flat:
                    v = torch.as_tensor(flat[fname], device=device)
                    target.copy_(to_torch_layout(v, fname))

    return load


def make_grad_step(model: torch.nn.Module, augment: bool = True
                   ) -> Callable:
    """Build the worker-local step: forward/backward WITHOUT the update.

    The async-mode analogue of the reference worker's ``train_local_batch``
    (worker.py:333-348), with the update left to the parameter store.
    Returns ``grad_step(params, batch_stats, images_u8, labels,
    generator=None) -> (grads, new_batch_stats, loss, accuracy)``:
    ``grads`` and ``new_batch_stats`` are flat flax-named dicts of
    contiguous tensors on the model's device in flax layouts; ``loss`` and
    ``accuracy`` are 0-dim tensors (no host sync). ``images_u8`` is the raw
    uint8 NHWC batch; augmentation (drawn from ``generator``) and
    normalization run on the device.
    """
    pnames, snames = flax_names(model)
    device = _model_device(model)
    params_t = dict(model.named_parameters())
    buffers_t = dict(model.named_buffers())
    order = list(pnames)
    load = flax_state_loader(model)

    def grad_step(params, batch_stats, images_u8, labels, generator=None):
        load(params, batch_stats)
        x = torch.as_tensor(images_u8, device=device)
        y = torch.as_tensor(labels, device=device).long()
        # Augment on the raw uint8 pixels: same floats as casting first.
        if augment:
            x = augment_batch(x, generator)
        x = standardize(to_float(x))
        model.train()
        logits = model(x)
        loss = cross_entropy_loss(logits, y)
        grads_t = torch.autograd.grad(loss, [params_t[t] for t in order])
        grads = {pnames[t]: to_flax_layout(g, pnames[t]).contiguous()
                 for t, g in zip(order, grads_t)}
        new_stats = {f: buffers_t[t].detach().clone()
                     for t, f in snames.items()}
        accuracy = (logits.detach().argmax(-1) == y).float().mean()
        return grads, new_stats, loss.detach(), accuracy

    return grad_step


def make_fused_local_step(model: torch.nn.Module, augment: bool = True
                          ) -> Callable:
    """Build the ``local_sgd`` worker's step: grads, then the plain SGD
    apply ``p -= lr * g`` and the window accumulator ``a += g``.

    ``fused_step(params, accum, batch_stats, images_u8, labels,
    generator, lr) -> (params, accum, batch_stats, loss, accuracy)``:
    ``params``, ``accum`` and ``batch_stats`` are flat flax-named dicts of
    tensors on the model's device, updated IN PLACE and returned — the
    counterpart of the JAX step's donated buffers: no param-sized
    allocation and no host copy inside the K-step window. ``lr`` is a
    host scalar, passed to the update as the kernels' ``alpha``.

    Rounding: ``torch._foreach_add_(params, grads, alpha=-lr)`` computes
    ``p + (-lr) * g`` with one rounding (a fused multiply-add), which is
    what the JAX step's jitted ``p - lr * g`` gives on XLA's CPU backend;
    a multiply and then a subtract would round twice and differ from it
    in the last bit. With K=1 the accumulator holds ``0 + g``, so the
    pushed window mean is the faithful step's gradient up to ±0."""
    pnames, snames = flax_names(model)
    device = _model_device(model)
    params_t = dict(model.named_parameters())
    buffers_t = dict(model.named_buffers())
    order = list(pnames)
    names = [pnames[t] for t in order]
    stat_pairs = [(f, buffers_t[t]) for t, f in snames.items()]
    load = flax_state_loader(model)

    def fused_step(params, accum, batch_stats, images_u8, labels,
                   generator, lr):
        load(params, batch_stats)
        x = torch.as_tensor(images_u8, device=device)
        y = torch.as_tensor(labels, device=device).long()
        if augment:
            x = augment_batch(x, generator)
        x = standardize(to_float(x))
        model.train()
        logits = model(x)
        loss = cross_entropy_loss(logits, y)
        grads_t = torch.autograd.grad(loss, [params_t[t] for t in order])
        # Flax layouts, contiguous: the foreach kernels take the fast
        # path only over tensors of one layout.
        grads = [to_flax_layout(g, n).contiguous()
                 for g, n in zip(grads_t, names)]
        with torch.no_grad():
            torch._foreach_add_([params[n] for n in names], grads,
                                alpha=-float(lr))
            torch._foreach_add_([accum[n] for n in names], grads)
            for f, buf in stat_pairs:
                batch_stats[f].copy_(buf)
        accuracy = (logits.detach().argmax(-1) == y).float().mean()
        return params, accum, batch_stats, loss.detach(), accuracy

    return fused_step


def collect_moe_stats(model: torch.nn.Module) -> list[dict]:
    """The routing statistics of every ``SwitchMoEMlp`` layer's last
    training forward (``models/vit.py``), in module-tree order: one dict
    per MoE layer (the JAX package's ``moe_stats`` entries)."""
    return [m.stats for m in model.modules()
            if isinstance(m, SwitchMoEMlp) and m.stats is not None]


def _moe_metrics(layers: list[dict], ce: torch.Tensor,
                 aux: torch.Tensor) -> dict:
    """The MoE metrics of a step, as 0-dim device tensors: ``loss`` is the
    cross-entropy alone (comparable across modes), ``moe_load_imbalance``
    the mean over layers of max/mean expert load."""
    load = torch.stack([s["load"] for s in layers]).detach()     # [L, E]
    return {
        "loss": ce.detach(),
        "moe_aux_loss": aux.detach(),
        "moe_load_imbalance": torch.mean(
            load.amax(dim=1) / load.mean(dim=1).clamp_min(1e-9)),
        "moe_drop_frac": torch.mean(torch.stack(
            [s["drop_frac"] for s in layers])).detach(),
    }


def make_train_step(model: torch.nn.Module, augment: bool = True,
                    reduce_grads: Callable | None = None,
                    moe_aux_weight: float | None = None,
                    batch_rows: Callable | None = None) -> Callable:
    """Build ``train_step(state, images_u8, labels, generator=None) ->
    (state, metrics)`` for a state whose tensors are ``model``'s own
    (``train_state.module_train_state``): counterpart of the JAX
    ``make_train_step``.

    Augments the raw uint8 NHWC batch on the device (draws from
    ``generator``), standardizes, computes the mean cross-entropy and its
    gradient, and applies the state's optimizer in place, so the module's
    weights move and no parameter-sized copy is kept. A BatchNorm model's
    training forward updates its running statistics (the state's
    ``batch_stats``) in place, with flax's conventions (biased variance,
    momentum 0.9 on the old value). ``metrics`` holds 0-dim ``loss`` and
    ``accuracy`` tensors, ``learning_rate`` where the optimizer schedules
    it, and with augmentation ``augment_draws`` ``[B, 3]`` (crop row,
    crop column, flip) — no host sync. ``reduce_grads(names, grads) ->
    grads``, given by the model-parallel trainers over several ranks,
    maps the gradients (torch parameter names, in order) before the
    apply. ``batch_rows(t) -> t`` (MoE over ranks) keeps this rank's rows
    of the augmented, standardized images and of the labels: every rank
    augments the whole global batch with the same draws, as one process
    would, and trains on its own rows.

    ``moe_aux_weight is not None`` (a model with ``SwitchMoEMlp`` layers):
    the loss is ``ce + moe_aux_weight * mean(aux)`` over the layers'
    Switch aux losses, and ``metrics`` gain ``moe_aux_loss``,
    ``moe_load_imbalance`` and ``moe_drop_frac`` (its ``loss`` is the
    cross-entropy); 0.0 keeps the metrics with balancing off."""
    pnames, _ = flax_names(model)
    device = _model_device(model)
    params_t = dict(model.named_parameters())
    order = list(pnames)
    std = standardizer(device)

    def train_step(state, images_u8, labels, generator=None):
        x = torch.as_tensor(images_u8, device=device)
        y = torch.as_tensor(labels, device=device).long()
        metrics = {}
        if augment:
            offsets, flip = augment_draws(x.shape[0], generator, device)
            x = augment_with_draws(x, offsets, flip)
            metrics["augment_draws"] = torch.cat(
                [offsets, flip[:, None].long()], 1)
        x = std(to_float(x))
        if batch_rows is not None:
            x, y = batch_rows(x), batch_rows(y)
        model.train()
        logits = model(x)
        loss = cross_entropy_loss(logits, y)
        moe = None
        if moe_aux_weight is not None:
            layers = collect_moe_stats(model)
            aux = (torch.stack([s["aux_loss"] for s in layers]).mean()
                   if layers else loss.new_zeros(()))
            moe = _moe_metrics(layers, loss, aux) if layers else None
            loss = loss + moe_aux_weight * aux
        grads_t = torch.autograd.grad(loss, [params_t[t] for t in order])
        if reduce_grads is not None:
            grads_t = reduce_grads(order, grads_t)
        lr = state.apply_gradients_(
            {pnames[t]: to_flax_layout(g, pnames[t])
             for t, g in zip(order, grads_t)})
        metrics["loss"] = loss.detach()
        metrics["accuracy"] = (logits.detach().argmax(-1) == y).float().mean()
        if lr is not None:
            metrics["learning_rate"] = lr
        if moe is not None:
            metrics.update(moe)
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Build ``eval_step(params, batch_stats, images_u8, labels) ->
    (correct, total)``: top-1 over one batch with the running BN
    statistics, matching worker.py:313-331. ``correct`` is a 0-dim
    tensor, so a caller summing over batches syncs once at the end."""
    device = _model_device(model)
    load = flax_state_loader(model)
    std = standardizer(device)

    @torch.no_grad()
    def eval_step(params, batch_stats, images_u8, labels):
        load(params, batch_stats)
        model.eval()
        x = std(to_float(torch.as_tensor(images_u8, device=device)))
        y = torch.as_tensor(labels, device=device).long()
        logits = model(x)
        return (logits.argmax(-1) == y).sum(), int(y.shape[0])

    return eval_step
