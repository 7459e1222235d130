"""Training and evaluation loops (port of ``ivf_tpu/train/loop.py``): one
``train_step`` / ``eval_step`` pair and the host orchestration around it.

  * loss: ``'cross_entropy'`` (log-softmax of the logits) or
    ``'nll_on_probs'``, the reference's NLLLoss applied to softmax
    probabilities, ``mean(-p[target])``; the target's entry is picked by a
    one-hot select, whose backward is elementwise (a gather's CUDA
    backward adds with atomics);
  * ``kernel_l2``: the Keras ``l2(lambda)`` term on the ConvLSTM input
    kernels (the parameters named ``wx``), ``lambda * sum(w ** 2)`` on
    the float32 masters;
  * BatchNorm running statistics update in the forward (training mode);
    dropout draws from ``train/state.py::step_generator(seed, step)``;
  * uint8 clips are cast to float32 once on the device;
  * ``compute_dtype='bfloat16'``: mixed precision. The forward and backward
    run on a differentiable bfloat16 copy of the parameters
    (``torch.func.functional_call``), while the master parameters, the
    optimizer state, the BN running statistics (updated in float32 from
    the batch's bfloat16 statistics), the loss and the gradients stay
    float32, as ``ivf_tpu/train/loop.py:66-137`` keeps them. The clips stay
    float32 up to the first conv, which rounds them to bfloat16 (exact for
    uint8 pixels): I3D and ``cnn_3d`` see the JAX package's values; the
    ConvLSTM's state stays float32 (bfloat16 gates, as in the search),
    where the JAX package's train step carries a bfloat16 state (a known
    divergence, queued in ROADMAP.md's Queue 3).

Metric reads are deferred: ``train_epoch`` keeps each step's device
scalars and reads them in bulk every 64 steps, at print points and at the
epoch's end, so the host does not wait on every step.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ivf_tpu_torch.models.layers import set_dropout_generator
from ivf_tpu_torch.precision import inference_model, reference_numerics_fn
from ivf_tpu_torch.train.metrics import AverageMeter, topk_accuracy
from ivf_tpu_torch.train.optim import get_learning_rate, set_learning_rate
from ivf_tpu_torch.train.state import TrainState, step_generator


def _compute_loss(logits: torch.Tensor, labels: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type not in ("cross_entropy", "nll_on_probs"):
        raise ValueError(f"unknown loss_type {loss_type}")
    hot = labels.long()[:, None] == torch.arange(logits.shape[-1], device=logits.device)
    scores = torch.log_softmax(logits, dim=-1) if loss_type == "cross_entropy" else logits
    return -torch.where(hot, scores, 0.0).sum(-1).mean()


def _kernel_l2_penalty(params: Dict[str, torch.Tensor], coeff: float) -> torch.Tensor:
    """``coeff * sum(w ** 2)`` over the ConvLSTM input kernels (``wx``):
    Keras l2 has no 1/2 factor and reaches the input kernel only."""
    total = 0.0
    for name, p in params.items():
        if name.rsplit(".", 1)[-1] == "wx":
            total = total + (p * p).sum()
    return coeff * total


def _device_inputs(model, clips: torch.Tensor, labels: torch.Tensor):
    dev = next(model.parameters()).device
    clips, labels = clips.to(dev), labels.to(dev)
    if clips.dtype == torch.uint8:
        clips = clips.float()
    return clips, labels


def make_train_step(loss_type: str = "cross_entropy", kernel_l2: float = 0.0, compute_dtype: str = "float32"):
    """``train_step(state, clips, labels) -> (state, metrics)``: one
    optimizer step in place on ``state`` (the module in training mode),
    with the device scalars ``loss``, ``top1`` and ``top5``."""
    bf16 = compute_dtype == "bfloat16"

    @reference_numerics_fn
    def train_step(state: TrainState, clips: torch.Tensor, labels: torch.Tensor):
        model = state.model.train()
        clips, labels = _device_inputs(model, clips, labels)
        set_dropout_generator(model, step_generator(state.seed, state.step, clips.device))
        params = state.params()
        try:
            if bf16:
                compute = {n: p.to(torch.bfloat16) for n, p in params.items()}
                logits = torch.func.functional_call(model, compute, (clips,), strict=False)
            else:
                logits = model(clips)
        finally:
            set_dropout_generator(model, None)
        loss = _compute_loss(logits.float(), labels, loss_type)
        if kernel_l2:
            loss = loss + _kernel_l2_penalty(params, kernel_l2)
        grads = torch.autograd.grad(loss, list(params.values()))
        state.apply_gradients(dict(zip(params, grads)))
        with torch.no_grad():
            top1, top5 = topk_accuracy(logits.detach(), labels, (1, 5))
        return state, {"loss": loss.detach(), "top1": top1, "top5": top5}

    return train_step


def make_eval_step(loss_type: str = "cross_entropy", compute_dtype: str = "float32"):
    """``eval_step(state, clips, labels) -> metrics`` in eval mode (BN on
    its running statistics, folded): ``loss``, ``top1``, ``top5`` and the
    float32 ``logits``. In bfloat16 the model runs as ``find_masks`` runs
    it (``precision.inference_model``): a bfloat16 copy of the float32
    master, made once per state step, so an evaluation between two train
    steps casts once."""
    bf16 = compute_dtype == "bfloat16"
    copy_of = {}

    def bf16_copy(state: TrainState) -> torch.nn.Module:
        key = (id(state.model), state.step)
        if copy_of.get("key") != key:
            copy_of.clear()  # the last step's copy goes before the next one is made
            copy_of.update(key=key, model=inference_model(copy.deepcopy(state.model), torch.bfloat16))
        return copy_of["model"]

    @torch.no_grad()
    @reference_numerics_fn
    def eval_step(state: TrainState, clips: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = bf16_copy(state) if bf16 else state.model.eval()
        clips, labels = _device_inputs(model, clips, labels)
        logits = model(clips).float()
        loss = _compute_loss(logits, labels, loss_type)
        top1, top5 = topk_accuracy(logits, labels, (1, 5))
        return {"loss": loss, "top1": top1, "top5": top5, "logits": logits}

    return eval_step


def train_epoch(
    state: TrainState,
    loader: Iterable,
    train_step: Callable,
    print_freq: int = 0,
    max_steps: Optional[int] = None,
    skip_steps: int = 0,
    step_offset: int = 0,
    step_callback: Optional[Callable[[TrainState, int], None]] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch over ``loader`` yielding (clips, labels[, ids]) batches.
    Returns (state, epoch metrics).

    Mid-epoch resume: ``skip_steps`` discards the loader's first batches
    (for a loader that cannot skip by index; ``ClipLoader.set_epoch`` can);
    ``step_offset`` is how many batches of this epoch were trained before,
    so ``step_callback(state, done_in_epoch)`` sees the true in-epoch count
    for the mid-epoch checkpoints."""
    meters = {k: AverageMeter() for k in ("loss", "top1", "top5", "batch_time")}
    pend = []

    def _drain():
        if not pend:
            return
        vals = torch.stack(
            [torch.stack([m["loss"], m["top1"], m["top5"]]).float() for m, _ in pend]
        ).cpu().tolist()
        for (loss, top1, top5), (_, n) in zip(vals, pend):
            meters["loss"].update(loss, n)
            meters["top1"].update(top1, n)
            meters["top5"].update(top5, n)
        pend.clear()

    t_epoch = time.time()
    steps = 0
    for i, batch in enumerate(loader):
        if i < skip_steps:
            continue  # trained before the mid-epoch checkpoint
        if max_steps is not None and steps >= max_steps:
            break
        clips, labels = batch[0], batch[1]
        state, metrics = train_step(state, clips, labels)
        pend.append((metrics, clips.shape[0]))
        steps += 1
        if (print_freq and i % print_freq == 0) or len(pend) >= 64:
            _drain()
            if print_freq and i % print_freq == 0:
                dt = (time.time() - t_epoch) / steps
                print(
                    f"  step {i}: loss {meters['loss'].avg:.4f} "
                    f"top1 {meters['top1'].avg:.2f} ({dt:.3f}s/batch)"
                )
        if step_callback is not None:
            step_callback(state, step_offset + steps)
    _drain()
    if steps:
        meters["batch_time"].update((time.time() - t_epoch) / steps, steps)
    return state, {k: m.avg for k, m in meters.items()}


def evaluate(
    state: TrainState,
    loader: Iterable,
    eval_step: Callable,
    max_steps: Optional[int] = None,
    collect_predictions: bool = False,
    top_k: int = 5,
):
    """Validation pass; with ``collect_predictions`` also ``y_true``,
    ``y_hat`` and the top-``top_k`` matrix ``y_hat_top5`` (numpy), as
    ``inference_kth.py:154-178`` collects them."""
    meters = {k: AverageMeter() for k in ("loss", "top1", "top5")}
    y_true, y_hat, y_hat_top5 = [], [], []
    for i, batch in enumerate(loader):
        if max_steps is not None and i >= max_steps:
            break
        clips, labels = batch[0], batch[1]
        metrics = eval_step(state, clips, labels)
        n = clips.shape[0]
        for k in ("loss", "top1", "top5"):
            meters[k].update(float(metrics[k]), n)
        if collect_predictions:
            logits = metrics["logits"].cpu().numpy()
            y_true.append(np.asarray(labels.cpu() if torch.is_tensor(labels) else labels))
            y_hat.append(logits.argmax(-1))
            y_hat_top5.append(np.argsort(-logits, axis=-1)[:, :top_k])
    out = {k: m.avg for k, m in meters.items()}
    if collect_predictions:
        out["y_true"] = np.concatenate(y_true)
        out["y_hat"] = np.concatenate(y_hat)
        out["y_hat_top5"] = np.concatenate(y_hat_top5)
    return out


def fit(
    state: TrainState,
    train_loader_fn: Callable[[], Iterable],
    val_loader_fn: Callable[[], Iterable],
    num_epochs: int,
    loss_type: str = "cross_entropy",
    scheduler=None,
    checkpointer=None,
    print_freq: int = 0,
    last_lr: float = 0.0,
    max_steps_per_epoch: Optional[int] = None,
    plotter=None,
    kernel_l2: float = 0.0,
    start_epoch: int = 0,
    best_loss: float = float("inf"),
    checkpoint_every_steps: int = 0,
    start_batch_offset: int = 0,
    compute_dtype: str = "float32",
) -> Tuple[TrainState, list]:
    """The epoch loop of ``ivf_tpu/train/loop.py::fit``: train, validate,
    step the scheduler (val loss, or val top-1 / 100 for a scheduler that
    monitors accuracy) into the optimizer's lr, plot, checkpoint (best on
    val loss); stop when the lr falls below ``last_lr``. ``start_epoch`` /
    ``best_loss`` / ``start_batch_offset`` come from a restored checkpoint.
    ``checkpoint_every_steps`` > 0 also checkpoints every N train batches
    mid-epoch; a resumed epoch starts at ``start_batch_offset`` (the
    loader's ``set_epoch`` skips by index: the order is a function of
    (seed, epoch)), and its metrics cover the remainder only. The dropout
    draws come from the state's seed (the JAX package's ``rng``)."""
    train_step = make_train_step(loss_type, kernel_l2=kernel_l2, compute_dtype=compute_dtype)
    eval_step = make_eval_step(loss_type, compute_dtype=compute_dtype)
    try:
        return _fit_epochs(
            state, train_loader_fn, val_loader_fn, num_epochs, train_step, eval_step, scheduler,
            checkpointer, print_freq, last_lr, max_steps_per_epoch, plotter, start_epoch, best_loss,
            checkpoint_every_steps, start_batch_offset,
        )
    finally:
        if checkpointer is not None:
            # an async write and its deferred best copy land even when an
            # epoch raised after a best save
            checkpointer.wait_until_finished()


def _fit_epochs(
    state, train_loader_fn, val_loader_fn, num_epochs, train_step, eval_step, scheduler, checkpointer,
    print_freq, last_lr, max_steps_per_epoch, plotter, start_epoch, best_loss, checkpoint_every_steps,
    start_batch_offset,
):
    history = []
    for epoch in range(start_epoch, num_epochs):
        lr_now = get_learning_rate(state.opt_state)
        if last_lr and lr_now < last_lr:
            print(f" > stopping: lr {lr_now} < last_lr {last_lr}")
            break
        train_loader = train_loader_fn()
        offset = start_batch_offset if epoch == start_epoch else 0
        skip = offset
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch, skip_batches=offset)
            skip = 0
        step_cb = None
        if checkpointer is not None and checkpoint_every_steps:

            def step_cb(s, done_in_epoch, _epoch=epoch):
                if done_in_epoch % checkpoint_every_steps == 0:
                    checkpointer.save(s, _epoch, is_best=False, best_loss=best_loss, batch_offset=done_in_epoch)

        state, train_metrics = train_epoch(
            state, train_loader, train_step, print_freq, max_steps_per_epoch,
            skip_steps=skip, step_offset=offset, step_callback=step_cb,
        )
        val_metrics = evaluate(state, val_loader_fn(), eval_step, max_steps_per_epoch)
        if scheduler is not None:
            if getattr(scheduler, "monitor", "loss") == "accuracy":
                monitored = val_metrics["top1"] / 100.0
            else:
                monitored = val_metrics["loss"]
            state.opt_state = set_learning_rate(state.opt_state, scheduler.step(monitored))
        history.append({"epoch": epoch, "lr": lr_now, "train": train_metrics, "val": val_metrics})
        print(
            f" > epoch {epoch}: train loss {train_metrics['loss']:.4f} "
            f"val loss {val_metrics['loss']:.4f} val top1 {val_metrics['top1']:.2f}"
        )
        if plotter is not None:
            plotter.plot({
                "loss": train_metrics["loss"],
                "val_loss": val_metrics["loss"],
                "acc": train_metrics["top1"] / 100.0,
                "val_acc": val_metrics["top1"] / 100.0,
                "learning_rate": lr_now,
            })
        if checkpointer is not None:
            is_best = val_metrics["loss"] < best_loss
            best_loss = min(val_metrics["loss"], best_loss)
            checkpointer.save(state, epoch, is_best=is_best, best_loss=best_loss)
    return state, history
