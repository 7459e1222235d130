"""Checkpoints with the reference's save / best-copy semantics (port of
``ivf_tpu/utils/checkpoint.py``), over ``torch.save``.

``<directory>/checkpoint`` is written at every save and copied to
``<directory>/model_best`` on an improvement (``utils.save_checkpoint`` of
the reference). A checkpoint holds the parameters, the BN statistics, the
optimizer state, the epoch, the step, the run's seed, the best loss and,
for a mid-epoch save, the batch offset, so a run resumes exactly. Every
file is written to a temporary name in the directory and renamed over the
old one, so a crash mid-write leaves the previous checkpoint whole.
Reading the JAX package's orbax directories is not ported (ROADMAP.md,
Queue 1 item 11).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, Optional

import torch

from ivf_tpu_torch.train.optim import OptState
from ivf_tpu_torch.train.state import TrainState

LOGITS_KEYS = ("logits", "end_fc", "fc", "gap_conv")


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def _replace_atomically(write, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


class Checkpointer:
    """``async_save=True`` makes ``save`` return once the state is copied to
    host memory: one thread writes it, and the next ``save``, ``restore``,
    ``exists`` or ``wait_until_finished`` waits for that write (re-raising
    its error) and then makes the deferred best copy."""

    def __init__(self, directory: str, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_best = False

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def wait_until_finished(self) -> None:
        """Block until an in-flight save has landed, then make its deferred
        best copy. A no-op when nothing is in flight."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error, self._pending_best = self._error, None, False
            raise err
        if self._pending_best:
            self._pending_best = False
            self._copy_best()

    def _copy_best(self) -> None:
        _replace_atomically(lambda tmp: shutil.copyfile(self._path("checkpoint"), tmp), self._path("model_best"))

    def _write(self, payload: dict) -> None:
        try:
            _replace_atomically(lambda tmp: torch.save(payload, tmp), self._path("checkpoint"))
        except BaseException as exc:  # noqa: BLE001 (re-raised by wait_until_finished)
            self._error = exc

    def save(
        self,
        state: TrainState,
        epoch: int,
        is_best: bool = False,
        best_loss: float = float("inf"),
        batch_offset: int = 0,
    ) -> None:
        """``batch_offset`` > 0 marks a mid-epoch checkpoint: that many
        batches of ``epoch`` are in ``state``, and ``restore`` resumes that
        epoch at that batch."""
        self.wait_until_finished()
        opt = state.opt_state
        payload = {
            "params": _host(state.params()),
            "batch_stats": _host(state.batch_stats()),
            "opt_state": {
                "learning_rate": float(opt.learning_rate),
                "count": int(opt.count),
                "slots": {s: _host(v) for s, v in opt.slots.items()},
            },
            "epoch": int(epoch),
            "step": int(state.step),
            "seed": int(state.seed),
            "best_loss": float(best_loss),
            "batch_offset": int(batch_offset),
        }
        if self.async_save:
            self._pending_best = is_best
            self._thread = threading.Thread(target=self._write, args=(payload,), name="ivf-torch-ckpt")
            self._thread.start()
            return
        self._write(payload)
        self.wait_until_finished()
        if is_best:
            self._copy_best()

    def _load(self, name: str) -> dict:
        self.wait_until_finished()
        return torch.load(self._path(name), map_location="cpu", weights_only=True)

    def restore(
        self,
        state: TrainState,
        name: str = "checkpoint",
        skip_logits: bool = False,
        logits_keys: tuple = LOGITS_KEYS,
    ) -> tuple:
        """Restore into ``state`` (in place). Returns (state, start_epoch,
        best_loss, batch_offset): a mid-epoch checkpoint resumes its own
        epoch at its batch, an epoch-end one the next epoch at 0. With
        ``skip_logits`` the classifier head (parameters under
        ``logits_keys``) keeps its fresh values and may differ in class
        count, and the optimizer state and step stay the fresh ones
        (class-count transfer, ``train_i3d_smth.py:76-88``); the run then
        starts at the next epoch."""
        payload = self._load(name)
        params, stats = state.params(), state.batch_stats()
        keep = {n for n in params if skip_logits and n.split(".")[0] in logits_keys}
        for kind, want, got in (("params", params, payload["params"]), ("batch_stats", stats, payload["batch_stats"])):
            bad = sorted(set(want) - set(got) - keep) + sorted(
                n for n in set(want) & set(got) - keep if tuple(want[n].shape) != tuple(got[n].shape)
            )
            if bad or (not skip_logits and set(got) != set(want)):
                raise KeyError(f"checkpoint {name}: {kind} do not match the state's: {bad[:5]}")
        with torch.no_grad():
            for n, p in params.items():
                if n not in keep:
                    p.copy_(payload["params"][n])
            for n, b in stats.items():
                b.copy_(payload["batch_stats"][n])
        epoch = int(payload["epoch"])
        best = float(payload.get("best_loss", float("inf")))
        if skip_logits:
            return state, epoch + 1, best, 0
        opt = payload["opt_state"]
        state.opt_state = OptState(
            opt["learning_rate"],
            int(opt["count"]),
            {s: {n: t.to(params[n].device) for n, t in v.items()} for s, v in opt["slots"].items()},
        )
        state.step = int(payload["step"])
        state.seed = int(payload.get("seed", state.seed))
        offset = int(payload.get("batch_offset", 0))
        return state, (epoch if offset > 0 else epoch + 1), best, offset

    def exists(self, name: str = "checkpoint") -> bool:
        self.wait_until_finished()
        return os.path.exists(self._path(name))

    def load_variables(self, name: str = "checkpoint") -> Dict[str, torch.Tensor]:
        """The model's state dict (parameters and BN statistics) alone,
        for ``find_masks`` / ``infer`` consumers that need no optimizer
        state."""
        payload = self._load(name)
        return {**payload["params"], **payload["batch_stats"]}
