"""Checkpoint and resume of the train state (port of ``blurred_gan_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file, ``<directory>/<samples_seen>.pt``,
keyed by examples seen. It holds:

- both modules' ``state_dict`` (the generator's BatchNorm running statistics
  included);
- both optimizers' ``state_dict``;
- ``g_ema``, the generator's average, when the run keeps one;
- the ``n_img`` and ``n_batches`` counters;
- ``aux``, a JSON string of host-side state (the adaptive σ controller).

Only tensors, numbers, strings, tuples and dicts, so ``torch.load(...,
weights_only=True)`` reads it. A save writes a temporary file and then
``os.replace``\\ s it, so an interrupted save never leaves half a checkpoint.
A restore loads the optimizers' moments and counters and keeps the live
optimizers' hyperparameters (learning rate, betas, eps, decay) and their
``capturable`` setting (see :func:`_load_optimizer`): a run resumed under
another ``--learning_rate`` or ``--g_learning_rate`` runs at the new rate, as
the JAX package's does (its optax state holds no rate), and checkpoints
interchange between the CPU and the card and between ``Trainer.fit`` and
``Trainer.fit_device_resident``. A checkpoint of one optimizer restored into
another raises. As the JAX package does, a checkpoint without ``g_ema``
restored into a state with one seeds the average from the restored generator,
and one with ``g_ema`` restored into a state without one gives the state the
saved average.
Retention: the ``max_to_keep`` latest, plus every checkpoint saved at least
``keep_time_interval_hours`` after the previous one so kept (file times, so
the rule holds across restarts). The saves are synchronous. The step draws
its randomness from ``(seed, n_batches)``, so no generator state is saved.

In a data-parallel run (``runtime.py``) every process holds the same state:
rank 0 alone writes a checkpoint and prunes old ones, and every process waits
at a barrier after the rename, so none reads a directory that is being
written; every process restores the same file. A save on SIGINT / SIGTERM
(``barrier=False``) is rank 0's alone, with no barrier: the processes may
receive the signal at different steps.

Also the JSON sidecars (``hyper_parameters.json``, ``train_config.json``) and
the save on SIGINT / SIGTERM.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from blurred_gan_tpu_torch.runtime import process_count, process_index
from blurred_gan_tpu_torch.train.state import set_capturable

_SUFFIX = ".pt"


class CheckpointManager:
    """Saves and restores (TrainState, aux dict) pairs under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 keep_time_interval_hours: Optional[float] = 1.0):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_time_interval_hours = keep_time_interval_hours

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}{_SUFFIX}")

    def all_steps(self) -> List[int]:
        names = (n[:-len(_SUFFIX)] for n in os.listdir(self.directory) if n.endswith(_SUFFIX))
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, samples_seen: int, state, aux: Optional[Dict] = None,
             barrier: bool = True) -> str:
        """Write the checkpoint of ``state`` keyed by ``samples_seen``; returns
        its path. In a data-parallel run only rank 0 writes, and with
        ``barrier`` every process waits until it has."""
        path = self._path(int(samples_seen))
        if process_index() == 0:
            self._write(path, state, aux)
        if barrier and process_count() > 1:
            dist.barrier()
        return path

    def _write(self, path: str, state, aux: Optional[Dict]) -> None:
        payload = {
            "generator": state.generator.state_dict(),
            "discriminator": state.discriminator.state_dict(),
            "g_opt": state.g_opt.state_dict(),
            "d_opt": state.d_opt.state_dict(),
            "n_img": int(state.n_img),
            "n_batches": int(state.n_batches),
            "aux": json.dumps(aux or {}),
        }
        if state.g_ema is not None:
            payload["g_ema"] = list(state.g_ema)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._remove_old()

    def _remove_old(self) -> None:
        steps = self.all_steps()
        old = steps[:-self.max_to_keep] if self.max_to_keep > 0 else []
        interval = (self.keep_time_interval_hours or 0) * 3600.0
        last_kept = None
        for step in old:
            t = os.path.getmtime(self._path(step))
            if interval and (last_kept is None or t - last_kept >= interval):
                last_kept = t  # the interval keeper
                continue
            os.remove(self._path(step))

    def restore_latest(self, state) -> Optional[Tuple[Dict, int]]:
        """Load the newest checkpoint into ``state`` in place and return
        ``(aux, samples_seen)``; None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        # Loaded on the CPU: load_state_dict copies parameters, buffers and
        # Adam moments to their parameters' device.
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.generator.load_state_dict(payload["generator"])
        state.discriminator.load_state_dict(payload["discriminator"])
        for name in ("g_opt", "d_opt"):
            _load_optimizer(getattr(state, name), payload[name], name)
        _restore_ema(state, payload.get("g_ema"))
        state.n_img = payload["n_img"]
        state.n_batches = payload["n_batches"]
        return json.loads(payload["aux"]), step


@torch.no_grad()
def _restore_ema(state, saved: Optional[List[torch.Tensor]]) -> None:
    """Load the saved average into ``state.g_ema`` in place; seed it from the
    restored generator if the checkpoint has none; take the saved one if the
    state keeps none."""
    params = list(state.generator.parameters())
    if state.g_ema is None:
        if saved is not None:
            state.g_ema = [t.to(p.device) for t, p in zip(saved, params)]
        return
    if saved is None:
        print("[checkpoint] the checkpoint has no generator EMA - seeded g_ema from the "
              "restored generator weights")
        saved = params
    for t, v in zip(state.g_ema, saved):
        t.copy_(v)


def _kind(group: Dict) -> str:
    """The optimizer a ``param_group`` belongs to, by the hyperparameter
    only it has: Adam's betas, SGD's momentum, RMSprop's decay."""
    for key, kind in (("betas", "Adam"), ("momentum", "SGD"), ("decay", "RMSprop")):
        if key in group:
            return kind
    return "unknown"


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict, name: str = "optimizer") -> None:
    """Load the moments and counters of ``saved`` into ``opt``, keeping its
    own hyperparameters and ``capturable`` setting, with its step counters
    where that setting puts them
    (:func:`~blurred_gan_tpu_torch.train.state.set_capturable`).
    ``load_state_dict`` would take both from the checkpoint: an old learning
    rate, and capturable Adam from a checkpoint of the chunked mode in a CPU
    run or ``fit`` (or the reverse). ``saved`` must come from the same kind
    of optimizer."""
    saved_kind, kind = _kind(saved["param_groups"][0]), _kind(opt.param_groups[0])
    if saved_kind != kind:
        raise ValueError(f"{name}: the checkpoint holds {saved_kind} state, the run "
                         f"uses {kind}")
    capturable = any(group.get("capturable", False) for group in opt.param_groups)
    live = [{k: v for k, v in group.items() if k not in ("params", "capturable")}
            for group in opt.param_groups]
    opt.load_state_dict(saved)
    set_capturable(opt, capturable)
    for group, hyper in zip(opt.param_groups, live):
        group.update(hyper)


# ---------------------------------------------------------------------------
# JSON sidecars next to the checkpoints
# ---------------------------------------------------------------------------


def save_sidecars(run_dir: str, hparams=None, config=None) -> None:
    if hparams is not None:
        hparams.save_json(os.path.join(run_dir, "hyper_parameters.json"))
    if config is not None:
        config.save_json(os.path.join(run_dir, "train_config.json"))


def load_sidecar(run_dir: str, cls, filename: str):
    path = os.path.join(run_dir, filename)
    if os.path.exists(path):
        return cls.from_json(path)
    return None


# ---------------------------------------------------------------------------
# Save on Ctrl-C / SIGTERM
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def save_on_interrupt(save_fn, defer: bool = False):
    """Run a training block; on SIGINT/SIGTERM call ``save_fn()`` once, then
    raise KeyboardInterrupt so the caller unwinds. Installs signal handlers,
    so it must run on the main thread.

    ``defer=True``: the handler only records the signal; the caller invokes the
    yielded ``check()`` at points where its state is whole (not inside a
    step), and ``check()`` then saves once and raises KeyboardInterrupt. A
    second signal while one is pending unwinds at once (escape hatch for a
    stuck step); the save is still attempted, and a failing save is reported,
    not allowed to stop the unwind.
    """
    fired = {"done": False}
    pending = {"sig": False}

    def do_save():
        if fired["done"]:
            return
        fired["done"] = True
        try:
            save_fn()
        except Exception as e:  # noqa: BLE001 — the unwind below must still happen
            print(f"[checkpoint] interrupt save failed: {e!r}")

    def handler(signum, frame):
        if defer and not pending["sig"]:
            pending["sig"] = True
            print("[trainer] signal received - will checkpoint at the next safe "
                  "point; send again to force immediate unwind", flush=True)
            return
        do_save()
        raise KeyboardInterrupt

    def check():
        if pending["sig"]:
            do_save()
            raise KeyboardInterrupt

    old_int = signal.signal(signal.SIGINT, handler)
    old_term = signal.signal(signal.SIGTERM, handler)
    try:
        yield check
        # A deferred signal that landed after the caller's last check must
        # still be acted on, not dropped when the handlers are restored.
        check()
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)
