"""The host training loop (port of the ``fit`` part of ``blurred_gan_tpu/train/loop.py``).

Batches come from the port's numpy ``DataPipeline``; σ for each step is
``BlurDecayController.sigma(n_batches)``; every step prints one log line and
appends one JSON line to ``<log_dir>/metrics.jsonl``. Checkpoints, sample
grids, metrics and the adaptive controller are not ported yet (ROADMAP).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

from blurred_gan_tpu_torch.data.pipeline import DataPipeline
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step


class Trainer:
    """Owns the train state and step, and drives them over a dataset."""

    def __init__(self, gan: GAN, hparams, dataset, *, device, seed: int = 0,
                 log_dir: Optional[str] = None,
                 blur_controller: Optional[BlurDecayController] = None):
        self.gan = gan
        self.hparams = hparams
        self.dataset = dataset
        self.device = torch.device(device)
        self.seed = seed
        self.log_dir = log_dir
        self.blur_controller = blur_controller
        self.state = create_train_state(gan, hparams, device=self.device, seed=seed)
        self.step_fn = make_train_step(gan, hparams, seed=seed)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            hparams.save_json(os.path.join(log_dir, "hparams.json"))

    def sigma_for_step(self) -> float:
        if self.blur_controller is not None:
            return self.blur_controller.sigma(self.state.n_batches)
        return self.hparams.initial_blur_std

    def fit(self, total_examples: int, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Train until ``total_examples`` images have been seen or ``max_steps``
        steps have run in this call. Returns one log dict per step."""
        bs = self.hparams.global_batch_size
        steps_per_epoch = max(self.dataset.num_examples // bs, 1)
        n = self.state.n_batches
        pipe = DataPipeline(self.dataset, bs, seed=self.seed,
                            start_epoch=n // steps_per_epoch,
                            start_batch=n % steps_per_epoch)
        history: List[Dict[str, float]] = []
        jsonl = (open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
                 if self.log_dir else None)
        t_last = time.perf_counter()
        try:
            for batch in pipe:
                if self.state.n_img >= total_examples or (
                        max_steps is not None and len(history) >= max_steps):
                    break
                sigma = self.sigma_for_step()
                reals = torch.from_numpy(batch).to(self.device)
                metrics, _ = self.step_fn(self.state, reals, sigma)
                names = sorted(metrics)
                # One device->host copy for all scalars; it also waits for the step.
                values = torch.stack([metrics[k].float() for k in names]).tolist()
                now = time.perf_counter()
                logs = dict(zip(names, values))
                logs.update(n_batches=self.state.n_batches, n_img=self.state.n_img,
                            images_per_sec=batch.shape[0] / (now - t_last))
                t_last = now
                history.append(logs)
                print(f"[trainer] step {logs['n_batches']} n_img={logs['n_img']} "
                      f"d_loss={logs['disc_loss']:+.4f} g_loss={logs['gen_loss']:+.4f} "
                      f"gp={logs['gp_term']:.4f} std={sigma:.4f} "
                      f"{logs['images_per_sec']:.1f} img/s", flush=True)
                if jsonl is not None:
                    jsonl.write(json.dumps(logs) + "\n")
        finally:
            pipe.close()
            if jsonl is not None:
                jsonl.close()
        return history
