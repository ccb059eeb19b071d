"""The host training loop (port of ``blurred_gan_tpu/train/loop.py``, the host path).

- σ for step N comes from the open-loop ``BlurDecayController`` before the
  step is dispatched, or from the ``AdaptiveBlurController`` fed by step N−1's
  scores;
- example-count hooks (``train/hooks.py``) log scalars, write the fixed-latent
  sample grid and checkpoint; image summaries every N batches;
- ``MetricFeeder``\\ s record (reals, fakes) pairs into SWD / FID for
  ``num_samples`` images every N examples and log the results;
- a checkpoint every N examples, on SIGINT / SIGTERM and at the end of
  ``fit``; the latest is restored at construction, with the hooks' phase and
  the adaptive controller's state;
- the run directory holds ``hyper_parameters.json`` and ``train_config.json``
  (the sidecars), ``run_manifest.json``, ``events.jsonl`` (``"step"`` = images
  seen), ``checkpoints/`` and ``samples_grid_<examples>.png``;
- with ``ema_decay > 0`` sample grids and evaluation use the generator's
  average (``TrainerConfig.sample_with_ema``), as they do after restoring a
  checkpoint that holds one;
- on steps that skip the generator (``d_steps_per_g_step > 1``) the logged
  ``gen_loss`` carries the last real value forward, as the reference's
  running mean did; ``did_gen_step`` says which steps ran it.

With an open-loop σ, the host work of step N (the copy of its scalars,
logging, hooks) runs after step N+1 is dispatched, so the device does not wait
on it; the scalars' copy to the host is issued right after step N, so
waiting for it does not wait for step N+1. The adaptive controller needs each
step's scores before it picks the next σ, so with it the host works in step.

``fit_device_resident`` is the chunked mode of ``train/fast.py``: the dataset
on the device, K steps per chunk (a CUDA graph replayed K times on the card),
σ and the adaptive controller on the device, one fetch of the chunk's
metrics; hooks and logging then replay per step, so checkpoints and grids
land on chunk boundaries.

Data parallelism (a process group of N > 1, ``runtime.py``; the JAX
package's multi-process paths): each process trains on its shard of every
epoch (``DataPipeline(shard_index=rank, shard_count=N)``) at a local batch of
``global_batch_size / N``, and the step (``train/step.py``) makes the
gradients, the BatchNorm statistics and the logged scalars global, so σ, the
adaptive controller and every hook agree across the processes; the counters
and the hooks count global examples. Rank 0 alone writes the logs, the
sidecars, the manifest, the PNGs and the checkpoints; every process restores
the same checkpoint, and the processes' states are compared at construction
(``parallel.check_replicas_equal``). A sample grid shows rank 0's contiguous
slice of the fixed latents; ``evaluate`` scores each process's reals shard
against its slice of the latents and merges SWD and FID across the processes
(``cross_process_merge``), logging a metric without a merge as
``eval_localshard_*``. Metric feeders measure each process's own pairs, as in
the JAX package. ``fit_device_resident`` is single-process.
"""

from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch import parallel
from blurred_gan_tpu_torch.data.pipeline import DataPipeline
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.ops.blur import blur_images
from blurred_gan_tpu_torch.runtime import process_count, process_index
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.checkpoint import (
    CheckpointManager, save_on_interrupt, save_sidecars)
from blurred_gan_tpu_torch.train.fast import ChunkRunner, chunk_indices
from blurred_gan_tpu_torch.train.hooks import EveryNExamples, HookList
from blurred_gan_tpu_torch.train.state import (
    GAN, TrainState, create_train_state, set_capturable)
from blurred_gan_tpu_torch.train.step import make_sample_fn, make_train_step, step_seed
from blurred_gan_tpu_torch.utils.images import normalize_images, samples_grid, write_png
from blurred_gan_tpu_torch.utils.logging import MetricsLogger
from blurred_gan_tpu_torch.utils.watchdog import fetch as watchdog_fetch

GRID_SAMPLES = 64
HISTORY_STEPS = 1024  # per-step logs kept in Trainer.history
# Seed words of the sample grid's latents, beside the step's (seed, n_batches).
_GRID_SEED_WORDS = (0x67726964, 0)
# Offsets of a chunk-boundary feeder measurement: its reals' shuffle seed and
# its latents' step counter, off the training stream (the JAX package's).
_FEEDER_DATA_SEED, _FEEDER_LATENT_STEP = 7919, 1_000_000_000


def _nhwc_numpy(images: torch.Tensor) -> np.ndarray:
    return images.detach().permute(0, 2, 3, 1).to(torch.float32).cpu().numpy()


def _copy_to_host(x: torch.Tensor):
    """(host tensor, ready event): ``x``'s copy to the host, issued now and
    asynchronous on a CUDA device, where the event marks its end; on the CPU
    ``x`` itself and None."""
    if x.device.type != "cuda":
        return x, None
    host = x.to("cpu", non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def to_unit_range(reals: torch.Tensor) -> torch.Tensor:
    """A pipeline batch (uint8 NHWC) as NCHW float32 in [-1, 1], as the step sees it."""
    if reals.dtype == torch.uint8:
        reals = (reals.to(torch.float32) - 127.5) / 127.5
    return reals.permute(0, 3, 1, 2).contiguous()


class MetricFeeder:
    """Records (reals, fakes) pairs into a metric every N examples: triggered
    by its hook, it takes ``num_samples`` images from the following batches,
    then returns the results and resets the metric."""

    def __init__(self, metric, every_n_examples: int, num_samples: int,
                 preprocess_fn: Optional[Callable] = None, name: Optional[str] = None):
        self.metric = metric
        self.num_samples = num_samples
        self.preprocess_fn = preprocess_fn
        self.name = name or getattr(metric, "name", "metric")
        self.recording = False
        self.samples_recorded = 0
        self.hook = EveryNExamples(every_n_examples, self._start,
                                   starting_from=-num_samples, name=self.name)

    def _start(self, samples_seen, logs) -> None:
        self.recording = True

    def feed(self, reals: torch.Tensor, fakes: torch.Tensor) -> Optional[Dict[str, float]]:
        """Call once per step after ``hook.after_step`` with NCHW [-1, 1]
        batches; returns the results when a measurement completes."""
        if not self.recording:
            return None
        take = min(reals.shape[0], self.num_samples - self.samples_recorded)
        r, f = reals[:take], fakes[:take]
        if self.preprocess_fn is not None:
            r, f = self.preprocess_fn(r), self.preprocess_fn(f)
        self.metric.update_state(r, f)
        self.samples_recorded += take
        if self.samples_recorded < self.num_samples:
            return None
        if hasattr(self.metric, "results"):
            out = {f"{self.name}/{k}": v for k, v in self.metric.results().items()}
        else:
            out = {self.name: float(self.metric.result())}
        self.recording = False
        self.samples_recorded = 0
        self.metric.reset_states()
        return out


@dataclass
class TrainerConfig:
    """Loop-level knobs. A cadence of 0 disables its hook."""

    log_metrics_every_n_examples: int = 100
    sample_grid_every_n_examples: int = 5_000
    checkpoint_every_n_examples: int = 10_000
    # Reals, fakes and their blurred views every N batches.
    image_summaries_interval_batches: int = 50
    # Beside the raw grid, a samples_grid_blurred image of what the critic sees.
    show_blurred_samples: bool = True
    save_sample_pngs: bool = True
    # With hparams.ema_decay > 0, sample grids and evaluate() use the EMA
    # generator weights; False samples the live weights even then.
    sample_with_ema: bool = True
    # Watchdog budget in seconds for each step's scalar fetch (0 = off); the
    # first fetch of a fit call gets first_device_fetch_timeout_s.
    device_fetch_timeout_s: float = 0.0
    first_device_fetch_timeout_s: float = 3600.0
    log_dir: str = "results/log"
    checkpoint_dir: Optional[str] = None  # None/"" -> <log_dir>/checkpoints
    seed: int = 0


class Trainer:
    """Wires state, step, σ controller, hooks, metrics and checkpoints together.

    ``device``: where the networks live and the steps run. ``world``,
    ``rank``, ``is_main``: the data-parallel group's size, this process's
    rank, and whether it is rank 0 (1, 0 and True without a group).
    ``history``: the logs of the last ``HISTORY_STEPS`` steps, each with
    ``n_batches``, ``n_img`` and the step's ``images_per_sec`` (global
    examples between consecutive steps' host work; in the chunked mode, its
    chunk's). ``chunk_runner``: the
    chunked mode's runner (its graph and capture time), kept for the next
    ``fit_device_resident`` call while it can serve it.
    """

    def __init__(self, gan: GAN, hparams, dataset, *, device,
                 trainer_config: Optional[TrainerConfig] = None,
                 blur_controller: Optional[BlurDecayController] = None,
                 adaptive_controller: Optional[AdaptiveBlurController] = None,
                 metric_feeders: Sequence[MetricFeeder] = (),
                 config_sidecars: Optional[Dict] = None):
        self.gan = gan
        self.hparams = hparams
        self.dataset = dataset
        self.device = torch.device(device)
        self.cfg = trainer_config or TrainerConfig()
        self.blur_controller = blur_controller
        self.adaptive_controller = adaptive_controller
        self.ada_state = adaptive_controller.init() if adaptive_controller else None
        self.metric_feeders = list(metric_feeders)
        self.world, self.rank = process_count(), process_index()
        self.is_main = self.rank == 0
        if hparams.global_batch_size % self.world:
            raise ValueError(f"global batch {hparams.global_batch_size} does not split over "
                             f"{self.world} processes")

        os.makedirs(self.cfg.log_dir, exist_ok=True)
        self.logger = MetricsLogger(self.cfg.log_dir, enabled=self.is_main)
        self.ckpt = CheckpointManager(self.cfg.checkpoint_dir
                                      or os.path.join(self.cfg.log_dir, "checkpoints"))
        self.state: TrainState = create_train_state(gan, hparams, device=self.device,
                                                    seed=self.cfg.seed)
        self.step_fn = make_train_step(gan, hparams, seed=self.cfg.seed)
        self._use_ema = (float(getattr(hparams, "ema_decay", 0.0) or 0.0) > 0
                         and self.cfg.sample_with_ema)
        self.sample_fn = make_sample_fn(gan, use_ema=self._use_ema)
        # Fixed latents of the sample grid, drawn on the CPU so they do not
        # depend on the device.
        grid_seed = np.random.SeedSequence([self.cfg.seed, *_GRID_SEED_WORDS])
        grid_rng = torch.Generator().manual_seed(int(grid_seed.generate_state(1, np.uint64)[0]))
        self.grid_latents = gan.sample_latents(GRID_SAMPLES, grid_rng, "cpu").to(self.device)

        if config_sidecars and self.is_main:
            save_sidecars(self.cfg.log_dir, **config_sidecars)
            hp = config_sidecars.get("hparams")
            self.logger.hparams(hp.asdict() if hp is not None else {})
        self._stop = False
        self._current_sigma = 0.0
        self._steps_per_epoch = 0
        self._last_metrics: Dict[str, float] = {}
        self._gen_loss_carry: Optional[float] = None
        self.history: collections.deque = collections.deque(maxlen=HISTORY_STEPS)
        self._fetch_warmed = False
        self.chunk_runner: Optional[ChunkRunner] = None
        self._maybe_restore()
        parallel.check_replicas_equal(self.state)
        self._build_hooks()

    # ------------------------------------------------------------------ setup

    def _write_run_manifest(self) -> None:
        """``run_manifest.json``: what the sidecars do not say, for post-hoc
        tools. Written by ``fit``, not at construction, so a reader that builds
        a Trainer never overwrites a run's manifest; by rank 0 alone."""
        if not self.is_main:
            return
        manifest = {"dataset": getattr(self.dataset, "name", "unknown"),
                    "image_shape": list(self.dataset.image_shape),
                    "num_examples": int(getattr(self.dataset, "num_examples", 0)),
                    "latent_size": int(self.gan.latent_size),
                    "ema": bool(self._use_ema)}
        with open(os.path.join(self.cfg.log_dir, "run_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    def _maybe_restore(self) -> None:
        restored = self.ckpt.restore_latest(self.state)
        self._restored_samples = 0
        if restored is None:
            return
        aux, step = restored
        self._restored_samples = int(step)
        if self.adaptive_controller and "adaptive_blur" in aux:
            self.ada_state = self.adaptive_controller.state_from_dict(aux["adaptive_blur"])
            if self.ada_state.stop_training:
                # A completed run stays completed on resume.
                print("[trainer] restored a stop_training checkpoint - training is complete")
                self._stop = True
        print(f"[trainer] restored checkpoint @ {step} examples "
              f"(n_batches={self.state.n_batches})")
        if self.cfg.sample_with_ema and not self._use_ema and self.state.g_ema is not None:
            # The checkpoint carries an average that the hparams did not ask
            # for (a missing or stale sidecar): trust the state, so samples
            # are never the live weights taken for the average.
            self._use_ema = True
            self.sample_fn = make_sample_fn(self.gan, use_ema=True)

    def _build_hooks(self) -> None:
        self.hooks = HookList()
        for n, fn, name in ((self.cfg.log_metrics_every_n_examples, self._log_metrics,
                             "log_metrics"),
                            (self.cfg.sample_grid_every_n_examples, self._sample_grid,
                             "sample_grid"),
                            (self.cfg.checkpoint_every_n_examples, self._checkpoint,
                             "checkpoint")):
            if n > 0:
                self.hooks.add(EveryNExamples(n, fn, name=name))
        for feeder in self.metric_feeders:
            self.hooks.add(feeder.hook)
        if self._restored_samples:
            self.hooks.restore(self._restored_samples)

    # ------------------------------------------------------------------ hooks

    def _log_metrics(self, samples_seen: int, logs: Dict) -> None:
        self.logger.scalars(samples_seen, logs, prefix="batch_")

    def _sample_grid(self, samples_seen: int, logs: Dict) -> None:
        """The fixed latents' samples as a grid (PNG and image summary), and
        their blurred view at the current σ (image summary). In a
        data-parallel run each process samples its contiguous slice of the
        latents and rank 0's slice is the grid."""
        per = self.grid_latents.shape[0] // self.world
        samples = self.sample_fn(self.state,
                                 self.grid_latents[self.rank * per:(self.rank + 1) * per])
        grid = samples_grid(normalize_images(_nhwc_numpy(samples)))
        self.logger.image(samples_seen, "samples_grid", grid)
        if self.cfg.show_blurred_samples and self._current_sigma > 0:
            blurred = blur_images(samples, self._current_sigma, impl=self.gan.blur_impl)
            self.logger.image(samples_seen, "samples_grid_blurred",
                              samples_grid(normalize_images(_nhwc_numpy(blurred))))
        if self.cfg.save_sample_pngs and self.is_main:
            write_png(os.path.join(self.cfg.log_dir, f"samples_grid_{samples_seen:08d}.png"),
                      grid)

    def _image_summaries(self, reals: torch.Tensor, fakes: torch.Tensor, sigma) -> None:
        """Up to 16 reals and fakes (NCHW, [-1, 1]) and their blurred views."""
        n = min(16, fakes.shape[0])
        reals, fakes = reals[:n], fakes[:n]
        grid = (4, (n + 3) // 4)
        for tag, images in (("train/reals", reals),
                            ("train/reals_blurred", blur_images(reals, sigma,
                                                                impl=self.gan.blur_impl)),
                            ("train/fakes", fakes),
                            ("train/fakes_blurred", blur_images(fakes, sigma,
                                                                impl=self.gan.blur_impl))):
            self.logger.image(self.samples_seen, tag,
                              samples_grid(normalize_images(_nhwc_numpy(images)), grid))

    def _checkpoint(self, samples_seen: int, logs: Dict) -> None:
        self.ckpt.save(self.samples_seen, self.state, self._aux_dict())

    # ------------------------------------------------------------------ train

    @property
    def samples_seen(self) -> int:
        return self.state.n_img

    @property
    def restored_examples(self) -> int:
        """Step key of the checkpoint restored at construction (0: a fresh run)."""
        return self._restored_samples

    def sigma_for_step(self) -> float:
        if self.ada_state is not None:
            return float(self.ada_state.std)
        if self.blur_controller is not None:
            return self.blur_controller.sigma(self.state.n_batches)
        return getattr(self.hparams, "initial_blur_std", 0.0)

    def fit(self, total_examples: int, max_steps: Optional[int] = None) -> TrainState:
        """Train until ``total_examples`` images have been seen (across
        restarts), ``max_steps`` steps have run in this call, or the adaptive
        controller stops; then checkpoint and return the state. Adam runs
        non-capturable here, its step counters on the host. In a
        data-parallel run each process reads its shard of every epoch at the
        local batch."""
        self._fetch_warmed = False
        self._write_run_manifest()
        set_capturable(self.state.g_opt, False)
        set_capturable(self.state.d_opt, False)
        local_bs = self.hparams.global_batch_size // self.world
        self._steps_per_epoch = max(self.dataset.num_examples // self.world // local_bs, 1)
        n = self.state.n_batches
        # Resume the deterministic stream at the exact batch.
        pipe = DataPipeline(self.dataset, local_bs, seed=self.cfg.seed,
                            start_epoch=n // self._steps_per_epoch,
                            start_batch=n % self._steps_per_epoch,
                            shard_index=self.rank, shard_count=self.world)
        steps_done = 0
        self._throughput = (time.time(), self.samples_seen)
        self._t_last_step = time.perf_counter()
        pipeline_ahead = self.adaptive_controller is None
        pending = None

        def interrupt_save():
            print("[trainer] interrupted - saving checkpoint")
            self.ckpt.save(self.samples_seen, self.state, self._aux_dict(), barrier=False)

        # defer=True: the handler only records the signal; check() saves
        # between steps, never in the middle of one.
        with save_on_interrupt(interrupt_save, defer=True) as check_interrupt:
            try:
                for batch in pipe:
                    check_interrupt()
                    if self.samples_seen >= total_examples or self._stop:
                        break
                    if max_steps is not None and steps_done >= max_steps:
                        break
                    sigma = self._current_sigma = self.sigma_for_step()
                    reals = torch.from_numpy(batch).to(self.device)
                    metrics, fakes = self.step_fn(self.state, reals, sigma)
                    steps_done += 1
                    item = (reals, fakes, sigma, *self._copy_scalars(metrics),
                            self.state.n_batches, self.state.n_img)
                    if pipeline_ahead:
                        if pending is not None:
                            self._process_step_host(*pending)
                        pending = item
                    else:
                        self._process_step_host(*item)
                if pending is not None:
                    self._process_step_host(*pending)
            finally:
                pipe.close()
        self.ckpt.save(self.samples_seen, self.state, self._aux_dict())
        self.logger.flush()
        return self.state

    def _copy_scalars(self, metrics: Dict[str, torch.Tensor]):
        """(names, host tensor, ready event): the step's scalars stacked into
        one vector and its copy to the host issued now."""
        names = sorted(metrics)
        packed = torch.stack([metrics[k].to(torch.float32) for k in names])
        return (names, *_copy_to_host(packed))

    def _fetch(self, host: torch.Tensor, ready, what: str, steps: int = 1) -> np.ndarray:
        """Wait for a copy of ``steps`` steps' scalars under the watchdog
        (``steps`` times the per-step budget); the first fetch of a fit call
        also waits for the first step's warm-up and gets the larger budget."""
        t = self.cfg.device_fetch_timeout_s * steps
        if t and t > 0 and not self._fetch_warmed:
            t = max(t, self.cfg.first_device_fetch_timeout_s)
        out = watchdog_fetch(host, t, what=what, ready=ready)
        self._fetch_warmed = True
        return out

    def _process_step_host(self, reals, fakes, sigma, names, host, ready,
                           n_batches: int, n_img: int) -> None:
        """Host work of one dispatched step: controller feedback, logging,
        hooks, image summaries, metric feeders. The fetch waits for that step."""
        values = self._fetch(host, ready, "step-metrics fetch").astype(np.float64).tolist()
        logs = dict(zip(names, values))
        self._fill_gen_loss(logs)
        examples = reals.shape[0] * self.world  # the global batch
        now = time.perf_counter()
        step_rate = examples / (now - self._t_last_step)
        self._t_last_step = now

        if self.adaptive_controller is not None:
            self.ada_state, tele = self.adaptive_controller.update(
                self.ada_state, n_batches, logs["fake_scores"], logs["real_scores"])
            logs.update(tele)
            if self.ada_state.stop_training:
                print("[trainer] adaptive controller reached min std - stopping")
                self._stop = True

        self._log_progress(n_img, n_batches, logs)

        reals_f = None
        interval = self.cfg.image_summaries_interval_batches
        if interval and n_batches % interval == 0 and self.is_main:
            reals_f = to_unit_range(reals)
            self._image_summaries(reals_f, fakes, sigma)

        self.hooks.after_step(examples, logs)
        self._maybe_log_epoch(n_batches, n_img, logs)
        for feeder in self.metric_feeders:
            if feeder.recording:
                if reals_f is None:
                    reals_f = to_unit_range(reals)
                out = feeder.feed(reals_f, fakes)
                if out:
                    self.logger.scalars(n_img, out)
                    print(f"[metrics @ {n_img}] {({k: round(v, 4) for k, v in out.items()})}",
                          flush=True)
        self._last_metrics = logs
        self.history.append(dict(logs, n_batches=n_batches, n_img=n_img,
                                 images_per_sec=step_rate))

    def fit_device_resident(self, total_examples: int, chunk_steps: int = 50,
                            max_chunks: Optional[int] = None) -> TrainState:
        """Train in chunks of ``chunk_steps`` steps on a device-resident copy
        of the dataset (``train/fast.py``) until ``total_examples`` images have
        been seen, ``max_chunks`` chunks have run in this call, or the adaptive
        controller stops; then checkpoint and return the state.

        Progress is quantised to whole chunks, so a run may overshoot
        ``total_examples`` by up to ``chunk_steps * batch - 1`` examples. After
        each chunk the host fetches its metrics once, advances its counters by
        the steps the chunk executed, and replays the hooks and logging per
        step, so checkpoints and sample grids land on chunk boundaries and see
        the chunk's final state. Metric feeders whose hook fired are measured
        at the chunk boundary against fresh samples (:meth:`_run_feeder_eval`).
        Image summaries need each step's batch, which never reaches the host
        in this mode, so there are none. The runner, and on the card its
        captured graph and its copy of the dataset, is kept for the next call
        with the same dataset and ``chunk_steps``; otherwise it is released
        before the next one is built.
        """
        if self.world > 1:
            raise RuntimeError(f"the device-resident mode is single-process; this run has "
                               f"{self.world} processes (use fit)")
        images = getattr(self.dataset, "images", None)
        if images is None:
            raise ValueError("the device-resident mode needs a memory-resident dataset "
                             "(ArrayDataset; ShardedArrayDataset.materialize() makes one)")
        self._fetch_warmed = False
        self._write_run_manifest()
        bs = self.hparams.global_batch_size
        self._steps_per_epoch = max(self.dataset.num_examples // bs, 1)
        runner = self.chunk_runner
        if runner is not None and runner.reusable(images, chunk_steps, self.blur_controller,
                                                  self.adaptive_controller):
            if runner.adaptive is not None:
                runner.load_adaptive(self.ada_state)
        else:
            # Released first, so the card never holds two copies of the dataset.
            runner = self.chunk_runner = None
            runner = self.chunk_runner = ChunkRunner(
                self.gan, self.hparams, self.state, images, chunk_steps, seed=self.cfg.seed,
                blur_controller=self.blur_controller,
                adaptive_controller=self.adaptive_controller, adaptive_state=self.ada_state)
        self._throughput = (time.time(), self.samples_seen)

        def interrupt_save():
            print("[trainer] interrupted - saving checkpoint")
            self.ckpt.save(self.samples_seen, self.state, self._aux_dict(), barrier=False)

        chunks_done = 0
        with save_on_interrupt(interrupt_save, defer=True) as check_interrupt:
            while self.samples_seen < total_examples and not self._stop:
                check_interrupt()
                if max_chunks is not None and chunks_done >= max_chunks:
                    break
                t0 = time.perf_counter()
                n0, img0 = self.state.n_batches, self.state.n_img
                idx = chunk_indices(self.dataset.num_examples, bs, chunk_steps, n0,
                                    self.cfg.seed)
                host, ready = _copy_to_host(runner.run(idx, n0))
                packed = self._fetch(host, ready, "chunk-metrics fetch", steps=chunk_steps)
                seconds = time.perf_counter() - t0
                chunks_done += 1
                arrs = {k: packed[:, j].astype(np.float64) for j, k in enumerate(runner.names)}
                executed = chunk_steps
                if runner.adaptive is not None:
                    # The host mirror of the controller is set before the hook
                    # replay, so a checkpoint saved there holds both states of
                    # the same step.
                    self.ada_state = runner.adaptive.to_host()
                    if self.ada_state.stop_training:
                        # Steps after the stop left the state as it was: count
                        # only the executed prefix, so the host counters equal
                        # the frozen device state.
                        flags = arrs["stop_training"]
                        executed = int(flags.argmax()) + 1 if flags.any() else chunk_steps
                self.state.n_batches = n0 + executed
                self.state.n_img = img0 + executed * bs
                check_interrupt()  # state and counters agree: a safe point to save

                rate = executed * bs / seconds
                for i in range(executed):
                    logs = {k: float(v[i]) for k, v in arrs.items()}
                    self._fill_gen_loss(logs)
                    n_batches, n_img = n0 + i + 1, img0 + (i + 1) * bs
                    self._current_sigma = logs.get("std", 0.0)
                    self.hooks.after_step(bs, logs)
                    self._maybe_log_epoch(n_batches, n_img, logs)
                    self._last_metrics = logs
                    self.history.append(dict(logs, n_batches=n_batches, n_img=n_img,
                                             images_per_sec=rate))
                self._log_progress(self.samples_seen, self.state.n_batches, self._last_metrics,
                                   f" (chunk of {executed} steps in {seconds:.2f} s)")
                for feeder in self.metric_feeders:
                    if feeder.recording:
                        self._run_feeder_eval(feeder)
                if runner.adaptive is not None and self.ada_state.stop_training:
                    print("[trainer] adaptive controller reached min std - stopping")
                    self._stop = True
        self.ckpt.save(self.samples_seen, self.state, self._aux_dict())
        self.logger.flush()
        return self.state

    @torch.no_grad()
    def _run_feeder_eval(self, feeder: MetricFeeder) -> None:
        """Measure a feeder whose hook fired during a chunk's replay: pairs of
        dataset reals (a shuffle of their own) and fresh samples (latents off
        the training stream), fed until the feeder's ``num_samples`` are in,
        as the host loop's feeding would."""
        bs = self.hparams.global_batch_size
        n = self.state.n_batches
        it = self.dataset.batches(bs, seed=self.cfg.seed + _FEEDER_DATA_SEED + n)
        latent_rng = torch.Generator().manual_seed(
            step_seed(self.cfg.seed, _FEEDER_LATENT_STEP + n))
        while feeder.recording:
            reals = to_unit_range(torch.from_numpy(next(it)).to(self.device))
            latents = self.gan.sample_latents(bs, latent_rng, "cpu").to(self.device)
            out = feeder.feed(reals, self.sample_fn(self.state, latents))
            if out:
                self.logger.scalars(self.samples_seen, out)
                print(f"[metrics @ {self.samples_seen}] "
                      f"{({k: round(v, 4) for k, v in out.items()})}", flush=True)

    def _fill_gen_loss(self, logs: Dict) -> None:
        """A step that skipped the generator reports ``gen_loss`` 0; log the
        last real value instead, so that logged ``gen_loss`` never
        interleaves real values with structural zeros."""
        if logs.get("did_gen_step", 1.0):
            self._gen_loss_carry = logs["gen_loss"]
        elif self._gen_loss_carry is not None:
            logs["gen_loss"] = self._gen_loss_carry

    def _log_progress(self, n_img: int, n_batches: int, logs: Dict, suffix: str = "") -> None:
        """A progress line and ``logs["images_per_sec"]`` once 5 s have passed
        since the last one."""
        t_last, n_last = self._throughput
        t_now = time.time()
        if t_now - t_last <= 5.0:
            return
        logs["images_per_sec"] = (n_img - n_last) / (t_now - t_last)
        self._throughput = (t_now, n_img)
        if self.is_main:
            print(f"[trainer] {n_img} examples ({n_batches} batches) "
                  f"d_loss={logs['disc_loss']:+.4f} std={logs['std']:.4f} "
                  f"{logs['images_per_sec']:.1f} img/s{suffix}", flush=True)

    def _maybe_log_epoch(self, n_batches: int, n_img: int, logs: Dict) -> None:
        """``epoch_*`` scalars at each epoch boundary: the last batch's logs."""
        spe = self._steps_per_epoch
        if spe and n_batches % spe == 0:
            self.logger.scalars(n_img, dict(logs, epoch=n_batches // spe), prefix="epoch_")

    @torch.no_grad()
    def evaluate(self, num_samples: int = 1000, metrics=None, seed: int = 1234
                 ) -> Dict[str, float]:
        """SWD and FID (random-conv features) between dataset reals and fresh
        samples, ``num_samples`` pairs, logged as ``eval_*``. ``metrics``:
        objects with ``update_state`` / ``results`` or ``result``.

        In a data-parallel run each process scores ``num_samples`` pairs of
        its own: its shard of the reals stream (training's sharding) against
        its contiguous slice of each batch's latents. A metric with
        ``cross_process_merge`` is then merged over the processes
        (``num_samples × N`` pairs) and logged as ``eval_*``; one without
        stays the process's own and is logged as ``eval_localshard_*``."""
        if metrics is None:
            metrics = [SWDMetric(), FIDMetric()]
        bs = self.hparams.global_batch_size
        local_bs = bs // self.world
        latent_rng = torch.Generator().manual_seed(seed)
        it = self.dataset.batches(local_bs, seed=seed, shard_index=self.rank,
                                  shard_count=self.world)
        rows = slice(self.rank * local_bs, (self.rank + 1) * local_bs)
        done = 0
        while done < num_samples:
            take = min(local_bs, num_samples - done)
            reals = to_unit_range(torch.from_numpy(next(it)[:take]).to(self.device))
            latents = self.gan.sample_latents(bs, latent_rng, "cpu")[rows].to(self.device)
            fakes = self.sample_fn(self.state, latents)[:take]
            for m in metrics:
                m.update_state(reals, fakes)
            done += take
        out: Dict[str, float] = {}
        local_out: Dict[str, float] = {}
        for m in metrics:
            merge = getattr(m, "cross_process_merge", None)
            merged = self.world > 1 and merge is not None
            if merged:
                merge(parallel.allgather)
            sink = out if self.world == 1 or merged else local_out
            if hasattr(m, "results"):
                sink.update(m.results())
            else:
                sink[m.name] = float(m.result())
            m.reset_states()
        if out:
            self.logger.scalars(self.samples_seen, out, prefix="eval_")
        if local_out:
            self.logger.scalars(self.samples_seen, local_out, prefix="eval_localshard_")
        return {**out, **local_out}

    def export_weights(self, directory: str) -> None:
        """The generator's and the critic's ``state_dict`` as ``generator.pt``
        and ``discriminator.pt``; with an average, also ``generator_ema.pt``:
        the generator's ``state_dict`` with the averaged weights and the live
        BatchNorm statistics. Rank 0 alone writes them."""
        if not self.is_main:
            return
        os.makedirs(directory, exist_ok=True)
        generator = self.state.generator.state_dict()
        torch.save(generator, os.path.join(directory, "generator.pt"))
        torch.save(self.state.discriminator.state_dict(),
                   os.path.join(directory, "discriminator.pt"))
        if self.state.g_ema is not None:
            names = [n for n, _ in self.state.generator.named_parameters()]
            torch.save(dict(generator, **dict(zip(names, self.state.g_ema))),
                       os.path.join(directory, "generator_ema.pt"))

    def _aux_dict(self) -> Dict:
        aux = {}
        if self.ada_state is not None:
            aux["adaptive_blur"] = AdaptiveBlurController.state_to_dict(self.ada_state)
        return aux

    def close(self) -> None:
        self.logger.close()
