"""A pool of gloo processes for ``tests/test_torch_parallel.py``, and the cases they run.

``Pool(world)`` spawns ``world`` processes that join one gloo group on this
machine and then serve cases: ``pool.run(name, **kwargs)`` runs the case
``name`` in every process at once and returns each rank's result, a dict of
numpy arrays and plain values. A case that raises in any process fails the
call with that process's traceback; a case that does not return within the
timeout fails it too. The group starts once for all the cases a test module
runs. This module imports torch and the port, never jax, so the processes
start quickly; the cases also run in the test process itself, without a
group, as the one-process reference.
"""

from __future__ import annotations

import datetime
import os
import socket
import traceback
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from blurred_gan_tpu_torch import parallel
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.dryrun import tiny_gan
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.runtime import process_count, process_index
from blurred_gan_tpu_torch.train import checkpoint as checkpoint_mod
from blurred_gan_tpu_torch.train import step as step_mod
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod

RES, SIGMA, STEP_SEED, TIMEOUT_S = 16, 1.5, 5, 120


def _numpy_state(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _recording_steps(state):
    """Patch the step's optimizer hand-off to record the gradients it is
    given: a list that gets ``{"d": [...], "g": [...]}`` per step."""
    grads: List[Dict] = []
    real_apply = step_mod._apply

    def recording_apply(opt, params, gs):
        grads[-1]["g" if opt is state.g_opt else "d"] = [g.detach().numpy().copy() for g in gs]
        real_apply(opt, params, gs)

    step_mod._apply = recording_apply
    return grads, real_apply


def dp_run(hparams: dict, steps: int, global_batch: int) -> dict:
    """``steps`` steps of :func:`~blurred_gan_tpu_torch.dryrun.tiny_gan` (dropout
    on) from seed 0 at ``global_batch``, this process taking its rows of each
    global batch: per step the metrics, the gradients handed to the
    optimizers, both networks' ``state_dict`` and the generator's average."""
    world, rank = process_count(), process_index()
    gan = tiny_gan()
    hp = BlurredWGANGPHyperParameters(batch_size=global_batch // world,
                                      global_batch_size=global_batch, **hparams)
    state = create_train_state(gan, hp, device="cpu", seed=0)
    step = make_train_step(gan, hp, seed=STEP_SEED)
    rng = np.random.RandomState(0)
    b = global_batch // world
    grads, real_apply = _recording_steps(state)
    out = {"metrics": [], "grads": grads, "generator": [], "critic": [], "ema": []}
    try:
        for _ in range(steps):
            reals = rng.randint(0, 256, (global_batch, RES, RES, 3)).astype(np.uint8)
            grads.append({})
            metrics, fakes = step(state, torch.from_numpy(reals[rank * b:(rank + 1) * b]), SIGMA)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["generator"].append(_numpy_state(state.generator))
            out["critic"].append(_numpy_state(state.discriminator))
            out["ema"].append([t.numpy().copy() for t in state.g_ema or []])
    finally:
        step_mod._apply = real_apply
    out["fakes_rows"] = int(fakes.shape[0])
    out["n_img"], out["n_batches"] = state.n_img, state.n_batches
    return out


def jax_parity_step(g_kw: dict, d_channels: tuple, latent: int, generator: dict,
                    critic: dict, reals: np.ndarray, noise: dict, sigma: float) -> dict:
    """One step of the port's dropout-free narrow pair from the given
    ``state_dict``s on this process's rows of ``reals``, with the global
    ``noise`` pinned: the metrics, the gradients and both ``state_dict``s."""
    world, rank = process_count(), process_index()
    batch = reals.shape[0]
    gan = GAN(DCGANGenerator(**g_kw),
              DCGANDiscriminator(channels=d_channels, dropout_rate=0.0, in_channels=3,
                                 image_hw=(RES, RES)), latent_size=latent)
    hp = BlurredWGANGPHyperParameters(batch_size=batch // world, global_batch_size=batch)
    state = create_train_state(gan, hp, device="cpu")
    state.generator.load_state_dict({k: torch.from_numpy(v) for k, v in generator.items()})
    state.discriminator.load_state_dict({k: torch.from_numpy(v) for k, v in critic.items()})
    grads, real_apply = _recording_steps(state)
    b = batch // world
    try:
        grads.append({})
        metrics, _ = make_train_step(gan, hp)(
            state, torch.from_numpy(reals[rank * b:(rank + 1) * b]), sigma,
            noise={k: torch.from_numpy(v) for k, v in noise.items()})
    finally:
        step_mod._apply = real_apply
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads[0],
            "generator": _numpy_state(state.generator), "critic": _numpy_state(state.discriminator)}


def metric_merge(real_feats: np.ndarray, fake_feats: np.ndarray, reals: np.ndarray,
                 fakes: np.ndarray) -> dict:
    """This process's rows of each array (split in rank order) into an FID
    over the features as given and an SWD over the NCHW images, each merged
    across the processes with ``parallel.allgather``. The SWD's patch
    positions continue the stream a single metric fed every process's rows
    in rank order would draw, so the merge is comparable with it."""
    world, rank = process_count(), process_index()

    def mine(a):
        n = a.shape[0] // world
        return torch.from_numpy(a[rank * n:(rank + 1) * n])

    fid = FIDMetric(feature_fn=lambda x: x.reshape(x.shape[0], -1))
    fid.update_state(mine(real_feats)[:, :, None, None], mine(fake_feats)[:, :, None, None])
    fid.cross_process_merge(parallel.allgather)
    swd = SWDMetric(nhoods_per_image=16, dir_repeats=2, dirs_per_repeat=32, seed=3)
    n = reals.shape[0] // world
    for r in range(rank):  # advance the position stream past the earlier ranks' draws
        swd.update_state(torch.from_numpy(reals[r * n:(r + 1) * n]),
                         torch.from_numpy(fakes[r * n:(r + 1) * n]))
        swd.reset_states()
    swd.update_state(mine(reals), mine(fakes))
    swd.cross_process_merge(parallel.allgather)
    return {"fid": fid.result(), "swd": swd.results()}


def trainer_case(log_dir: str) -> dict:
    """A ``Trainer`` of the tiny pair at a global batch of 8 on a synthetic
    16x16x3 corpus: 2 steps of ``fit`` (a checkpoint at the end), then a
    second ``Trainer`` on the same run directory restores it; the state
    digests of the live and restored states, the checkpoint writes this
    process made, what ``fit_device_resident`` raises, and ``evaluate``'s
    merged SWD and FID."""
    writes = []
    real_write = checkpoint_mod.CheckpointManager._write

    def counting_write(self, path, state, aux):
        writes.append(os.path.basename(path))
        real_write(self, path, state, aux)

    checkpoint_mod.CheckpointManager._write = counting_write
    try:
        def trainer():
            hp = BlurredWGANGPHyperParameters(batch_size=8 // process_count(),
                                              global_batch_size=8)
            return Trainer(tiny_gan(), hp, synthetic_dataset((RES, RES, 3), 64), device="cpu",
                           trainer_config=TrainerConfig(
                               log_dir=log_dir, log_metrics_every_n_examples=8,
                               sample_grid_every_n_examples=16, checkpoint_every_n_examples=0,
                               image_summaries_interval_batches=0, seed=0))

        live = trainer()
        live.fit(total_examples=10 ** 6, max_steps=2)
        restored = trainer()
        try:
            restored.fit_device_resident(total_examples=10 ** 6, chunk_steps=2)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        scores = restored.evaluate(num_samples=16, metrics=[
            SWDMetric(nhoods_per_image=8, dir_repeats=2, dirs_per_repeat=16),
            FIDMetric(feature_dim=16)])
        for t in (live, restored):
            t.close()
    finally:
        checkpoint_mod.CheckpointManager._write = real_write
    return {"writes": writes, "live": parallel.state_digest(live.state),
            "restored": parallel.state_digest(restored.state),
            "restored_examples": restored.restored_examples, "refused": refused,
            "scores": scores, "history": [h["disc_loss"] for h in live.history]}


CASES = {f.__name__: f for f in (dp_run, jax_parity_step, metric_merge, trainer_case)}


def _serve(rank: int, world: int, port: int, conn) -> None:
    logging_mod._summary_writer = lambda log_dir: None  # no TensorBoard import here
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            message = conn.recv()
            if message is None:
                return
            name, kwargs = message
            try:
                conn.send((True, CASES[name](**kwargs)))
            except Exception:  # noqa: BLE001 - reported to the test process
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pool:
    """``world`` gloo processes serving :data:`CASES`."""

    def __init__(self, world: int = 2):
        ctx = mp.get_context("spawn")
        port = free_port()
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(rank, world, port, child), daemon=True)
            proc.start()
            self.conns.append(parent)
            self.procs.append(proc)

    def run(self, name: str, timeout: float = TIMEOUT_S, **kwargs) -> list:
        for conn in self.conns:
            conn.send((name, kwargs))
        results = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(timeout):
                raise TimeoutError(f"rank {rank} did not finish {name} in {timeout} s")
            ok, value = conn.recv()
            if not ok:
                raise RuntimeError(f"rank {rank}, {name}:\n{value}")
            results.append(value)
        return results

    def close(self) -> None:
        for conn in self.conns:
            conn.send(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
