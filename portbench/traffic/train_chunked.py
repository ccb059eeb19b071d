"""Chunked training on a device-resident corpus: ``Trainer.fit_device_resident``
as ``train_celeba --device_resident`` / ``train_mnist --device_resident`` run
it (a CUDA graph of the step replayed ``chunk_steps`` times a chunk, one
fetch of the chunk's metrics, the hooks replayed per step).

Set-up builds one ``Trainer`` and hands it to the window:

1. the corpus and the weights from the seed, loaded into the port's networks;
2. the warm-up: one ``fit_device_resident`` call of two chunks of
   ``chunk_steps``. Its first chunk builds the runner that the window
   reuses (the corpus on the card, the graph's capture) and is the checked
   pass: inside it :class:`StepTap` reads the state after step 1 (the critic
   step's fakes, ``ChunkRunner.fakes``; the gradient as Adam holds it, its
   first moment over ``1 − β₁``) and after step ``check_steps`` (each
   parameter's change). The second chunk's time sets how many chunks fill
   ``--seconds``;
3. the window: one ``fit_device_resident`` call of that many chunks on the
   same runner (with ``--trace 1``: ``trace_chunks`` chunks under the
   profiler).

The benchmark's hook, fired after each step's own hooks as a chunk's logs
are replayed, keeps the checked steps' losses, every step's σ and each
chunk's end. ``train_img_s`` is the window's images over the time from the
call to the end of its last chunk's hook replay (the call's closing
checkpoint comes after it). After the window the program's state is freed
and the reference follows the checked steps from the same weights, batches,
σ and draws (:func:`fill`: the numbers compared); every step's σ of the run
is held to the configuration's schedule (``sigma_gap``).

Parameters: ``chunk_steps``, ``check_steps``, ``trace_chunks``.
"""

from __future__ import annotations

import contextlib
import gc
import math
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Optional

import torch

import blurred_gan_tpu_torch.train.fast as fast
from blurred_gan_tpu_torch.data.pipeline import ArrayDataset
from blurred_gan_tpu_torch.train.hooks import EveryNExamples

from portbench import checks as ck
from portbench import flops, inputs, port
from portbench import trace as tr
from portbench.context import Context, Outcome
from portbench.reference import train as ref

ADAM_BETA1 = 0.9


def device_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    """``(names, norms)``: each tensor's norm in float64, left on its device."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].detach(), dtype=torch.float64)
                         for k in names])
    return names, norms * scale


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names, norms = device_norms(tensors, scale)
    return dict(zip(names, norms.tolist()))


def program_leaves(trainer) -> Dict[str, torch.Tensor]:
    out = {f"generator/{k}": p for k, p in trainer.state.generator.named_parameters()}
    out.update({f"critic/{k}": p for k, p in trainer.state.discriminator.named_parameters()})
    return out


class StepTap:
    """Reads the program's state inside the first chunk of the window's
    runner. ``ChunkRunner.run`` asks ``step_phase`` for each step's phase
    before it queues the step, on the card's replayed path and on the CPU's
    eager one alike: when it asks for the step whose pre-step counter is
    ``n``, steps 1 to ``n`` are queued, and what the tap queues then on the
    same stream reads the state after step ``n``. The norms stay on the
    device until :meth:`readings`."""

    def __init__(self, trainer, check_steps: int):
        self.trainer, self.check_steps = trainer, check_steps
        self.leaves = program_leaves(trainer)
        self.w0 = {k: p.detach().clone() for k, p in self.leaves.items()}
        self.fakes = self.moments = self.deltas = None
        self.first = None            # the first moments themselves, for their directions

    @contextlib.contextmanager
    def installed(self):
        phase = fast.step_phase

        def tapped(hparams, n_batches):
            if n_batches == 1 and self.fakes is None:
                self._after_first()
            if n_batches == self.check_steps and self.deltas is None:
                self.deltas = device_norms({k: p - self.w0[k] for k, p in self.leaves.items()})
                self.w0 = None
            return phase(hparams, n_batches)

        fast.step_phase = tapped
        try:
            yield self
        finally:
            fast.step_phase = phase

    def _after_first(self) -> None:
        self.fakes = self.trainer.chunk_runner.fakes.detach().float().clone()
        state = self.trainer.state
        moments = {}
        for net, opt, module in (("generator", state.g_opt, state.generator),
                                 ("critic", state.d_opt, state.discriminator)):
            for k, p in module.named_parameters():
                moments[f"{net}/{k}"] = opt.state[p]["exp_avg"]
        self.moments = device_norms(moments, 1.0 / (1.0 - ADAM_BETA1))
        self.first = {k: t.detach().clone() for k, t in moments.items()}

    def readings(self):
        """``(fakes, first-gradient norms, change norms, first gradients)``
        in host memory, None where the tap did not read."""
        host = lambda pair: None if pair is None else dict(zip(pair[0], pair[1].tolist()))
        fakes = None if self.fakes is None else self.fakes.cpu()
        first = None if self.first is None else {k: t.cpu() for k, t in self.first.items()}
        return fakes, host(self.moments), host(self.deltas), first


class Recorder:
    """The benchmark's hook, fired after every step the trainer replays."""

    def __init__(self, chunk_steps: int, check_steps: int):
        self.chunk_steps, self.check_steps = chunk_steps, check_steps
        self.steps = 0
        self.losses: List[Dict[str, float]] = []
        self.sigmas: List[float] = []        # every step's σ, in step order
        self.chunk_ends: List[float] = []
        self.window_from = None      # the step count where the window starts
        self.window_chunks = 0
        self.window_end = math.nan
        self.nonfinite = 0

    def after_step(self, samples_seen: int, logs: Dict) -> None:
        self.steps += 1
        self.sigmas.append(float(logs["std"]))
        if self.steps <= self.check_steps:
            self.losses.append({k: float(logs[k]) for k in ("disc_loss", "gen_loss")})
        if self.steps % self.chunk_steps == 0:
            self.chunk_ends.append(time.perf_counter())
        if self.window_from is None:
            return
        if not (math.isfinite(logs["disc_loss"]) and math.isfinite(logs["gen_loss"])):
            self.nonfinite += 1
        if self.steps - self.window_from == self.window_chunks * self.chunk_steps:
            self.window_end = self.chunk_ends[-1]
            tr.instant("window_end")


def run(ctx: Context) -> Outcome:
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    batch, k = cfg["batch_size"], params["chunk_steps"]
    n_check = params["check_steps"]
    total = port.total_examples(cfg)
    images = inputs.corpus(cfg, ctx.seed, dev)
    ctx.phase("corpus")
    seed = inputs.sub_seed(ctx.seed, "program", bits=31)
    log_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        trainer = port.trainer(cfg, ArrayDataset(images, name=f"portbench-{cfg['name']}"),
                               dev, log_dir, seed)
        weights = inputs.weights(cfg, ctx.seed, dev)
        port.load(trainer.state.generator, weights["generator"])
        port.load(trainer.state.discriminator, weights["critic"])
        del weights
        ctx.phase("trainer and weights")
        tap = StepTap(trainer, n_check)
        rec = Recorder(k, n_check)
        trainer.hooks.add(EveryNExamples(batch, rec.after_step, name="portbench"))
        with tap.installed():
            trainer.fit_device_resident(total, chunk_steps=k, max_chunks=2)
        chunk_s = rec.chunk_ends[-1] - rec.chunk_ends[-2]
        ctx.phase("warm-up and checked steps")
        chunks = params["trace_chunks"] if ctx.trace else max(2, round(ctx.seconds / chunk_s))
        sigma = ref.decayed_sigma(cfg["sigma0"], total, trainer.state.n_batches)
        rec.window_from, rec.window_chunks = rec.steps, chunks
        with tr.capture(ctx.trace) as cap:
            start = time.perf_counter()
            tr.instant("window_start")
            trainer.fit_device_resident(total, chunk_steps=k, max_chunks=chunks)
        window_s = rec.window_end - start
        ends = [start] + rec.chunk_ends[-chunks:]
        ctx.notes.append("window chunks (s): " + " ".join(
            f"{b - a:.4f}" for a, b in zip(ends, ends[1:])))
        ctx.phase("window and its checkpoint")
        memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        trainer.close()
        fakes, grads, deltas, first = tap.readings()
        readings = fakes, rec.losses, grads, deltas, first
        sigmas, nonfinite = rec.sigmas, rec.nonfinite
        del trainer, rec, tap
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    checks = ctx.checks()
    compare(ctx, images, seed, readings, checks)
    checks.add("sigma_gap", sigma_gap(cfg, sigmas), f"{len(sigmas)} steps")
    ctx.phase("reference")
    steps = chunks * k
    return Outcome(
        setup_s=start - ctx.process_start,
        metrics={"train_img_s": steps * batch / window_s},
        attempted=steps, failed=nonfinite, checks=checks, memory_peak_bytes=memory,
        trace=cap.trace,
        facts={"steps": steps, "images": steps * batch,
               "step_flops": flops.step_flops(cfg, sigma),
               "blur_flops_per_step": flops.blur_taps(cfg, sigma),
               "blur_bytes_per_step": flops.blur_bytes(cfg)})


def sigma_gap(cfg: dict, sigmas: List[float]) -> float:
    """The largest relative gap between a step's σ as the program ran it and
    the configuration's schedule at that step's pre-step counter."""
    total = port.total_examples(cfg)
    if not sigmas:
        return math.inf
    reference = [ref.decayed_sigma(cfg["sigma0"], total, n) for n in range(len(sigmas))]
    gap = max(abs(s - r) / r for s, r in zip(sigmas, reference))
    return gap if math.isfinite(gap) else math.inf


def reference_readings(cfg: dict, images, seed: int, run_seed: int, steps: int, device,
                       precision: str = "float32", rows: Optional[int] = None):
    """(first step's fakes, losses, first-gradient norms, change norms,
    first gradients) of the reference over the checked steps, from the
    run's weights; ``images``
    the corpus (host array or device tensor), ``seed`` the program's.
    ``precision`` and ``rows`` make the controls (``reference/train.py``)."""
    weights = inputs.weights(cfg, run_seed, device)
    gan = ref.ReferenceGAN(cfg, weights, device, precision)
    w0 = {k: v.clone() for k, v in gan.parameters().items()}
    total = port.total_examples(cfg)
    fakes, losses, grads, named = None, [], {}, {}
    for n in range(steps):
        idx = ref.batch_indices(cfg["corpus_size"], cfg["batch_size"], n, seed)
        sigma = ref.decayed_sigma(cfg["sigma0"], total, n)
        reals = images[torch.from_numpy(idx).to(images.device)] if torch.is_tensor(images) \
            else torch.from_numpy(images[idx])
        out = gan.step(reals, sigma, ref.step_seed(seed, n), rows)
        losses.append({k: out[k] for k in ("disc_loss", "gen_loss")})
        if n == 0:
            fakes = out["fakes"].cpu()
            named = {f"critic/{k}": g for k, g in zip(gan.d_names, out["d_grads"])}
            named.update({f"generator/{k}": g for k, g in zip(gan.g_names, out["g_grads"])})
            grads = leaf_norms(named)
    deltas = leaf_norms({k: v - w0[k] for k, v in gan.parameters().items()})
    return fakes, losses, grads, deltas, named


def image_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst image's gap: ``‖p − r‖ / ‖r‖`` over its pixels."""
    if program is None or program.shape != reference.shape:
        return math.inf
    diff = (program.to(torch.float32) - reference).flatten(1).norm(dim=1)
    gap = (diff / reference.flatten(1).norm(dim=1)).max()
    return float(gap) if torch.isfinite(gap) else math.inf


def loss_gaps(program: List[Dict[str, float]], reference: List[Dict[str, float]]) -> List[float]:
    """Each step's loss gap: the larger of the critic's and the generator's
    loss gaps, over the step's larger reference loss."""
    if len(program) != len(reference):
        return [math.inf]
    out = []
    for p, r in zip(program, reference):
        scale = max(abs(r["disc_loss"]), abs(r["gen_loss"]))
        gap = max(abs(p[k] - r[k]) for k in ("disc_loss", "gen_loss")) / scale
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def compare(ctx: Context, images, seed: int, readings, checks) -> None:
    n = ctx.params["check_steps"]
    reference = reference_readings(ctx.config, images, seed, ctx.seed, n, ctx.device)
    fill(checks, *readings, *reference)


def turns(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
          leaves: List[str]) -> Dict[str, float]:
    """Each leaf's ``1 − cos`` between the program's first gradient and the
    reference's: how far its direction turned, whatever its norm."""
    out = {}
    for k in leaves:
        r = reference[k].double().flatten()
        p = program[k].to(r.device).double().flatten()
        cos = torch.dot(p, r) / (p.norm() * r.norm())
        out[k] = 1.0 - float(cos) if torch.isfinite(cos) else math.inf
    return out


def fill(checks, fakes, losses, grads, deltas, first, r_fakes, r_losses, r_grads, r_deltas,
         r_first) -> None:
    """The numbers compared: the first step's fakes (worst image), its loss,
    each leaf's first gradient (its norm by the worst leaf and the median
    leaf, its direction by the median leaf that the reference moves) and
    each parameter's change by the worst leaf. A number without a limit in
    the cell's file is only read; a state the tap did not read fails."""
    checks.add("fake_gap", image_gap(fakes, r_fakes))
    gaps = loss_gaps(losses, r_losses)
    checks.add("loss_gap", gaps[0], "later steps: " + " ".join(f"{g:.3g}" for g in gaps[1:]))
    if grads is None or deltas is None or first is None:
        for name in ("grad_gap", "grad_gap_median", "grad_turn", "delta_gap"):
            checks.fail(name, "the state was not read inside the first chunk")
        return
    moved = ck.moved_leaves(r_grads)
    grad = ck.leaf_gaps(grads, r_grads)
    delta = ck.leaf_gaps(deltas, r_deltas, moved)
    for name, gaps in (("grad_gap", grad), ("delta_gap", delta)):
        worst = sorted(gaps, key=gaps.get, reverse=True)
        checks.add(name, gaps[worst[0]], ", ".join(f"{k} {gaps[k]:.3g}" for k in worst[:3])
                   + f"; median leaf {statistics.median(gaps.values()):.3g}")
    checks.add("grad_gap_median", statistics.median(grad.values()),
               "leaves' 3rd quartile, 9th decile: " + " ".join(
                   f"{q:.3g}" for q in statistics.quantiles(grad.values(), n=20)[14::3]))
    turn = turns(first, r_first, moved)
    worst = max(turn, key=turn.get)
    checks.add("grad_turn", statistics.median(turn.values()),
               f"worst leaf {worst} {turn[worst]:.3g}; 9th decile "
               f"{statistics.quantiles(turn.values(), n=10)[8]:.3g}")
