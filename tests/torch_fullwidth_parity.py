"""Full-width train steps of the port against the JAX package's, on the CPU,
and the whole-run σ schedule and batch order of the quality check's runs.

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/torch_fullwidth_parity.py \\
        [--arms 1,2,3,4,5,6,7,8] [--schedule] [--rounding] [--out parity.jsonl]

**Steps.** The ``quality.CONFIGS`` surfaces at their real widths and batch
(32). The JAX state comes from ``create_train_state`` (``PRNGKey(3)``) and
reaches the port through ``flax_to_torch`` (weights, BatchNorm statistics);
both sides then run freely from it. Step ``i`` takes batch ``i`` of the
corpus's ``RandomState(0)`` shuffle at σ₀, and its draws (``z_d``, ``z_g``,
α) are the JAX step's for ``PRNGKey(11 + i)``, handed to the port. The
critic's dropout is 0 on both sides (0.3 in training: the frameworks cannot
share masks). Arms:

1. ``celeba64`` plain, 2 steps;
2. ``celeba64 --d_steps 2``, 4 steps (two generator periods);
3. ``celeba64 --ref_grad_scale``, 2 steps;
4. ``mnist`` plain, 2 steps;
5. ``celeba64_sharp --bf16``, 2 steps, against JAX compiled without XLA's
   excess precision (``exact``) and by default (``default``, excess precision
   on, the program the JAX package trains with); also ``default`` against
   ``exact``. The port's bfloat16 generator keeps its products' float32 sums
   where the default compile does (``models/dcgan.py``'s ``f32_sums``);
6. ``celeba64 --gen_upsample resize``, 2 steps;
7. ``celeba64 --ttur_g_lr 0.002``, 2 steps; step 0's line also holds each
   network's Adam rate, read back from its first update on both sides (and
   set on the port's optimizers);
8. ``celeba64 --adaptive``, 4 steps: each side's closed-loop controller
   (:data:`ADAPTIVE`, ``quality train``'s with no warm-up and no pause between
   changes, so that σ can move after every step) reads that side's own step
   scores and sets the next step's σ; each line also holds both controllers'
   state after the step.

``--rounding`` measures how far float32 rounding alone moves the celeba64
generator on each side, per upsampler (:func:`generator_rounding`).

``--long 1,2,3`` runs each listed float32 arm for :data:`LONG_STEPS`
steps on both sides from the same JAX state, each side free, and after
every step sets the port's state beside JAX's: the losses, each network's
parameters, the generator's BatchNorm running statistics and the eval
generator's output on fixed latents (:func:`long_arm`). An arm's drift is
read beside the plain arm's (1) over the same steps.

:func:`run_arm` with ``narrow=True`` builds the celeba64 layout at a few
channels a layer (:data:`NARROW_G`, :data:`NARROW_D`): the same stages,
kernels and strides (``tests/test_torch_arm_parity.py``).

``--hlo`` lists the bfloat16 roundings the default compile of arm 5's JAX
step drops: an f32 value converted to bf16 and straight back inside one
computation, counted in each compile by the network and pass of the fusion
that holds it; then the same for its generator alone, by layer, for both
upsamplers with and without ``--fast_gen``, in eval mode and in train mode
with its VJP (:func:`hlo_generator_roundings`).

Per step, one JSON line: each loss on each side and its relative difference;
for each network the relative L2 of its parameter update (the step's change
of all its parameters, flattened) against JAX's, ``|Δport − Δjax| /
|Δjax|`` (null where JAX's update is 0, a skipped generator step, with the
port's update norm beside it), the share of elements whose update has the
other sign, and the relative L2 of the step's gradient, read back from
Adam's first moments. Adam's early updates are close to ``−lr·sign(g)``, so
an element whose gradient is within rounding of 0 moves by ``lr`` either
way: the update's difference is the gradient's, magnified.

**Schedule** (``--schedule``, host only, no train step runs). For each
surface's full run (``mnist`` 180,000 examples, ``celeba64`` and
``celeba64_sharp`` 60,000) and each seed of ``--seeds``, both packages'
``Trainer.fit`` run with the open-loop controller of ``train_ours`` on a
corpus of the surface's size whose images carry their own index, with the
train step replaced by a recorder: the σ fed at every step (as float32, what
the step computes with) and the corpus indices of every batch must be equal.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import re
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blurred_gan_tpu import models as jmodels
from blurred_gan_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from blurred_gan_tpu.sched.blur import AdaptiveBlurController as JaxAdaptive
from blurred_gan_tpu.sched.blur import BlurDecayController as JaxBlurDecay
from blurred_gan_tpu.train import BlurredWGANGPHyperParameters as JaxHP
from blurred_gan_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from blurred_gan_tpu.train.state import GAN as JaxGAN, create_train_state as jax_state
from blurred_gan_tpu.train.step import make_train_step as jax_step
from blurred_gan_tpu_torch import quality
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.data.pipeline import ArrayDataset
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod
from torch_variant_harness import exact_rounding, load_jax_state

B = quality.BATCH
KEY0 = 11
BETA1 = 0.9  # Adam's, on both sides

ARMS = {
    1: dict(config="celeba64", steps=2),
    2: dict(config="celeba64", steps=4, hp=dict(d_steps_per_g_step=2)),
    3: dict(config="celeba64", steps=2, hp=dict(reference_grad_scale=True)),
    4: dict(config="mnist", steps=2),
    5: dict(config="celeba64_sharp", steps=2, dtype="bfloat16"),
    6: dict(config="celeba64", steps=2, upsample="resize"),
    7: dict(config="celeba64", steps=2, hp=dict(g_learning_rate=0.002)),
    8: dict(config="celeba64", steps=4, adaptive=True),
}
# Arm 8's controller over ``quality train``'s (σ₀ the surface's, changes
# applied): no warm-up and no pause between changes, where the run's
# controller waits 100 batches for each.
ADAPTIVE = dict(warmup_n_batches=0, delay_between_modifications=1)
# The celeba64 layout at narrow widths: five generator blocks from 4² to 64²,
# five stride-2 critic convolutions.
NARROW_G = dict(init_hw=(4, 4), init_features=8,
                blocks=((8, 1), (8, 2), (4, 2), (4, 2), (4, 2)), out_channels=3)
NARROW_D = (4, 4, 8, 8, 8)
RUN_EXAMPLES = {"mnist": 180_000, "celeba64": 60_000, "celeba64_sharp": 60_000}
# Steps of each ``--long`` free run.
LONG_STEPS = 24


def jax_networks(cfg: quality.ParityConfig, dtype: str, upsample: str = "transpose",
                 narrow: bool = False):
    dt = jnp.dtype(dtype)
    if narrow:
        assert cfg.arch == "celeba64", cfg.arch
        g = jmodels.DCGANGenerator(latent_size=quality.LATENT, compute_dtype=dt,
                                   upsample=upsample, **NARROW_G)
        d = jmodels.DCGANDiscriminator(channels=NARROW_D, compute_dtype=dt)
    elif cfg.arch == "mnist":
        g, d = jmodels.mnist_generator(compute_dtype=dt), jmodels.mnist_discriminator(compute_dtype=dt)
    else:
        res = cfg.image_shape[0]
        g = jmodels.celeba_generator(res, compute_dtype=dt, upsample=upsample)
        d = jmodels.celeba_discriminator(res, compute_dtype=dt)
    return g, d.clone(dropout_rate=0.0)


def port_networks(cfg: quality.ParityConfig, dtype: str, upsample: str = "transpose",
                  narrow: bool = False):
    dt = getattr(torch, dtype)
    if narrow:
        g = DCGANGenerator(latent_size=quality.LATENT, compute_dtype=dt, upsample=upsample,
                           **NARROW_G)
        d = DCGANDiscriminator(channels=NARROW_D, image_hw=cfg.image_shape[:2],
                               compute_dtype=dt)
    else:
        g, d = quality.networks(cfg, dt, upsample)
    d.dropout_rate = 0.0
    return g, d


def draws(key) -> dict:
    """The JAX step's draws for ``key`` (``split(key, 4)``; the second key is
    the dropout's)."""
    k_zd, _, k_gp, k_zg = jax.random.split(key, 4)
    out = {"z_d": jax.random.uniform(k_zd, (B, quality.LATENT), jnp.float32),
           "alpha": jax.random.uniform(k_gp, (B, 1, 1, 1), dtype=jnp.float32),
           "z_g": jax.random.uniform(k_zg, (B, quality.LATENT), jnp.float32)}
    return {k: np.asarray(v) for k, v in out.items()}


def reals_batches(cfg: quality.ParityConfig, n: int):
    images = quality.corpus(cfg).images
    order = np.random.RandomState(0).permutation(len(images))
    return [images[order[i * B:(i + 1) * B]] for i in range(n)]


def flat(module) -> np.ndarray:
    return np.concatenate([p.detach().to(torch.float64).reshape(-1).numpy()
                           for p in module.parameters()])


def flat_moment(opt, module) -> np.ndarray:
    """Adam's first moment of ``module``'s parameters (0 before a first step)."""
    return np.concatenate([opt.state[p]["exp_avg"].to(torch.float64).reshape(-1).numpy()
                           if p in opt.state else np.zeros(p.numel())
                           for p in module.parameters()])


def jax_flat(scratch, params) -> np.ndarray:
    """A flax parameter tree, flattened in the port's parameter order."""
    flax_to_torch(scratch, params)
    return flat(scratch)


def jax_moment(scratch, opt_state) -> np.ndarray:
    """Adam's first moment in a JAX optimizer state, as :func:`jax_flat`."""
    adam = opt_state[0]
    return jax_flat(scratch, adam.mu)


def jax_side(scratch, state):
    """(generator, critic) parameters and first moments of a JAX state, flat."""
    return ((jax_flat(scratch[0], state.g_params), jax_flat(scratch[1], state.d_params)),
            (jax_moment(scratch[0], state.g_opt_state), jax_moment(scratch[1], state.d_opt_state)))


def rel_l2(got, want):
    den = float(np.linalg.norm(want))
    return None if den == 0.0 else float(np.linalg.norm(got - want) / den)


def jax_trajectory(jgan, jhp, state0, batches, sigma, dtype, compile_mode, controller=None):
    """(states, metrics, controller trace) of ``len(batches)`` JAX steps;
    ``compile_mode`` is ``exact`` (no excess precision off float32) or
    ``default``. With a ``controller`` each step's σ is its state's, updated
    from the step's scores (:func:`controller_trace`)."""
    step = jax_step(jgan, jhp, donate_state=False)
    states, metrics = [state0], []
    ctrl = controller.init() if controller else None
    trace = []
    for i, reals in enumerate(batches):
        s = ctrl.std if ctrl else sigma
        args = (states[-1], jnp.asarray(reals), jnp.float32(s), jax.random.PRNGKey(KEY0 + i))
        if i == 0:
            step = (exact_rounding(step, dtype, *args) if compile_mode == "exact"
                    else step.lower(*args).compile())
        t0 = time.time()
        state, m, _ = step(*args)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
        if ctrl:
            ctrl = controller_trace(controller, ctrl, i, s, metrics[-1], trace)
        print(f"[jax {compile_mode}] step {i}: {time.time() - t0:.1f} s", flush=True)
    return states, metrics, trace


def controller_trace(controller, ctrl, i, sigma, metrics, trace):
    """Feed step ``i``'s scores to ``controller`` with the batch count after
    the step, as both host loops do; record the σ the step ran at and the
    state after it in ``trace``; returns the new state."""
    ctrl, _ = controller.update(ctrl, i + 1, metrics["fake_scores"], metrics["real_scores"])
    trace.append({"sigma_in": sigma, "sigma_after": ctrl.std,
                  "score_ratio": ctrl.score_ratio,
                  "last_modification_batch": ctrl.last_modification_batch})
    return ctrl


def port_trajectory(cfg, hp, dtype, state0, batches, sigma, upsample="transpose",
                    narrow=False, controller=None):
    """((parameters, first moments) of both networks, flat, before and after
    each step; metrics; the GAN; the controller trace; the optimizers'
    learning rates) of the port's steps from the JAX ``state0``."""
    gan = GAN(*port_networks(cfg, dtype, upsample, narrow), blurred=True)
    state = create_train_state(gan, hp, device="cpu")
    load_jax_state(state, state0)
    state.n_img = state.n_batches * B
    step = make_train_step(gan, hp)
    lrs = {"generator": state.g_opt.param_groups[0]["lr"],
           "discriminator": state.d_opt.param_groups[0]["lr"]}

    def snapshot():
        return ((flat(state.generator), flat(state.discriminator)),
                (flat_moment(state.g_opt, state.generator),
                 flat_moment(state.d_opt, state.discriminator)))

    params = [snapshot()]
    metrics = []
    ctrl = controller.init() if controller else None
    trace = []
    for i, reals in enumerate(batches):
        s = ctrl.std if ctrl else sigma
        noise = {k: torch.from_numpy(v.copy())
                 for k, v in draws(jax.random.PRNGKey(KEY0 + i)).items()}
        t0 = time.time()
        m, _ = step(state, torch.from_numpy(reals), s, noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(snapshot())
        if ctrl:
            ctrl = controller_trace(controller, ctrl, i, s, metrics[-1], trace)
        print(f"[port] step {i}: {time.time() - t0:.1f} s", flush=True)
    return params, metrics, gan, trace, lrs


def adam_rate(side, j):
    """The learning rate of network ``j``'s first Adam update from a fresh
    state: an element moves by ``lr·g/(|g| + ε)`` (both bias corrections
    give ``m̂ = g``, ``v̂ = g²``), so the median of ``|Δp|·(|g| + ε)/|g|`` over
    the elements whose gradient is far from 0, with ``g`` read back from the
    first moment."""
    (p0, _), (p1, m1) = [(snap[0][j], snap[1][j]) for snap in side[:2]]
    g = m1 / (1 - BETA1)
    big = np.abs(g) > 1e-3 * np.abs(g).max()
    return float(np.median(np.abs(p1 - p0)[big] * (np.abs(g[big]) + 1e-7) / np.abs(g[big])))


def compare(name, side_a, metrics_a, side_b, metrics_b, step_i):
    """One step's line: ``a`` against the reference ``b``. Each side is a
    list of (parameters, first moments) snapshots; the step's gradient comes
    back from Adam's first moment, ``(m_t − β₁ m_{t−1}) / (1 − β₁)``."""
    line = {"compare": name, "step": step_i, "losses": {}, "update_rel_l2": {},
            "grad_rel_l2": {}, "update_sign_flips": {}}
    for k in sorted(set(metrics_a) & set(metrics_b)):
        a, b = metrics_a[k], metrics_b[k]
        line["losses"][k] = {"got": a, "want": b,
                             "rel": None if b == 0 else abs(a - b) / abs(b)}
    for j, net in enumerate(("generator", "discriminator")):
        (pa0, ma0), (pa1, ma1) = [(s[0][j], s[1][j]) for s in side_a[step_i:step_i + 2]]
        (pb0, mb0), (pb1, mb1) = [(s[0][j], s[1][j]) for s in side_b[step_i:step_i + 2]]
        da, db = pa1 - pa0, pb1 - pb0
        line["update_rel_l2"][net] = rel_l2(da, db)
        if line["update_rel_l2"][net] is None:  # a skipped step on the reference side
            line["update_rel_l2"][f"{net}_norm_got"] = float(np.linalg.norm(da))
            continue
        line["update_sign_flips"][net] = float(np.mean(np.sign(da) != np.sign(db)))
        line["grad_rel_l2"][net] = rel_l2((ma1 - BETA1 * ma0) / (1 - BETA1),
                                          (mb1 - BETA1 * mb0) / (1 - BETA1))
    return line


def hlo_roundings(emit) -> None:
    """Arm 5's JAX step compiled both ways: the bfloat16 roundings (an f32
    value converted to bf16 and straight back to f32 inside one computation)
    each compile keeps, counted by network and pass of the ``op_name`` of the
    convert back to f32, else of the fusion that holds it."""
    arm = ARMS[5]
    cfg = quality.CONFIGS[arm["config"]]
    jhp = JaxHP(batch_size=B, global_batch_size=B)
    jgan = JaxGAN(*jax_networks(cfg, "bfloat16"), blurred=True)
    state0 = jax_state(jgan, jhp, jax.random.PRNGKey(3), cfg.image_shape)
    args = (state0, jnp.asarray(reals_batches(cfg, 1)[0]), jnp.float32(cfg.sigma0),
            jax.random.PRNGKey(KEY0))
    lowered = jax_step(jgan, jhp, donate_state=False).lower(*args)
    counts = {"default": _roundings(lowered.compile().as_text()),
              "exact": _roundings(lowered.compile(
                  compiler_options={"xla_allow_excess_precision": False}).as_text())}
    dropped = collections.Counter()
    for op, n in counts["exact"].items():
        dropped[op] += n - counts["default"].get(op, 0)
    emit({"hlo_roundings": {k: sum(v.values()) for k, v in counts.items()},
          "dropped_by_default": dict(sorted(((k, v) for k, v in dropped.items() if v),
                                            key=lambda kv: -kv[1]))})


def hlo_generator_roundings(emit) -> None:
    """Arm 5's bfloat16 generator alone, per upsampler and ``--fast_gen``:
    the roundings the default compile drops from the exact one in the eval
    forward and in the train forward with its VJP, by the layer whose op
    holds them (:func:`_roundings`' rule; ``jvp``: forward, ``transpose``:
    backward). The port keeps the float32 sums exactly where a layer's
    forward loses them here (``models/dcgan.py``'s ``f32_sums``)."""
    cfg = quality.CONFIGS[ARMS[5]["config"]]
    res = cfg.image_shape[0]
    z = jnp.asarray(np.random.RandomState(0).rand(B, quality.LATENT).astype(np.float32))
    cot = jnp.asarray(np.random.RandomState(1).randn(B, *cfg.image_shape).astype(np.float32))
    for upsample in ("transpose", "resize"):
        for fast in (False, True):
            kw = {"bn_dtype": jnp.bfloat16, "output_f32": False} if fast else {}
            gen = jmodels.celeba_generator(res, upsample=upsample,
                                           compute_dtype=jnp.bfloat16, **kw)
            variables = gen.init(jax.random.PRNGKey(0), z, train=False)

            def evaluate(v, z):
                return gen.apply(v, z, train=False)

            def train_vjp(v, z):
                def out(params):
                    return gen.apply({"params": params, "batch_stats": v["batch_stats"]}, z,
                                     train=True, mutable=["batch_stats"])[0]
                return jax.vjp(out, v["params"])[1](cot.astype(
                    jnp.bfloat16 if fast else jnp.float32))

            for mode, fn in (("eval", evaluate), ("train+vjp", train_vjp)):
                lowered = jax.jit(fn).lower(variables, z)
                counts = [_roundings(c.as_text(), depth=3) for c in (
                    lowered.compile(), lowered.compile(
                        compiler_options={"xla_allow_excess_precision": False}))]
                dropped = {k: v - counts[0].get(k, 0) for k, v in counts[1].items()
                           if v > counts[0].get(k, 0)}
                emit({"hlo_generator": {"upsample": upsample, "fast_gen": fast, "mode": mode},
                      "exact": sum(counts[1].values()), "default": sum(counts[0].values()),
                      "dropped_by_default": dict(sorted(dropped.items()))})


def _roundings(text: str, depth: int = 2) -> collections.Counter:
    comp, converts, owner = None, {}, {}
    for line in text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head and not line.startswith(" "):
            comp = head.group(1)
            continue
        m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = (\w+)\[[^=]*? convert\(%([\w.\-]+)\)", line)
        if m:
            op = re.search(r'op_name="([^"]*)"', line)
            converts[(comp, m.group(1))] = (m.group(2), m.group(3), op and op.group(1))
        call = re.search(r"calls=%([\w.\-]+)", line)
        if call:
            op = re.search(r'op_name="([^"]*)"', line)
            owner[call.group(1)] = op.group(1) if op else "?"
    out = collections.Counter()
    for (comp, _), (dtype, src, op) in converts.items():
        if dtype == "f32" and converts.get((comp, src), ("",))[0] == "bf16":
            # The convert's own op, else the op of the fusion that holds it.
            op = re.sub(r"^jit\(\w+\)/", "", op or owner.get(comp, comp))
            # The network and the pass (jvp: forward, transpose: backward),
            # or with ``depth`` 3 the layer too.
            out["/".join(p for p in op.split("/")[:depth])] += 1
    return out


def run_arm(n: int, emit, narrow: bool = False) -> None:
    """Arm ``n``'s steps on both sides, a line per step and comparison to
    ``emit``; ``narrow``: the layout at :data:`NARROW_G` / :data:`NARROW_D`."""
    arm = ARMS[n]
    cfg = quality.CONFIGS[arm["config"]]
    dtype = arm.get("dtype", "float32")
    upsample = arm.get("upsample", "transpose")
    hp_kw = arm.get("hp", {})
    sigma = float(cfg.sigma0)
    jhp = JaxHP(batch_size=B, global_batch_size=B, **hp_kw)
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B, **hp_kw)
    controllers = ((AdaptiveBlurController(max_value=sigma, **ADAPTIVE),
                    JaxAdaptive(max_value=sigma, **ADAPTIVE))
                   if arm.get("adaptive") else (None, None))
    jgan = JaxGAN(*jax_networks(cfg, dtype, upsample, narrow), blurred=True)
    state0 = jax.tree_util.tree_map(
        np.asarray, jax_state(jgan, jhp, jax.random.PRNGKey(3), cfg.image_shape))
    batches = reals_batches(cfg, arm["steps"])
    port_params, port_metrics, gan, port_trace, port_lrs = port_trajectory(
        cfg, hp, dtype, state0, batches, sigma, upsample, narrow, controllers[0])
    scratch = (copy.deepcopy(gan.generator), copy.deepcopy(gan.discriminator))
    modes = ("exact", "default") if dtype != "float32" else ("exact",)
    jax_sides, jax_traces = {}, {}
    for mode in modes:
        states, metrics, jax_traces[mode] = jax_trajectory(
            jgan, jhp, state0, batches, sigma, dtype, mode, controllers[1])
        jax_sides[mode] = ([jax_side(scratch, s) for s in states], metrics)
    pairs = [("port_vs_jax_" + m, (port_params, port_metrics), jax_sides[m]) for m in modes]
    if "default" in jax_sides:
        pairs.append(("jax_default_vs_jax_exact", jax_sides["default"], jax_sides["exact"]))
    head = {"arm": n, "config": cfg.name, "dtype": dtype, "hp": hp_kw}
    if upsample != "transpose":
        head["upsample"] = upsample
    if arm.get("adaptive"):
        head["adaptive"] = ADAPTIVE
    if narrow:
        head["narrow"] = True
    for name, (pa, ma), (pb, mb) in pairs:
        for i in range(arm["steps"]):
            line = dict(head, **compare(name, pa, ma[i], pb, mb[i], i))
            if name.startswith("port_vs_jax_"):
                if "g_learning_rate" in hp_kw and i == 0:
                    nets = ("generator", "discriminator")
                    line["adam_lr"] = {
                        "port_set": port_lrs,
                        "port": {net: adam_rate(pa, j) for j, net in enumerate(nets)},
                        "jax": {net: adam_rate(pb, j) for j, net in enumerate(nets)}}
                if port_trace:
                    jt = jax_traces[name[len("port_vs_jax_"):]][i]
                    line["controller"] = {"port": port_trace[i], "jax": jt,
                                          "sigma_equal": port_trace[i]["sigma_after"]
                                          == jt["sigma_after"]}
            emit(line)


def running_stats(module) -> np.ndarray:
    """The BatchNorm running means and variances of ``module``, flat."""
    return np.concatenate([b.detach().to(torch.float64).reshape(-1).numpy()
                           for name, b in module.named_buffers() if "running_" in name])


def long_arm(n: int, steps: int, emit, narrow: bool = False) -> None:
    """Float32 arm ``n`` for ``steps`` steps on both sides from one JAX
    state (the draws handed over as :func:`run_arm` does), each side running
    freely. After each step, one line: the losses; the relative L2 of each
    network's parameters and of the generator's running statistics against
    JAX's at the same step (JAX's state read into a copy of the port's
    networks); the eval generator's output on the first 64 eval latents,
    its largest difference and relative L2; and JAX's output's largest
    change since step 0, the scale the difference is read against."""
    arm = ARMS[n]
    cfg = quality.CONFIGS[arm["config"]]
    if arm.get("dtype", "float32") != "float32" or arm.get("adaptive"):
        raise SystemExit(f"arm {n}: --long takes the float32 arms at a fixed sigma")
    upsample = arm.get("upsample", "transpose")
    hp_kw = arm.get("hp", {})
    sigma = float(cfg.sigma0)
    jhp = JaxHP(batch_size=B, global_batch_size=B, **hp_kw)
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B, **hp_kw)
    jgan = JaxGAN(*jax_networks(cfg, "float32", upsample, narrow), blurred=True)
    jstate = jax.tree_util.tree_map(
        np.asarray, jax_state(jgan, jhp, jax.random.PRNGKey(3), cfg.image_shape))
    gan = GAN(*port_networks(cfg, "float32", upsample, narrow), blurred=True)
    state = create_train_state(gan, hp, device="cpu")
    load_jax_state(state, jstate)
    port_step, jstep = make_train_step(gan, hp), jax.jit(jax_step(jgan, jhp, donate_state=False))
    jgen = jax.jit(lambda p, st, z: jgan.generate(p, st, z, train=False)[0])
    scratch = (copy.deepcopy(gan.generator), copy.deepcopy(gan.discriminator))
    z = quality.eval_latents()[:2 * B]
    out0 = np.asarray(jgen(jstate.g_params, jstate.g_stats, jnp.asarray(z)), np.float64)
    head = {"long": n, "config": cfg.name, "hp": hp_kw}
    if narrow:
        head["narrow"] = True
    for i, reals in enumerate(reals_batches(cfg, steps)):
        key = jax.random.PRNGKey(KEY0 + i)
        t0 = time.time()
        jstate, jm, _ = jstep(jstate, jnp.asarray(reals), jnp.float32(sigma), key)
        jstate = jax.tree_util.tree_map(np.asarray, jstate)
        noise = {k: torch.from_numpy(v.copy()) for k, v in draws(key).items()}
        pm, _ = port_step(state, torch.from_numpy(reals), sigma, noise=noise)
        flax_to_torch(scratch[0], jstate.g_params, jstate.g_stats)
        flax_to_torch(scratch[1], jstate.d_params)
        with torch.no_grad():
            got = gan.generate(torch.from_numpy(z), train=False).permute(0, 2, 3, 1)
        got = got.to(torch.float64).numpy()
        want = np.asarray(jgen(jstate.g_params, jstate.g_stats, jnp.asarray(z)), np.float64)
        losses = {}
        for k in sorted(set(pm) & set(jm)):
            a, b = float(pm[k]), float(jm[k])
            losses[k] = {"got": a, "want": b, "rel": None if b == 0 else abs(a - b) / abs(b)}
        emit(dict(head, step=i, losses=losses,
                  params_rel_l2={"generator": rel_l2(flat(gan.generator), flat(scratch[0])),
                                 "discriminator": rel_l2(flat(gan.discriminator),
                                                         flat(scratch[1]))},
                  running_stats_rel_l2=rel_l2(running_stats(gan.generator),
                                              running_stats(scratch[0])),
                  eval_out={"max_abs": float(np.abs(got - want).max()),
                            "rel_l2": rel_l2(got.ravel(), want.ravel()),
                            "jax_change_since_step0_max_abs": float(np.abs(want - out0).max())},
                  seconds=round(time.time() - t0, 1)))


def generator_rounding(emit) -> None:
    """How far float32 rounding alone moves the celeba64 generator, per
    upsampler: JAX's float32 and the port's float32 train-mode forward and
    parameter VJP (one random cotangent) against JAX's in float64 (BatchNorm
    and the output too), from the same ``PRNGKey(0)`` weights. A port whose
    distance to that reference is of the size of JAX's own float32 one
    differs from JAX by rounding, not by what it computes."""
    cfg = quality.CONFIGS["celeba64"]
    res = cfg.image_shape[0]
    z = np.random.RandomState(0).rand(B, quality.LATENT).astype(np.float32)
    cot = np.random.RandomState(1).randn(B, *cfg.image_shape).astype(np.float32)
    for upsample in ("transpose", "resize"):
        variables = jmodels.celeba_generator(res, upsample=upsample).init(
            jax.random.PRNGKey(0), jnp.asarray(z), train=False)
        port = quality.networks(cfg, upsample=upsample)[0]
        flax_to_torch(port, variables["params"], variables["batch_stats"])
        port.train()
        out = port(torch.from_numpy(z)).permute(0, 2, 3, 1)
        (out * torch.from_numpy(cot)).sum().backward()
        sides = {"port_f32": (out.detach().to(torch.float64).numpy(),
                              np.concatenate([p.grad.to(torch.float64).reshape(-1).numpy()
                                              for p in port.parameters()]))}
        scratch = copy.deepcopy(port)
        with jax.enable_x64(True):
            for name, dt in (("jax_f32", jnp.float32), ("jax_f64", jnp.float64)):
                kw = dict(output_f32=False, bn_dtype=jnp.float64) if dt == jnp.float64 else {}
                gen = jmodels.celeba_generator(res, upsample=upsample, compute_dtype=dt, **kw)
                v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables)

                def forward(params):
                    return gen.apply({"params": params, "batch_stats": v["batch_stats"]},
                                     jnp.asarray(z, dt), train=True, mutable=["batch_stats"])[0]

                y, vjp = jax.vjp(forward, v["params"])
                (grads,) = vjp(jnp.asarray(cot, y.dtype))
                grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
                sides[name] = (np.asarray(y, np.float64), jax_flat(scratch, grads))
        ref_out, ref_grad = sides.pop("jax_f64")
        emit({"generator_rounding": upsample, "config": cfg.name, "against": "jax_f64",
              **{name: {"out_max_abs": float(np.abs(o - ref_out).max()),
                        "grad_rel_l2": rel_l2(g, ref_grad)}
                 for name, (o, g) in sides.items()}})


# ---------------------------------------------------------------------------
# The whole run's schedule, host only
# ---------------------------------------------------------------------------


def index_images(n: int) -> np.ndarray:
    """(n, 8, 8, 3) uint8 images whose first pixel spells the index in base 256."""
    images = np.zeros((n, 8, 8, 3), np.uint8)
    idx = np.arange(n)
    for c in range(3):
        images[:, 0, 0, c] = (idx >> (8 * c)) & 0xFF
    return images


def decode(batch: np.ndarray) -> np.ndarray:
    b = np.asarray(batch).astype(np.int64)
    return b[:, 0, 0, 0] | (b[:, 0, 0, 1] << 8) | (b[:, 0, 0, 2] << 16)


TINY_G = dict(latent_size=4, init_hw=(2, 2), init_features=4, blocks=((4, 2), (4, 2)),
              out_channels=3)


def _metrics(sigma):
    return {"disc_loss": 0.0, "gen_loss": 0.0, "did_gen_step": 1.0, "std": sigma,
            "real_scores": 0.0, "fake_scores": 0.0}


def port_schedule(cfg, examples, seed, images, log_dir):
    gan = GAN(DCGANGenerator(**TINY_G), DCGANDiscriminator(channels=(4,), image_hw=(8, 8)),
              latent_size=TINY_G["latent_size"])
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B)
    tr = Trainer(gan, hp, ArrayDataset(images), device="cpu",
                 trainer_config=TrainerConfig(log_dir=log_dir, seed=seed,
                                              sample_grid_every_n_examples=0,
                                              checkpoint_every_n_examples=0,
                                              image_summaries_interval_batches=0),
                 blur_controller=BlurDecayController(total_n_training_examples=examples,
                                                     max_value=cfg.sigma0))
    sigmas, indices = [], []

    def record(state, reals, sigma):
        sigmas.append(np.float32(sigma))
        indices.append(decode(reals.numpy()))
        state.n_img += reals.shape[0]
        state.n_batches += 1
        return ({k: torch.tensor(v) for k, v in _metrics(sigma).items()},
                torch.zeros(reals.shape[0], 3, 8, 8))

    tr.step_fn = record
    tr.fit(total_examples=examples)
    tr.close()
    return np.array(sigmas), np.stack(indices)


def jax_schedule(cfg, examples, seed, images, log_dir):
    jgan = JaxGAN(jmodels.DCGANGenerator(**TINY_G),
                  jmodels.DCGANDiscriminator(channels=(4,), dropout_rate=0.0),
                  latent_size=TINY_G["latent_size"], blurred=True)
    jhp = JaxHP(batch_size=B, global_batch_size=B)
    tr = JaxTrainer(jgan, jhp, JaxArrayDataset(images),
                    trainer_config=JaxTrainerConfig(log_dir=log_dir, seed=seed,
                                                    sample_grid_every_n_examples=0,
                                                    checkpoint_every_n_examples=0,
                                                    image_summaries_interval_batches=0),
                    blur_controller=JaxBlurDecay(total_n_training_examples=examples,
                                                 max_value=cfg.sigma0))
    sigmas, indices = [], []
    fakes = jnp.zeros((B, 8, 8, 3))

    def record(state, batch, sigma, key):
        sigmas.append(np.float32(sigma))
        indices.append(decode(batch))
        return state, {k: jnp.float32(v) for k, v in _metrics(float(sigma)).items()}, fakes

    tr.step_fn = record
    tr.fit(total_examples=examples)
    tr.close()
    return np.array(sigmas), np.stack(indices)


def schedule_check(seeds, emit) -> None:
    for name, examples in RUN_EXAMPLES.items():
        cfg = quality.CONFIGS[name]
        images = index_images(cfg.corpus_n)
        for seed in seeds:
            t0 = time.time()
            with tempfile.TemporaryDirectory() as d:
                ps, pi = port_schedule(cfg, examples, seed, images, os.path.join(d, "port"))
                js, ji = jax_schedule(cfg, examples, seed, images, os.path.join(d, "jax"))
            line = {"schedule": name, "examples": examples, "seed": seed,
                    "steps": [len(ps), len(js)],
                    "sigma_equal": bool(len(ps) == len(js) and np.array_equal(ps, js)),
                    "batches_equal": bool(pi.shape == ji.shape and np.array_equal(pi, ji)),
                    "sigma_first_last": [float(ps[0]), float(ps[-1])],
                    "epochs": round(len(ps) * B / cfg.corpus_n, 3),
                    "seconds": round(time.time() - t0, 1)}
            if len(ps) == len(js) and not line["sigma_equal"]:
                line["sigma_max_abs_diff"] = float(np.max(np.abs(ps.astype(np.float64) - js)))
            emit(line)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arms", default="1,2,3,4,5", help="the step arms ('' for none)")
    p.add_argument("--schedule", action="store_true", help="also the whole-run schedule check")
    p.add_argument("--hlo", action="store_true",
                   help="also arm 5's bfloat16 roundings in JAX's two compiles, the step's "
                        "and its generator's")
    p.add_argument("--rounding", action="store_true",
                   help="also the celeba64 generator's float32 rounding on both sides "
                        "against JAX's float64, per upsampler")
    p.add_argument("--long", default="", help="float32 arms to run for LONG_STEPS steps, "
                                              "both sides free (e.g. 1,2,3)")
    p.add_argument("--seeds", default="0,6", help="the schedule check's seeds")
    p.add_argument("--threads", type=int, default=4, help="torch intra-op threads")
    p.add_argument("--out", default="", help="also append every line to this JSONL file")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    logging_mod._summary_writer = lambda log_dir: None

    def emit(line):
        s = json.dumps(line)
        print(s, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(s + "\n")

    for n in (int(a) for a in args.arms.split(",") if a):
        run_arm(n, emit)
    for n in (int(a) for a in args.long.split(",") if a):
        long_arm(n, LONG_STEPS, emit)
    if args.rounding:
        generator_rounding(emit)
    if args.hlo:
        hlo_roundings(emit)
        hlo_generator_roundings(emit)
    if args.schedule:
        schedule_check([int(s) for s in args.seeds.split(",")], emit)


if __name__ == "__main__":
    main()
