"""The port's FLOP counts of the CelebA networks and train step against XLA's
cost analysis of the JAX package's, per aten op.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_flop_gap.py --resolution 128 --batch 2

prints one JSON line: for the generator's and the critic's eval-mode forward
and for one default train step (float32, the plain blur on both sides:
``blur_impl="torch"`` / ``"einsum"``), ``FlopCounterMode``'s default count
per aten op (every tap of every convolution the port's ops compute: the SAME
padding it adds with ``F.pad`` and the row and column its transposed
convolutions compute and crop), ``bench.flop_counts``'s (each convolution by
the taps that read an input), and XLA's ``cost_analysis`` of the JAX
function at the same shapes, which counts the taps that read an input and
every elementwise operation too. ``tests/test_torch_bench.py`` holds the
forwards to XLA's at a small shape.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import torch
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from blurred_gan_tpu import models as jmodels
from blurred_gan_tpu import train as jtrain
from blurred_gan_tpu_torch.bench import flop_counts
from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step

SIGMA = 2.5


def xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


def xla_forwards(resolution: int, batch: int) -> dict:
    """XLA's FLOPs of the JAX generator's and critic's eval-mode forward."""
    gen, critic = jmodels.celeba_generator(resolution), jmodels.celeba_discriminator(resolution)
    key = jax.random.PRNGKey(0)
    g_vars = gen.init(key, jnp.zeros((1, 100)), train=False)
    d_vars = critic.init(key, jnp.zeros((1, resolution, resolution, 3)), train=False)
    return {"generator": xla_flops(lambda v, z: gen.apply(v, z, train=False), g_vars,
                                   jnp.zeros((batch, 100))),
            "critic": xla_flops(lambda v, x: critic.apply(v, x, train=False), d_vars,
                                jnp.zeros((batch, resolution, resolution, 3)))}


def xla_step(resolution: int, batch: int) -> float:
    """XLA's FLOPs of one default JAX train step, the plain (einsum) blur."""
    gan = jtrain.GAN(jmodels.celeba_generator(resolution),
                     jmodels.celeba_discriminator(resolution), blurred=True, blur_impl="einsum")
    hp = jtrain.BlurredWGANGPHyperParameters(batch_size=batch, global_batch_size=batch)
    state = jtrain.create_train_state(gan, hp, jax.random.PRNGKey(0), (resolution, resolution, 3))
    step = jtrain.make_train_step(gan, hp, donate_state=False)
    return xla_flops(step, state, jnp.zeros((batch, resolution, resolution, 3)),
                     jnp.float32(SIGMA), jax.random.PRNGKey(3))


def port_forwards(resolution: int, batch: int) -> dict:
    """``bench.flop_counts`` of the port's generator's and critic's eval-mode
    forward."""
    gen, critic = celeba_generator(resolution).eval(), celeba_discriminator(resolution).eval()
    with torch.no_grad():
        return {"generator": sum(flop_counts(lambda: gen(torch.zeros(batch, 100)),
                                             gen).values()),
                "critic": sum(flop_counts(
                    lambda: critic(torch.zeros(batch, 3, resolution, resolution)),
                    critic).values())}


def port_step(resolution: int, batch: int) -> dict:
    """One default port step, plain blur: {"default": per-op counts of
    FlopCounterMode's own formulas, "taps": ``bench.flop_counts``,
    "default_zero_backward": the part of "default" that convolution
    backwards on all-zero output gradients make}."""
    out = {"default_zero_backward": 0}

    def conv_backward(grad_out, *args, out_val=None, **kwargs):
        n = flop_counter.conv_backward_flop(grad_out, *args, out_val=out_val, **kwargs)
        if not grad_out.any():
            out["default_zero_backward"] += n
        return n

    conv_backward._get_raw = True
    for name in ("default", "taps"):
        gan = GAN(celeba_generator(resolution), celeba_discriminator(resolution),
                  blur_impl="torch")
        hp = BlurredWGANGPHyperParameters(batch_size=batch, global_batch_size=batch)
        state = create_train_state(gan, hp, device="cpu")
        step = make_train_step(gan, hp)
        reals = torch.zeros((batch, resolution, resolution, 3))

        def run():
            step(state, reals, torch.tensor(SIGMA))

        if name == "default":
            with FlopCounterMode(display=False, custom_mapping={
                    torch.ops.aten.convolution_backward: conv_backward}) as counter:
                run()
            out[name] = {str(k): int(v) for k, v in counter.get_flop_counts()["Global"].items()}
        else:
            out[name] = flop_counts(run, gan.generator, gan.discriminator)
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch", type=int, default=2)
    args = p.parse_args()
    r, b = args.resolution, args.batch
    fwd = port_forwards(r, b)
    steps = port_step(r, b)
    print(json.dumps({"resolution": r, "batch": b, "forward_taps": fwd,
                      "forward_xla": xla_forwards(r, b), "step": steps,
                      "step_totals": {k: sum(v.values()) for k, v in steps.items()
                                      if isinstance(v, dict)},
                      "step_xla": xla_step(r, b)}), flush=True)


if __name__ == "__main__":
    main()
