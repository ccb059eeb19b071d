"""The inputs of a run, made from ``--seed``: the weights, the corpus, the
latents and the seeds of the program's own streams. The same seed gives the
same inputs; both the program and the reference receive them.

Weights are made on the run's device by a seeded ``torch.Generator``, one
uniform draw for all of a network's kernels, each scaled to its
glorot-uniform bound (tf.keras's initialiser); BatchNorm scales are 1, biases
and running means 0, running variances 1. Corpus pixels are uniform uint8
noise, one draw on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import nets

_TAGS = {"weights": 1, "corpus": 2, "program": 3, "latents": 4, "order": 5, "check": 6}


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    """A ``bits``-bit seed for one stream of the run, from ``--seed``."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    word = np.random.SeedSequence([seed, _TAGS[tag]]).generate_state(1, np.uint64)[0]
    return int(word) >> (64 - bits)


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _network(shapes, rng: torch.Generator, device) -> Dict[str, torch.Tensor]:
    kernels = [(n, s) for n, s, init in shapes if init == "glorot"]
    flat = torch.rand(sum(int(np.prod(s)) for _, s in kernels), generator=rng, device=device)
    out, at = {}, 0
    for name, shape, init in shapes:
        if init == "glorot":
            size = int(np.prod(shape))
            limit = nets.glorot_limit(shape)
            out[name] = (flat[at:at + size] * (2 * limit) - limit).reshape(shape)
            at += size
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
    return out


def weights(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"generator": {...}, "critic": {...}}``, float32 on ``device``."""
    rng = device_generator(seed, "weights", device)
    g = nets.generator_shapes(config["generator"], config["latent_size"],
                              config["image_shape"][2])
    d = nets.critic_shapes(config["critic"], config["image_shape"])
    return {"generator": _network(g, rng, device), "critic": _network(d, rng, device)}


def corpus_on_device(config: dict, seed: int, device) -> torch.Tensor:
    """The ``(corpus_size, H, W, C)`` uint8 corpus on ``device``."""
    rng = device_generator(seed, "corpus", device)
    shape = (config["corpus_size"], *config["image_shape"])
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=rng, device=device)


def corpus(config: dict, seed: int, device) -> np.ndarray:
    """The corpus made on ``device`` and returned in host memory, where the
    port's memory-resident dataset takes it."""
    return corpus_on_device(config, seed, device).cpu().numpy()
