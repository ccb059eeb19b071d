"""Sampling requests from one client in a closed loop: each request is one
call of ``train.step.make_sample_fn``'s eval-mode generator on its latents,
as the port's callers make it, and the next is sent once the last is
complete. A request kind (``requests``: ``size``, ``count`` a block, ``to``)
says where its caller takes the images, and so when it is complete:

- ``"host"``: in host memory, as ``Trainer._sample_grid`` takes a grid's
  (NHWC, float32, ``.cpu()`` into pageable memory);
- ``"device"``: on the card once its kernels have run, as the metric
  feeders and ``Trainer.evaluate`` take theirs (they score them there).

Requests come in blocks (each block the same multiset of requests, in an
order drawn from the seed), with latents made from the seed on the device
before the window (a pool of ``pool_blocks`` blocks, reused in turn past
it). The window ends at the first block boundary after ``--seconds``
(``trace_seconds`` with ``--trace 1``). Set-up builds the generator from
the seed's weights and runs every request kind twice.

After the window ``check_requests`` requests of the first ``check_blocks``
blocks, drawn from the seed with a request of the largest size among them,
are held against the reference's generator on the same latents, image by
image (:func:`image_gap`).

``sample_img_s``: the window's images over the window; ``sample_p95_ms``:
the 95th percentile of all the window's request latencies, from the call to
the request's completion.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import List

import numpy as np
import torch

from portbench import flops, inputs, port
from portbench import trace as tr
from portbench.context import Context, Outcome
from portbench.reference import nets

DESTINATIONS = ("host", "device")


class Plan:
    """The request sequence of a run: sizes, destinations, latent rows and
    the checked set."""

    def __init__(self, params: dict, seed: int):
        kinds = params["requests"]
        for kind in kinds:
            if kind["to"] not in DESTINATIONS:
                raise ValueError(f"a request goes to one of {DESTINATIONS}, not {kind['to']!r}")
        self.block = [(k["size"], k["to"]) for k in kinds for _ in range(k["count"])]
        self.block_images = sum(size for size, _ in self.block)
        self.largest = max(size for size, _ in self.block)
        self.pool = params["pool_blocks"]
        order = np.random.RandomState(inputs.sub_seed(seed, "order", bits=31))
        self.orders = [order.permutation(len(self.block)) for _ in range(self.pool)]
        check = np.random.RandomState(inputs.sub_seed(seed, "check", bits=31))
        n = params["check_blocks"] * len(self.block)
        largest = [r for r in range(n) if self.size(r) == self.largest]
        first = int(check.choice(largest))
        rest = [r for r in range(n) if r != first]
        picks = check.choice(rest, params["check_requests"] - 1, replace=False)
        self.checked = sorted([first, *map(int, picks)])

    def kind(self, r: int):
        """The request's ``(size, to)``."""
        b, j = divmod(r, len(self.block))
        return self.block[self.orders[b % self.pool][j]]

    def size(self, r: int) -> int:
        return self.kind(r)[0]

    def rows(self, r: int) -> slice:
        """The request's rows of the latent pool."""
        b, j = divmod(r, len(self.block))
        order = self.orders[b % self.pool]
        start = (b % self.pool) * self.block_images + sum(self.block[i][0] for i in order[:j])
        return slice(start, start + self.block[order[j]][0])


def to_host(images: torch.Tensor) -> torch.Tensor:
    """A grid's images as ``Trainer._sample_grid`` fetches them: NHWC float32
    in host memory."""
    return images.detach().permute(0, 2, 3, 1).to(torch.float32).cpu()


def run(ctx: Context) -> Outcome:
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    plan = Plan(params, ctx.seed)
    rng = inputs.device_generator(ctx.seed, "latents", dev)
    latents = torch.rand((plan.pool * plan.block_images, cfg["latent_size"]), generator=rng,
                         device=dev)
    sample = port.sampler(cfg, dev, inputs.weights(cfg, ctx.seed, dev)["generator"])
    ctx.phase("latents, weights and generator")
    sync = (lambda: torch.cuda.current_stream(dev).synchronize()) if dev.type == "cuda" \
        else (lambda: None)

    def request(z: torch.Tensor, to: str) -> torch.Tensor:
        """One request, complete when this returns: NHWC images in host
        memory, or NCHW images on the card."""
        out = sample(z)
        if to == "host":
            return to_host(out)
        sync()
        return out

    for size, to in sorted(set(plan.block)):
        for _ in range(2):
            request(latents[:size], to)
    ctx.phase("warm-up")
    per_block = len(plan.block)
    latencies: List[float] = []
    kept = {}
    images = failed = 0
    span = (lambda: tr.mark("request")) if ctx.trace else contextlib.nullcontext
    with tr.capture(ctx.trace) as cap:
        start = time.perf_counter()
        tr.instant("window_start")
        r = 0
        seconds = min(ctx.seconds, params["trace_seconds"]) if ctx.trace else ctx.seconds
        while r % per_block or time.perf_counter() - start < seconds:
            size, to = plan.kind(r)
            z = latents[plan.rows(r)]
            t0 = time.perf_counter()
            with span():
                out = request(z, to)
            latencies.append(time.perf_counter() - t0)
            images += out.shape[0]
            failed += out.shape[0] != size
            if r in plan.checked:
                kept[r] = out.clone()  # after its latency: a copy the program cannot reuse
            r += 1
        end = time.perf_counter()
        tr.instant("window_end")
    ctx.phase("window")
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = {q: out.cpu() for q, out in kept.items()}
    del sample
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = ctx.checks()
    weights = inputs.weights(cfg, ctx.seed, dev)["generator"]
    gaps = []
    for q in plan.checked:
        if q not in kept:
            checks.fail("image_gap", f"request {q} never completed")
            break
        program = kept[q].permute(0, 3, 1, 2) if plan.kind(q)[1] == "host" else kept[q]
        gaps.append(image_gap(program, reference_images(cfg, weights, latents[plan.rows(q)])))
    else:
        worst = int(np.argmax(gaps))
        checks.add("image_gap", gaps[worst], f"request {plan.checked[worst]}")
    ctx.phase("reference")
    return Outcome(
        setup_s=start - ctx.process_start,
        metrics={"sample_img_s": images / (end - start),
                 "sample_p95_ms": float(np.percentile(latencies, 95)) * 1e3},
        attempted=len(latencies), failed=failed, checks=checks, memory_peak_bytes=memory,
        trace=cap.trace,
        facts={"images": images, "requests": len(latencies),
               "generator_flops_per_image": flops.generator_forward_per_image(cfg)})


@torch.no_grad()
def reference_images(cfg: dict, weights, latents: torch.Tensor, precision: str = "float32",
                     block: int = 250) -> torch.Tensor:
    """The reference generator's eval-mode images, in blocks of rows."""
    return torch.cat([nets.generate(weights, latents[i:i + block], cfg["generator"],
                                    train=False, precision=precision).cpu()
                      for i in range(0, latents.shape[0], block)])


def image_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst image's gap: ``‖p − r‖ / ‖r‖`` over its pixels."""
    if program.shape != reference.shape:
        return float("inf")
    diff = (program.to(torch.float32) - reference).flatten(1).norm(dim=1)
    gap = (diff / reference.flatten(1).norm(dim=1)).max()
    return float(gap) if torch.isfinite(gap) else float("inf")
