"""The blur kernel's σ mode at the main path's sizes, on the card.

    python tests/torch_blur_tiling.py [--out chiprun_out/blur_tiling.jsonl]

Builds the kernel with ``-Xptxas -v`` (registers and spills of every
instantiation), prints both modes' registers, local bytes and blocks per SM
at each size, then holds σ mode against its plain version (the band
matrices of ``blur_matrix`` and two matmuls; rtol and atol 1e-5, float32
both sides in another summation order) across σ and shapes, the scalar path
and planes below the 3-tap floor included. Then, at the main path's sizes
(96 planes of 28², 64², 128² and 256² at σ 2.5, and 192 planes of 128² at
σ 5, the critic's call on ``cat([fakes, reals])``, and at σ 100, a band
wider than the window), it times σ mode (at the tile height the kernel takes
for the width), T mode on the band matrices and the two cuBLAS float32
matmuls (``blur_planes_reference`` on prebuilt matrices), each as 50 calls
captured in a CUDA graph and replayed, by CUDA events, in turns; beside the
bound by bytes (each plane read once and written once at 3.35 TB/s). One
JSON line per (size, arm). Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blurred_gan_tpu_torch.ops import blur_cuda  # noqa: E402
from blurred_gan_tpu_torch.ops.blur import blur_matrix  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SIGMAS = (0.05, 0.3, 2.5, 5.0, 23.5, 100.0)
# (planes, h, w): the four sizes, non-square planes, widths off the float4 path.
CHECK_SHAPES = ((96, 28, 28), (96, 64, 64), (96, 128, 128), (24, 256, 256), (6, 16, 32),
                (6, 36, 30), (3, 20, 12), (2, 8, 30), (4, 37, 5), (3, 300, 520), (2, 40, 1024),
                (5, 1, 1), (5, 3, 3))
TIMED = ((96, 28, 2.5), (96, 64, 2.5), (96, 128, 2.5), (96, 256, 2.5), (192, 128, 5.0),
         (192, 128, 100.0))
PEAK_BYTES_PER_S = 3.35e12


def graphed_ms(fn, calls=50, replays=4):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()

    def once():
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (calls * replays)
    return once


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_blur_tiling: no CUDA device")
    from blurred_gan_tpu_torch.entry import card_line

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(blur_cuda.build(verbose=True), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for h in (28, 64, 128, 256):
        for mode in ("sigma", "t"):
            print(f"[attributes] {mode} {h}x{h}: {blur_cuda.kernel_attributes(mode, h, h)}",
                  flush=True)

    worst = 0.0
    for p, h, w in CHECK_SHAPES:
        x = torch.randn(p, h, w, device=dev, generator=gen)
        for sigma in SIGMAS:
            s = torch.tensor(sigma, device=dev)
            want = blur_cuda.blur_sigma_reference(x, s, max(h, w))
            got = blur_cuda.blur_sigma_forward(x, s, max(h, w))
            torch.testing.assert_close(got, want, **TOL,
                                       msg=lambda m: f"{p}x{h}x{w} sigma {sigma}: {m}")
            worst = max(worst, float((got - want).abs().max()))
    # The scalar path: a contiguous view at an offset of one float.
    x = torch.randn(1 + 4 * 32 * 32, device=dev, generator=gen)[1:].view(4, 32, 32)
    s = torch.tensor(2.0, device=dev)
    torch.testing.assert_close(blur_cuda.blur_sigma_forward(x, s, 32),
                               blur_cuda.blur_sigma_reference(x, s, 32), **TOL)
    torch.cuda.synchronize()
    print(f"[check] σ mode against the plain version: max |err| {worst:.3e}",
          flush=True)

    lines = []
    for p, res, sigma in TIMED:
        x = torch.randn(p, res, res, device=dev, generator=gen)
        s = torch.tensor(sigma, device=dev)
        t = blur_matrix(s, res)
        arms = {"sigma": lambda: blur_cuda._launch_sigma(x, s, res),
                "t_mode": lambda: blur_cuda._launch(x, t, t),
                "cublas": lambda: blur_cuda.blur_planes_reference(x, t, t)}
        timers = {k: graphed_ms(fn) for k, fn in arms.items()}
        runs = {k: [] for k in arms}
        for order in (list(arms), list(arms)[::-1]):
            for k in order:
                runs[k].append(timers[k]())
        bound_us = 1e6 * 8 * p * res * res / PEAK_BYTES_PER_S
        for k, v in runs.items():
            line = {"planes": p, "res": res, "sigma": sigma, "arm": k, "us": min(v) * 1e3,
                    "runs_us": [r * 1e3 for r in v], "bound_us": bound_us,
                    "device": torch.cuda.get_device_name(0)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
