"""The readings that a cell's correctness limits are set from, at the cell's
own size, on the seeds given; one JSON line a seed, with each number beside
the cell's limit and whether the reading passes them all (``correct``):

    python -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--precision fp8|tf32] [--fault half_batch]

Each reading puts the plain reference in the program's place, computed
in a lower precision than the configuration states (``--precision``: fp8 for
bfloat16, TF32 for float32) or with a planted fault (``--fault half_batch``:
a training step that makes every fake of its batch and takes its means over
the first half of the batch), and reads the numbers the cell's comparison
reads against the float32 reference. A control or a fault that the
comparison catches reads ``"correct": false``. The benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from portbench import inputs, port
from portbench.checks import Checks
from portbench.reference.precision import PRECISIONS
from portbench.spec import Spec


def train_readings(spec: Spec, cell: dict, seed: int, dev, precision: str,
                   rows: Optional[int]) -> Checks:
    traffic = spec.traffic(cell["traffic"])
    cfg = cell["config"]
    images = inputs.corpus_on_device(cfg, seed, dev)
    program_seed = inputs.sub_seed(seed, "program", bits=31)
    n = cell["params"]["check_steps"]
    ref = traffic.reference_readings(cfg, images, program_seed, seed, n, dev)
    ctl = traffic.reference_readings(cfg, images, program_seed, seed, n, dev, precision, rows)
    checks = Checks(cell["limits"])
    traffic.fill(checks, *ctl, *ref)
    if "sigma_gap" in cell["limits"]:
        # The reference in the program's place runs the configuration's schedule.
        checks.add("sigma_gap", 0.0)
    return checks


def sample_readings(spec: Spec, cell: dict, seed: int, dev, precision: str) -> Checks:
    traffic = spec.traffic(cell["traffic"])
    cfg = cell["config"]
    plan = traffic.Plan(cell["params"], seed)
    rng = inputs.device_generator(seed, "latents", dev)
    latents = torch.rand((plan.pool * plan.block_images, cfg["latent_size"]), generator=rng,
                         device=dev)
    weights = inputs.weights(cfg, seed, dev)["generator"]
    gaps = [traffic.image_gap(traffic.reference_images(cfg, weights, latents[plan.rows(q)],
                                                       precision),
                              traffic.reference_images(cfg, weights, latents[plan.rows(q)]))
            for q in plan.checked]
    worst = int(np.argmax(gaps))
    checks = Checks(cell["limits"])
    checks.add("image_gap", gaps[worst], f"request {plan.checked[worst]}")
    return checks


def main(argv: Optional[Sequence[str]] = None, root=None, device: Optional[str] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--precision", default="float32", choices=PRECISIONS)
    p.add_argument("--fault", default=None, choices=["half_batch"])
    args = p.parse_args(argv)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    dev = port.device(device or "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell["traffic"] == "train_chunked":
            rows = cell["config"]["batch_size"] // 2 if args.fault == "half_batch" else None
            out = train_readings(spec, cell, seed, dev, args.precision, rows)
        else:
            out = sample_readings(spec, cell, seed, dev, args.precision)
        readings = {k: {"value": v, "at": note} for k, (v, note) in out.readings.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "fault": args.fault, "correct": out.correct, "checks": out.as_dict(),
                          "readings": readings, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
