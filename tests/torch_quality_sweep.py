"""A sweep of quality-check runs on one card: train them several at a time,
score them with the port's stack, diagnose their spectra, and gather what a
throw-away machine should bring back.

    python tests/torch_quality_sweep.py --out out/quality \\
        --runs heavy64:celeba64:resize,ttur,adaptive:6-11 \\
        --runs heavy64_tpu:celeba64:plain,d2,refscale:12-23:tpu \\
        --rows_from heavy64=results/quality/torch/celeba64/card/eval_torch_d2_s678.jsonl \\
        [--keep heavy64/torch_resize_s6] [--work $TMPDIR/sweep]

``--runs`` takes ``<name>:<config>:<arms>:<seeds>[:<examples>][:tpu]``
(repeated): ``python -m blurred_gan_tpu_torch.quality train`` of each arm
(``plain``, ``bf16``, ``resize``, ``ttur`` at 0.002, ``adaptive``, ``d2``,
``refscale``; :data:`ARM_FLAGS`) and seed (``a-b`` or a comma list) into
``<work>/<name>/``, 60,000 examples unless given, ``--concurrent`` (6) at a
time, each run's checkpoints removed when it ends. A trailing ``:tpu`` trains
the name's runs through ``tests/torch_tpu_precision.py train`` (every product
of the networks as a TPU's DEFAULT float32), and a run of such a name whose
meta lacks ``"tpu_precision"`` or counts no product fails; its files carry
the plain arms' names, so give it a name of its own. Then, for each name:

- ``evaluate`` of each seed in a process of its own (four at a time;
  ``eval_<name>_s<seed>.jsonl``), then one ``evaluate --pool``
  over all its seeds that scores only the floor row and merges the seeds'
  rows and the ``--rows_from`` files given for the name (the first file
  holding a row wins): per-seed gaps against the plain ``torch`` rows and the
  pooled statistics (``pool_<name>.jsonl``; none for a name of plain runs
  alone and no ``--rows_from``);
- ``tools.diagnose_samples`` over its arms (``diag_<name>.jsonl``);
- the metas, ``samples_sha256.txt`` (each npz file's hash) and
  ``samples_array_sha256.txt`` (the hash of each ``samples`` array's bytes:
  an npz file holds its write time, the array does not).

All of it goes to ``<out>/<name>/``; the sample sets named by ``--keep``
(``<name>/<prefix>_s<seed>``, 47 MiB each at 64²) are copied there too. The
card's name and power limit, and each phase's seconds, go to
``<out>/sweep.json``. A run or a phase that fails makes the script exit 1
after the rest has run. It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ARM_FLAGS = {"plain": [], "bf16": ["--bf16"], "resize": ["--gen_upsample", "resize"],
             "ttur": ["--ttur_g_lr", "0.002"], "adaptive": ["--adaptive"],
             "d2": ["--d_steps", "2"], "refscale": ["--ref_grad_scale"]}
EVAL_CONCURRENT = 4  # evaluate and diagnose processes at once (their FIDs' sqrtm is on the host)
PREFIX = {"plain": "torch", "bf16": "torch_bf16", "resize": "torch_resize",
          "ttur": "torch_ttur", "adaptive": "torch_adaptive", "d2": "torch_d2",
          "refscale": "torch_refscale"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(ROOT, "tests", "torch_tpu_precision.py")


def seeds_of(text: str):
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",")]


def parse_runs(specs):
    """{name: (config, arms, seeds, examples, tpu)} of the ``--runs`` specs."""
    out = {}
    for spec in specs:
        parts = spec.split(":")
        tpu = parts[-1] == "tpu"
        if tpu:
            parts = parts[:-1]
        name, config, arms, seeds = parts[:4]
        examples = int(parts[4]) if len(parts) > 4 else 60_000
        arms = arms.split(",")
        unknown = set(arms) - set(ARM_FLAGS)
        if unknown:
            raise SystemExit(f"unknown arms {sorted(unknown)}; known: {sorted(ARM_FLAGS)}")
        out[name] = (config, arms, seeds_of(seeds), examples, tpu)
    return out


def train_cmd(config, arm, seed, examples, out, *, tpu=False, concurrent=1, device="cuda"):
    """The command line that trains one run: ``quality train``, or the TPU
    precision harness's ``train`` with the same flags."""
    head = [sys.executable, HARNESS] if tpu else [sys.executable, "-m",
                                                  "blurred_gan_tpu_torch.quality"]
    return head + ["train", "--config", config, "--examples", str(examples),
                   "--seed", str(seed), "--out", out, "--concurrent_runs", str(concurrent),
                   "--device", device] + ARM_FLAGS[arm]


def meta_fault(path, tpu):
    """Why the run whose meta is ``path`` failed, or None: no meta, or (asked
    for the harness) no ``"tpu_precision"`` with a nonzero count of products."""
    if not os.path.exists(path):
        return f"{path}: no meta"
    if not tpu:
        return None
    with open(path) as f:
        record = json.load(f).get("tpu_precision") or {}
    if not record.get("products"):
        return f"{path}: no products through the TPU precision harness"
    return None


def run(cmd, log_path, remove=""):
    """Run ``cmd`` with its output to ``log_path`` (the repository's root on
    its ``PYTHONPATH``, for the harness), then remove the directory
    ``remove`` if given; its exit code."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env).returncode
    if remove:
        shutil.rmtree(remove, ignore_errors=True)
    return rc


def in_pool(jobs, workers):
    """Run ``(cmd, log[, remove])`` jobs ``workers`` at a time; the failed
    ones' logs."""
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        codes = list(pool.map(lambda job: run(*job), jobs))
    return [job[1] for job, rc in zip(jobs, codes) if rc != 0]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def card_fields():
    if not shutil.which("nvidia-smi"):
        return "no nvidia-smi"
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True)
    return q.stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", action="append", required=True,
                   help="<name>:<config>:<arms>:<seeds>[:<examples>][:tpu] (repeatable)")
    p.add_argument("--out", required=True)
    p.add_argument("--work", default="", help="run directories (default: a temporary one)")
    p.add_argument("--rows_from", action="append", default=[],
                   help="<name>=<jsonl>[,<jsonl>...]: earlier rows of the same stack for "
                        "the name's pooled run (repeatable)")
    p.add_argument("--keep", action="append", default=[],
                   help="<name>/<prefix>_s<seed>: a sample set to copy to <out>")
    p.add_argument("--concurrent", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    runs = parse_runs(args.runs)
    rows_from = {}
    for item in args.rows_from:
        name, files = item.split("=", 1)
        rows_from.setdefault(name, []).extend(f for f in files.split(",") if f)
    work = args.work or tempfile.mkdtemp(prefix="sweep_")
    os.makedirs(args.out, exist_ok=True)
    py = [sys.executable, "-m"]
    report = {"card": card_fields(), "runs": {}, "seconds": {}, "failed": []}
    print(json.dumps({"card": report["card"]}), flush=True)

    t0 = time.time()
    n_runs = sum(len(arms) * len(seeds) for _, arms, seeds, _, _ in runs.values())
    jobs, metas = [], []
    for name, (config, arms, seeds, examples, tpu) in runs.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for seed in seeds:
            for arm in arms:
                cmd = train_cmd(config, arm, seed, examples, d, tpu=tpu,
                                concurrent=min(args.concurrent, n_runs), device=args.device)
                jobs.append((cmd, os.path.join(d, f"train_{PREFIX[arm]}_s{seed}.log"),
                             os.path.join(d, f"{PREFIX[arm]}_log_s{seed}", "checkpoints")))
                metas.append((os.path.join(d, f"{PREFIX[arm]}_meta_s{seed}.json"), tpu))
    report["failed"] += in_pool(jobs, args.concurrent)
    report["failed"] += [fault for fault in (meta_fault(*m) for m in metas) if fault]
    report["seconds"]["train"] = round(time.time() - t0, 1)

    t0 = time.time()
    jobs = []
    for name, (config, arms, seeds, _, _) in runs.items():
        d = os.path.join(work, name)
        for seed in seeds:
            jobs.append((py + ["blurred_gan_tpu_torch.quality", "evaluate", "--config", config,
                               "--dir", d, "--seeds", str(seed), "--device", args.device],
                         os.path.join(d, f"eval_{name}_s{seed}.jsonl")))
        sides = ",".join(PREFIX[a] for a in arms)
        jobs.append((py + ["blurred_gan_tpu_torch.tools.diagnose_samples", "--dir", d,
                           "--config", config, "--seeds", ",".join(map(str, seeds)),
                           "--sides", sides, "--device", args.device],
                     os.path.join(d, f"diag_{name}.jsonl")))
    report["failed"] += in_pool(jobs, EVAL_CONCURRENT)
    report["seconds"]["evaluate_and_diagnose"] = round(time.time() - t0, 1)

    t0 = time.time()
    jobs = []
    for name, (config, arms, seeds, _, _) in runs.items():
        if arms == ["plain"] and name not in rows_from:
            continue  # no arm to pair with the plain runs
        d = os.path.join(work, name)
        empty = os.path.join(work, f"{name}_pool")
        os.makedirs(empty, exist_ok=True)
        files = [os.path.join(d, f"eval_{name}_s{s}.jsonl") for s in seeds]
        files += rows_from.get(name, [])
        jobs.append((py + ["blurred_gan_tpu_torch.quality", "evaluate", "--config", config,
                           "--dir", empty, "--seeds", ",".join(map(str, seeds)), "--pool",
                           "--device", args.device,
                           "--rows_from", ",".join(os.path.abspath(f) for f in files)],
                     os.path.join(d, f"pool_{name}.jsonl")))
    report["failed"] += in_pool(jobs, EVAL_CONCURRENT)
    report["seconds"]["pool"] = round(time.time() - t0, 1)

    for name, (config, arms, seeds, _, tpu) in runs.items():
        d, out = os.path.join(work, name), os.path.join(args.out, name)
        os.makedirs(out, exist_ok=True)
        kept = glob.glob(os.path.join(d, "*.json*")) + glob.glob(os.path.join(d, "*.log"))
        for path in sorted(kept):
            shutil.copy(path, out)
        lines = {"samples_sha256.txt": [], "samples_array_sha256.txt": []}
        for path in sorted(glob.glob(os.path.join(d, "*_samples_s*.npz"))):
            base = os.path.basename(path)
            with open(path, "rb") as f:
                lines["samples_sha256.txt"].append(f"{sha256(f.read())}  {base}")
            with np.load(path) as z:
                lines["samples_array_sha256.txt"].append(
                    f"{sha256(np.ascontiguousarray(z['samples']).tobytes())}  {base}")
        for fname, text in lines.items():
            with open(os.path.join(out, fname), "w") as f:
                f.write("\n".join(text) + "\n")
        report["runs"][name] = {"config": config, "arms": arms, "seeds": seeds,
                                "tpu_precision": tpu, "sets": len(lines["samples_sha256.txt"])}
    for item in args.keep:
        name, stem = item.split("/", 1)
        prefix, seed = stem.rsplit("_s", 1)
        src = os.path.join(work, name, f"{prefix}_samples_s{seed}.npz")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out, name))
        else:
            report["failed"].append(src)
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    if not args.work:
        shutil.rmtree(work, ignore_errors=True)
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
