"""A throwaway benchmark root for the CPU tests: the repository's traffic
kinds and metric readers, plus small configurations and cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.spec import DEFAULT_ROOT

TINY = {
    "source": "https://github.com/lebrice/blurred-GAN/blob/master/demo_celeba.py",
    "image_shape": [16, 16, 3], "latent_size": 12,
    "generator": {"init_hw": [4, 4], "init_features": 16,
                  "blocks": [[16, 1], [8, 2], [4, 2]], "final": "conv", "final_stride": 1},
    "critic": {"channels": [4, 8, 16], "dropout": 0.3},
    "compute_dtype": "float32", "batch_size": 8, "learning_rate": 0.001,
    "gp_coefficient": 10.0, "e_drift": 0.0001, "sigma0": 2.0, "epochs": 10,
    "corpus_size": 96, "reduced": [], "assumed": []}

TINY_MNIST = dict(TINY, image_shape=[12, 12, 1], latent_size=10,
                  generator={"init_hw": [3, 3], "init_features": 16, "blocks": [[8, 1], [4, 2]],
                             "final": "transpose", "final_stride": 2},
                  critic={"channels": [4, 8], "dropout": 0.3}, sigma0=0.05)

TRAIN = {"traffic": "train_chunked", "chips": 1,
         "params": {"chunk_steps": 4, "check_steps": 3, "trace_chunks": 2},
         "limits": {"fake_gap": 1e-4, "loss_gap": 1e-4, "grad_gap": 1e-4,
                    "grad_gap_median": 1e-4, "grad_turn": 1e-4, "delta_gap": 1e-4,
                    "sigma_gap": 0.0},
         "why": "test"}
SAMPLE = {"traffic": "sample_requests", "chips": 1,
          "params": {"requests": [{"size": 2, "count": 2, "to": "device"},
                                  {"size": 3, "count": 1, "to": "host"},
                                  {"size": 9, "count": 1, "to": "host"}],
                     "pool_blocks": 3, "check_blocks": 2, "check_requests": 3,
                     "trace_seconds": 1},
          "limits": {"image_gap": 1e-5}, "why": "test"}


def make_root(tmp: Path, cells: dict, configs: dict) -> Path:
    """A root holding ``BENCHMARK.json`` with ``cells`` ({name: cell file})
    under the repository's end-to-end and per-layer metrics, and
    ``configs`` ({name: config file})."""
    root = Path(tmp)
    for sub in ("traffic", "metrics"):
        shutil.copytree(DEFAULT_ROOT / "portbench" / sub, root / "portbench" / sub)
    for sub, files in (("configs", configs), ("workloads", cells)):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
        for name, body in files.items():
            (root / "portbench" / sub / f"{name}.json").write_text(json.dumps(body))
    bench = json.loads((DEFAULT_ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["workloads"] = [{"name": n, "config": c["config"], "traffic": c["traffic"],
                           "chips": 1, "why": "test"} for n, c in cells.items()]
    bench["configs"] = [{"name": n, "source": c["source"], "file": f"portbench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n, c in configs.items()]
    # Each cell reports what its traffic kind measures.
    kinds = {"train_chunked": ("train_img_s", "train"),
             "sample_requests": ("sample_img_s", "sample")}
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            m["workloads"] = [n for n, c in cells.items()
                              if m["name"].split("_")[0] == kinds[c["traffic"]][1]]
    for m in bench["per_layer"]:
        m["workloads"] = [n for n, c in cells.items()
                          if m["name"].split(".")[1] == kinds[c["traffic"]][1]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
