"""The harness on the CPU: each cell's files are found by name, a CPU device
is refused for measurement, a cell, configuration and metric are added by
new files and entries alone, and ``correct`` comes out false when the timed
path is broken underneath (the faults the cells can have)."""

import json

import pytest
import torch

from portbench import run
from portbench.spec import Spec
from portbench.tests import tiny

SEED = 3_000_000_019  # above 2**31: a seed may need more than 32 signed bits


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    cells = {"tiny.train": dict(tiny.TRAIN, config="tiny"),
             "tiny_mnist.train": dict(tiny.TRAIN, config="tiny_mnist"),
             "tiny.sample": dict(tiny.SAMPLE, config="tiny")}
    return tiny.make_root(tmp_path_factory.mktemp("root"), cells,
                          {"tiny": tiny.TINY, "tiny_mnist": tiny.TINY_MNIST})


def run_cell(root, cell, capsys, trace=0, seed=SEED):
    torch.set_num_threads(2)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], root=root, device="cpu")
    assert rc == 0
    return last_json(capsys)


@pytest.mark.parametrize("cell", [w["name"] for w in Spec().benchmark()["workloads"]])
def test_each_cell_is_found_by_name(cell):
    spec = Spec()
    bench = spec.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    found = spec.cell(cell)
    assert found["config"]["name"] == entry["config"]
    assert found["traffic"] == entry["traffic"] and found["chips"] == entry["chips"]
    assert found["why"] == entry["why"]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert conf["source"] == found["config"]["source"]
    assert conf["reduced"] == found["config"]["reduced"]
    assert callable(spec.traffic(found["traffic"]).run)
    e2e, per_layer = spec.cell_metrics(cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert callable(spec.metric(m["name"]).read)
    assert found["limits"]


def test_a_cpu_device_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "celeba128.train", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "needs 1 CUDA card" in out.err


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mnist.train", "tiny.sample"])
def test_a_sound_run_is_correct(root, cell, capsys):
    result = run_cell(root, cell, capsys)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {"setup_s"} < set(result["metrics"])
    traced = run_cell(root, cell, capsys, trace=1)
    assert traced["correct"] is True
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


def test_a_cell_a_configuration_and_a_metric_come_as_new_files(root, capsys):
    spec = Spec(root)
    (root / "portbench" / "configs" / "throwaway.json").write_text(
        json.dumps(dict(tiny.TINY, image_shape=[8, 8, 3], corpus_size=40,
                        generator=dict(tiny.TINY["generator"], blocks=[[16, 1], [8, 2]]))))
    cell = dict(tiny.TRAIN, config="throwaway")
    (root / "portbench" / "workloads" / "throwaway.train.json").write_text(json.dumps(cell))
    (root / "portbench" / "metrics" / "steps.throwaway.py").write_text(
        "def read(r):\n    return float(r.facts['steps'])\n")
    bench = spec.benchmark()
    bench["configs"].append({"name": "throwaway", "source": tiny.TINY["source"],
                             "file": "portbench/configs/throwaway.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "throwaway.train", "config": "throwaway",
                               "traffic": "train_chunked", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("throwaway.train")
    bench["per_layer"].append({"name": "steps.throwaway", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_img_s", "workloads": ["throwaway.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run_cell(root, "throwaway.train", capsys)["correct"] is True
    traced = run_cell(root, "throwaway.train", capsys, trace=1)
    assert traced["metrics"]["steps.throwaway"]["value"] == 2 * tiny.TRAIN["params"]["chunk_steps"]


def _frozen_step(make_step_body):
    """A step that returns its state unchanged."""
    def make(gan, hparams):
        body = make_step_body(gan, hparams)

        def step(state, reals, sigma, *a, **kw):
            with torch.no_grad():
                saved = [p.clone() for p in state.generator.parameters()]
                saved += [p.clone() for p in state.discriminator.parameters()]
            out = body(state, reals, sigma, *a, **kw)
            with torch.no_grad():
                params = list(state.generator.parameters()) + list(state.discriminator.parameters())
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        return step
    return make


def _half_batch(make_step_body):
    """Half of the batch's reals left out, the means taken over the rest (its
    first half twice); every fake of the batch is still made, so the
    critic step's fakes are the sound step's."""
    def make(gan, hparams):
        half = hparams.global_batch_size // 2
        body = make_step_body(gan, hparams)

        def step(state, reals, sigma, *a, **kw):
            return body(state, torch.cat([reals[:half], reals[:half]]), sigma, *a, **kw)
        return step
    return make


@pytest.mark.parametrize("fault", [_frozen_step, _half_batch])
@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mnist.train"])
def test_a_broken_step_is_not_correct(root, cell, fault, monkeypatch, capsys):
    import blurred_gan_tpu_torch.train.fast as fast

    monkeypatch.setattr(fast, "make_step_body", fault(fast.make_step_body))
    result = run_cell(root, cell, capsys)
    assert result["correct"] is False


def test_an_altered_answer_is_not_correct(root, monkeypatch, capsys):
    import blurred_gan_tpu_torch.train.step as step

    make = step.make_sample_fn

    def altered(gan, use_ema=False):
        fn = make(gan, use_ema)

        def sample(state, latents):
            out = fn(state, latents).clone()
            out[-1] = -out[-1]
            return out
        return sample

    monkeypatch.setattr(step, "make_sample_fn", altered)
    assert run_cell(root, "tiny.sample", capsys)["correct"] is False


@pytest.mark.parametrize("cell, fault, precision, caught", [
    ("tiny.train", "half_batch", "float32", True),
    ("tiny_mnist.train", "half_batch", "float32", True),
    ("tiny.train", None, "float32", False),
    ("tiny.sample", None, "float32", False),
])
def test_the_control_applies_the_cells_limits(root, cell, fault, precision, caught, capsys):
    from portbench import control

    argv = ["--workload", cell, "--seeds", "5", "--precision", precision]
    assert control.main(argv + (["--fault", fault] if fault else []), root=root,
                        device="cpu") == 0
    line = last_json(capsys)
    assert line["correct"] is (not caught)
    assert set(line["checks"]) == set(Spec(root).cell(cell)["limits"])
    if fault:
        # Every fake of the batch is still made: the critic step's are the sound step's.
        assert line["checks"]["fake_gap"]["value"] == 0.0
