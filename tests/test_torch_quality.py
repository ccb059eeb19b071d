"""``python -m blurred_gan_tpu_torch.quality`` and the repo root's
``quality_torch_score.py`` against ``benchmarks/quality_parity.py``.

The train side is held to ``train_ours``: the configurations and eval
latents; the per-step σ of a 3-step MNIST run against the JAX package's
``BlurDecayController``; each arm's files and meta keys against those
``train_ours`` writes with its ``Trainer`` and ``GAN`` replaced by stubs
(no JAX training runs; the port's runs take one step on MNIST-shaped networks
at narrow widths); the one-arm refusal; the eval samples of a JAX state
carried across (``convert.flax_state_to_torch``) against JAX
``gan.generate(train=False)`` on the first 100 eval latents at 1e-5, live and
averaged weights, on the MNIST networks and a narrow CelebA layout; the CLI
on the CPU. The runs here train on a 256-image slice of the synthetic corpus
(building the 60,000-image corpus takes ~8 s).

The scorer's row is held to ``evaluate``'s on the same sample set, both
computed here with the same reductions (the scorer does not copy the row's
code, so a change on either side shows): FID over 32 random-conv features
(a 2048² ``sqrtm`` takes ~20 s here), SWD with 8 projections of 16 patches an
image (its default sorts take ~100 s on 1000 MNIST images here), 100 held-out
reals, no Inception FID.
"""

import ast
import dataclasses
import functools
import importlib.util
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blurred_gan_tpu.metrics as jax_metrics
import blurred_gan_tpu.train as jax_train
from blurred_gan_tpu.models import DCGANGenerator as JaxG, DCGANDiscriminator as JaxD
from blurred_gan_tpu.models import mnist_discriminator as jax_mnist_d
from blurred_gan_tpu.models import mnist_generator as jax_mnist_g
from blurred_gan_tpu.sched.blur import BlurDecayController as JaxBlurDecay
from blurred_gan_tpu_torch import quality
from blurred_gan_tpu_torch.convert import flax_state_to_torch
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.models.dcgan import (
    DCGANDiscriminator, DCGANGenerator, mnist_discriminator, mnist_generator)
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from test_torch_sampling import perturbed

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = 256
TOL = dict(rtol=1e-5, atol=1e-5)
# The devices' fields the port's meta adds to train_ours's keys.
ADDED_META = {"device", "power_limit_w"}
ARMS = {"plain": {}, "bf16": {"bf16": True}, "ema": {"ema_decay": 0.999},
        "adaptive": {"adaptive": True}, "refscale": {"ref_grad_scale": True},
        "resize": {"gen_upsample": "resize"}, "ttur": {"ttur_g_lr": 2e-4},
        "d2": {"d_steps": 2}}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


qts = _load("quality_torch_score", REPO / "quality_torch_score.py")
qp = qts.qp  # benchmarks/quality_parity.py, as the scorer imports it


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its runs are many small ops,
    which a worker's default thread pool slows when the suite's other
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from blurred_gan_tpu_torch.utils import logging as logging_mod

    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


@functools.lru_cache(maxsize=None)
def small_corpus(image_shape):
    return synthetic_dataset(image_shape, num_examples=CORPUS)


@pytest.fixture
def slice_corpus(monkeypatch):
    """The port's runs train on the corpus's first 256 images."""
    monkeypatch.setattr(quality, "corpus", lambda cfg: small_corpus(cfg.image_shape))


def narrow_mnist(cfg, compute_dtype=torch.float32, upsample="transpose"):
    """The MNIST networks' layout (7x7 Dense, a stride-1 and a stride-2
    up-stage, a stride-2 final up-stage; two stride-2 convolutions) at 8 and
    16 channels."""
    assert cfg.arch == "mnist"
    return (DCGANGenerator(init_hw=(7, 7), init_features=16, blocks=((8, 1), (8, 2)),
                           out_channels=1, final_transpose=True, final_stride=2,
                           upsample=upsample, compute_dtype=compute_dtype),
            DCGANDiscriminator(channels=(8, 16), in_channels=1, image_hw=(28, 28),
                               compute_dtype=compute_dtype))


def test_configs_and_eval_latents_are_quality_paritys():
    assert {k: dataclasses.asdict(v) for k, v in quality.CONFIGS.items()} == {
        k: dataclasses.asdict(v) for k, v in qp.CONFIGS.items()}
    assert (quality.BATCH, quality.LATENT, quality.N_EVAL) == (qp.BATCH, qp.LATENT, qp.N_EVAL)
    np.testing.assert_array_equal(quality.eval_latents(), qp._eval_latents())
    assert quality.eval_latents().dtype == np.float32


def test_sigma_per_step_is_the_jax_schedule(tmp_path, slice_corpus, monkeypatch):
    monkeypatch.setattr(quality, "networks", narrow_mnist)
    cfg, examples = quality.CONFIGS["mnist"], 3 * quality.BATCH
    trainers = []
    quality.train(cfg, examples, str(tmp_path), 0, device="cpu", on_trainer=trainers.append)
    sigmas = [h["std"] for h in trainers[0].history]
    want = JaxBlurDecay(total_n_training_examples=examples, max_value=cfg.sigma0)
    assert len(sigmas) == 3
    for n, got in enumerate(sigmas):
        assert np.float32(got) == np.float32(want.sigma(n)), (n, got, want.sigma(n))
    assert sigmas[0] > sigmas[1] > sigmas[2]


def jax_train_ours(monkeypatch, out, **arm):
    """``train_ours`` on MNIST with its ``Trainer`` and ``GAN`` replaced by
    stubs (1000 zero samples); returns its meta and the files it wrote."""

    class StubGAN:
        def __init__(self, gen, disc, blurred):
            pass

        def generate(self, params, stats, z, train):
            return np.zeros((z.shape[0], 28, 28, 1), np.float32), None

    class StubTrainer:
        def __init__(self, gan, hp, ds, trainer_config, blur_controller, adaptive_controller):
            self.ada_state = types.SimpleNamespace(std=0.05, stop_training=False)

        def fit(self, total_examples):
            return types.SimpleNamespace(g_params={}, g_ema={}, g_stats={},
                                         n_img=np.array([0, total_examples]))

        def close(self):
            pass

    monkeypatch.setattr(jax_train, "Trainer", StubTrainer)
    monkeypatch.setattr(jax_train, "GAN", StubGAN)
    monkeypatch.setattr(qp, "_corpus", lambda cfg: None)
    qp.train_ours(qp.CONFIGS["mnist"], 64, str(out), 0, **arm)
    (meta_path,) = out.glob("*_meta_s0.json")
    return json.loads(meta_path.read_text()), sorted(p.name for p in out.glob("*_s0.*"))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_files_and_meta_keys_are_train_ours(arm, tmp_path, monkeypatch, slice_corpus):
    jax_meta, jax_files = jax_train_ours(monkeypatch, tmp_path / "jax", **ARMS[arm])
    monkeypatch.setattr(quality, "networks", narrow_mnist)
    meta = quality.train(quality.CONFIGS["mnist"], quality.BATCH, str(tmp_path / "torch"), 0,
                         device="cpu", **ARMS[arm])
    files = sorted(p.name for p in (tmp_path / "torch").glob("*_s0.*"))
    assert files == [f.replace("ours", "torch", 1) for f in jax_files]
    assert files[0].startswith(quality.arm_prefix(**ARMS[arm]) + "_meta")
    assert set(meta) == set(jax_meta) | ADDED_META
    assert json.loads((tmp_path / "torch" / files[0]).read_text()) == meta
    same = {k for k in jax_meta if k not in ("framework", "backend", "images_per_sec",
                                             "elapsed_s", "examples", "examples_trained",
                                             "sigma_final", "stopped_early")}
    assert {k: meta[k] for k in same} == {k: jax_meta[k] for k in same}
    assert meta["framework"] == "blurred_gan_tpu_torch" and meta["backend"] == "torch-cpu"
    assert meta["device"] == "cpu"
    if arm == "plain":  # what chip_smoke.py's phase 19 holds the card's runs to
        import chip_smoke

        assert chip_smoke.TRAIN_OURS_META == set(jax_meta)
        assert chip_smoke.QUALITY_META == set(meta)
    if arm == "adaptive":
        assert meta["examples_trained"] == quality.BATCH and not meta["stopped_early"]
        assert meta["sigma_final"] == quality.CONFIGS["mnist"].sigma0  # no change in warm-up


# quality_parity.py's flags that only its evaluate reads, and the port's own
# (evaluate's --dir, where quality_parity.py reads --out).
EVALUATE_FLAGS = {"--seeds", "--inception", "--pool", "--rows_from", "--inception_size"}
PORT_FLAGS = {"--device", "--concurrent_runs", "--dir"}


def quality_parity_flags():
    """{flag: default} of the ``add_argument`` calls in quality_parity.py's source."""
    tree = ast.parse((REPO / "benchmarks" / "quality_parity.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args[0].value.startswith("--")):
            default = [k.value for k in node.keywords if k.arg == "default"]
            flags[node.args[0].value] = (ast.literal_eval(default[0]) if default else None)
    return flags


def test_flags_are_train_ours():
    theirs = quality_parity_flags()
    parser = quality.build_parser()
    mine = {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0].startswith("--")
            and a.option_strings[0] != "--help"}
    assert set(mine) == set(theirs) | PORT_FLAGS
    assert EVALUATE_FLAGS <= set(mine)
    # the defaults, less --out's (the port writes inside its checkout), the
    # store_true flags' (None in the source, False parsed) and --inception's
    # (the port scores the Inception column unless --no-inception, as the
    # recorded rows have it)
    for flag in set(mine) - PORT_FLAGS - {"--out", "--bf16", "--adaptive",
                                          "--ref_grad_scale", "--pool", "--inception"}:
        assert mine[flag] == theirs[flag], flag
    assert parser.parse_args(["train"]).device == "cuda"
    assert parser.parse_args(["evaluate"]).inception
    assert not parser.parse_args(["evaluate", "--no-inception"]).inception


def test_one_arm_per_run(tmp_path, monkeypatch):
    with pytest.raises(SystemExit) as jax_refusal:
        qp.train_ours(qp.CONFIGS["mnist"], 64, str(tmp_path), 0, bf16=True, d_steps=2)
    monkeypatch.setattr(quality, "corpus", lambda cfg: pytest.fail("built the corpus"))
    with pytest.raises(SystemExit) as refusal:
        quality.train(quality.CONFIGS["mnist"], 64, str(tmp_path), 0, bf16=True, d_steps=2,
                      device="cpu")
    assert str(refusal.value) == str(jax_refusal.value)
    assert not list(tmp_path.iterdir())


def jax_narrow_celeba():
    return JaxG(init_hw=(4, 4), init_features=16, blocks=((16, 1), (8, 2))), \
        JaxD(channels=(8, 16))


def port_narrow_celeba():
    return (DCGANGenerator(init_hw=(4, 4), init_features=16, blocks=((16, 1), (8, 2))),
            DCGANDiscriminator(channels=(8, 16), image_hw=(8, 8)))


@pytest.fixture(scope="module", params=["mnist", "narrow_celeba8"])
def carried(request):
    """A perturbed JAX state (an average away from the weights, running
    statistics away from (0, 1)) and the port's state carrying it."""
    if request.param == "mnist":
        jnets, nets, shape = (jax_mnist_g(), jax_mnist_d()), (
            mnist_generator(), mnist_discriminator()), (28, 28, 1)
    else:
        jnets, nets, shape = jax_narrow_celeba(), port_narrow_celeba(), (8, 8, 3)
    jgan = jax_train.GAN(*jnets, blurred=True)
    jstate = perturbed(jax_train.create_train_state(
        jgan, jax_train.BlurredWGANGPHyperParameters(ema_decay=0.9), jax.random.PRNGKey(1),
        shape))
    gan = GAN(*nets, blurred=True)
    state = create_train_state(gan, BlurredWGANGPHyperParameters(ema_decay=0.9), device="cpu")
    flax_state_to_torch(state, jstate)
    return jgan, jstate, gan, state


@pytest.mark.parametrize("weights", ["live", "ema"])
def test_eval_samples_are_jax_generate(carried, weights):
    jgan, jstate, gan, state = carried
    z = quality.eval_latents()[:100]
    params = jstate.g_ema if weights == "ema" else jstate.g_params
    want = np.asarray(jgan.generate(params, jstate.g_stats, jnp.asarray(z), train=False)[0])
    got = quality.eval_samples(gan, state, use_ema=weights == "ema", latents=z)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_cli_writes_samples_and_meta(tmp_path, slice_corpus, capsys):
    out = tmp_path / "q"
    quality.main(["train", "--config", "mnist", "--examples", "64", "--out", str(out),
                  "--seed", "3", "--device", "cpu", "--concurrent_runs", "3"])
    with np.load(out / "torch_samples_s3.npz") as d:
        samples = d["samples"]
    assert samples.shape == (1000, 28, 28, 1) and samples.dtype == np.float32
    assert np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1
    meta = json.loads((out / "torch_meta_s3.json").read_text())
    assert meta["seed"] == 3 and meta["examples"] == 64 and meta["concurrent_runs"] == 3
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == meta
    assert (out / "torch_log_s3" / "events.jsonl").exists()


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(SystemExit, match="no CUDA device"):
        quality.main(["train", "--out", str(tmp_path)])


@pytest.fixture
def small_metrics(monkeypatch):
    """Both sides' metrics at the test's reductions (module docstring)."""
    monkeypatch.setattr(jax_metrics, "FIDMetric",
                        functools.partial(jax_metrics.FIDMetric, feature_dim=32))
    monkeypatch.setattr(jax_metrics, "SWDMetric",
                        functools.partial(jax_metrics.SWDMetric, nhoods_per_image=16,
                                          dir_repeats=1, dirs_per_repeat=8))
    monkeypatch.setattr(qp, "N_EVAL", 100)


def rows_of(text):
    return {r["samples"]: r for r in (json.loads(line) for line in text.splitlines()
                                      if line.startswith("{")) if "samples" in r}


def test_scorer_row_is_evaluates(tmp_path, small_metrics, capsys):
    cfg = qp.ParityConfig("mnist", (28, 28, 1), 300, 0.05)
    fakes = np.tanh(np.random.RandomState(0).standard_normal((100, 28, 28, 1))
                    ).astype(np.float32)
    np.savez(tmp_path / "ours_samples_s0.npz", samples=fakes)
    np.savez(tmp_path / "torch_samples_s0.npz", samples=fakes)
    qp.evaluate(cfg, str(tmp_path), [0], use_inception=False)
    jax_rows = rows_of(capsys.readouterr().out)
    rows = qts.score_dir(cfg, str(tmp_path), [0], use_inception=False)
    printed = rows_of(capsys.readouterr().out)
    assert set(rows) == {"reals_floor", "torch_s0"}
    assert printed == {"reals_vs_reals": rows["reals_floor"], "torch_s0": rows["torch_s0"]}
    for mine, theirs in ((rows["torch_s0"], jax_rows["ours_s0"]),
                         (rows["reals_floor"], jax_rows["reals_vs_reals"])):
        assert mine.pop("stack") == "jax"
        assert set(mine) == set(theirs) and len(mine) == 10
        assert {k: v for k, v in mine.items() if k != "samples"} == {
            k: v for k, v in theirs.items() if k != "samples"}


def test_scorer_reports_every_pair_of_the_arms(capsys):
    """The recorded rows pair with the port's: per-seed gaps, then pooled
    statistics over every seed both sides of a pair have."""
    rows = {f"{side}_s{seed}": {"samples": f"{side}_s{seed}", "SWDx1e3_avg": 1.0 + seed + k,
                                "kid": 0.01 * (1 + k), "precision": 0.5}
            for seed in (0, 1, 2) for k, side in enumerate(("ours", "ours_bf16", "torch",
                                                            "torch_bf16"))}
    del rows["torch_bf16_s2"]
    qts.report(rows, [0, 1], ["torch", "torch_bf16"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    pairs = ["torch_vs_ours", "torch_bf16_vs_ours_bf16", "torch_bf16_vs_torch",
             "ours_bf16_vs_ours"]
    assert [next(iter(o)) for o in out[:8]] == [f"rel_gap_{p}" for p in pairs] * 2
    assert out[0] == {"rel_gap_torch_vs_ours": {"SWDx1e3_avg": 2.0, "kid": 2.0}, "seed": 0}
    pooled = out[8:]
    assert [o["pooled"] for o in pooled] == pairs
    assert [o["seeds"] for o in pooled] == [[0, 1, 2], [0, 1], [0, 1], [0, 1, 2]]
    assert pooled[0]["stats"]["SWDx1e3_avg"]["median_torch"] == 4.0
    assert pooled[0]["total_wins_of_all_comparisons"] == {"ours": 6, "torch": 0, "ties": 0}


def test_pool_only_pools_earlier_rows(tmp_path, capsys):
    """``--pool_only`` scores nothing: it merges the rows of earlier runs
    and the recorded ones, and reports on the port's arms among them."""
    files = []
    for name, sides in (("recorded", ("ours", "ours_ema")), ("s01", ("torch", "torch_ema"))):
        path = tmp_path / f"{name}.jsonl"
        path.write_text("[fid] a note line\n" + "\n".join(
            json.dumps({"samples": f"{side}_s{seed}", "SWDx1e3_avg": 10.0 + seed + k})
            for seed in (0, 1) for k, side in enumerate(sides)) + "\n")
        files.append(str(path))
    rows = qts.main(["--pool_only", "--seeds", "0,1", "--rows_from", ",".join(files)])
    assert set(rows) == {f"{s}_s{n}" for s in ("ours", "ours_ema", "torch", "torch_ema")
                         for n in (0, 1)}
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [o["pooled"] for o in out if "pooled" in o] == [
        "torch_vs_ours", "torch_ema_vs_ours_ema", "torch_ema_vs_torch", "ours_ema_vs_ours"]
