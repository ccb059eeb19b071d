"""The port's ``tools.convert_inception`` against the repo root's
``tools/convert_inception.py``, as tests/test_convert_inception.py holds the
root tool: a torchvision state dict built from ``random_inception_params``
(the port's: a ``torch.Generator`` draw, no download), γ folded back out of
it.

- the γ folding's round trip to the source parameters (rtol 2e-6 / atol 1e-7,
  the root test's tolerance), and equal arrays to the root tool's;
- missing keys and wrong shapes fail naming the scope; format detection; the
  TF-slim name map; a missing ``tensorflow`` named in the error;
- the npz the CLI writes from a ``.pth`` file, and the npz it validates and
  writes again, byte-equal to the root tool's for the same input, and loaded
  by the port's ``load_inception_weights`` to the source parameters.
"""

import os
import sys

import numpy as np
import pytest
import torch

from blurred_gan_tpu.metrics.inception import conv_specs as jax_conv_specs
from blurred_gan_tpu.metrics.inception import save_inception_weights as jax_save_weights
from blurred_gan_tpu_torch.metrics.inception import load_inception_weights, random_inception_params
from blurred_gan_tpu_torch.tools import convert_inception as pci

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import convert_inception as jci  # noqa: E402  (the root tool)
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

FOLD_TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture(scope="module")
def source():
    """(HWIO numpy parameters, a torchvision state dict whose γ-folding gives
    them back)."""
    params = {scope: {f: (t.numpy().transpose(2, 3, 1, 0) if f == "w" else t.numpy())
                      for f, t in unit.items()}
              for scope, unit in random_inception_params(seed=3).items()}
    rng = np.random.RandomState(0)
    sd = {}
    for scope, _, _, cout in jax_conv_specs():
        mod, p = scope.replace("/", "."), params[scope]
        g = (0.5 + rng.rand(cout)).astype(np.float32)
        sd[f"{mod}.conv.weight"] = torch.tensor((p["w"] / g).transpose(3, 2, 0, 1))  # OIHW
        sd[f"{mod}.bn.weight"] = torch.tensor(g)
        sd[f"{mod}.bn.bias"] = torch.tensor(p["beta"])
        sd[f"{mod}.bn.running_mean"] = torch.tensor(p["mean"] / g)
        sd[f"{mod}.bn.running_var"] = torch.tensor(p["var"])
    return params, sd


def assert_params_close(got, want, **tol):
    assert set(got) == set(want)
    for scope, unit in want.items():
        assert set(got[scope]) == set(unit)
        for field, arr in unit.items():
            np.testing.assert_allclose(np.asarray(got[scope][field]), arr,
                                       err_msg=f"{scope}/{field}", **tol)


def test_gamma_folding_round_trip_and_root_tool(source):
    params, sd = source
    got = pci.convert_torchvision_state_dict(sd)
    assert_params_close(got, params, **FOLD_TOL)
    assert_params_close(got, jci.convert_torchvision_state_dict(sd), rtol=0, atol=0)
    assert pci.check_params(got) is got


def test_missing_and_misshapen_fail_naming_the_scope(source):
    params, sd = source
    sd = dict(sd)
    del sd["Mixed_6b.branch7x7_2.conv.weight"]
    with pytest.raises(KeyError, match="Mixed_6b/branch7x7_2"):
        pci.convert_torchvision_state_dict(sd)
    sd["Mixed_6b.branch7x7_2.conv.weight"] = torch.zeros(3, 3, 3, 3)
    with pytest.raises(ValueError, match="Mixed_6b.branch7x7_2.conv.weight"):
        pci.convert_torchvision_state_dict(sd)
    bad = {scope: dict(unit) for scope, unit in params.items()}
    bad["Conv2d_4a_3x3"]["mean"] = bad["Conv2d_4a_3x3"]["mean"][:5]
    with pytest.raises(ValueError, match="Conv2d_4a_3x3/mean"):
        pci.check_params(bad)
    bad["Conv2d_4a_3x3"] = params["Conv2d_4a_3x3"]
    del bad["Mixed_7c/branch_pool"]["var"]
    with pytest.raises(KeyError, match="Mixed_7c/branch_pool/var"):
        pci.check_params(bad)


def test_format_detection(tmp_path):
    d = tmp_path / "ckptdir"
    d.mkdir()
    (tmp_path / "model.index").write_text("")
    paths = ["weights.npz", "model.pth", "m.PT", "pytorch_model.bin", "inception_v3.ckpt",
             str(d), str(tmp_path / "model"), "weights"]
    assert [pci.detect_format(p) for p in paths] == [
        "npz", "torchvision", "torchvision", "torchvision", "slim", "slim", "slim",
        "torchvision"]
    assert [pci.detect_format(p) for p in paths] == [jci.detect_format(p) for p in paths]


def test_slim_name_map_equals_the_root_tools():
    names = [pci._slim_name(scope) for scope, _, _, _ in jax_conv_specs()]
    assert names == [jci._slim_name(scope) for scope, _, _, _ in jax_conv_specs()]
    assert len(set(names)) == 94
    assert pci._slim_name("Mixed_5c/branch5x5_2") == "InceptionV3/Mixed_5c/Branch_1/Conv_1_0c_5x5"


def test_slim_without_tensorflow_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import fails as if not installed
    with pytest.raises(ImportError, match="needs tensorflow"):
        pci.convert(str(tmp_path / "inception_v3.ckpt"), str(tmp_path / "out.npz"))


def test_cli_writes_the_root_tools_bytes(source, tmp_path, capsys):
    params, sd = source
    src = str(tmp_path / "inception_v3.pth")
    torch.save(sd, src)
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "root.npz")
    pci.main([src, got])
    assert "detected format: torchvision" in capsys.readouterr().out
    jci.convert(src, want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    loaded = load_inception_weights(got)
    back = {scope: {f: (t.numpy().transpose(2, 3, 1, 0) if f == "w" else t.numpy())
                    for f, t in unit.items()} for scope, unit in loaded.items()}
    assert_params_close(back, params, **FOLD_TOL)


def test_npz_validate_and_resave(source, tmp_path):
    params, _ = source
    src = str(tmp_path / "in.npz")
    jax_save_weights(params, src)
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "root.npz")
    out = pci.convert(src, got, fmt="npz")
    jci.convert(src, want, fmt="npz")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(out["Conv2d_1a_3x3"]["w"].numpy().transpose(2, 3, 1, 0),
                                  params["Conv2d_1a_3x3"]["w"])
