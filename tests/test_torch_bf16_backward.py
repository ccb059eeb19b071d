"""The bfloat16 generator's backward (``--bf16``, ``--fast_gen``) against
the JAX package's bfloat16 generator compiled by default (XLA's excess
precision on, the program the package trains with).

That compile keeps in float32 what the JAX package's dtypes would round in
the generator's backward (``tests/torch_fullwidth_parity.py --hlo`` lists
the roundings it drops): each convolution's weight gradient and, where the
convolution casts a float32 input, its input gradient. It keeps the rest:
the cotangent of each product (the sum of BatchNorm's two paths, each
rounded), the Dense's weight gradient (its rounding moves onto the transpose
of the dot), and every bfloat16 elementwise step of ``--fast_gen``,
``tanh``'s derivative among them. The port mirrors exactly that
(``models/dcgan.py``: ``_GeneratorProduct``, ``BatchNorm.grad_dtype``,
``_Tanh``), with a forward that is bit-equal to the plain casts'.

Tolerances for the train-mode parameter gradient of one fixed float32
cotangent, relative L2 (the inputs of ``tests/test_torch_bf16.py``):

- ``TAIL_REL_L2`` 1e-3 per tensor, for the tensors whose gradient meets at
  most one BatchNorm backward: the last convolution, the last BatchNorm and
  the last up-stage. Measured <= 6.4e-5 where the port's forward equals
  JAX's bit for bit, <= 3.6e-4 for ``resize`` with ``fast_gen``, whose
  bfloat16 forward differs from JAX's in 6 of 3072 output values (one
  unit each, float32 statistics summed in another order). The port before
  this backward: 5.5e-3 to 7.2e-3 at each case's farthest of these
  tensors; the compile without excess precision lies at least 8.3e-3 from
  the default one on each.
- ``NET_REL_L2`` 1e-2 over the whole network. Further up, each BatchNorm
  rounds float32 values that the two programs sum in different orders, so
  a last-bit difference becomes a bfloat16 unit now and then and grows
  through every layer above it. One float32 unit on one BatchNorm scale
  moves JAX's own gradient by up to 4.6e-3 here, the port lies 1.1e-5
  (``transpose`` with ``fast_gen``) to 4.6e-3 away (before this backward
  5.8e-3 to 8.8e-3), the compile without excess precision 5.2e-2 to
  6.8e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch.models import dcgan as tm
from test_torch_bf16 import generator_pair, latents, nchw, port_generator, rel_l2
from test_torch_step import RES, to_torch_layout
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TAIL_REL_L2 = 1e-3
NET_REL_L2 = 1e-2
CASES = [(up, fast) for up in ("transpose", "resize") for fast in (False, True)]


def case_id(case):
    return case[0] + ("+fast_gen" if case[1] else "")


def tail_names(tg):
    """The parameters whose gradient meets at most one BatchNorm backward."""
    last_bn, last_up = len(tg.bns) - 1, len(tg.ups) - 1
    return {"final.weight", f"bns.{last_bn}.weight", f"bns.{last_bn}.bias",
            f"ups.{last_up}.conv.weight"}


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_generator_gradient_is_the_default_compiles(case):
    upsample, fast = case
    jg, tg, variables = generator_pair("bfloat16", fast, upsample)
    z = latents()
    cot = np.random.RandomState(3).randn(4, RES, RES, 3).astype(np.float32)

    def loss(params):
        out, _ = jg.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(z), train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot)

    lowered = jax.jit(jax.grad(loss)).lower(variables["params"])
    layout = port_generator("float32", False, upsample)
    default, exact = (to_torch_layout(layout, c(variables["params"])) for c in (
        lowered.compile(),
        lowered.compile(compiler_options={"xla_allow_excess_precision": False})))
    tg.train(True)
    torch.sum(tg(torch.from_numpy(z)).float() * nchw(cot)).backward()
    got = {name: p.grad.numpy() for name, p in tg.named_parameters()}
    assert got.keys() == default.keys()
    for name in tail_names(tg):
        assert got[name].dtype == np.float32
        assert rel_l2(got[name], default[name]) <= TAIL_REL_L2, name
        # ... and not the gradient of the compile without excess precision.
        assert rel_l2(exact[name], default[name]) > 2 * TAIL_REL_L2, name
    flat = [np.concatenate([d[n].ravel() for n in got]) for d in (got, default, exact)]
    assert rel_l2(flat[0], flat[1]) <= NET_REL_L2
    assert rel_l2(flat[2], flat[1]) > 2 * NET_REL_L2


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_is_the_plain_casts(case):
    """The train-mode forward through the backward's autograd functions is
    bit-equal to the same forward without them (no gradient wanted: the
    products on operands cast to bfloat16, their float32 sums where
    ``f32_sums``), and one product to the plain cast's."""
    upsample, fast = case
    _, tg, _ = generator_pair("bfloat16", fast, upsample)
    z = torch.from_numpy(latents())
    tg.train(True)
    stats = {k: v.clone() for k, v in tg.state_dict().items()}
    with_grad = tg(z)
    assert with_grad.requires_grad
    tg.load_state_dict(stats)
    with torch.no_grad():
        plain = tg(z)
    assert with_grad.dtype == plain.dtype == (torch.bfloat16 if fast else torch.float32)
    assert torch.equal(with_grad.detach(), plain)

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 8, 6, 6).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(4, 8, 5, 5).astype(np.float32)).requires_grad_(True)
    y = tm._generator_product(x, w, torch.bfloat16, True, (1, 0, False))
    want = torch.nn.functional.conv2d(x.detach().bfloat16().float(),
                                      w.detach().bfloat16().float())
    assert y.dtype == torch.float32 and torch.equal(y.detach(), want)
