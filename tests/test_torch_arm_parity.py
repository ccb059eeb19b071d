"""The heavy-blur quality arms' steps against the JAX package's, at the
celeba64 layout on narrow widths: ``--gen_upsample resize``, ``--ttur_g_lr
0.002`` and ``--adaptive`` (arms 6-8 of ``tests/torch_fullwidth_parity.py``,
whose :func:`run_arm` runs both sides from one JAX state with the same
batches and draws).

Each step's two losses are held at rtol 1e-5 of the larger of the loss and
the critic's mean real score: both are means of critic scores, so a loss
near 0 is a difference of scores of that size and carries their rounding.
The ttur arm also holds both networks' Adam rates, as set and as read back
from the first update, on both sides; the adaptive arm holds σ and the
controller's state after every step to JAX's, each side's controller fed
that side's own scores.
"""

import pytest

import torch_fullwidth_parity as harness
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: threefry draws)
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RTOL = 1e-5
ARMS = {"resize": 6, "ttur": 7, "adaptive": 8}


@pytest.fixture(autouse=True, scope="module")
def no_summaries():
    from blurred_gan_tpu_torch.utils import logging as logging_mod

    writer = logging_mod._summary_writer
    logging_mod._summary_writer = lambda log_dir: None
    yield
    logging_mod._summary_writer = writer


def arm_lines(n):
    lines = []
    harness.run_arm(n, lines.append, narrow=True)
    assert [ln["step"] for ln in lines] == list(range(harness.ARMS[n]["steps"]))
    assert {ln["compare"] for ln in lines} == {"port_vs_jax_exact"}
    return lines


@pytest.mark.parametrize("name", list(ARMS))
def test_arm_steps_match_jax(name):
    n = ARMS[name]
    lines = arm_lines(n)
    for ln in lines:
        losses = ln["losses"]
        scale = abs(losses["real_scores"]["want"])
        for key in ("disc_loss", "gen_loss"):
            got, want = losses[key]["got"], losses[key]["want"]
            assert abs(got - want) <= RTOL * max(abs(want), scale), (name, ln["step"], key,
                                                                     got, want)
        assert losses["did_gen_step"]["got"] == losses["did_gen_step"]["want"] == 1.0
        assert losses["std"]["got"] == losses["std"]["want"]
        for net in ("generator", "discriminator"):
            assert ln["update_rel_l2"][net] < 1e-2, (name, ln["step"], net, ln["update_rel_l2"])

    if name == "ttur":
        rates = lines[0]["adam_lr"]
        want = {"generator": 0.002, "discriminator": 0.001}
        assert rates["port_set"] == want
        for side in ("port", "jax"):
            for net, lr in want.items():
                assert rates[side][net] == pytest.approx(lr, rel=1e-4), (side, net, rates)
    else:
        assert all("adam_lr" not in ln for ln in lines)

    if name == "adaptive":
        sigma = harness.quality.CONFIGS["celeba64"].sigma0
        for ln in lines:
            port, ref = ln["controller"]["port"], ln["controller"]["jax"]
            assert ln["controller"]["sigma_equal"]
            assert port["sigma_in"] == ref["sigma_in"] == sigma
            assert ln["losses"]["std"]["want"] == pytest.approx(sigma, rel=1e-7)  # float32
            assert port["sigma_after"] == ref["sigma_after"]
            assert port["last_modification_batch"] == ref["last_modification_batch"]
            assert port["score_ratio"] == pytest.approx(ref["score_ratio"], rel=1e-6)
            sigma = ref["sigma_after"]
        # The closed loop ran: σ moved after the first step.
        first, last = lines[0]["controller"]["jax"], lines[-1]["controller"]["jax"]
        assert last["sigma_after"] < first["sigma_in"]
    else:
        assert all("controller" not in ln for ln in lines)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_long_free_run(n):
    """Plain, ``--d_steps 2`` and ``--ref_grad_scale`` for six steps with
    each side running freely (``long_arm``): the losses, the generator step's
    gate, both networks' parameters, the generator's running statistics and
    the eval generator's output stay with JAX's after every step. The losses
    are held at 1e-4 of their scale: free, the two sides' parameters part by
    rounding step after step (the six-step run of arm 3 reaches 1.8e-5)."""
    lines = []
    harness.long_arm(n, 6, lines.append, narrow=True)
    assert [ln["step"] for ln in lines] == list(range(6))
    for ln in lines:
        losses = ln["losses"]
        scale = abs(losses["real_scores"]["want"])
        for key in ("disc_loss", "gen_loss"):
            got, want = losses[key]["got"], losses[key]["want"]
            assert abs(got - want) <= 1e-4 * max(abs(want), scale), (n, ln["step"], key)
        gen = losses["did_gen_step"]
        assert gen["got"] == gen["want"] == (1.0 if n != 2 or ln["step"] % 2 == 0 else 0.0)
        assert max(ln["params_rel_l2"].values()) < 1e-3, (n, ln["step"], ln["params_rel_l2"])
        assert ln["running_stats_rel_l2"] < 1e-5, (n, ln["step"])
        assert ln["eval_out"]["max_abs"] < 1e-4, (n, ln["step"], ln["eval_out"])
