"""Each per-layer reader computes its metric from a small stored trace
(``data/small_trace.json``: a window of 100 ms holding two chunks)."""

from pathlib import Path

import pytest

from portbench.spec import Spec
from portbench.trace import Trace

TRACE = Trace.from_json((Path(__file__).parent / "data" / "small_trace.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"


class Reader:
    def __init__(self, facts, dtype="bfloat16", device=H100):
        self.trace, self.facts, self.device_name = TRACE, facts, device
        self.config = {"compute_dtype": dtype}

    def peak(self, what):
        from portbench.peaks import peak
        return peak(self.device_name, what)


FACTS = {"steps": 2, "images": 10, "step_flops": 989.4e12 * 0.1 * 0.01 / 2,
         "blur_bytes_per_step": 3.35e9, "blur_flops_per_step": 66.9e12 * 0.5e-3,
         "generator_flops_per_image": 989.4e9}


@pytest.mark.parametrize("name, expected", [
    ("device_idle.train", 15.0),
    ("device_idle.train.mnist28", 15.0),
    ("device_idle.sample", 15.0),
    ("chunk_gap_ms.train", 9.0),
    ("chunk_gap_ms.train.mnist28", 9.0),
    ("copy_share.train", 100.0 * 10 / 85),
    ("copy_share.train.mnist28", 100.0 * 10 / 85),
    ("blur_roofline.train", 50.0),
    ("blur_roofline.train.mnist28", 50.0),
    ("mfu.train", 1.0),
    ("mfu.train.mnist28", 1.0),
    ("mfu.sample", 10.0),
])
def test_reader_values(name, expected):
    assert Spec().metric(name).read(Reader(FACTS)) == pytest.approx(expected, rel=1e-9)


@pytest.mark.parametrize("name", ["mfu.train", "mfu.train.mnist28", "mfu.sample",
                                  "blur_roofline.train", "blur_roofline.train.mnist28"])
def test_share_of_a_peak_is_left_out_on_an_unknown_card(name):
    assert Spec().metric(name).read(Reader(FACTS, device="NVIDIA A10")) is None


def test_trace_window_busy_and_breakdown():
    lo, hi = TRACE.window()
    assert (lo, hi) == (0, 100_000_000)
    assert TRACE.busy_ns() == 85_000_000
    b = TRACE.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_gemm_bf16", pytest.approx(0.071)]
    assert b["idle_gaps"] == [["host: no traced operation", pytest.approx(0.014)],
                              ["cudaEventSynchronize", pytest.approx(0.001)]]


def test_trace_round_trips_through_json():
    again = Trace.from_json(TRACE.to_json())
    assert again.device_ops == TRACE.device_ops and again.marks == TRACE.marks
