"""Each per-layer metric's arithmetic on a recorded profile, and the
frozen work models against hand counts."""
import json

import numpy as np
import pytest

from bench import harness as H
from bench.trace import Trace
from bench.workmodels import cgp_sim, flash_attention, lm_step, lut_matmul
from conftest import DATA, REPO


@pytest.fixture
def trace():
    r = json.loads((DATA / "recorded_profile.json").read_text())
    return Trace(device=[tuple(d) for d in r["device"]],
                 host=[tuple(h) for h in r["host"]], window_s=r["window_s"],
                 calls=r["calls"], spans=r["spans"], info=r["info"])


def read(name, trace):
    return H.reader(name)(trace)


def test_busy_and_idle(trace):
    # union: [1000, 3000] + [3500, 6000] + [7000, 8000] + [9000, 9100] us
    assert trace.busy_s() == pytest.approx(5.6e-3)
    for cell in ("sweep", "eval", "decode"):
        assert read(f"device_idle.{cell}", trace) == pytest.approx(44.0)


def test_rooflines(trace):
    # 2 calls of 1 ms bound over 2 launches of 2 ms: 50%
    assert read("lut_matmul_roofline.decode", trace) == pytest.approx(50.0)
    assert read("lut_matmul_roofline.eval", trace) == pytest.approx(50.0)
    assert read("flash_attention_roofline", trace) == pytest.approx(25.0)
    assert read("cgp_sim_roofline", trace) is None      # nothing recorded


def test_roofline_needs_the_launches_of_the_calls(trace):
    trace.calls["lut_matmul"] = [1.0] * 3               # 2 of 3 traced
    assert read("lut_matmul_roofline.eval", trace) is None


def test_spans_mfu_and_glue(trace):
    assert read("decode.enqueue_ms", trace) == pytest.approx(3.0)
    # 9.89e11 FLOPs in 10 ms at 989 TFLOP/s: 10%
    assert read("mfu.decode", trace) == pytest.approx(10.0)
    # outside lut_matmul: 0.6 + 1.0 + 0.1 ms over 2 steps
    assert read("decode.glue_device_ms", trace) == pytest.approx(0.85)
    assert read("sweep.mutate_ms", trace) is None


def test_breakdown(trace):
    b = trace.breakdown()
    assert b["device_ops"][0] == ["lut_matmul_kernel<8, 4>",
                                  pytest.approx(4e-3)]
    assert len(b["device_ops"]) == 4
    gaps = dict(b["idle_gaps"])
    # 3000-3500 and 6000-7000 under decode_step/argmax, 8000-9000 argmax
    assert gaps["decode_step"] == pytest.approx(0.5e-3)
    assert gaps["argmax"] == pytest.approx(2e-3)


def test_every_metric_has_a_reader():
    spec = H.load_spec()
    for m in spec["per_layer"]:
        assert callable(H.reader(m["name"]))
        assert H.reader(m["name"])(Trace()) is None


def test_lut_and_flash_bounds_by_hand():
    # an int32 add a product at 67e12 / 4 a second
    assert lut_matmul.bound_ms(128, 2048, 8192) == pytest.approx(
        128 * 2048 * 8192 / (67e12 / 4) * 1e3)
    assert round(lut_matmul.bound_ms(128, 2048, 8192), 4) == 0.1282
    # 4·D FLOPs a causal pair of each head at 989 TFLOP/s
    pairs = 32768 * 32769 // 2
    assert flash_attention.bound_ms(1, 32, 8, 32768, 32768, 64, 2) == \
        pytest.approx(4 * 32 * 64 * pairs / 989e12 * 1e3)
    assert flash_attention.pairs(4, 6) == 10
    assert flash_attention.pairs(6, 4) == 18


def test_cgp_bound_counts_active_gates_only():
    from repro_torch.launch import roofline as RL
    # every node active: the program's own count (R·n_n·W gate-words)
    full = cgp_sim.bound_ms(256 * 400, 256, 16, 400, 16, 2048)
    assert full == pytest.approx(RL.bound_ms(256, 16, 400, 16, 2048)[0])
    # a genome with a quarter of its gates active needs less, never more
    quarter = cgp_sim.bound_ms(256 * 100, 256, 16, 400, 16, 2048)
    assert quarter < full
    # per gate-word: 4 int32 operations, 1 popcount, 3 shared accesses;
    # the shared accesses bound it when the gates dominate
    gate_words = 256 * 400 * 2048
    assert full == pytest.approx(gate_words * 3 / (67e12 / 8) * 1e3)


def test_active_counts_by_hand():
    # inputs 0, 1; gate 2 = AND(0, 1), gate 3 = INV(2) (its b unused),
    # gate 4 = OR(0, 0) unused; output: gate 3
    nodes = np.array([[[0, 1, 2], [2, 4, 1], [0, 0, 3]]])
    one_input = np.array([1, 1, 0, 0, 0, 0, 0, 0])
    assert cgp_sim.active_counts(nodes, np.array([[3]]), 2,
                                 one_input).tolist() == [2]
    assert cgp_sim.active_counts(nodes, np.array([[0]]), 2,
                                 one_input).tolist() == [0]


def test_model_flops_by_hand():
    cfg = json.loads((REPO / "bench" / "configs" / "phi4_mini.json")
                     .read_text())
    d, f, hd = 3072, 8192, 128
    layer = d * 3072 * 2 + d * 1024 * 2 + 3 * d * f
    macs = 32 * layer + d * 200064
    assert lm_step.projection_macs(cfg) == macs
    attn = 4 * 24 * hd * 32 * 4096 * 4097 // 2
    assert lm_step.forward_flops(cfg, 1, 4096) == 2 * macs * 4096 + attn
    assert lm_step.decode_flops(cfg, 256, 600) == \
        2 * macs * 256 + 4 * 24 * hd * 32 * 256 * 600
