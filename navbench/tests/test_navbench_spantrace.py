"""The program's spans against a trace (``navbench/spantrace.py``) on
synthetic events: device operations to the innermost span holding the
runtime call with their correlation id, self time, host syncs inside and
outside the program's spans, unattributed operations, idle gaps to the
innermost program span inside a harness label; and ``navbench.spanrun``
end to end on the CPU's tiny cells."""

import pytest

import tiny
from img_env_tpu_torch.utils import trace
from navbench import spanrun, spantrace

US = 1000     # ns per µs: program spans are in ns, events in µs

# program spans (ns): a step holding an advance (with the crowd) and an
# observation (with the sensor pass); an act after it
SPANS = [("env.step", -1, 0 * US, 100 * US),
         ("env.advance", 0, 5 * US, 40 * US),
         ("env.crowd", 1, 10 * US, 30 * US),
         ("env.observe", 0, 50 * US, 90 * US),
         ("env.sensor", 3, 60 * US, 80 * US),
         ("mpc.act", -1, 120 * US, 160 * US)]
# the harness's calls (µs): the env step and the act, and a host read
LABELS = [("env_step", 0.0, 105.0), ("host_read", 106.0, 110.0),
          ("act", 115.0, 165.0)]
# runtime calls (name, start, end, correlation), µs
CALLS = [("cudaLaunchKernel", 12.0, 13.0, 1),       # in env.crowd
         ("cudaLaunchKernel", 20.0, 21.0, 2),       # in env.crowd
         ("cudaLaunchKernel", 35.0, 36.0, 3),       # in env.advance
         ("cudaLaunchKernelExC", 61.0, 62.0, 4),    # in env.sensor
         ("cudaMemsetAsync", 85.0, 86.0, 5),        # in env.observe
         ("cudaLaunchKernel", 102.0, 103.0, 6),     # env_step label only
         ("cudaMemcpyAsync", 107.0, 108.0, 7),      # host_read
         ("cudaStreamSynchronize", 108.0, 109.0, 8),
         ("cudaStreamSynchronize", 25.0, 26.0, 9),  # in env.crowd
         ("cudaLaunchKernel", 130.0, 131.0, 10),    # in mpc.act
         ("cudaLaunchKernel", 170.0, 171.0, 11)]    # outside everything
# device operations (name, start, end, correlation), µs
OPS = [("add_kernel", 14.0, 16.0, 1), ("mul_kernel", 22.0, 24.0, 2),
       ("limiter", 37.0, 38.0, 3), ("sgemm_nn", 63.0, 70.0, 4),
       ("Memset (Device)", 86.0, 87.0, 5), ("noise", 103.0, 104.0, 6),
       ("Memcpy DtoH", 108.0, 108.5, 7), ("rollout", 132.0, 140.0, 10),
       ("late", 171.0, 172.0, 11), ("lost", 180.0, 181.0, 99)]


def test_innermost_span_chain():
    who = spantrace.Owners(SPANS, LABELS)
    assert who.chain(12.0) == ["env.crowd", "env.advance", "env.step"]
    assert who.chain(35.0) == ["env.advance", "env.step"]
    assert who.chain(45.0) == ["env.step"]
    assert who.chain(102.0) == [] and who.owner(102.0) == "env_step"
    assert who.owner(130.0) == "mpc.act"
    assert who.owner(170.0) == "other"


def test_ops_go_to_the_span_that_issued_them():
    att = spantrace.attribute(OPS, CALLS, SPANS, LABELS)
    own = dict(att["self"])
    assert own == {"env.crowd": 2, "env.advance": 1, "env.sensor": 1,
                   "env.observe": 1, "env_step": 1, "host_read": 1,
                   "mpc.act": 1, "other": 1, "unattributed": 1}
    within = {k: len(v) for k, v in att["within"].items()}
    assert within == {"env.step": 5, "env.advance": 3, "env.crowd": 2,
                      "env.observe": 2, "env.sensor": 1, "mpc.act": 1}
    assert att["unattributed"] == 1


def test_syncs_inside_and_outside_program_spans():
    got = spantrace.syncs(CALLS, SPANS, LABELS)
    assert got == {"inside": {"env.crowd": {"cudaStreamSynchronize": 1}},
                   "outside": {"host_read": {"cudaStreamSynchronize": 1}}}


def test_idle_gaps_go_to_the_innermost_program_span():
    gaps = dict(spantrace.idle_gaps(OPS, SPANS, LABELS, 0.0, 200.0))
    # busy 14-16, 22-24, 37-38, 63-70, 86-87, 103-104, 108-108.5, 132-140,
    # 171-172, 180-181: each gap to the span holding its midpoint
    want = {"env.advance": 14 + 13, "env.crowd": 6, "env.observe": 25,
            "env.sensor": 16, "env.step": 16, "host_read": 4,
            "mpc.act": 23.5 + 31, "other": 8 + 19}
    assert gaps == {k: pytest.approx(v / 1e6) for k, v in want.items()}
    assert "env_step" not in gaps     # every gap under it has a span


def test_host_table_whole_and_self_time():
    table = spantrace.host_table(SPANS, trace.self_ns(SPANS),
                                 {"reset.scenes": 4}, 2)
    rows = table["spans"]
    assert rows["env.step"]["ms"] == pytest.approx(0.1 / 2)
    assert rows["env.step"]["self_ms"] == pytest.approx((100 - 35 - 40)
                                                        / 1e3 / 2)
    assert rows["env.advance"]["self_ms"] == pytest.approx(15 / 1e3 / 2)
    assert rows["env.crowd"]["self_ms"] == rows["env.crowd"]["ms"]
    assert rows["env.crowd"]["calls"] == 0.5
    assert table["counts"] == {"reset.scenes": 4}


def test_reduce_and_metrics():
    dev = spantrace.reduce(OPS, CALLS, SPANS, LABELS, 0.0, 200.0, 2)
    assert dev["ops"] == 10 and dev["unattributed"] == 1
    assert dev["ops_within"]["env.crowd"] == 1.0
    assert dev["device_ms_within"]["env.crowd"] == pytest.approx(4e-3 / 2)
    assert dev["sensor_ms"] == pytest.approx(7e-3 / 2)
    assert dev["sensor_gemm_share"] == pytest.approx(1.0)
    spans = SPANS + [("batch.reset_local", -1, 200 * US, 260 * US),
                     ("reset.states", 6, 210 * US, 250 * US)]
    host = spantrace.host_table(spans, trace.self_ns(spans),
                                {"reset.scenes": 3}, 2)
    got = spantrace.metrics(host, dev, batch=True)
    assert got == {
        "crowd_ms.batch": pytest.approx(0.01),
        "reset_ms.batch": pytest.approx(0.06 / 3),
        "crowd_ops_per_step.batch": 1.0,
        "act_ops_per_step.batch": 0.5,
        "sensor_device_ms.batch": pytest.approx(3.5e-3),
        "host_syncs_per_step.batch": 0.5}
    # nothing to read: nothing reported
    assert spantrace.metrics(None, None, batch=False) == {}
    bare = spantrace.host_table([("env.step", -1, 0, 10 * US)], [10 * US],
                                {}, 1)
    assert spantrace.metrics(bare, None, batch=False) == {}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    return str(d), tiny.make_checkout(str(d))


@pytest.mark.parametrize("cell,want", [
    ("stage5.eval50", {"env.step", "env.advance", "env.crowd",
                       "env.dynamics", "env.observe", "env.raster",
                       "env.sensor", "env.peds", "policy.forward"}),
    ("bench200.mppi", {"env.step", "env.advance", "env.dynamics",
                       "env.observe", "env.raster", "env.sensor", "mpc.act",
                       "mpc.predict", "mpc.solve", "mpc.neighbours",
                       "mpc.edt", "mpc.rollout"})])
def test_spanrun_on_the_cpu(checkout, cell, want):
    d, bench = checkout
    res = spanrun.run_spans(bench, cell, 3000000021, 0.5, "cpu", d)
    assert set(res["host"]["spans"]) == want
    assert res["setup_statics_s"] > 0
    assert res["device"] is None          # no card: no trace
    assert set(res["metrics"]) == ({"crowd_ms.batch"}
                                   if cell.startswith("stage5") else set())
