"""The trace readers on a hand-made Chrome trace of two steps: the
benchmark's readers read the same with and without the program's spans in
it, and `program_trace`'s readings equal the values worked out by hand;
then `program_trace.trace_cell` on a small cell on the CPU."""
import pytest
import torch

from featbench import harness
from featbench import program_trace as PT
from featbench import trace as TR
from featbench.testutil import tiny_root

OURS = frozenset({"fast_harris_kernel", "nms_cells_kernel"})


def _x(name, cat, ts, dur, corr=None):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _step(o: float, c: int, program: bool) -> list:
    """A step at `o` us: a `port` span around a detect-and-compute call
    (upload, pyramid, one level, the wait) with one launch after the
    program's span closes, a `port` span around RANSAC, a `bench` span of
    glue; correlation ids from c."""
    ann = "user_annotation"
    ev = [_x("featbench/step", ann, o, 100),
          _x("featbench/detect_and_compute", ann, o + 5, 90),
          _x("featbench/find_homography_ransac", ann, o + 96, 3.5),
          _x("featbench/glue", ann, o + 99.5, 0.4),
          _x("cudaMemcpyAsync", "cuda_runtime", o + 8, 1, c + 5),
          _x("cudaLaunchKernel", "cuda_runtime", o + 13, 0.5, c + 1),
          _x("cudaLaunchKernel", "cuda_runtime", o + 31, 0.5, c + 2),
          _x("cudaStreamSynchronize", "cuda_runtime", o + 60, 30),
          _x("cudaLaunchKernel", "cuda_runtime", o + 94.5, 0.2, c + 4),
          _x("cudaLaunchKernel", "cuda_runtime", o + 97, 0.2, c + 3),
          _x("cuLaunchKernel", "cuda_driver", o + 99.6, 0.05, c + 6),
          _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", o + 9, 2,
             c + 5),
          _x("void fast_harris_kernel(unsigned char const*, int)", "kernel",
             o + 14, 6, c + 1),
          _x("nms_cells_kernel", "kernel", o + 40, 30, c + 2),
          _x("void at::native::elementwise_kernel<128, 2>()", "kernel",
             o + 95, 1, c + 4),
          _x("void at::native::vectorized_elementwise_kernel<4>()",
             "kernel", o + 98, 1, c + 3),
          _x("void at::native::reduce_kernel<512, 1>()", "kernel",
             o + 99.7, 0.1, c + 6),
          {"ph": "f", "name": "ac2g", "cat": "ac2g", "ts": o + 13, "id": c}]
    if program:
        ev += [_x("eff/api.detect_and_compute", ann, o + 6, 88),
               _x("eff/api.upload", ann, o + 7, 5),
               _x("eff/pipeline.pyramid", ann, o + 12, 18),
               _x("eff/pipeline.detect_level", ann, o + 30, 30),
               _x("eff/wait.block", ann, o + 60, 30),
               _x("eff/ops.find_homography_ransac", ann, o + 96.5, 2.5)]
    return ev


def _events(program: bool = True) -> list:
    return _step(0, 0, program) + _step(100, 10, program)


PORTS = {"detect_and_compute", "find_homography_ransac"}
FRAMES = 2


def _ctx(events):
    cell = harness.Cell("t", {}, {}, [], [])
    return harness.Context(cell, tr=TR.parse(events), frames_traced=FRAMES,
                           ours=OURS)


@pytest.mark.parametrize("metric", ["glue_ms", "kernel_ms", "match_verify_ms",
                                    "idle_share"])
def test_benchmark_readers_ignore_the_programs_spans(metric):
    read = harness.reader(metric)
    with_spans, without = read(_ctx(_events())), read(_ctx(_events(False)))
    assert with_spans is not None and with_spans == without
    want = {"glue_ms": 2.1e-3, "kernel_ms": 0.036, "match_verify_ms": 1e-3,
            "idle_share": 59.9}[metric]
    assert with_spans == pytest.approx(want)


def test_benchmark_parse_ignores_the_programs_spans():
    a, b = TR.parse(_events()), TR.parse(_events(False))
    assert a.ops == b.ops and a.host_spans == b.host_spans
    assert a.window == b.window == (0.0, 200.0)
    assert TR.breakdown(a) == TR.breakdown(b)


def test_program_readings_by_hand():
    r = PT.readings(_events(), FRAMES, PORTS)
    # [6, 94] and [96.5, 99] less the wait [60, 90]
    assert r["host_work_ms"] == pytest.approx(60.5e-3)
    # idle [6, 9], [11, 14], [20, 40], [90, 94], [96.5, 98]
    assert r["idle_host_ms"] == pytest.approx(31.5e-3)
    assert r["launches_per_frame"] == 3          # at 13, 31 and 97
    assert (r["launches"], r["launches_uncovered"]) == (10, 2)   # 94.5
    assert r["spans_per_frame"] == 6
    assert r["traced_step_ms"] == [0.1, 0.1]
    assert r["idle_share"] == pytest.approx(59.9)


def test_program_readings_without_the_programs_spans():
    r = PT.readings(_events(False), FRAMES, PORTS)
    assert r["host_work_ms"] is None and r["idle_host_ms"] is None
    assert r["launches_per_frame"] is None
    assert r["launches_uncovered"] == 8    # each launch in a port span


def test_stages_name_each_gap_by_its_innermost_span():
    stages = PT.readings(_events(), FRAMES, PORTS)["stages"]
    idle = {"step": 5.1, "detect_and_compute": 2.0,
            "eff/api.detect_and_compute": 5.0, "eff/api.upload": 3.0,
            "eff/pipeline.pyramid": 12.0, "eff/pipeline.detect_level": 10.0,
            "eff/wait.block": 20.0, "find_homography_ransac": 1.0,
            "eff/ops.find_homography_ransac": 1.5, "glue": 0.3}
    device = {"eff/api.upload": 2.0, "eff/pipeline.pyramid": 6.0,
              "eff/pipeline.detect_level": 30.0, "detect_and_compute": 1.0,
              "eff/ops.find_homography_ransac": 1.0, "glue": 0.1}
    launches = {"eff/pipeline.pyramid": 1, "eff/pipeline.detect_level": 1,
                "detect_and_compute": 1, "eff/ops.find_homography_ransac": 1,
                "glue": 1}
    syncs = {"eff/api.upload": 1, "eff/wait.block": 1}
    assert set(stages) == set(idle)
    for name, row in stages.items():
        assert row["idle_ms"] == pytest.approx(idle[name] * 1e-3), name
        assert row["device_ms"] == pytest.approx(
            device.get(name, 0.0) * 1e-3), name
        assert row["launches"] == launches.get(name, 0), name
        assert row["syncs"] == syncs.get(name, 0), name


def test_interval_sets():
    xs = PT.merged([(5, 7), (0, 2), (1, 3), (7, 9)])
    assert xs == [[0, 3], [5, 9]]
    assert PT.minus(xs, [[1, 2], [4, 6], [8, 10]]) == [[0, 1], [2, 3],
                                                       [6, 8]]
    assert PT.meet(xs, [[2, 6], [8, 10]]) == [[2, 3], [5, 6], [8, 9]]
    assert PT.length(xs) == 7
    assert PT.within(9, xs) and not PT.within(4, xs)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,stage", [
    ("tiny.single", "eff/pipeline.detect_level"),
    ("tiny.batch", "eff/sharding.frame"),
    ("tiny.sequence", "eff/ransac.solve_score")])
def test_trace_cell_on_the_cpu(root, cell, stage):
    r = PT.trace_cell(cell, 2 ** 31 + 5, 1, "cpu", root)
    assert r["device"] == "cpu" and r["frames"] >= 2
    assert r["spans_per_frame"] > 0 and r["host_work_ms"] > 0
    assert stage in r["stages"]
    assert r["launches"] == 0           # no kernel launches on the CPU
    assert r["span_cost_us"] > 0
