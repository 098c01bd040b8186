"""The traced window's summary from a Chrome trace's events: busy time as
the union of device intervals, device time by the harness's ranges
through launch correlation ids, idle gaps by the host's range."""
from benchcore.trace import summarize


def test_summary_of_a_small_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "engine.dispatch",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.decode_step",
         "ts": 10, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "engine.emit",
         "ts": 150, "dur": 150, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 15, "dur": 5, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 40, "dur": 50,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 80, "dur": 40,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 250, "dur": 10,
         "args": {"correlation": 9}},
    ]
    s = summarize(ev, window_s=300e-6)
    assert abs(s["busy_s"] - 90e-6) < 1e-12          # [40, 120] and [250, 260]
    assert s["by_range"]["bench.decode_step"]["count"] == 1
    assert abs(s["by_range"]["bench.decode_step"]["device_s"] - 90e-6) < 1e-12
    assert abs(s["by_range"]["engine.dispatch"]["device_s"] - 90e-6) < 1e-12
    assert s["device_ops"][0][0] == "k_a"
    # the one gap, [120, 250], has its middle inside emit
    assert s["idle_gaps"] == [("engine.emit", 130e-6)]
