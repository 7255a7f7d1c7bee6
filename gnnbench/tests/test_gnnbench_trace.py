"""The trace reading on a made-up Chrome trace, and the readers on it."""

import pytest

from gnnbench import flops
from gnnbench import trace as tracing
from gnnbench.readers import Context, per_step_ms, roofline_pct


def x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def events():
    ev = [
        # the replays: 0..100 us, device busy 10..40 and 50..90
        x("gnnbench.replays", "user_annotation", 0, 100),
        x("cudaGraphLaunch", "cuda_runtime", 1, 5, correlation=1),
        x("cudaDeviceSynchronize", "cuda_runtime", 8, 92),
        x("k_a", "kernel", 10, 30, tid=7, correlation=1),
        x("k_b", "kernel", 50, 40, tid=7, correlation=1),
        # the eager steps: 200..400 us
        x("gnnbench.eager", "user_annotation", 200, 200),
        x("gnnbench.plan", "user_annotation", 210, 20),
        x("cudaLaunchKernel", "cuda_runtime", 212, 2, correlation=10),
        x("gnnbench.model", "user_annotation", 240, 100),
        x("glt::gather_rows", "cpu_op", 245, 10),
        x("cudaLaunchKernel", "cuda_runtime", 247, 2, correlation=11),
        # a backward operator on the autograd thread
        x("glt::gat_block_backward", "cpu_op", 300, 20, tid=2),
        x("cudaLaunchKernel", "cuda_runtime", 305, 2, tid=2, correlation=12),
        x("sample", "kernel", 215, 4, tid=7, correlation=10),
        x("gather_rows_kernel", "kernel", 250, 6, tid=7, correlation=11),
        # launched where the profiler saw no runtime call: between two of
        # the backward operator's launches, so it counts there
        x("bwd_a", "kernel", 310, 3, tid=7, correlation=12),
        x("bwd_mid", "kernel", 314, 2, tid=7, correlation=99),
        x("bwd_b", "kernel", 317, 3, tid=7, correlation=12),
    ]
    return ev


def test_summarize():
    s = tracing.summarize(events(), replay_steps=4, eager_steps=2)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(70e-6)
    assert s.device_ops[0] == ("k_b", pytest.approx(40e-6))
    # idle: 0..10 and 40..50 under the synchronise or the launch, 90..100
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(30e-6)
    assert s.span_device_s["plan"] == pytest.approx(4e-6)
    assert s.span_device_s["model"] == pytest.approx(14e-6)
    assert s.op_device_s["glt::gather_rows"] == pytest.approx(6e-6)
    assert s.op_device_s["glt::gat_block_backward"] == pytest.approx(8e-6)
    assert s.op_calls == {"glt::gather_rows": 1,
                          "glt::gat_block_backward": 1}
    assert s.unattributed_s == 0


def test_readers_on_the_summary():
    s = tracing.summarize(events(), replay_steps=4, eager_steps=2)
    peaks = flops.load_peaks("h100_sxm")
    w = flops.gather_rows(10, 10, 100, 4)
    ctx = Context(trace=s, step_work=flops.Work(products=1e6),
                  kernel_work={"glt::gather_rows": [w]}, peaks=peaks,
                  store_build_s=1.0)
    assert per_step_ms(ctx, "plan") == pytest.approx(2e-3)
    assert roofline_pct(ctx, "glt::gather_rows") == pytest.approx(
        100 * w.bytes / peaks["hbm_bytes_per_s"] / 6e-6)
    # a launch count other than the model's expects: silent
    ctx.kernel_work["glt::gather_rows"] = [w, w]
    assert roofline_pct(ctx, "glt::gather_rows") is None
    assert roofline_pct(ctx, "glt::segment_spmm") is None
    ctx.trace = None
    assert per_step_ms(ctx, "plan") is None
