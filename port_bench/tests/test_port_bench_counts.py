"""The benchmark's counts against numbers worked by hand."""

from __future__ import annotations

import pytest

from port_bench import counts


def test_one_conv():
    # 3x3, 512 -> 512 at 4x4: 2 * 512 * 9 * 512 * 16 = 75,497,472
    assert counts.conv_flops(512, 512, 3, 4, 4) == 75_497_472


def test_one_bottleneck():
    # layer1's block0 at 200x272 from 64 channels: 1x1 64->64, 3x3 64->64,
    # 1x1 64->256 and the 1x1 64->256 downsample
    hw = 200 * 272
    want = 2 * hw * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    # 73,728 multiply-adds a pixel
    assert counts.stage_flops(64, 64, 1, 200, 272) == want == 8_021_606_400


def test_trunk_sizes_and_head():
    t = counts.trunk_parts(800, 1216)
    assert t["layer1_hw"] == (200, 304) and t["feat_hw"] == (50, 76)
    # the head: layer4 at 4x4 a roi, blocks 1024->(512)->2048 then two of 2048
    block0 = 2 * 16 * (1024 * 512 + 9 * 512 * 512 + 512 * 2048 + 1024 * 2048)
    rest = 2 * 16 * (2048 * 512 + 9 * 512 * 512 + 512 * 2048)
    assert counts.head_flops(1, 81) == block0 + 2 * rest + 2 * 2048 * 81 * 5


def test_one_roi_align_avg_bwd_call():
    # grad [256, 7, 7, 1024] bf16, rois [256, 5] f32, features [2, 50, 76, 1024] bf16
    ops, nbytes, peak = counts.roi_align_avg_bwd_work(
        [[256, 7, 7, 1024], [256, 5]], ["c10::BFloat16", "float"], [2, 50, 76, 1024])
    assert ops == 1024 * 256 * (8 * 64 + 4 * 49) == 185_597_952
    assert nbytes == 2 * (256 * 49 * 1024 + 2 * 50 * 76 * 1024) + 4 * 256 * 5
    assert peak == counts.PEAK_F32
    # bytes-bound: 41.26 MB at 3.35 TB/s is 12.32 us, the ops 2.8 us
    assert nbytes / counts.PEAK_BYTES > ops / peak
    assert nbytes / counts.PEAK_BYTES == pytest.approx(12.316e-6, rel=1e-3)


def test_kernel_names_map_to_ops():
    assert counts.kernel_op("void bottleneck_wgmma<...>") == "rlod::res_stage"
    assert counts.kernel_op("roi_align_avg_bwd_rows") == "rlod::roi_align_avg_bwd"
    assert counts.kernel_op("sm90_xmma_fprop") is None


def test_train_step_flops_per_image():
    # the flagship's step at 800x1088, 128 rois an image: ~0.9-1.0 TFLOP an image
    per_image = counts.train_step_flops(2, 800, 1088, 128, 81) / 2
    assert 0.8e12 < per_image < 1.1e12


def _events():
    """A tiny chrome trace: one `rlod::roi_align_avg_bwd` call on thread 1
    whose launch (correlation 7) ran a 20 us kernel, a cuDNN kernel
    launched outside any op, and the window's marks."""
    op = {"cat": "cpu_op", "name": "rlod::roi_align_avg_bwd", "tid": 1, "ts": 100.0, "dur": 50.0,
          "args": {"Input Dims": [[256, 7, 7, 1024], [256, 5], [], []],
                   "Input type": ["c10::BFloat16", "float", "ScalarList", "Scalar"],
                   "Concrete Inputs": ["", "", "[2, 50, 76, 1024]", "0.0625"]}}
    return [op,
            {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 110.0, "dur": 5.0,
             "args": {"correlation": 7}},
            {"cat": "kernel", "name": "roi_align_avg_bwd_rows", "ts": 120.0, "dur": 20.0,
             "args": {"correlation": 7}},
            {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 200.0, "dur": 5.0,
             "args": {"correlation": 8}},
            {"cat": "kernel", "name": "sm90_xmma_fprop", "ts": 210.0, "dur": 30.0,
             "args": {"correlation": 8}},
            {"cat": "user_annotation", "name": "port_bench.window_start", "ts": 90.0},
            {"cat": "user_annotation", "name": "port_bench.window_end", "ts": 290.0}]


def test_trace_attributes_kernels_to_their_op():
    from port_bench.roofline import share
    from port_bench.trace import Trace

    t = Trace(_events(), (90.0, 290.0))
    assert t.busy_s() == pytest.approx(50e-6) and t.window_s == pytest.approx(200e-6)
    calls = t.op_device_s("rlod::roi_align_avg_bwd")
    assert len(calls) == 1 and calls[0][0] == pytest.approx(20e-6)
    # 41.26 MB of bytes at 3.35 TB/s over 20 us of device time
    assert share(t, "rlod::roi_align_avg_bwd") == pytest.approx(100 * 12.316e-6 / 20e-6,
                                                                 rel=1e-3)
    b = t.breakdown(counts.kernel_op)
    assert b["device_ops"][0] == ["sm90_xmma_fprop", pytest.approx(30e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(70e-6)


def test_a_call_without_device_time_fails_the_run():
    from port_bench.roofline import share
    from port_bench.trace import Trace

    events = [e for e in _events() if e.get("args", {}).get("correlation") != 7]
    with pytest.raises(RuntimeError, match="no device time"):
        share(Trace(events, (90.0, 290.0)), "rlod::roi_align_avg_bwd")
