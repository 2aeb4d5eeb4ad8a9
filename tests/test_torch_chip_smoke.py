"""The work counts and bounds that chip_smoke.py prints beside each kernel's
time, held to counts made by hand from the shapes. CPU only: chip_smoke
imports nothing but the standard library at module level."""

import pytest

import chip_smoke as C

SLICE = (16, 8, 1024, 32)  # the TransUNet bottleneck at 512^2: 1024 tokens


@pytest.mark.parametrize("kernel, shape, dtype, flop, nbytes, exp2", [
    # five (S, S, D) products; q, k, v, o, dO in and dq, dk, dv out (bf16),
    # lse2 in (float32); P recomputed by both kernels
    ("flash_bwd", SLICE, "bfloat16", 42.9e9, 67.6e6, 268.4e6),
    # two products; q, k, v in and o out, lse2 out
    ("flash_fwd", SLICE, "bfloat16", 17.2e9, 34.1e6, 134.2e6),
    # its two kernels: S^T, dP^T, dV, dK (+ delta) and S, dP, dQ
    ("flash_bwd_dkdv", SLICE, "bfloat16", 34.4e9, 59.8e6, 134.2e6),
    ("flash_bwd_dq", SLICE, "bfloat16", 25.8e9, 43.0e6, 134.2e6),
    # float32 moves twice the bytes for the same products
    ("flash_bwd", SLICE, "float32", 42.9e9, 134.7e6, 268.4e6),
    # the EDT's lower envelope: 26 integer operations a pixel, both passes
    ("edt", (16, 512, 512), "bfloat16", 109.05e6, 21.0e6, 0),
    # the exp2 probe: 512 x 16384 float32 read and written, one exp2 each
    ("exp2_probe", (512, 16384), "float32", 0, 67_108_864, 8_388_608),
    # the m-skip forward: the forward's two products at the probe's shape
    ("flash_fwd_mskip", (8, 8, 4096, 32), "bfloat16", 137_438_953_472,
     68_157_440, 1_073_741_824),
])
def test_work_counts_match_hand_counts(kernel, shape, dtype, flop, nbytes,
                                       exp2):
    w = C.work_counts(kernel, shape, dtype)
    assert w["flop"] == pytest.approx(flop, rel=2e-3)
    assert w["bytes"] == pytest.approx(nbytes, rel=2e-3)
    assert w["exp2"] == pytest.approx(exp2, rel=2e-3)


def test_bounds_at_the_slice_shape():
    """bf16 flash work is bound by the tensor cores (989 TFLOP/s) rather
    than the bytes (3.35 TB/s); the pair's exp2 floor (two passes of 134 M
    exp2 at 16 a clock on 132 SMs at 1980 MHz) lies above its FLOP bound;
    the EDT's lower envelope does 26 integer operations a pixel on the
    INT32 lanes (64 a clock per SM), a little longer than its 5 bytes a
    pixel take; the min-plus algorithm's add and min per (row, column,
    column) would have taken 0.0641 ms at the float32 rate."""
    ms, by, exp2_ms = C.bound("flash_bwd", SLICE)
    assert by == "operations"
    assert ms == pytest.approx(0.0434, rel=1e-2)
    assert exp2_ms == pytest.approx(0.0642, rel=1e-2)
    assert C.bound("flash_fwd", SLICE)[0] == pytest.approx(0.0174, rel=1e-2)
    edt_ms, edt_by, _ = C.bound("edt", (16, 512, 512))
    assert edt_by == "operations"
    assert edt_ms == pytest.approx(0.00652, rel=1e-2)
    assert C.bound("edt", (128, 256, 256))[0] == pytest.approx(0.01304,
                                                               rel=1e-2)
    edt_bytes = C.work_counts("edt", (16, 512, 512))["bytes"]
    assert edt_bytes / C.PEAK_BYTES * 1e3 == pytest.approx(0.00626,
                                                           rel=1e-2)
    minplus = C.work_counts("edt", (16, 512, 512))["minplus_flop"]
    assert minplus / C.PEAK_FLOPS["float32"] * 1e3 == pytest.approx(
        0.0641, rel=1e-2)
    # a product too thin for its bytes is bound by memory
    assert C.bound("flash_fwd", (64, 8, 64, 8))[1] == "bytes"


def test_redesign_order_follows_device_time(capsys):
    """The ratios to the fastest SDPA call come from one call between CUDA
    events (host latency included) and from queued device time; the
    redesign order follows the device time."""
    fwd = [dict(ms=0.17, library_ms=0.10, queue_ms=0.145,
                library_queue_ms=0.088, library="CUDNN_ATTENTION")]
    bwd = [dict(ms=0.50, library_ms=0.33, queue_ms=0.466,
                library_queue_ms=0.229, library="CUDNN_ATTENTION")]
    r = C.decide(fwd, bwd)
    assert r["r_fwd"] == pytest.approx(1.7)
    assert r["r_fwd"] > r["r_bwd"] and r["r_bwd_queued"] > r["r_fwd_queued"]
    out = capsys.readouterr().out
    assert out.rstrip().endswith(
        "slower than SDPA by device time: the backward pair, the forward")


@pytest.mark.parametrize("kernel, shape, ms", [
    # five products of 2 B H S^2 D FLOP at 495 / 3 TFLOP/s (3xTF32)
    ("flash_bwd", SLICE, 0.2603),
    ("flash_bwd_dkdv", SLICE, 0.2082),
    ("flash_bwd_dq", SLICE, 0.1562),
    ("flash_bwd", (2, 2, 1024, 128), 0.03254),
    ("flash_fwd", SLICE, 0.1041),
])
def test_float32_flash_bounds_at_the_3xtf32_rate(kernel, shape, ms):
    """float32 flash work is bound at the tensor cores' TF32 rate over
    three (a float32-accurate product as three TF32 products), not at the
    FMA rate of 67 TFLOP/s; the EDT's bound, its integer operations on the
    INT32 lanes, does not follow the dtype argument."""
    got, by, _ = C.bound(kernel, shape, "float32")
    assert by == "operations"
    assert got == pytest.approx(ms, rel=2e-3)
    assert C.bound("edt", (16, 512, 512), "float32") == C.bound(
        "edt", (16, 512, 512))
    w = C.work_counts("edt", (16, 512, 512))
    assert w["flop"] / C.INT32_OPS_PER_S * 1e3 == pytest.approx(
        0.00652, rel=1e-2)


def test_probe_bounds():
    """The exp2 probe is bound by its 67.1 MB at 3.35 TB/s (0.0200 ms; its
    exp2 alone 0.0020 ms of the unit); the m-skip forward at the probe's
    shape by the tensor cores (137.4 GFLOP at 989 TFLOP/s, 0.139 ms), under
    an exp2 floor of 0.257 ms."""
    ms, by, exp2_ms = C.bound("exp2_probe", (512, 16384))
    assert by == "bytes"
    assert ms == pytest.approx(0.0200, rel=2e-3)
    assert exp2_ms == pytest.approx(0.00201, rel=1e-2)
    ms, by, exp2_ms = C.bound("flash_fwd_mskip", (8, 8, 4096, 32))
    assert by == "operations"
    assert ms == pytest.approx(0.139, rel=2e-3)
    assert exp2_ms == pytest.approx(0.257, rel=2e-3)


@pytest.mark.parametrize("kernel, shape, ms, by", [
    # benchmarks/pallas_conv_probe.py at N128 128^2 C = CO = 128 bf16:
    # 618.5 GFLOP at 989 TFLOP/s, above its 1.09 GB (0.326 ms; the input
    # padded by one pixel)
    ("conv3x3", (128, 128, 128, 128, 128), 0.6254, "operations"),
    # the gather probes at N128 256^2: f32 values and int32 indices in, f32
    # out (100.7 MB); packed u16 (67.1 MB); u8 (50.3 MB)
    ("gather", (128, 256, 256, 4), 0.03005, "bytes"),
    ("gather", (128, 256, 256, 2), 0.02003, "bytes"),
    ("gather", (128, 256, 256, 1), 0.01502, "bytes"),
])
def test_bounds_of_the_probes_still_to_port(kernel, shape, ms, by):
    got, got_by, _ = C.bound(kernel, shape)
    assert got_by == by
    assert got == pytest.approx(ms, rel=2e-3)
    if kernel == "conv3x3":
        w = C.work_counts(kernel, shape)
        assert w["flop"] == 618_475_290_624
        assert w["bytes"] == 1_090_945_280


@pytest.mark.parametrize("shape, shared, nbytes, ms", [
    # builders A, B, C and B2: N128 256^2 f32 in and out, one (256, 256)
    # int32 index plane read once for the batch
    ((128, 256, 256, 4), True, 67_371_008, 0.02011),
    # F: (2048, 128) f32 src and out, an int32 index per element
    ((1, 2048, 128, 4), False, 3_145_728, 0.000939),
    # P4: (8, 128)
    ((1, 8, 128, 4), False, 12_288, 12_288 / 3.35e12 * 1e3),
    # P5 (512, 128) and P6 (256, 256): 786,432 B each
    ((1, 512, 128, 4), False, 786_432, 0.000235),
    ((1, 256, 256, 4), False, 786_432, 0.000235),
])
def test_bounds_of_the_ported_gather_builders(shape, shared, nbytes, ms):
    """The gather kernel's builders at their own shapes: bound by bytes, a
    shared index counted once (not once per image, as the per-image default
    counts it)."""
    w = C.work_counts("gather", shape, shared_index=shared)
    assert w["bytes"] == nbytes and w["flop"] == 0
    got, by, _ = C.bound("gather", shape, shared_index=shared)
    assert by == "bytes"
    assert got == pytest.approx(ms, rel=2e-3)
