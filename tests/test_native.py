"""framepump native runtime: layout transforms and the SPSC frame ring.

Tests run against whichever implementation loaded (native .so or numpy
fallback) and additionally force the fallback for differential testing.
"""

import threading

import numpy as np
import pytest

from dips import native


def _ref_planarize(frame, hp, wp, swap_rb):
    rgb = frame[..., :3]
    if swap_rb:
        rgb = rgb[..., ::-1]
    out = np.zeros((3, hp, wp), np.uint8)
    out[:, :frame.shape[0], :frame.shape[1]] = np.moveaxis(rgb, -1, 0)
    return out


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("cin", [3, 4])
def test_planarize(swap, cin, rng):
    frame = rng.integers(0, 256, (13, 37, cin), np.uint8)
    got = native.planarize(frame, 16, 128, swap_rb=swap)
    np.testing.assert_array_equal(got, _ref_planarize(frame, 16, 128, swap))


@pytest.mark.parametrize("swap", [False, True])
def test_interleave(swap, rng):
    planes = rng.integers(0, 256, (3, 16, 128), np.uint8)
    got = native.interleave(planes, 13, 37, swap_rb=swap)
    exp = np.moveaxis(planes[:, :13, :37], 0, -1)
    if swap:
        exp = exp[..., ::-1]
    np.testing.assert_array_equal(got, exp)


def test_interleave_gray_broadcast(rng):
    planes = rng.integers(0, 256, (1, 8, 128), np.uint8)
    got = native.interleave(planes, 8, 100)
    exp = np.repeat(planes[:, :8, :100], 3, axis=0)
    np.testing.assert_array_equal(got, np.moveaxis(exp, 0, -1))


@pytest.mark.parametrize("tier", ["scalar", "ssse3", "avx512"])
@pytest.mark.parametrize(
    "w", [1, 15, 16, 17, 32, 33, 47, 48, 49, 63, 64, 65, 127, 128, 129])
def test_layout_simd_tail_sweep(w, tier, rng, monkeypatch):
    """Widths straddling the 16- and 64-pixel SIMD block boundaries, on
    every tier the host supports (DIPS_SIMD caps the dispatch): the
    vector body and the tail must agree with the numpy reference at every
    split (also exercised on non-x86 hosts, where everything is scalar)."""
    if native.NATIVE_AVAILABLE:
        monkeypatch.setenv("DIPS_SIMD", tier)
        if tier != "scalar" and native.simd_level() == 0:
            pytest.skip(f"host cannot run the {tier} tier")
    elif tier != "scalar":
        pytest.skip("native framepump unavailable")
    h, hp, wp = 5, 8, 192
    for cin in (3, 4):
        frame = rng.integers(0, 256, (h, w, cin), np.uint8)
        for swap in (False, True):
            got = native.planarize(frame, hp, wp, swap_rb=swap)
            np.testing.assert_array_equal(
                got, _ref_planarize(frame, hp, wp, swap))
    planes = rng.integers(0, 256, (3, hp, wp), np.uint8)
    for swap in (False, True):
        got = native.interleave(planes, h, w, swap_rb=swap)
        exp = np.moveaxis(planes[:, :h, :w], 0, -1)
        np.testing.assert_array_equal(got, exp[..., ::-1] if swap else exp)


def test_simd_level_reporting():
    """simd_level() reflects the DIPS_SIMD cap and names resolve."""
    lvl = native.simd_level()
    assert lvl in native.SIMD_NAMES
    if native.NATIVE_AVAILABLE:
        import os
        old = os.environ.get("DIPS_SIMD")
        try:
            os.environ["DIPS_SIMD"] = "scalar"
            assert native.simd_level() == 0
        finally:
            if old is None:
                os.environ.pop("DIPS_SIMD", None)
            else:
                os.environ["DIPS_SIMD"] = old
    else:
        assert lvl == -1


def test_planarize_roundtrip(rng):
    frame = rng.integers(0, 256, (24, 130, 3), np.uint8)
    planes = native.planarize(frame, 24, 256)
    back = native.interleave(planes, 24, 130)
    np.testing.assert_array_equal(back, frame)


@pytest.fixture(params=["native", "fallback"])
def make_ring(request):
    """Build rings against the loaded implementation AND the pure-Python
    UCircularIndex fallback, for differential testing."""
    use_native = request.param == "native"
    if use_native and not native.NATIVE_AVAILABLE:
        pytest.skip("native framepump unavailable")

    def mk(slots, slot_bytes):
        return native.FrameRing(slots, slot_bytes, use_native=use_native)
    return mk


def test_frame_ring_order_and_backpressure(make_ring):
    ring = make_ring(4, 16)
    produced = [np.full(16, i, np.uint8) for i in range(32)]

    def producer():
        for p in produced:
            assert ring.push(p)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    buf = np.empty(16, np.uint8)
    while True:
        rc = ring.pop(buf, timeout_ms=5000)
        if rc == -1:
            break
        assert rc == 0
        got.append(buf.copy())
    t.join()
    assert len(got) == 32
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, produced[i])


def test_frame_ring_timeout(make_ring):
    ring = make_ring(2, 8)
    buf = np.empty(8, np.uint8)
    assert ring.pop(buf, timeout_ms=50) == -2  # empty, not closed
    ring.close()
    assert ring.pop(buf, timeout_ms=50) == -1  # closed and drained


def test_push_after_close_rejected(make_ring):
    ring = make_ring(2, 8)
    ring.close()
    assert not ring.push(np.zeros(8, np.uint8))


def test_native_available_or_fallback():
    # In this image g++ exists, so the native path should have built.
    import shutil
    if shutil.which("g++") and not native.os.environ.get("DIPS_NO_NATIVE"):
        assert native.NATIVE_AVAILABLE


def test_frame_ring_concurrent_stress(make_ring):
    """Race-stress the SPSC ring (SURVEY.md §5: the rebuild's concurrency
    surface is exactly this producer/consumer pair)."""
    import numpy as np
    ring = make_ring(3, 256)
    n = 500
    errors = []

    def producer():
        try:
            for i in range(n):
                buf = np.full(256, i % 251, np.uint8)
                assert ring.push(buf)
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            ring.close()

    t = threading.Thread(target=producer)
    t.start()
    got = 0
    buf = np.empty(256, np.uint8)
    while True:
        rc = ring.pop(buf, timeout_ms=10000)
        if rc == -1:
            break
        assert rc == 0
        assert (buf == got % 251).all()  # strict FIFO, no tearing
        got += 1
    t.join()
    assert not errors and got == n


def test_frame_ring_len(make_ring):
    ring = make_ring(4, 8)
    import numpy as np
    assert len(ring) == 0
    ring.push(np.zeros(8, np.uint8))
    ring.push(np.zeros(8, np.uint8))
    assert len(ring) == 2
    buf = np.empty(8, np.uint8)
    ring.pop(buf)
    assert len(ring) == 1


def test_frame_ring_pop_rejects_noncontiguous(make_ring):
    """ADVICE regression: reshape(-1) of a non-contiguous view is a copy;
    the popped frame would be silently discarded."""
    ring = make_ring(2, 8)
    ring.push(np.arange(8, dtype=np.uint8))
    view = np.empty((8, 2), np.uint8)[:, 0]  # non-contiguous column view
    with pytest.raises(ValueError):
        ring.pop(view)


def test_unknown_simd_env_pins_scalar(monkeypatch):
    """Review regression: an operator typo (DIPS_SIMD=avx2/sse3/AVX512)
    must pin the SAFEST tier, not silently leave the maximum running."""
    if not native.NATIVE_AVAILABLE:
        pytest.skip("native module not built")
    for bogus in ("avx2", "sse3", "AVX512", "Scalar"):
        monkeypatch.setenv("DIPS_SIMD", bogus)
        assert native.simd_level() == 0, bogus


def _compile_dummy_so(path):
    import subprocess
    src = str(path) + ".cpp"
    with open(src, "w") as f:
        f.write('extern "C" int fp_nothing() { return 0; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(path), src],
                   check=True, capture_output=True)


def test_stale_prebuilt_so_is_rebuilt(tmp_path, monkeypatch):
    """Review regression: a libframepump.so built from an OLDER source tree
    lacks newly-added symbols; importing the package must rebuild it (or
    fall back), never die in AttributeError at import time."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no toolchain")
    shutil.copy(native._DIR + "/framepump.cpp", tmp_path / "framepump.cpp")
    shutil.copy(native._DIR + "/Makefile", tmp_path / "Makefile")
    so = tmp_path / "libframepump.so"
    _compile_dummy_so(so)
    # make the stale binary look up to date so the mtime check passes and
    # the AttributeError force-rebuild path is the one exercised
    import os
    late = max(os.path.getmtime(tmp_path / "framepump.cpp"),
               os.path.getmtime(tmp_path / "Makefile")) + 10
    os.utime(so, (late, late))
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    lib = native._load()
    assert lib is not None
    assert int(lib.fp_simd_level()) >= 0  # the rebuilt .so has the symbol


def test_stale_so_without_toolchain_falls_back(tmp_path, monkeypatch):
    """Same stale binary but no Makefile/source to rebuild from: _load()
    must return None (numpy fallback), not raise."""
    import os, shutil
    if shutil.which("g++") is None:
        pytest.skip("no toolchain")
    so = tmp_path / "libframepump.so"
    _compile_dummy_so(so)
    future = os.path.getmtime(so) + 10
    os.utime(so, (future, future))
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    assert native._load() is None
