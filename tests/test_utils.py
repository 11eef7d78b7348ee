"""utils: circular index parity and stage timers."""

import os
import time

import pytest

from dips.utils import StageTimers, UCircularIndex, trace


def test_ucircular_index_wraps():
    i = UCircularIndex(0, 4)
    for expected in [1, 2, 3, 0, 1]:
        i += 1
        assert int(i) == expected
    i += 6
    assert int(i) == 3
    assert i == 3


def test_ucircular_index_validation():
    with pytest.raises(ValueError):
        UCircularIndex(0, 0)
    assert int(UCircularIndex(7, 4)) == 3  # constructor wraps


def test_stage_timers_accumulate():
    t = StageTimers()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    t.add_frames(5)
    s = t.summary()
    assert s["a"]["calls"] == 2
    assert s["a"]["total_s"] >= 0.01
    assert s["_overall"]["frames"] == 5
    assert s["_overall"]["fps"] > 0
    assert "a" in str(t)


def test_trace_noop():
    with trace(None):
        pass  # must be a no-op without a logdir


def test_cli_profile_flag(tmp_path, capsys):
    from dips.cli import main as cli_main
    from dips.io import moving_square_clip, write_clip
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=6, height=32, width=48), path)
    rc = cli_main(["--input", path, "--output", str(tmp_path / "o.avi"),
                   "--profile", "--temporal=2", "--batch=3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "StageTimers" in out and "device" in out


def test_validate_tool():
    """The deployment acceptance check passes on this backend."""
    from dips import validate
    assert validate.run(quick=True, verbose=False, height=40, width=150,
                        n_frames=8, batch=4) == 0


def test_remaining_builder_aliases_and_spectrum():
    """Touch the last unreferenced public surfaces: builder aliases and the
    FFT spectrum view."""
    import numpy as np
    from dips import DiPsJob, DiPsProperties
    from dips.ops.analysis import fft_magnitude_spectrum

    p = DiPsProperties().with_change_threshold(500)
    assert p.change_threshold == 255  # clamped
    assert DiPsProperties().with_approx_median().approx_median
    job = DiPsJob().with_properties(p).with_video_backend("opencv")
    assert job.properties.change_threshold == 255
    assert job.video_backend == "opencv"

    img = np.zeros((16, 32), np.uint8)
    img[::2] = 255  # strong vertical frequency
    spec = np.asarray(fft_magnitude_spectrum(img))
    assert spec.shape == (16, 32) and np.isfinite(spec).all()
    assert spec.max() > spec.min()


# ---------------------------------------------------------------------------
# persistent compilation cache
# ---------------------------------------------------------------------------

@pytest.fixture
def _cache_config_guard():
    """Snapshot + restore the jax compilation-cache config so enabling the
    cache inside a test cannot leak into the rest of the in-process suite
    (the cache dir is a tmp_path that pytest deletes afterwards)."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_enable_compile_cache_writes_entries(tmp_path, _cache_config_guard):
    import jax
    import jax.numpy as jnp
    from dips.utils.compilecache import enable_compile_cache

    d = tmp_path / "xla-cache"
    got = enable_compile_cache(str(d))
    # an explicit directory is used exactly as given
    assert got == str(d)
    assert os.path.isdir(got)
    assert jax.config.jax_compilation_cache_dir == got

    # a fresh jit lowers + compiles -> at least one persisted executable
    f = jax.jit(lambda x: x * 3 - jnp.float32(1.5))
    f(jnp.ones((8, 128), jnp.float32)).block_until_ready()
    assert os.listdir(got), "no cache entries written"
    # idempotent re-enable
    assert enable_compile_cache(str(d)) == got


def test_enable_compile_cache_after_prior_compiles(tmp_path,
                                                   _cache_config_guard):
    """Enabling the cache AFTER this process already compiled something
    must still take effect: jax latches its persistent-cache init on the
    first compile, and without the reset in enable_compile_cache a
    dir configured later is silently ignored (the full-suite ordering
    bug — any earlier test's compile disabled the cache for good)."""
    import jax
    import jax.numpy as jnp
    from dips.utils.compilecache import enable_compile_cache

    # force the latch: one compile with whatever state the suite left
    jax.jit(lambda x: x - jnp.float32(0.25))(
        jnp.ones((8, 128), jnp.float32)).block_until_ready()

    d = tmp_path / "late-cache"
    got = enable_compile_cache(str(d))
    jax.jit(lambda x: x * jnp.float32(7.0) + 2)(
        jnp.ones((8, 128), jnp.float32)).block_until_ready()
    assert os.listdir(got), "late-enabled cache wrote no entries"


def test_compile_cache_flag_plumbing(tmp_path, monkeypatch,
                                     _cache_config_guard):
    import argparse

    from dips.utils import compilecache as cc

    ap = argparse.ArgumentParser()
    cc.add_compile_cache_flag(ap)
    monkeypatch.setattr(cc, "CHECKOUT_CACHE_DIR", str(tmp_path / "co"))

    # flag absent + env unset -> disabled
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.apply_compile_cache_flag(ap.parse_args([])) is None

    # explicit dir, used as given
    d = tmp_path / "explicit"
    got = cc.apply_compile_cache_flag(
        ap.parse_args(["--compile-cache", str(d)]))
    assert got == str(d) and d.is_dir()

    # bare flag -> the fixed checkout default (cpu-pinned suite -> per-host
    # subdir of it)
    got = cc.apply_compile_cache_flag(ap.parse_args(["--compile-cache"]))
    assert os.path.dirname(got) == str(tmp_path / "co")

    # JAX_COMPILATION_CACHE_DIR wins over the default, exactly, and also
    # enables the cache with no CLI flag at all
    envd = tmp_path / "from-env"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(envd))
    assert cc.default_cache_dir() == str(envd)
    assert cc.apply_compile_cache_flag(
        ap.parse_args(["--compile-cache"])) == str(envd)
    assert cc.apply_compile_cache_flag(ap.parse_args([])) == str(envd)


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(tmp_path, monkeypatch, _cache_config_guard,
                                 env_set):
    """With JAX_COMPILATION_CACHE_DIR set, compiled entries land in that
    directory and nowhere else; without it, under the fixed checkout
    cache directory."""
    import jax
    import jax.numpy as jnp
    from dips.utils import compilecache as cc

    checkout = tmp_path / "checkout-cache"
    envd = tmp_path / "env-cache"
    monkeypatch.setattr(cc, "CHECKOUT_CACHE_DIR", str(checkout))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(envd))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cc.enable_compile_cache()
    jax.jit(lambda x: x * jnp.float32(5.0) - 3)(
        jnp.ones((8, 128), jnp.float32)).block_until_ready()
    if env_set:
        assert got == str(envd) and os.listdir(envd)
        assert not checkout.exists()
    else:
        assert got.startswith(str(checkout)) and os.listdir(got)
        assert not envd.exists()


def test_checkout_cache_dir_is_fixed():
    """The default is <checkout>/.jax_cache: built from the package's own
    location, never from a temp dir, pid or time (the path keys the
    entries), and listed in .gitignore."""
    from dips.utils import compilecache as cc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.CHECKOUT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_host_partition_cpu_only(tmp_path, monkeypatch,
                                               _cache_config_guard):
    """Per-host partitioning applies ONLY to CPU-pinned processes under
    the fixed checkout default: device executables are host-portable and
    stay shared, while x86 AOT entries can SIGILL on a host with fewer
    CPU features."""
    from dips.utils import compilecache as cc

    d = tmp_path / "shared"
    monkeypatch.setattr(cc, "CHECKOUT_CACHE_DIR", str(d))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cc, "_platform_selection", lambda: "gpu")
    assert cc.enable_compile_cache() == str(d)

    monkeypatch.setattr(cc, "_platform_selection", lambda: "cpu")
    got = cc.enable_compile_cache()
    assert os.path.dirname(got) == str(d) and got != str(d)
    # deterministic on a given host
    assert cc.enable_compile_cache() == got
    assert cc._host_fingerprint() == cc._host_fingerprint()
    # an explicit directory is never partitioned
    assert cc.enable_compile_cache(str(tmp_path / "x")) == str(tmp_path / "x")


def test_cli_and_serve_accept_compile_cache_flag():
    """The flag is installed on every frontend parser."""
    from dips.cli import build_parser

    args = build_parser().parse_args(["--input", "x.avi", "--compile-cache"])
    assert args.compile_cache == ""
    args = build_parser().parse_args(["--input", "x.avi"])
    assert args.compile_cache is None


def test_gui_thumbnail_cache_freshness(tmp_path):
    import os
    import time

    from dips.gui import thumbnail_cache_valid

    video = tmp_path / "v.avi"
    thumb = tmp_path / "v.avi.thumb.png"
    video.write_bytes(b"x")
    assert not thumbnail_cache_valid(str(video), str(thumb))  # no thumb
    thumb.write_bytes(b"t")
    assert thumbnail_cache_valid(str(video), str(thumb))
    # re-record the video AFTER the thumbnail -> cache is stale
    later = time.time() + 10
    os.utime(video, (later, later))
    assert not thumbnail_cache_valid(str(video), str(thumb))


def test_dat_dir_skips_alien_d_files(tmp_path):
    """A stray 'D' file that is not a dump must be skipped, not abort the
    batch."""
    import numpy as np

    from dips.io.datfiles import read_dat_dir

    w, h = 4, 6
    for i in range(2):
        rgba = np.full((h, w, 4), 10 * (i + 1), np.uint8)
        (tmp_path / f"Dat_{i}.d").write_bytes(b"\0" * 4 + rgba.tobytes())
    (tmp_path / "DESIGN.md").write_text("not a dump")
    frames = list(read_dat_dir(str(tmp_path), width=w, height=h))
    assert len(frames) == 2
    assert frames[0][0, 0, 0] == 10 and frames[1][0, 0, 0] == 20


def test_subsample_rejects_bad_target_seconds(tmp_path):
    from dips.io.subsample import subsample_video

    with pytest.raises(ValueError, match="target_seconds"):
        subsample_video("in.avi", "out.avi", keep_every=2, target_seconds=0)


def test_doctor_report(capsys, monkeypatch):
    """The doctor collects every section and renders hints; --json emits
    one machine-readable object."""
    import json

    from dips import doctor

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    info = doctor.collect()
    assert set(info) == {"jax", "native", "opencv", "gstreamer",
                         "compile_cache", "report"}
    assert info["jax"]["processes"] == 1  # single-process topology
    assert info["jax"]["backend"] == "cpu"  # conftest forces CPU
    assert not info["jax"]["ok"] and "no GPU" in info["jax"]["hint"]
    assert "nvidia_smi" in info["jax"]
    assert info["compile_cache"]["hint"]  # off by default

    # a not-ok section (the CPU-forced jax backend here) drives a
    # NON-ZERO exit so health-check scripts see the failure
    assert doctor.main([]) == 1
    out = capsys.readouterr().out
    assert "[!!] jax:" in out and "[ok] opencv:" in out

    assert doctor.main(["--json"]) == 1
    parsed = json.loads(capsys.readouterr().out)
    assert parsed["opencv"]["ok"]

    # all-ok report -> exit 0
    monkeypatch.setattr(doctor, "collect",
                        lambda **kw: {"jax": {"ok": True}})
    assert doctor.main([]) == 0


def test_doctor_reports_hung_backend(monkeypatch):
    """A wedged driver can block jax.devices() forever; the doctor must
    DIAGNOSE that (watchdog timeout) instead of inheriting the hang."""
    import time

    import jax

    from dips import doctor

    monkeypatch.setattr(jax, "devices", lambda *a, **k: time.sleep(3.0))
    info = doctor.collect(timeout_s=0.2)
    assert not info["jax"]["ok"]
    assert "did not answer" in info["jax"]["hint"]
    assert info["jax"]["backend"] is None
    # the rest of the report still renders
    assert info["opencv"]["ok"] and "compile_cache" in info


def test_doctor_survives_broken_section(monkeypatch):
    """A crashing component is reported as ok=false, not a traceback —
    the broken hosts are the ones that need the doctor."""
    from dips import doctor
    from dips.io import gstreamer

    def boom():
        raise RuntimeError("plugin scan failed")

    monkeypatch.setattr(gstreamer, "available", boom)
    info = doctor.collect(timeout_s=5.0)
    assert not info["gstreamer"]["ok"]
    assert "plugin scan failed" in info["gstreamer"]["error"]
    # every other section is still present and intact
    assert set(info) >= {"jax", "native", "opencv", "compile_cache"}
    assert info["opencv"]["ok"]


@pytest.mark.parametrize("backend,ok", [("gpu", True), ("cpu", False)])
def test_doctor_backend_verdict(monkeypatch, backend, ok):
    """The doctor calls a GPU backend ok and anything else (the CPU
    fallback a job would silently run on) not ok, with a hint."""
    import jax

    from dips import doctor

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    info = doctor._probe_jax(30.0)
    assert info["backend"] == backend and info["ok"] is ok
    assert (info["hint"] is None) is ok


def test_nvidia_smi_absent_or_failing(monkeypatch):
    """No nvidia-smi (or a failing one) reads as None, never a crash."""
    import shutil
    import subprocess

    from dips import doctor

    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert doctor.nvidia_smi() is None
    monkeypatch.setattr(shutil, "which", lambda name: "/bin/nvidia-smi")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: type(
        "R", (), {"returncode": 0, "stdout": "NVIDIA H100 80GB HBM3, "
                                             "700.00 W\n"})())
    assert doctor.nvidia_smi() == "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: type(
        "R", (), {"returncode": 9, "stdout": ""})())
    assert doctor.nvidia_smi() is None
