"""Guards for the driver-facing artifacts: bench.py's one-JSON-line stdout
contract and __graft_entry__'s two hooks."""

import json
import os
import subprocess
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prints_exactly_one_json_line():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv=['bench.py','--height','24','--width','48',"
        "'--batch','2','--temporal','2'];"
        f"exec(open({os.path.join(REPO, 'bench.py')!r}).read())"
    )
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    lines = [l for l in r.stdout.strip().splitlines() if l]
    assert len(lines) == 1, f"stdout must be ONE json line, got {lines}"
    payload = json.loads(lines[0])
    assert set(payload) == {"metric", "value", "unit", "vs_baseline",
                            "device"}
    assert payload["value"] > 0
    # every result names the device it ran on
    assert payload["device"]["platform"] == "cpu"
    assert payload["device"]["count"] >= 1


def test_bench_hung_backend_prints_error_json_not_hang():
    """A wedged driver can hang jax backend init forever; bench.py must
    turn that into ONE machine-readable error line + exit 1 (a hung bench
    leaves its caller with no artifact at all)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import time; jax.default_backend=lambda: time.sleep(3600);"
        "import sys; sys.argv=['bench.py','--backend-timeout','2'];"
        f"exec(open({os.path.join(REPO, 'bench.py')!r}).read())"
    )
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, (r.returncode, r.stdout, r.stderr[-300:])
    lines = [l for l in r.stdout.strip().splitlines() if l]
    assert len(lines) == 1, f"stdout must be ONE json line, got {lines}"
    payload = json.loads(lines[0])
    assert payload["metric"] == "backend_unreachable"
    assert "error" in payload and payload["value"] == 0.0


def test_graft_entry_hooks():
    sys.path.insert(0, REPO)
    try:
        from __graft_entry__ import entry
    finally:
        sys.path.remove(REPO)
    fn, args = entry()
    out = jax.jit(fn)(*args)
    assert all(np.isfinite(np.asarray(x)).all() for x in out[1:2])


def test_graft_entry_compiles_the_xla_step():
    """entry() is the XLA batch step every engine runs: it compiles, and
    its outputs equal ops/reference.batch_step on the same inputs."""
    from dips.ops import reference
    from dips.properties import DiPsProperties

    sys.path.insert(0, REPO)
    try:
        from __graft_entry__ import entry
    finally:
        sys.path.remove(REPO)
    fn, args = entry()
    compiled = jax.jit(fn).lower(*args).compile()
    out, stats, _, heat = compiled(*args)
    raw, _, flags, _, valid = args
    h, w = 64, 192
    hp, wp = raw.shape[-2:]
    eo, es, _, eh = reference.batch_step(
        DiPsProperties(window_size=3, temporal_size=4), h, w, raw,
        jax.numpy.zeros((hp, wp)), flags, jax.numpy.zeros((hp, wp)), valid)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(eo))
    np.testing.assert_array_equal(np.asarray(stats), np.asarray(es))
    np.testing.assert_array_equal(np.asarray(heat), np.asarray(eh))


def test_dryrun_multichip_hermetic_under_driver_conditions():
    """Regression: dryrun_multichip called from a process whose backend
    was ALREADY initialised (1 device) once silently did nothing about
    it — the mesh work landed on the wrong backend and died.  Simulate
    exactly that: a fresh parent process that
    initialises a 1-device CPU backend first (no conftest CPU forcing, no
    xla_force_host_platform_device_count), then calls dryrun_multichip(8).
    The hermetic subprocess implementation must still produce an 8-device
    mesh run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # parent has NO virtual-device forcing
    script = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "assert len(jax.devices()) == 1, jax.devices();"  # backend is live
        "from __graft_entry__ import dryrun_multichip;"
        "dryrun_multichip(8); print('PARENT-OK')"
    )
    r = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PARENT-OK" in r.stdout
