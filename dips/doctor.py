"""Environment diagnosis: one command that answers "why is this host
slow / failing?" before reading any logs.

    python -m dips.doctor [--json]

Reports the accelerator (backend, device kind, chip count), the native
host module (SSSE3 layout kernels vs numpy fallback), the media stack
(OpenCV build, GStreamer availability), and the persistent compilation
cache.  Read it top to bottom: each line names the knob to fix it (see
docs/OPERATIONS.md).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
from typing import Optional


def nvidia_smi() -> Optional[str]:
    """The cards' ``name, power.limit`` as ``nvidia-smi`` reports them
    (one line per card), or None where there is no such tool.  A card set
    below its maximum power limit runs slower under load, so every timing
    is reported beside this line."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        r = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return r.stdout.strip() or None


def _probe_jax(timeout_s: float) -> dict:
    """Backend probe under a watchdog: a wedged driver can block
    ``jax.devices()`` instead of failing, so run it in a daemon thread
    and report the hang instead of inheriting it."""
    import jax

    box: dict = {}

    def probe():
        try:
            backend = jax.default_backend()
            devs = jax.devices()
            box.update(backend=backend, devices=len(devs),
                       device_kind=devs[0].device_kind if devs else None,
                       processes=jax.process_count(),
                       local_devices=jax.local_device_count())
        except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
            box["error"] = repr(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return {"version": jax.__version__, "backend": None, "devices": 0,
                "device_kind": None, "ok": False,
                "hint": f"jax backend init did not answer within "
                        f"{timeout_s:g}s: accelerator driver wedged? "
                        f"(jobs would hang, not fall back - check "
                        f"nvidia-smi)"}
    if "error" in box:
        return {"version": jax.__version__, "backend": None, "devices": 0,
                "device_kind": None, "ok": False,
                "hint": f"jax backend init failed: {box['error']}"}
    ok = box["backend"] == "gpu"
    return {
        "version": jax.__version__, **box, "ok": ok,
        "hint": None if ok else
            f"no GPU: the step runs on the {box['backend']} backend "
            f"(correct but far slower)",
    }


def collect(timeout_s: float = 60.0) -> dict:
    """Gather the report as a dict (importable for tests/tools).

    Each section is guarded: a broken component is REPORTED as such
    (``ok: false`` + ``error``) rather than crashing the diagnosis —
    the broken hosts are the ones that need the doctor."""
    info: dict = {}

    def section(name, fn):
        try:
            info[name] = fn()
        except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
            info[name] = {"ok": False, "error": repr(e),
                          "hint": f"section crashed: {e!r}"}

    section("jax", lambda: {**_probe_jax(timeout_s),
                            "nvidia_smi": nvidia_smi()})

    def _native():
        from . import native
        lvl = native.simd_level()
        return {
            "available": native.NATIVE_AVAILABLE,
            "simd": native.SIMD_NAMES.get(lvl, str(lvl)),
            "ok": native.NATIVE_AVAILABLE,
            "hint": None if native.NATIVE_AVAILABLE else
                "native module not built (no toolchain?): host layout "
                "transforms fall back to numpy (~3x slower at 1080p)",
        }

    section("native", _native)

    def _opencv():
        import cv2
        return {"version": cv2.__version__, "ok": True, "hint": None}

    section("opencv", _opencv)

    def _gst():
        from .io import gstreamer
        return {
            "available": gstreamer.available(),
            "ok": True,  # optional either way
            "hint": None if gstreamer.available() else
                "GStreamer absent: OpenCV/FFmpeg handles files and URIs; "
                "PTS-preserving avimux egress unavailable",
        }

    section("gstreamer", _gst)

    def _compile_cache():
        from .utils import compilecache
        cc_dir = compilecache.default_cache_dir()
        enabled = bool(os.environ.get("JAX_COMPILATION_CACHE_DIR"))
        try:
            entries = len(os.listdir(cc_dir))
        except OSError:
            entries = 0
        return {
            "dir": cc_dir, "env_enabled": enabled, "entries": entries,
            "ok": True,
            "hint": None if enabled else
                "persistent compile cache off by default: set "
                "JAX_COMPILATION_CACHE_DIR or pass --compile-cache to "
                "skip jit compiles across restarts",
        }

    section("compile_cache", _compile_cache)

    def _report():
        try:
            import matplotlib
            return {"matplotlib": matplotlib.__version__, "ok": True,
                    "hint": None}
        except ImportError:
            return {"matplotlib": None, "ok": True,  # optional extra
                    "hint": "matplotlib absent: dips-report and "
                            "--heatmap-png unavailable (pip install "
                            "'dips[report]')"}

    section("report", _report)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dips-doctor", description="environment diagnosis")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--timeout", type=float, default=60.0, metavar="S",
                    help="seconds to wait for jax backend init before "
                         "declaring the accelerator unreachable")
    args = ap.parse_args(argv)
    info = collect(timeout_s=args.timeout)
    if args.json:
        print(json.dumps(info))
    else:
        for section, d in info.items():
            mark = "ok" if d.get("ok") else "!!"
            detail = ", ".join(f"{k}={v}" for k, v in d.items()
                               if k not in ("ok", "hint") and v is not None)
            print(f"[{mark}] {section}: {detail}")
            if d.get("hint"):
                print(f"     -> {d['hint']}")
    bad = [s for s, d in info.items() if not d.get("ok")]
    if bad:
        # non-zero so health-check scripts see the failure, not just a
        # human reading stderr
        print(f"attention: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
