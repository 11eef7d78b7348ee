"""Persistent XLA compilation cache.

The reference specializes its WGSL pipelines at startup every run
(``dips/src/gpu/mod.rs:101-109`` — shader compilation is paid on every
process launch).  Here the analogous cost is the first jit compile of each
(properties, geometry) step, which a restarted serving daemon pays again
for every geometry it warms.  JAX ships a persistent compilation cache
keyed on the HLO + compile options + platform; pointing it at a directory
makes every restart after the first a cache hit.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: exactly that directory (JAX reads
  the variable itself; this module sets no other);
* otherwise a fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
  The path is part of each entry's key, so it never depends on a temp
  dir, a pid or the time;
* ``--compile-cache DIR`` names an explicit directory instead.

``enable_compile_cache`` is idempotent and safe to call before or after
backend initialization (the cache is consulted at compile time, not at
backend init).
"""

from __future__ import annotations

import os
from typing import Optional

#: the fixed default: ``.jax_cache`` at the root of the checkout
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _host_fingerprint() -> str:
    """A short digest of the host CPU (machine arch + feature flags).

    XLA:CPU persists AOT-compiled x86 executables whose cache key does
    not cover the full host feature set: an entry written on one machine
    can be loaded on another with fewer features, where it aborts with
    SIGILL instead of recompiling (the AOT loader only warns).  The fixed
    checkout cache therefore partitions CPU-pinned processes per host
    fingerprint; GPU executables are device code and stay shared.
    """
    import hashlib
    import platform as _plat

    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{_plat.machine()}|{feats}".encode()
    return hashlib.sha256(raw).hexdigest()[:12]


def _platform_selection() -> str:
    """The explicitly selected jax platform ('' when auto-detected)."""
    sel = ""
    try:
        import jax
        sel = getattr(jax.config, "jax_platforms", None) or ""
    except Exception:
        pass
    sel = sel or os.environ.get("JAX_PLATFORMS", "")
    return sel.split(",")[0].strip().lower()


def default_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the fixed
    ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    ``path`` is an explicit directory, used as given.  Without it the
    cache goes to :func:`default_cache_dir`; under the fixed checkout
    default a CPU-pinned process (tests, the multichip dryrun) gets a
    per-host subdirectory (see :func:`_host_fingerprint`).  Every compile
    is cached, including sub-second ones: the cache lives in a dedicated
    directory, so the usual "don't cache trivial compiles" heuristics
    only cost restart latency here.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        resolved = os.path.abspath(os.path.expanduser(path))
    elif env_dir:
        resolved = env_dir
    else:
        resolved = CHECKOUT_CACHE_DIR
        if _platform_selection() == "cpu":
            resolved = os.path.join(resolved, "host-" + _host_fingerprint())
    os.makedirs(resolved, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", resolved)
    # jax initializes its persistent cache AT MOST ONCE, on the first
    # compile: if any compile already happened in this process with no
    # cache dir configured, the init latched "disabled" and the config
    # update above would be silently ignored.  reset_cache() drops the
    # latch so the next compile re-initializes against the new dir.
    try:
        from jax._src import compilation_cache as _cc
        active = getattr(_cc, "_cache", None)
        if getattr(_cc, "_cache_initialized", False) and (
                active is None
                or str(getattr(active, "_path", "")) != resolved):
            _cc.reset_cache()
    except Exception:
        pass  # internal API drift: worst case is the pre-existing behavior
    # Cache everything: a daemon restart should hit for every step it
    # compiled before, not only the slow ones.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return resolved


def add_compile_cache_flag(parser) -> None:
    """Install ``--compile-cache [DIR]`` on an argparse parser."""
    parser.add_argument(
        "--compile-cache", nargs="?", const="", default=None, metavar="DIR",
        help="persist compiled XLA executables under DIR (default "
             "$JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache) so "
             "restarts skip jit compilation")


def apply_compile_cache_flag(args) -> Optional[str]:
    """Honor the flag installed by :func:`add_compile_cache_flag`.

    Returns the cache dir when enabled, else None.  ``--compile-cache``
    with no value uses the default directory; the flag absent but
    ``JAX_COMPILATION_CACHE_DIR`` set also enables it, in that directory.
    """
    val = getattr(args, "compile_cache", None)
    if val is None and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return enable_compile_cache(val or None)
