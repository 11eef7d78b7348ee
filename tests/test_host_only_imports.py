"""What runs without OpenCV, and what never touches the accelerator.

OpenCV is an optional extra: the engines, the serve daemon, the
validation harness and the synthetic frame source import and run
without it, and only video file I/O asks for it, by name.  The serve
client and the load generator never initialise a JAX backend, so they
can share a host with the daemon that holds the card."""

import os
import subprocess
import sys
import threading

import pytest

from dips.properties import DiPsFilter, DiPsProperties
from dips.serve import DiPsServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_CV2 = "import sys; sys.modules['cv2'] = None\n"


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", ["dips", "dips.serve",
                                    "dips.serve.server", "dips.validate",
                                    "dips.io"])
def test_imports_without_opencv(module):
    r = _python(_NO_CV2 + f"import {module}\nprint('ok')")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_engine_runs_without_opencv():
    r = _python(_NO_CV2 + """
from dips import DiPsEngine, DiPsProperties
from dips.io.synthetic import moving_square_clip
frames = moving_square_clip(5, 16, 40)
out, stats = DiPsEngine(DiPsProperties(), 16, 40, batch=2).process_frames(
    list(frames))
print(out.shape, stats.shape)
""")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "(5, 16, 40, 3) (5, 4)"


@pytest.mark.parametrize("call", [
    "from dips.io.video import VideoReader; VideoReader('README.md')",
    "from dips.io.synthetic import moving_square_clip, write_clip; "
    "write_clip(moving_square_clip(2, 8, 8), 'x.avi')",
])
def test_video_io_names_the_missing_package(call):
    r = _python(_NO_CV2 + f"""
import dips
try:
    {call}
except dips.MissingDependencyError as e:
    print('typed:', e)
""")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("typed:") and "opencv-python" in r.stdout


@pytest.fixture()
def daemon():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


_BACKENDS = """
import jax._src.xla_bridge as xb
print('backends initialised:', xb.backends_are_initialized())
"""


def test_client_never_initialises_a_backend(daemon):
    r = _python(f"""
import numpy as np
from dips.serve import DiPsClient
c = DiPsClient({daemon.port}, session='cam')
out, stats = c.process(np.zeros((16, 24, 3), np.uint8))
c.heatmap()
c.close()
print(out.shape)
""" + _BACKENDS)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backends initialised: False" in r.stdout
    assert "(16, 24, 3)" in r.stdout


def test_loadgen_never_initialises_a_backend(daemon):
    r = _python(f"""
from dips.loadgen import main
assert main(['--port', '{daemon.port}', '--clients', '2', '--frames', '2',
             '--geometry', '16x24']) == 0
""" + _BACKENDS)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"ok": true' in r.stdout
    assert "backends initialised: False" in r.stdout
