"""dips — a JAX rebuild of DiPs (video frame-difference pixels).

See README.md for the design and SURVEY.md for the reference analysis.
"""

from .errors import (DecodeError, DeviceError, DiPsError, EncodeError,
                     FrameCallbackError, MissingDependencyError,
                     OutputPathError, ReplyLost, StreamError,
                     VideoPathError)
from .properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                         Encoding, OutputMode)
from .models import DiPsEngine
from .app import (DiPsJob, custom_dips_on_files, extract_thumbnail,
                  init_frame_extractor, init_thumbnail_extractor,
                  perform_dips, run_dips_app, run_dips_on_file,
                  run_dips_on_files, stream_dips)
from .parallel import (MultiHostStreamEngine, MultiStreamEngine,
                       init_multihost, stream_mesh)
from .ops.events import MotionDetector, MotionEvent, detect_events

__version__ = "0.2.0"

__all__ = [
    "ChromaFilter", "DiPsEngine", "DiPsError", "DiPsFilter", "DiPsJob",
    "DiPsMethod", "DiPsProperties", "DecodeError", "DeviceError", "Encoding",
    "EncodeError", "FrameCallbackError", "MissingDependencyError",
    "MotionDetector", "MotionEvent",
    "MultiHostStreamEngine", "MultiStreamEngine", "OutputMode",
    "OutputPathError", "ReplyLost", "StreamError", "VideoPathError",
    "detect_events", "init_multihost",
    "custom_dips_on_files", "extract_thumbnail", "init_frame_extractor",
    "init_thumbnail_extractor", "perform_dips", "run_dips_app",
    "run_dips_on_file", "run_dips_on_files", "stream_dips", "stream_mesh",
    "__version__",
]
