"""Lazy OpenCV handle for the video file I/O modules.

OpenCV is an optional extra (``pip install 'dips[video]'``): the engines,
the serve daemon and the numpy oracle never touch it.  ``cv2`` here
imports the real module on first attribute access and, when it is not
installed, raises :class:`~dips.errors.MissingDependencyError` naming the
package instead of failing at ``import dips``.
"""

from __future__ import annotations

from ..errors import MissingDependencyError


class _LazyCV2:
    def __getattr__(self, name):
        try:
            import cv2 as mod
        except ImportError as e:
            raise MissingDependencyError(
                "opencv-python", "video file I/O") from e
        return getattr(mod, name)


cv2 = _LazyCV2()
