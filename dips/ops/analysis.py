"""Post-analysis ops: temporal DFT, FFT denoise and the streaming per-pixel
flicker analyzer, as jittable JAX functions.

Productizes the reference's exploratory side-rail scripts (SURVEY.md §1):

* ``temporal_dft``  <- test_scripts/dft.py:1-48 (hand-rolled O(N^2) DFT of a
  4-sample pixel trace) — here a real FFT over the time axis of whole pixel
  planes, on device.
* ``FlickerAnalyzer`` <- the same dft.py exploration, taken to its intended
  scale: a per-PIXEL temporal-frequency energy map over an unbounded stream,
  O(1) memory (two carry planes), instead of one hand-computed 4-sample bin.
* ``fft_denoise``   <- test_scripts/image_denoise.py:5-52 (2-D FFT, centered
  square low-pass mask of radius 75, inverse FFT, magnitude).
* (heatmap accumulation lives inside the device steps themselves.)
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_DENOISE_RADIUS = 75  # ref: image_denoise.py:22


@jax.jit
def temporal_dft(traces: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Real DFT over the leading (time) axis.

    Args: traces (N, ...) f32 — e.g. a pixel-intensity history or the
      per-frame statistics series.
    Returns: (magnitude (N//2+1, ...), phase (N//2+1, ...)).
    """
    f = jnp.fft.rfft(traces.astype(jnp.float32), axis=0)
    return jnp.abs(f), jnp.angle(f)


@functools.partial(jax.jit, static_argnums=(1,))
def fft_denoise(image: jnp.ndarray,
                radius: int = DEFAULT_DENOISE_RADIUS) -> jnp.ndarray:
    """Square low-pass FFT denoise of a grayscale image (H, W).

    Matches the reference recipe: fft2 -> fftshift -> keep the centered
    (2r x 2r) square -> ifft2 -> magnitude (image_denoise.py:13-30).
    """
    img = image.astype(jnp.float32)
    h, w = img.shape[-2], img.shape[-1]
    f = jnp.fft.fftshift(jnp.fft.fft2(img), axes=(-2, -1))
    # the reference's slice [c-r : c+r] keeps rows c-r .. c+r-1 (2r wide)
    dr = jnp.arange(h) - h // 2
    dc = jnp.arange(w) - w // 2
    rows = (dr >= -radius) & (dr < radius)
    cols = (dc >= -radius) & (dc < radius)
    mask = (rows[:, None] & cols[None, :]).astype(jnp.complex64)
    back = jnp.fft.ifft2(jnp.fft.ifftshift(f * mask, axes=(-2, -1)))
    return jnp.abs(back)


@jax.jit
def fft_magnitude_spectrum(image: jnp.ndarray) -> jnp.ndarray:
    """20*log(|fftshift(fft2(img))| + 1), the spectrum view the reference
    plots (image_denoise.py:16)."""
    f = jnp.fft.fftshift(jnp.fft.fft2(image.astype(jnp.float32)),
                         axes=(-2, -1))
    return 20.0 * jnp.log(jnp.abs(f) + 1.0)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _flicker_update(chroma_value: int, state, frames_u8: jnp.ndarray,
                    coeffs: jnp.ndarray, alpha: jnp.ndarray):
    """One donated-state update of the streaming single-bin demodulator.

    ``state`` = (zr, zi, m): the complex exponentially-weighted
    demodulation accumulator planes and the running EWMA mean plane (the
    DC estimate removed before demodulation — without it every bright
    STATIC pixel would read a spurious amplitude of
    ~2*(1-alpha)*brightness, drowning real flicker).

    The scalar bookkeeping (demodulation phase per frame, the
    startup-bias denominator of the running mean) is precomputed on the
    HOST in float64 and fed as per-frame scan inputs — drift-free over
    unbounded streams with no in-kernel phasor rotation.  The planes ride
    a ``lax.scan`` with donated carries; its time on a GPU is not
    measured yet.

    ``frames_u8`` (N, H, W, 3) uint8 RGB; ``coeffs`` (3, N) f32 — rows
    are cos(phase_j), sin(phase_j) and the mean's bias denominator
    ``1 - alpha**(n_j+1)`` per frame; ``alpha`` = the traced EWMA decay.
    """
    from ..properties import ChromaFilter
    chroma = ChromaFilter(chroma_value)
    k = 1.0 - alpha

    def step(carry, xs):
        zr, zi, m = carry
        frame, c, s, denom = xs
        f = frame.astype(jnp.int32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        if chroma == ChromaFilter.RED:
            v = 2 * r
        elif chroma == ChromaFilter.GREEN:
            v = 2 * g
        elif chroma == ChromaFilter.BLUE:
            v = 2 * b
        else:  # HSL lightness on the [0, 510] integer intensity scale
            v = (jnp.maximum(jnp.maximum(r, g), b)
                 + jnp.minimum(jnp.minimum(r, g), b))
        x = v.astype(jnp.float32)
        # track + remove the DC component first; the bias-corrected mean
        # m/denom makes the very first frame read exactly centered=0
        m = alpha * m + k * x
        centered = x - m / denom
        # demodulate by e^{-i*phase} and low-pass (EWMA): z converges to
        # (A/2)e^{i*phi} for an intensity trace A*cos(omega*n + phi)
        zr = alpha * zr + k * centered * c
        zi = alpha * zi - k * centered * s
        return (zr, zi, m), None

    new_state, _ = jax.lax.scan(
        step, state, (frames_u8, coeffs[0], coeffs[1], coeffs[2]))
    return new_state


class FlickerAnalyzer:
    """Streaming per-pixel temporal-frequency energy map ("flicker map").

    Answers "which pixels oscillate at ``freq_hz``?" — vibration, mains
    flicker, blinking indicators — over an UNBOUNDED frame stream with O(1)
    memory: per pixel it carries a running mean (the DC estimate, removed
    first so static brightness cannot read as flicker) and one complex
    exponentially-weighted single-bin Fourier coefficient (demodulate the
    centered signal at the target frequency, low-pass with time constant
    ``tau_frames``).  This is the reference's
    temporal-DFT exploration (test_scripts/dft.py:1-48 hand-computes one
    4-sample bin of one pixel trace) productized at full-frame scale: the
    whole update is two fused elementwise passes per frame, batched
    through ``lax.scan`` with donated carries.

    Intensity follows the pipeline's chroma semantics (HSL lightness on the
    [0, 510] integer scale, or 2x a single channel — ops/oracle.py), so
    ``amplitude()`` is in those units: a pixel whose intensity trace is
    ``A*cos(2*pi*freq_hz*t)`` reads ``~A`` once ``2*tau_frames`` frames
    have streamed.  Frames are buffered host-side and dispatched in
    ``batch``-frame device steps (at most two trace shapes: ``batch``, and
    N=1 for flushed remainders).

    The recurrence's scalar bookkeeping (demodulation phase, ``alpha**n``
    startup bias) lives on the HOST in float64 — drift-free over
    unbounded streams; the device carries only the three planes (see
    ``_flicker_update`` for the measured lowering choice).
    """

    def __init__(self, freq_hz: float, fps: float,
                 tau_frames: Optional[float] = None,
                 chroma=None, batch: int = 16):
        from ..properties import ChromaFilter
        if not (math.isfinite(fps) and fps > 0):
            raise ValueError(f"fps must be positive, got {fps!r}")
        if not 0 < freq_hz < fps / 2:
            raise ValueError(
                f"freq_hz must lie in (0, fps/2) = (0, {fps / 2:g}) to be "
                f"resolvable at {fps:g} fps, got {freq_hz!r}")
        if tau_frames is None:
            # low-pass bandwidth well under the target frequency, so the
            # DC term (demodulated, it spins at -freq) averages out; floor
            # keeps very high frequencies from degenerating to tau ~ 1
            tau_frames = max(16.0, 4.0 * fps / freq_hz)
        if not (math.isfinite(tau_frames) and tau_frames >= 2.0):
            raise ValueError(
                f"tau_frames must be finite and >= 2, got {tau_frames!r}")
        self.freq_hz = float(freq_hz)
        self.fps = float(fps)
        self.tau_frames = float(tau_frames)
        self.chroma = ChromaFilter.ALL if chroma is None else chroma
        self.batch = max(1, int(batch))
        self._omega = 2.0 * math.pi * self.freq_hz / self.fps
        self._alpha = math.exp(-1.0 / self.tau_frames)  # float64, host
        self._state = None          # lazy: sized from the first frame
        self._geometry: Optional[Tuple[int, int]] = None
        self._pending: list = []
        self.frames_seen = 0

    def _init_state(self, h: int, w: int) -> None:
        # distinct buffers: the update donates the whole state tuple, and
        # two donated args must never alias one buffer
        self._state = (jnp.zeros((h, w), jnp.float32),
                       jnp.zeros((h, w), jnp.float32),
                       jnp.zeros((h, w), jnp.float32))

    def _coefficients(self, n: int):
        """Per-frame scan inputs for an ``n``-frame dispatch starting at
        absolute frame ``frames_seen``, computed host-side in float64:
        demodulation phase cos/sin (float64 with modular reduction —
        bounded rounding error, no cumulative drift; the float32 cast
        dominates at realistic frame counts) and the running mean's
        startup-bias denominator ``1 - alpha**(q+1)``, clamped away from
        zero so a tau at the float boundary (alpha == 1.0) yields zero
        flicker instead of 0/0 NaN planes."""
        a, w = self._alpha, self._omega
        n0 = self.frames_seen
        j = np.arange(n, dtype=np.float64)
        phase = math.fmod(w * n0, 2.0 * math.pi) + w * j
        denom = np.maximum(1.0 - a ** (n0 + j + 1.0), 1e-12)
        return np.stack([np.cos(phase), np.sin(phase),
                         denom]).astype(np.float32)

    def _dispatch(self, arr: np.ndarray) -> None:
        if self._state is None:
            self._init_state(*self._geometry)
        coeffs = self._coefficients(arr.shape[0])
        self._state = _flicker_update(self.chroma.value, self._state,
                                      jnp.asarray(arr), jnp.asarray(coeffs),
                                      jnp.float32(self._alpha))
        self.frames_seen += arr.shape[0]

    def update(self, frames: np.ndarray) -> None:
        """Feed frames: uint8 RGB, (H, W, 3) or (N, H, W, 3)."""
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim != 4 or frames.shape[-1] != 3 \
                or frames.dtype != np.uint8:
            raise ValueError("expected uint8 RGB (N, H, W, 3) or (H, W, 3), "
                             f"got {frames.dtype} {frames.shape}")
        if self._geometry is None:
            # the first frame fixes the geometry, even before a dispatch:
            # a mixed buffer would otherwise surface as np.stack's generic
            # shape error AFTER dropping the already-popped chunk
            self._geometry = (frames.shape[1], frames.shape[2])
        if frames.shape[1:3] != self._geometry:
            raise ValueError(f"frame geometry {frames.shape[1:3]} != "
                             f"analyzer geometry {self._geometry}")
        self._pending.extend(frames)
        while len(self._pending) >= self.batch:
            chunk, self._pending = (self._pending[:self.batch],
                                    self._pending[self.batch:])
            self._dispatch(np.stack(chunk))

    def flush(self) -> None:
        """Dispatch any buffered partial batch.

        Frame-by-frame on purpose: the scan length is shape-static,
        so a remainder of every size would each compile its own kernel — a
        serving client polling ``flicker`` mid-stream would hit up to
        ``batch - 1`` surprise compile stalls.  The N=1 trace is the one
        extra shape ever compiled."""
        chunk, self._pending = self._pending, []
        for frame in chunk:
            self._dispatch(frame[None])


    def power(self) -> np.ndarray:
        """(H, W) f32: startup-bias-corrected squared oscillation amplitude
        at ``freq_hz``, in intensity units — ``~A**2`` for a pixel trace
        ``A*cos(2*pi*freq_hz*t + phi)``."""
        self.flush()
        if self._state is None:
            raise RuntimeError("no frames streamed yet")
        zr, zi, _ = self._state
        # EWMA startup-bias correction: with n frames seen the accumulator
        # has only (1 - alpha**n) of its steady-state weight
        corr = max(1e-12, 1.0 - self._alpha ** self.frames_seen)
        z2 = np.asarray(zr) ** 2 + np.asarray(zi) ** 2
        return 4.0 * z2 / (corr * corr)

    def amplitude(self) -> np.ndarray:
        """(H, W) f32 oscillation amplitude at ``freq_hz`` (see power())."""
        return np.sqrt(self.power())

    def reset(self) -> None:
        self._pending = []
        self.frames_seen = 0
        if self._geometry is not None:
            self._init_state(*self._geometry)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _flicker_update_fleet(chroma_value: int, state, frames_u8: jnp.ndarray,
                          coeffs: jnp.ndarray, gates: jnp.ndarray,
                          alpha: jnp.ndarray):
    """Fleet twin of :func:`_flicker_update`: S streams' demodulator planes
    updated in ONE scan dispatch.

    ``state`` = (zr, zi, m), each (S, H, W) f32; ``frames_u8``
    (N, S, H, W, 3) uint8; ``coeffs`` (3, N, S) f32 (cos, sin, bias
    denominator per frame PER STREAM — streams advance on independent
    cursors); ``gates`` (N, S) f32 — 0 marks a padding replica, whose
    stream's state must stay bit-identically untouched; ``alpha`` (S,)
    f32 per-stream EWMA decay (streams may analyze different
    frequencies/time constants).

    Per active stream the arithmetic is exactly :func:`_flicker_update`'s
    (the same elementwise chain broadcast over the stream axis), so fleet
    maps are BIT-IDENTICAL to per-stream analyzers — asserted in tests.
    """
    from ..properties import ChromaFilter
    chroma = ChromaFilter(chroma_value)
    a3 = alpha[:, None, None]
    k3 = 1.0 - a3

    def step(carry, xs):
        zr, zi, m = carry
        frame, c, s, denom, g = xs
        f = frame.astype(jnp.int32)
        r, gr, b = f[..., 0], f[..., 1], f[..., 2]
        if chroma == ChromaFilter.RED:
            v = 2 * r
        elif chroma == ChromaFilter.GREEN:
            v = 2 * gr
        elif chroma == ChromaFilter.BLUE:
            v = 2 * b
        else:
            v = (jnp.maximum(jnp.maximum(r, gr), b)
                 + jnp.minimum(jnp.minimum(r, gr), b))
        x = v.astype(jnp.float32)
        live = (g > 0)[:, None, None]
        m_new = a3 * m + k3 * x
        centered = x - m_new / denom[:, None, None]
        zr_new = a3 * zr + k3 * centered * c[:, None, None]
        zi_new = a3 * zi - k3 * centered * s[:, None, None]
        return (jnp.where(live, zr_new, zr), jnp.where(live, zi_new, zi),
                jnp.where(live, m_new, m)), None

    new_state, _ = jax.lax.scan(
        step, state, (frames_u8, coeffs[0], coeffs[1], coeffs[2], gates))
    return new_state


class FleetFlickerAnalyzer:
    """Per-stream flicker maps for a WHOLE fleet in one device dispatch.

    :class:`FlickerAnalyzer` carries one stream's demodulator planes; at
    fleet scale (``MultiStreamEngine`` / ``--inputs`` batch mode /
    coalesced serve slots) per-stream analyzers would pay one device
    dispatch per stream per batch.  This class stacks S streams' carry
    planes as (S, H, W) and updates them all in one ``lax.scan`` dispatch
    (``_flicker_update_fleet``), with per-stream frequency/fps/tau,
    independent frame cursors (staggered starts, stalls) and per-frame
    validity gating — maps are bit-identical to per-stream analyzers.

    Streams start unconfigured; :meth:`configure` arms one (a serving slot
    binding flicker_hz, or all streams at once for a uniform fleet).
    :meth:`update` takes the same ragged per-stream frame lists the
    multi-stream engines consume.
    """

    def __init__(self, n_streams: int, chroma=None):
        from ..properties import ChromaFilter
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.n_streams = int(n_streams)
        self.chroma = ChromaFilter.ALL if chroma is None else chroma
        self._enabled = [False] * self.n_streams
        self._freq = np.zeros(self.n_streams, np.float64)
        self._fps = np.zeros(self.n_streams, np.float64)
        self._omega = np.zeros(self.n_streams, np.float64)
        self._alpha = np.ones(self.n_streams, np.float64)  # inert until
        self._tau = np.zeros(self.n_streams, np.float64)   # configured
        self.frames_seen = [0] * self.n_streams
        self._geometry: Optional[Tuple[int, int]] = None
        self._state = None
        self._staging: dict = {}   # round length n -> reusable host buffer

    # -- configuration ------------------------------------------------------
    def configure(self, stream: int, freq_hz: float, fps: float,
                  tau_frames: Optional[float] = None) -> None:
        """Arm one stream's analyzer (validation mirrors FlickerAnalyzer);
        re-configuring an armed stream resets its window."""
        if not (math.isfinite(fps) and fps > 0):
            raise ValueError(f"fps must be positive, got {fps!r}")
        if not 0 < freq_hz < fps / 2:
            raise ValueError(
                f"freq_hz must lie in (0, fps/2) = (0, {fps / 2:g}) to be "
                f"resolvable at {fps:g} fps, got {freq_hz!r}")
        if tau_frames is None:
            tau_frames = max(16.0, 4.0 * fps / freq_hz)
        if not (math.isfinite(tau_frames) and tau_frames >= 2.0):
            raise ValueError(
                f"tau_frames must be finite and >= 2, got {tau_frames!r}")
        self._freq[stream] = freq_hz
        self._fps[stream] = fps
        self._tau[stream] = tau_frames
        self._omega[stream] = 2.0 * math.pi * freq_hz / fps
        self._alpha[stream] = math.exp(-1.0 / tau_frames)
        self._enabled[stream] = True
        self.reset_stream(stream)

    def configure_all(self, freq_hz: float, fps: float,
                      tau_frames: Optional[float] = None) -> None:
        for si in range(self.n_streams):
            self.configure(si, freq_hz, fps, tau_frames)

    def config(self, stream: int) -> "Tuple[float, float, float] | None":
        """(freq_hz, fps, tau_frames) of an armed stream, else None."""
        if not self._enabled[stream]:
            return None
        return (float(self._freq[stream]), float(self._fps[stream]),
                float(self._tau[stream]))

    def reset_stream(self, stream: int) -> None:
        self.frames_seen[stream] = 0
        if self._state is not None:
            self._state = tuple(p.at[stream].set(0.0) for p in self._state)

    def disable(self, stream: int) -> None:
        self._enabled[stream] = False
        self.reset_stream(stream)

    # -- streaming ----------------------------------------------------------
    def _init_state(self, h: int, w: int) -> None:
        s = self.n_streams
        self._state = (jnp.zeros((s, h, w), jnp.float32),
                       jnp.zeros((s, h, w), jnp.float32),
                       jnp.zeros((s, h, w), jnp.float32))

    def update(self, frames_per_stream) -> None:
        """Feed one fleet round: a sequence of S per-stream frame lists
        (uint8 RGB (H, W, 3) each; empty/short lists allowed — ragged
        tails are gated off).  Unconfigured streams' frames are ignored.
        One device dispatch per distinct round length N."""
        if len(frames_per_stream) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got "
                             f"{len(frames_per_stream)}")
        counts = [len(f) if self._enabled[si] else 0
                  for si, f in enumerate(frames_per_stream)]
        n = max(counts, default=0)
        if n == 0:
            return
        for si, frames in enumerate(frames_per_stream):
            for f in frames:
                f = np.asarray(f)
                if f.ndim != 3 or f.shape[-1] != 3 or f.dtype != np.uint8:
                    raise ValueError(
                        f"stream {si}: expected uint8 RGB (H, W, 3), got "
                        f"{f.dtype} {f.shape}")
                if self._geometry is None:
                    self._geometry = f.shape[:2]
                if f.shape[:2] != self._geometry:
                    raise ValueError(
                        f"stream {si}: frame geometry {f.shape[:2]} != "
                        f"fleet geometry {self._geometry}")
        if self._state is None:
            self._init_state(*self._geometry)
        h, w = self._geometry
        s = self.n_streams
        # persistent staging per round length n: at fleet scale the
        # stacked buffer is large, and a fresh allocation + page faults
        # every round is real hot-path cost.  Stale bytes from earlier
        # rounds need NO re-zeroing — every (frame, stream) cell the
        # current round does not fill is gated off inside the kernel
        # (uint8 bytes cannot poison anything through a zero gate), and
        # jnp.asarray copies the buffer before this method returns.
        stacked = self._staging.get(n)
        if stacked is None:
            stacked = self._staging[n] = np.empty((n, s, h, w, 3),
                                                  np.uint8)
        gates = np.zeros((n, s), np.float32)
        coeffs = np.zeros((3, n, s), np.float32)
        j = np.arange(n, dtype=np.float64)
        for si in range(s):
            n_si = counts[si]
            if n_si == 0:
                continue
            for k in range(n_si):
                stacked[k, si] = frames_per_stream[si][k]
            gates[:n_si, si] = 1.0
            a, om, n0 = (self._alpha[si], self._omega[si],
                         self.frames_seen[si])
            phase = math.fmod(om * n0, 2.0 * math.pi) + om * j
            denom = np.maximum(1.0 - a ** (n0 + j + 1.0), 1e-12)
            coeffs[0, :, si] = np.cos(phase)
            coeffs[1, :, si] = np.sin(phase)
            coeffs[2, :, si] = denom
            self.frames_seen[si] += n_si
        self._state = _flicker_update_fleet(
            self.chroma.value, self._state, jnp.asarray(stacked),
            jnp.asarray(coeffs), jnp.asarray(gates),
            jnp.asarray(self._alpha.astype(np.float32)))

    # -- readout ------------------------------------------------------------
    def power(self, stream: int) -> np.ndarray:
        """(H, W) f32 squared oscillation amplitude for one stream (same
        startup-bias correction as FlickerAnalyzer.power)."""
        if not self._enabled[stream]:
            raise RuntimeError(f"stream {stream} has no flicker analyzer "
                               f"(configure it first)")
        if self._state is None or self.frames_seen[stream] == 0:
            raise RuntimeError(f"stream {stream}: no frames streamed yet")
        zr, zi, _ = self._state
        # python float, not np.float64: NEP-50 would promote the f32
        # planes to float64 and break bit-identity with FlickerAnalyzer
        corr = float(max(
            1e-12, 1.0 - self._alpha[stream] ** self.frames_seen[stream]))
        z2 = (np.asarray(zr[stream]) ** 2 + np.asarray(zi[stream]) ** 2)
        return 4.0 * z2 / (corr * corr)

    def amplitude(self, stream: int) -> np.ndarray:
        return np.sqrt(self.power(stream))

    def amplitudes(self) -> np.ndarray:
        """(S, H, W) f32 amplitude maps (zero planes for unarmed/fresh
        streams)."""
        if self._state is None or self._geometry is None:
            raise RuntimeError("no frames streamed yet")
        h, w = self._geometry
        out = np.zeros((self.n_streams, h, w), np.float32)
        for si in range(self.n_streams):
            if self._enabled[si] and self.frames_seen[si]:
                out[si] = self.amplitude(si)
        return out


@functools.partial(jax.jit, static_argnums=(1,))
def denoise_frames(frames_u8: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Batched FFT low-pass denoise of uint8 frames (N, H, W, C) -> uint8.

    The streaming-pipeline integration of :func:`fft_denoise` (BASELINE
    configs[4]: "4K streaming pipeline with ... denoise post-analysis").
    """
    f = frames_u8.astype(jnp.float32)
    planes = jnp.moveaxis(f, -1, 1)                        # (N, C, H, W)
    den = fft_denoise(planes, radius)  # operates on the last two axes
    den = jnp.moveaxis(den, 1, -1)
    return jnp.clip(jnp.rint(den), 0, 255).astype(jnp.uint8)
