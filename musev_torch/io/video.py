"""Video I/O (counterpart of ``musev_tpu/io/video.py``).

``VideoReader`` and ``write_video`` bind ``native/libmusevio.so`` (libav
decode and h264 encode, ``native/videoio.cpp``) through ctypes, as the JAX
package does; the library is not in git and is built by ``make -C native``
at first use. ``native_available()`` says whether it loaded: without libav
and its headers it does not, and the CLIs then write PNG frames.
``VideoReader.windows`` yields overlapping windows of the reference's
(time_size, step, overlap, sample_rate) contract. ``PrefetchingWindows``
runs the host stage of the next source window (decode, slicing, a
control-map processor) on a background thread while the current window
denoises on the card (the reference's DecordVideoDataset prefetch contract,
predictor.py:867-932).
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmusevio.so")

_lib = None
_lib_err: Optional[str] = None
_lib_lock = threading.Lock()


def _load_lib():
    """The native library, built on first use; None (and ``_lib_err`` set)
    where it cannot be built or loaded."""
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                _lib_err = f"native build failed: {e.stderr.strip()[-500:]}"
                return None
            except OSError as e:  # no make
                _lib_err = f"native build failed: {e}"
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _lib_err = str(e)
            return None
        lib.vio_open_reader.restype = ctypes.c_void_p
        lib.vio_open_reader.argtypes = [ctypes.c_char_p]
        lib.vio_reader_error.restype = ctypes.c_char_p
        lib.vio_reader_error.argtypes = [ctypes.c_void_p]
        for name, res in [
            ("vio_reader_width", ctypes.c_int),
            ("vio_reader_height", ctypes.c_int),
            ("vio_reader_fps", ctypes.c_double),
            ("vio_reader_nframes", ctypes.c_int64),
        ]:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = [ctypes.c_void_p]
        lib.vio_read_frames.restype = ctypes.c_int64
        lib.vio_read_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vio_close_reader.restype = None
        lib.vio_close_reader.argtypes = [ctypes.c_void_p]
        lib.vio_write_video.restype = ctypes.c_int
        lib.vio_write_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def native_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loaded)."""
    _load_lib()
    return _lib_err


class VideoReader:
    """Sequential window reader over a video file."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native video library unavailable: {_lib_err}")
        self._lib = lib
        self._h = lib.vio_open_reader(path.encode())
        err = lib.vio_reader_error(self._h)
        if err:
            msg = err.decode()
            lib.vio_close_reader(self._h)
            self._h = None
            raise IOError(f"{path}: {msg}")
        self.width = lib.vio_reader_width(self._h)
        self.height = lib.vio_reader_height(self._h)
        self.fps = lib.vio_reader_fps(self._h)
        self.num_frames = lib.vio_reader_nframes(self._h)

    def read(self, start: int, count: int, sample_rate: int = 1) -> np.ndarray:
        """-> (n, H, W, 3) uint8 RGB; n may be < count at EOF."""
        out = np.empty((count, self.height, self.width, 3), np.uint8)
        got = self._lib.vio_read_frames(
            self._h, start, count, sample_rate,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:got]

    def windows(self, time_size: int, overlap: int = 0, sample_rate: int = 1
                ) -> Iterator[np.ndarray]:
        """Yield (time_size, H, W, 3) windows stepping by time_size - overlap
        (DecordVideoDataset contract); the last may be shorter."""
        step = time_size - overlap
        start = 0
        while True:
            frames = self.read(start, time_size, sample_rate)
            if frames.shape[0] == 0:
                return
            yield frames
            if frames.shape[0] < time_size:
                return
            start += step * sample_rate

    def close(self):
        if self._h is not None:
            self._lib.vio_close_reader(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PrefetchingWindows:
    """Wrap a window iterator with a 2-deep background prefetch queue.

    ``map_fn`` (optional) is applied to each item INSIDE the worker thread —
    host-side stages like controlnet processors (dwpose, canny) run there and
    overlap the consumer's device compute: window i+1's maps are computed
    while window i denoises (the reference's DecordVideoDataset prefetch
    contract, predictor.py:867-932)."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2, map_fn=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item if map_fn is None else map_fn(item))
            except BaseException as e:  # pragma: no cover
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item


def write_video(path: str, frames: np.ndarray, fps: float = 12.0, crf: int = 18) -> None:
    """frames (T, H, W, 3) uint8 RGB -> h264 mp4."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native video library unavailable: {_lib_err}")
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_video takes (T, H, W, 3) frames, got {frames.shape}")
    t, h, w, _ = frames.shape
    rc = lib.vio_write_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, w, h, float(fps), int(crf),
    )
    if rc != 0:
        raise IOError(f"video encode failed rc={rc}")
