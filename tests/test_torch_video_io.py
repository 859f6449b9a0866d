"""The port's native video I/O against the JAX package's binding.

Both bind ``native/libmusevio.so``; the port's reader must read the same
frames as the JAX one from one file, and its windows must follow the
(time_size, step = time_size - overlap, sample_rate) contract. Needs the
native library, built from ``native/`` by ``make`` at first use; a test
skips, with the build's error as its reason, only where it is unavailable.
"""

import numpy as np
import pytest

from musev_tpu.io import video as jvideo
from musev_torch.io.video import (
    PrefetchingWindows,
    VideoReader,
    native_available,
    native_error,
    write_video,
)

T, H, W = 25, 64, 96


@pytest.fixture(scope="module")
def ramp_mp4(tmp_path_factory):
    """Frame i has red i * 10 and blue 255 - i * 10."""
    if not native_available():
        pytest.skip(f"native video library unavailable: {native_error()}")
    path = str(tmp_path_factory.mktemp("vio") / "ramp.mp4")
    frames = np.zeros((T, H, W, 3), np.uint8)
    for i in range(T):
        frames[i, :, :, 0] = i * 10
        frames[i, :, :, 2] = 255 - i * 10
    write_video(path, frames, fps=12)
    return path


def test_reader_reads_what_the_jax_reader_reads(ramp_mp4):
    with VideoReader(ramp_mp4) as r, jvideo.VideoReader(ramp_mp4) as j:
        assert (r.width, r.height, r.num_frames) == (j.width, j.height, j.num_frames) == (W, H, T)
        assert abs(r.fps - 12.0) < 0.01
        got, want = r.read(0, T + 5), j.read(0, T + 5)
    assert got.shape == (T, H, W, 3)
    np.testing.assert_array_equal(got, want)
    for i in range(T):
        assert abs(int(got[i, 0, 0, 0]) - i * 10) < 6


@pytest.mark.parametrize("time_size,overlap,sample_rate", [
    (12, 0, 1), (12, 4, 1), (5, 2, 2), (8, 7, 1), (30, 0, 1),
])
def test_windows_contract(ramp_mp4, time_size, overlap, sample_rate):
    """Window k starts at frame k * (time_size - overlap) * sample_rate and
    takes every sample_rate-th frame; the last is the first short one."""
    with VideoReader(ramp_mp4) as r, jvideo.VideoReader(ramp_mp4) as j:
        got = list(PrefetchingWindows(r.windows(time_size, overlap, sample_rate)))
        want = list(j.windows(time_size, overlap, sample_rate))
    assert len(got) == len(want) > 0
    step = (time_size - overlap) * sample_rate
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w)
        first = k * step
        n = min(time_size, len(range(first, T, sample_rate)))
        assert g.shape == (n, H, W, 3)
        for i in range(n):
            assert abs(int(g[i, 0, 0, 0]) - (first + i * sample_rate) * 10) < 6
    assert all(g.shape[0] == time_size for g in got[:-1])


def test_missing_file_raises(ramp_mp4, tmp_path):
    with pytest.raises(IOError):
        VideoReader(str(tmp_path / "no_such_video.mp4"))
