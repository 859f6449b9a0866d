"""Frames of every output video finished in the window, over the window's
length (host clock; each clip ends in a device-to-host copy of its frames)."""


def read(rec):
    return rec.frames / rec.window_s
