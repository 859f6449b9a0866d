"""Host-side input: the prefetching window iterator of the video paths."""
