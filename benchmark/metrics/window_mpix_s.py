"""The window's throughput, read per layer in the cells whose host sharing
moves it too far for an end-to-end bound: every texel of the window's
finished textures over the window's whole time, in Mpix/s (traced, so
under the spans and the device trace)."""

from .encode_mpix_s import SPANS, read  # noqa: F401
