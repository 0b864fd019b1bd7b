"""Copy of `basis_universal_tpu/utils/errors.py`.

Corrupt-input error policy.

The reference transcoder treats adversarial files as a product requirement:
every read in basisu_transcoder.cpp is bounds-checked and failure returns
false rather than crashing (SURVEY §5.3 — the codebase is fuzz-hardened).
The Python analog: container/stream parsers may raise whatever low-level
exception the corruption trips (struct.error, IndexError, zstd errors, ...);
the PUBLIC entry points wrap those into CorruptFileError (a ValueError), so
callers get one clean, documented failure mode and never a hang or garbage
return."""

import functools
import struct

try:
    import zstandard as _zstd
    _ZSTD_ERROR = _zstd.ZstdError
except Exception:  # pragma: no cover
    class _ZSTD_ERROR(Exception):
        pass


class CorruptFileError(ValueError):
    """Raised by public decode entry points on malformed/truncated input."""


# exception families a corrupt byte stream can trip inside the parsers
_LOW_LEVEL = (struct.error, IndexError, KeyError, OverflowError,
              UnicodeDecodeError, EOFError, MemoryError, _ZSTD_ERROR,
              AssertionError, ZeroDivisionError, TypeError)


def guard_parse(fn):
    """Decorator: re-raise low-level parse failures as CorruptFileError.

    ValueError (including CorruptFileError and intentional validation
    errors) and NotImplementedError pass through untouched."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (ValueError, NotImplementedError):
            raise
        except _LOW_LEVEL as e:
            raise CorruptFileError(
                f"corrupt or truncated input in {fn.__qualname__}: "
                f"{type(e).__name__}: {e}") from e

    return wrapper
