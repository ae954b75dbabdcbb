"""Device ops (JAX/XLA): histogram, encode, decode, codebook."""

import os as _os

#: persistent XLA compilation cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path inside the checkout (the path is part of the cache key,
#: so a directory that moves never hits)
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))),
    ".jax_cache",
)


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: the 16 MB chunk programs take
    seconds to compile, and the cache makes that a one-time cost.  JAX reads
    ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is unset does this
    point the cache at :data:`DEFAULT_CACHE_DIR`."""
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        _os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


_enable_compilation_cache()

from .histogram import histogram_device, histogram_np
# NOTE: ops/encode_scan_oracle.py is a differential test oracle, deliberately
# NOT exported — encode_device_merge is the one production encoder.
from .encode_merge import (
    code_bits_bucket,
    encode_device_merge,
    encode_device_merge_batch_slotted,
    encode_device_merge_slotted,
    slot_bucket,
    SLOT_BUCKETS,
    words_to_bytes,
)
from .decode import (
    DEFAULT_REFILL_WORDS,
    TABLE_BITS,
    build_decode_tables,
    cmp_len_bucket,
    decode_device,
    max_code_len,
    payload_to_words,
    syms_per_refill,
)
from .codebook import device_canonical_codes, device_code_lengths, device_codebook

__all__ = [
    "DEFAULT_CACHE_DIR",
    "histogram_device",
    "histogram_np",
    "code_bits_bucket",
    "encode_device_merge",
    "encode_device_merge_batch_slotted",
    "encode_device_merge_slotted",
    "slot_bucket",
    "SLOT_BUCKETS",
    "words_to_bytes",
    "DEFAULT_REFILL_WORDS",
    "TABLE_BITS",
    "build_decode_tables",
    "cmp_len_bucket",
    "decode_device",
    "max_code_len",
    "payload_to_words",
    "syms_per_refill",
    "device_canonical_codes",
    "device_code_lengths",
    "device_codebook",
]
