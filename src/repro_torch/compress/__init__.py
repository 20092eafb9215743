"""Compressed activation transport (``repro.compress``): the (bitmap,
payload) stream codec over Zebra-masked maps, and the measured-bytes
meter that reconciles it against Eq. 2/3. The integrity levels
(``compress/integrity.py``) wait (ROADMAP.md, module queue)."""
from .stream import (  # noqa: F401
    CompressedMap,
    compress,
    compress_tree,
    decompress,
    decompress_tree,
    nonzero_bitmap,
    pack_bitmap,
    unpack_bitmap,
)
from .meter import BandwidthMeter, SiteRecord  # noqa: F401
