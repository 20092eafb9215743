"""Compressed activation transport (``repro.compress``): the (bitmap,
payload) stream codec over Zebra-masked maps, the measured-bytes meter
that reconciles it against Eq. 2/3, and the stream-integrity
contract (``integrity``: the validation levels, the checksum and the
checks)."""
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
