"""Zebra core of the port: config, reference masking, the site engine and
the bandwidth accounting."""
from .zebra import (ZebraConfig, mean_zero_frac, zebra_cnn,  # noqa: F401
                    zebra_tokens)
from .backends import BackendSpec, backend_names, backend_spec  # noqa: F401
from .engine import (LayerAux, SiteAux, nchw_stream_dims,  # noqa: F401
                     site_block, stream_bytes, zebra_site)
from .bandwidth import (MapSpec, TokenMapSpec, index_overhead_pct,  # noqa: F401
                        reduced_bandwidth_pct, required_bandwidth_bytes,
                        stored_bits)
