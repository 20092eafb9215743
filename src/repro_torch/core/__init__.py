"""Zebra core of the port: config, threshold nets, reference masking, the
site engine, the bandwidth accounting and the partner methods (network
slimming, weight pruning)."""
from .zebra import (ThresholdNet, ZebraConfig, collect_zebra_loss,  # noqa: F401
                    mean_zero_frac, zebra_cnn, zebra_tokens)
from .backends import BackendSpec, backend_names, backend_spec  # noqa: F401
from .engine import (LayerAux, SiteAux, nchw_stream_dims,  # noqa: F401
                     site_block, stream_bytes, zebra_site)
from .bandwidth import (MapSpec, TokenMapSpec, index_overhead_pct,  # noqa: F401
                        reduced_bandwidth_pct, required_bandwidth_bytes,
                        stored_bits)
from . import slimming, weight_pruning  # noqa: F401
