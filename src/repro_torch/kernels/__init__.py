"""Zebra kernels of the port: CUDA for Hopper, each with a plain PyTorch
version beside its wrapper (see ``build`` for how they are compiled)."""
from .mask_pack import pack_blocks, zebra_bitmap, zebra_mask_pack  # noqa: F401
from .pack import expand_payload, zebra_pack, zebra_unpack  # noqa: F401
from .schedule import consumer_schedule, slot_map  # noqa: F401
from .spmm_cs import zebra_spmm_cs  # noqa: F401


def launch_counters() -> dict:
    """The wrappers whose ``.launches`` count the CUDA kernel launches, by
    kernel name. ``zebra_pack`` is the codec's entry (an external bitmap),
    which runs ``zebra_pack_kernel`` under a count of its own."""
    # local names: at package level they would hide the modules
    from .zebra_mask import zebra_mask
    from .zebra_spmm import zebra_spmm
    return {"zebra_bitmap_kernel": zebra_bitmap,
            "zebra_pack_kernel": pack_blocks,
            "zebra_unpack_kernel": zebra_unpack,
            "zebra_mask_kernel": zebra_mask,
            "zebra_pack": zebra_pack,
            "zebra_spmm_kernel": zebra_spmm,
            "zebra_spmm_cs_kernel": zebra_spmm_cs}


def reset_launch_counts() -> None:
    for wrapper in launch_counters().values():
        wrapper.launches = 0
