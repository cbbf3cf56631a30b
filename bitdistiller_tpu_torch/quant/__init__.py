from .packing import (
    PackedLinear,
    dequantize_linear,
    make_scale_combo,
    pack_codes,
    quantize_pack_linear,
    scales_from_combo,
    unpack_codes,
)

__all__ = [
    "PackedLinear",
    "dequantize_linear",
    "make_scale_combo",
    "pack_codes",
    "quantize_pack_linear",
    "scales_from_combo",
    "unpack_codes",
]
