from .color_map import apply_color_map_to_image
from .layout import add_border, add_label, hcat, vcat
from .trajectory import (
    generate_spin,
    generate_wobble,
    generate_wobble_transformation,
    interpolate_extrinsics,
    interpolate_intrinsics,
)

__all__ = [
    "generate_wobble",
    "generate_wobble_transformation",
    "interpolate_extrinsics",
    "interpolate_intrinsics",
    "generate_spin",
    "hcat",
    "vcat",
    "add_border",
    "add_label",
    "apply_color_map_to_image",
]
