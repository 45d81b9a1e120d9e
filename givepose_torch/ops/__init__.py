"""DCNv3 and int8 ops: plain versions, kernel wrappers and dispatch, and
the crop-and-resize resampler.

Importing the package registers the ``torch.ops.givepose`` operators
(``library.py``) through which the dispatch launches the kernels.
"""

from givepose_torch.ops import library  # noqa: F401
from givepose_torch.ops.dcnv3 import dcnv3_core, dcnv3_sampling_locations
from givepose_torch.ops.resample import (
    resize_matrix,
    crop_resize_affine,
    affine_crop_params,
    get_2d_coord_grid,
)
