"""DCNv3 and int8 ops: plain versions, kernel wrappers and dispatch.

Importing the package registers the ``torch.ops.givepose`` operators
(``library.py``) through which the dispatch launches the kernels.
"""

from givepose_torch.ops import library  # noqa: F401
