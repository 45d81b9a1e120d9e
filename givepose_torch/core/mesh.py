"""Per-process share of a global batch.

The port's copy of ``process_local_indices`` from
``givepose_tpu/core/mesh.py``; the rest of that module (device meshes,
sharding) becomes torch DDP in a later slice.
"""

from __future__ import annotations

import numpy as np


def process_local_indices(indices: np.ndarray, global_batch_size: int,
                          process_id: int = 0,
                          num_processes: int = 1) -> np.ndarray:
    """Per-process slice of an epoch's sample indices.

    Global batch t is ``indices[t*B:(t+1)*B]``; process p feeds the p-th
    contiguous chunk of every global batch, so that the concatenation of
    the processes' local batches is the global batch and a multi-process
    run is numerically a single process consuming ``indices`` directly.
    """
    assert global_batch_size % num_processes == 0, (global_batch_size,
                                                    num_processes)
    steps = len(indices) // global_batch_size
    local = global_batch_size // num_processes
    grid = indices[: steps * global_batch_size].reshape(
        steps, num_processes, local)
    return grid[:, process_id, :].ravel()
