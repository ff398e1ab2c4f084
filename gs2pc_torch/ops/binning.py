"""Legacy bin-size heuristic — capability parity only (the port's copy of
gs2pc.ops.binning, host numpy).

The reference groups Gaussians with similar point quotas into bins to batch
its torch MVN sampling (calculate_bin_sizes, gauss_to_pc.py:105-138).  The
gs2pc sampler is flat, so binning is unnecessary; this host implementation
exists so users migrating from the reference keep the same analysis
utility and so tests can pin its behaviour.
"""

from __future__ import annotations

import numpy as np


def calculate_bin_sizes(points_per_gaussian: np.ndarray) -> tuple[int, int]:
    """Reimplementation of gauss_to_pc.py:105-138 on the host.

    Returns (start_bin, bin_size): quotas above the ``start_bin``-th distinct
    value would be grouped into bins of width ``bin_size``.
    """
    ppg = np.asarray(points_per_gaussian).astype(np.int64)
    distribution = np.bincount(ppg)
    distribution = distribution[distribution.nonzero()[0]]

    if distribution.size < 3:
        return 1, 1

    gradients = np.absolute(np.gradient(np.gradient(distribution)))

    bin_size = max(len(distribution) // 100, 1)
    length = len(gradients) - len(gradients) % bin_size
    gradients = gradients[:length]
    if length == 0:
        return 1, bin_size

    summed = gradients.reshape(-1, bin_size).sum(axis=1)

    cut_off = np.max(summed) // 50
    peak = int(np.argmax(summed))

    below = np.nonzero(summed[peak:] < cut_off)[0]
    start_bin = int(below[0]) if below.shape[0] != 0 else 1
    return start_bin, bin_size
