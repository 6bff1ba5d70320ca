"""The yardstick's peaks and cost functions, frozen here so that no later
change to the program moves them.

``rqs_inverse_ops``, ``inverse_cost`` and ``pool_cost`` are copies of
``chip_smoke.py``'s (the kernel tables' bounds), ``flow_forward_ops`` and
``likelihood_ops`` count the other model FLOPs of a run the same way: each
exp, log, log1p, sqrt, division, comparison and select one operation, a
multiply-add two. A flow reference (``reference/flows/``) and a likelihood
kind (``harness/likelihoods/``) count their own on these terms."""

from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores (the
# port keeps TF32 off), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
NUM_BINS = 8
NUM_BLOCKS = 3


def rqs_inverse_ops(k):
    """f32 operations the RQS inverse of one value needs with K = k bins:
    pre-normalisation 12K - 4, knots 20K - 14, clamp and comparisons
    K + 2, the chosen bin 3, its two derivatives 26, the quadratic's
    solve, output and logdet 52."""
    return 33 * k + 65


def rqs_forward_ops(k):
    """The forward RQS of one value: as the inverse up to the chosen bin's
    derivatives (33K + 13), then theta and its clamp 4, theta(1 - theta)
    2, the numerator 5, the curvature 3, the denominator 2, the output 2,
    the derivative's numerator 11, the logdet 4 and the tail select 2."""
    return 33 * k + 48


def _mlp_ops(n_in, n_out, hidden):
    return (2 * (n_in * hidden + 2 * hidden * hidden + hidden * n_out)
            + 6 * hidden + n_out)


def _mlp_params(n_in, n_out, hidden):
    return (n_in * hidden + hidden + 2 * (hidden * hidden + hidden)
            + hidden * n_out + n_out)


def inverse_cost(n, d, hidden, num_bins=NUM_BINS, num_blocks=NUM_BLOCKS):
    """(operations, bytes) the chain inverse needs for n rows: per row and
    block the two conditioner MLPs, the RQS inverse of each dim, the
    per-dim logdet sum, x @ W^-1 and the affine; e^-s once per block; the
    constant logdet once per row. Bytes: z read once, the unpadded
    parameters read once, x and logdet written once."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut
    per_block = (_mlp_ops(up, cut * per, hidden) + _mlp_ops(cut, up * per,
                                                            hidden)
                 + d * rqs_inverse_ops(num_bins) + d + 2 * d * d + 2 * d)
    ops = n * (num_blocks * per_block + 1) + num_blocks * 2 * d
    params = num_blocks * (2 * d + d * d + _mlp_params(up, cut * per, hidden)
                           + _mlp_params(cut, up * per, hidden)) + 1
    nbytes = 4 * (2 * n * d + n + params)
    return ops, nbytes


def flow_forward_ops(d, hidden, num_bins=NUM_BINS, num_blocks=NUM_BLOCKS):
    """Operations of one row through the flow's forward and its log
    density: per block the ActNorm 2d, x @ W 2d^2, the two conditioners,
    the RQS forward of each dim and the logdet sum d, plus the three
    blocks' logdets 2 and the base density 3d + 1."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut
    per_block = (2 * d + 2 * d * d + _mlp_ops(cut, up * per, hidden)
                 + _mlp_ops(up, cut * per, hidden)
                 + d * rqs_forward_ops(num_bins) + d)
    return num_blocks * per_block + 2 + 3 * d + 1


def epoch_ops(n_rows, fwd):
    """One training epoch on ``n_rows`` live points of a flow whose forward
    costs ``fwd`` a row: forward and backward (three forwards) over the
    training rows, one forward over the 10% validation rows."""
    n_valid = max(1, int(round(n_rows * 0.1)))
    return 3 * fwd * (n_rows - n_valid) + fwd * n_valid


def training_epoch_ops(n_rows, d, hidden):
    """``epoch_ops`` of the spline flow at d and ``hidden``."""
    return epoch_ops(n_rows, flow_forward_ops(d, hidden))


def likelihood_ops(d):
    """The Gaussian's quadratic form x @ P (2d^2) and the row sum (2d)."""
    return 2 * d * d + 2 * d


def pool_cost(n, m, d, k, flagged, sectors, accepts, slots):
    """(operations, bytes) one consumption needs at these inputs: a compare
    a flagged candidate, a tournament over the live set (n) and its path
    after each accept; the m flags, the flagged candidates' logl sectors,
    the live logl once, ``it`` and the boundary flag, and each replaced
    slot's row of x and derived read and written and its logl written."""
    ops = flagged + n + accepts * math.ceil(math.log2(max(n, 2)))
    nbytes = m + 32 * sectors + 4 * n + 9 + slots * (8 * d + 8 * k + 4)
    return ops, nbytes


def bound_s(ops, nbytes):
    """(seconds, 'operations' or 'bytes'): the least time at the peaks."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')
