"""Rational-quadratic spline (RQS) transform, Durkan et al. 2019.

Port of ``nnest_tpu/bijectors/rqs.py`` with every numerical detail kept:

- identity tails outside [-B, B] (every lane computes the spline on the
  clamped input and ``torch.where`` selects the tail);
- first and last knots pinned to -B and B, boundary derivatives pinned to 1
  through the softplus-inverse constant;
- one-hot bin selection from edge comparisons, with the last edge bumped by
  1e-6 so an input at B lands in the last bin;
- the inverse's discriminant clamp at 0, the 1e-12 denominator guard and
  the root clip to [0, 1].

The CUDA kernel (``csrc/spline_inverse.cu``) computes the same inverse per
(row, dim) in registers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def softplus(x):
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0) (no threshold)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def _edges(unnormalized, B, min_size):
    """Softmax-normalised bin sizes → (K+1) knot positions with the ends
    pinned to -B and B, and the K bin sizes between them."""
    K = unnormalized.shape[-1]
    sizes = F.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * K) * sizes
    cum = 2.0 * B * torch.cumsum(sizes, dim=-1) - B
    lo = torch.full_like(cum[..., :1], -B)
    hi = torch.full_like(cum[..., :1], B)
    edges = torch.cat([lo, cum[..., :-1], hi], dim=-1)
    return edges, edges[..., 1:] - edges[..., :-1]


def conditioner_knots(out, num_bins, tail_bound):
    """The spline coupling's pre-normalisation of its conditioner's output
    (..., 3K - 1), the reference's double normalisation: ``2B softmax`` of
    the K widths and K heights and ``softplus`` of the K - 1 interior
    derivatives, which :func:`rqs` then normalises again."""
    K, B = num_bins, tail_bound
    W, H, D = out[..., :K], out[..., K:2 * K], out[..., 2 * K:]
    W = 2.0 * B * F.softmax(W, dim=-1)
    H = 2.0 * B * F.softmax(H, dim=-1)
    return W, H, softplus(D)


def knots(unnormalized_widths, unnormalized_heights, tail_bound,
          min_bin_width=DEFAULT_MIN_BIN_WIDTH,
          min_bin_height=DEFAULT_MIN_BIN_HEIGHT):
    """(cumwidths, cumheights): the x- and y-knots the transform uses."""
    return (_edges(unnormalized_widths, tail_bound, min_bin_width)[0],
            _edges(unnormalized_heights, tail_bound, min_bin_height)[0])


def rqs(inputs,
        unnormalized_widths,
        unnormalized_heights,
        unnormalized_derivatives,
        inverse: bool = False,
        tail_bound: float = 1.0,
        min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Apply the unconstrained RQS (linear tails outside [-B, B]).

    ``unnormalized_widths``/``heights`` are (..., K), ``derivatives`` the
    K-1 interior ones. Returns (outputs, logabsdet) shaped like ``inputs``.
    """
    B = tail_bound
    K = unnormalized_widths.shape[-1]
    if min_bin_width * K > 1.0:
        raise ValueError('Minimal bin width too large for the number of bins')
    if min_bin_height * K > 1.0:
        raise ValueError('Minimal bin height too large for the number of bins')

    inside = (inputs >= -B) & (inputs <= B)
    x = torch.clamp(inputs, -B, B)

    cumwidths, widths = _edges(unnormalized_widths, B, min_bin_width)
    cumheights, heights = _edges(unnormalized_heights, B, min_bin_height)

    const = math.log(math.exp(1.0 - min_derivative) - 1.0)
    boundary = torch.full_like(unnormalized_derivatives[..., :1], const)
    derivatives = min_derivative + softplus(
        torch.cat([boundary, unnormalized_derivatives, boundary], dim=-1))

    bins = cumheights if inverse else cumwidths
    bins_cmp = torch.cat([bins[..., :-1], bins[..., -1:] + 1e-6], dim=-1)
    ge = (x[..., None] >= bins_cmp).to(x.dtype)
    onehot = ge[..., :-1] - ge[..., 1:]

    def take(a):
        return torch.sum(a * onehot, dim=-1)

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_heights = take(heights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_p1 = take(derivatives[..., 1:])

    d_sum = input_derivatives + input_derivatives_p1 - 2.0 * input_delta

    if inverse:
        y_rel = x - input_cumheights
        a = input_heights * (input_delta - input_derivatives) + y_rel * d_sum
        b = input_heights * input_derivatives - y_rel * d_sum
        c = -input_delta * y_rel
        discriminant = torch.clamp(b ** 2 - 4.0 * a * c, min=0.0)
        denom = -b - torch.sqrt(discriminant)
        # Guard masked/degenerate lanes (exactly-at-knot inputs give
        # c == 0 and root == 0) against 0/0.
        safe = torch.abs(denom) > 1e-12
        root = torch.where(
            safe, 2.0 * c / torch.where(safe, denom, torch.ones_like(denom)),
            torch.zeros_like(denom))
        root = torch.clamp(root, 0.0, 1.0)
        outputs = root * input_bin_widths + input_cumwidths
        theta_1mt = root * (1.0 - root)
        denominator = input_delta + d_sum * theta_1mt
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_p1 * root ** 2
            + 2.0 * input_delta * theta_1mt
            + input_derivatives * (1.0 - root) ** 2)
        logabsdet = -(torch.log(derivative_numerator)
                      - 2.0 * torch.log(denominator))
    else:
        theta = (x - input_cumwidths) / input_bin_widths
        theta = torch.clamp(theta, 0.0, 1.0)
        theta_1mt = theta * (1.0 - theta)
        numerator = input_heights * (input_delta * theta ** 2
                                     + input_derivatives * theta_1mt)
        denominator = input_delta + d_sum * theta_1mt
        outputs = input_cumheights + numerator / denominator
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_p1 * theta ** 2
            + 2.0 * input_delta * theta_1mt
            + input_derivatives * (1.0 - theta) ** 2)
        logabsdet = (torch.log(derivative_numerator)
                     - 2.0 * torch.log(denominator))

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet
