"""The ``mixture`` kind: upstream nnest's ``GaussianMix`` (adammoss/nnest
v0.4.2), up to four Gaussian modes of width ``sigma`` whose centres differ
only in the first two dims, at (0, sep), (0, -sep), (sep, 0), (-sep, 0)
with ``weights``, in float32 on the device with a count of the rows it
evaluated; the transform ``lim * u`` from the cube to the box; and the deep
bands' start ``level``, a live set drawn exactly uniformly within
{logL > floor} and the box.

The likelihood is the function upstream's class computes, vectorised over
the modes: log_norm + logsumexp_i(log w_i - (|x_s - c_i|^2 + |x_f|^2) /
2 sigma^2), x_s the first two dims, x_f the rest.

The start ``level``: logL > floor holds exactly where |x_f| < rho(x_s),
rho(x_s)^2 = 2 sigma^2 (log_norm - floor + m(x_s)) with m(x_s) =
logsumexp_i(log w_i - |x_s - c_i|^2 / 2 sigma^2), so the set is, over each
slow pair, a ball of the fast dims. A uniform draw in it: the slow pair
from its marginal, which is proportional to the ball's volume rho^(d-2)
(by rejection from the uniform square with acceptance (rho / rho_max)^(d-2),
rho_max from m <= log sum w); the fast dims uniform in the ball of radius
rho (a direction times rho U^(1/(d-2))); then rejection of any point
outside the open box. The draws are float64 on the device from one
generator, rounded to float32 cube values. Before each draw
``require_kernel_path`` refuses a program whose hot inverse of the
configuration's flow cannot take the spline kernel that the band
requires."""

from __future__ import annotations

import math

import torch

from harness.likelihoods.gaussian import Scale

OFFSETS = ((0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0))


class Mixture:
    def __init__(self, lk, device, dtype=torch.float32):
        self.dim, self.sigma = int(lk['x_dim']), float(lk['sigma'])
        weights = lk['weights']
        self.centres = float(lk['sep']) * torch.tensor(
            OFFSETS[:len(weights)], dtype=dtype, device=device)
        self.log_w = torch.log(torch.tensor(weights, dtype=dtype,
                                            device=device))
        self.log_norm = -0.5 * self.dim * math.log(2 * math.pi
                                                   * self.sigma ** 2)
        self.rows = 0

    def slow_part(self, xs):
        """logsumexp_i(log w_i - |x_s - c_i|^2 / 2 sigma^2) of slow pairs
        ``xs`` (n, 2)."""
        r2 = torch.sum((xs[:, None, :] - self.centres) ** 2, dim=-1)
        return torch.logsumexp(self.log_w - r2 / (2 * self.sigma ** 2),
                               dim=-1)

    def __call__(self, x):
        self.rows += x.shape[0]
        fast = torch.sum(x[:, 2:] ** 2, dim=-1)
        r2 = torch.sum((x[:, None, :2] - self.centres) ** 2, dim=-1)
        return self.log_norm + torch.logsumexp(
            self.log_w - (r2 + fast[:, None]) / (2 * self.sigma ** 2),
            dim=-1)


def build(like_cfg, device):
    return Mixture(like_cfg, device), Scale(like_cfg['lim'])


def ops_per_row(like_cfg):
    """Per mode the slow pair's two differences and their squared sum 6,
    the fast dims' squared sum 2(d - 2) once, then per mode the sum, the
    scale and the weight 3; the logsumexp over M modes 4M + 2 and the
    normalisation 1."""
    m, d = len(like_cfg['weights']), like_cfg['x_dim']
    return 6 * m + 2 * (d - 2) + 3 * m + 4 * m + 2 + 1


def level_draw(lk, floor, n, seed, device):
    """``n`` cube points, float32 values in a float64 tensor on ``device``,
    uniform within {logL > floor} and the open box, as the module's note
    sets out."""
    d, lim, sigma = lk['x_dim'], float(lk['lim']), float(lk['sigma'])
    nf = d - 2
    mix = Mixture(lk, device, torch.float64)
    c = mix.log_norm - floor
    rho2_max = 2 * sigma ** 2 * (c + math.log(sum(lk['weights'])))
    if rho2_max <= 0:
        raise ValueError('no point has logL above the floor %r' % floor)
    g = torch.Generator(device=device).manual_seed(int(seed))
    kept, have = [], 0
    block = 16 * n
    while have < n:
        xs = lim * (2.0 * torch.rand(block, 2, generator=g,
                                     dtype=torch.float64, device=device)
                    - 1.0)
        rho2 = torch.clamp(2 * sigma ** 2 * (c + mix.slow_part(xs)), min=0)
        ratio = (rho2 / rho2_max) ** (nf / 2)
        take = torch.rand(block, generator=g, dtype=torch.float64,
                          device=device) < ratio
        xs, rho = xs[take], torch.sqrt(rho2[take])
        y = torch.randn(xs.shape[0], nf, generator=g, dtype=torch.float64,
                        device=device)
        y = y / torch.linalg.norm(y, dim=1, keepdim=True)
        r = rho * torch.rand(xs.shape[0], generator=g, dtype=torch.float64,
                             device=device) ** (1.0 / nf)
        x = torch.cat([xs, r[:, None] * y], dim=1)
        u = (x / lim).to(torch.float32)
        ok = torch.all(torch.abs(u) < 1.0, dim=1)
        kept.append(u[ok].double())
        have += int(ok.sum())
    return torch.cat(kept)[:n]


def level_set(like, config, floor, n, seed, device):
    """(u float64 numpy (n, d), logl float64 numpy of float32 values,
    floor): the live set within {logL > floor}. A point whose float32 logl
    is not above the floor is replaced by a later draw."""
    lk = config['likelihood']
    u = level_draw(lk, floor, 2 * n, seed, device).to(torch.float32)
    with torch.no_grad():
        logl = like(lk['lim'] * u)
    like.rows -= u.shape[0]   # the benchmark's own draws are not the run's
    ok = logl.double() > floor
    u, logl = u[ok][:n], logl[ok][:n]
    if u.shape[0] < n:
        raise RuntimeError('too few points above the birth floor')
    return (u.double().cpu().numpy(), logl.double().cpu().numpy(),
            float(floor))


def require_kernel_path(like, config, band, device):
    """Refuse, at set-up, a program that cannot run a band which requires
    ``spline_inverse`` launches: the hot inverse of the configuration's
    flow (``LatentKernels._hot_inverse`` on a fresh flow, called once on
    four rows) has to launch the spline kernel on a card, or run its plain
    twin on the CPU. A program whose hot inverse of this flow is the flow's
    own plain ``inverse`` raises here, before the warm-up, instead of
    running the window to read ``missing_kernels``."""
    if 'spline_inverse' not in band.get('require_launches', ()):
        return
    from nnest_torch.flows import build_flow
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.samplers.kernels import LatentKernels

    from harness import cells
    flow_kw = cells.flow_args(config)
    d = config['likelihood']['x_dim']
    model = build_flow(d, hidden_dim=config['hidden_dim'], device=device,
                       **flow_kw)
    kernels = LatentKernels(model, like, None,
                            num_slow=flow_kw.get('num_slow', 0))
    before = si.launches + fused_spline.calls
    with torch.no_grad():
        kernels._hot_inverse()(torch.zeros(4, d, device=device))
    if si.launches + fused_spline.calls == before:
        raise RuntimeError(
            'the band requires spline_inverse launches, and this program\'s '
            'hot inverse of the %s flow %s runs neither the spline kernel '
            'nor its twin: it cannot run this cell' % (
                config.get('flow_reference', 'spline'), flow_kw))


def init_set(like, config, band, n, seed, device):
    """The live set of a band whose ``start`` is ``level``, within its
    ``floor``, once :func:`require_kernel_path` has passed."""
    if band['start'] != 'level':
        raise ValueError('the mixture kind has no start %r' % band['start'])
    require_kernel_path(like, config, band, device)
    return level_set(like, config, float(band['floor']), n, seed, device)
