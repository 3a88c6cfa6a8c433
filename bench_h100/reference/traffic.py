"""One slot's traffic and queue arithmetic (the scheduler's published
semantics, wireless_dqn_test.py):

- arrivals ~ Poisson(0.5 * (rate_lo + rate_hi) * load) per link, drawn by
  the inverse CDF from one uniform (the count of CDF entries below it);
- link rates: a Gaussian of mean (lo + hi) / 2 and deviation (hi - lo) / 4,
  truncated toward zero to an integer and clamped to [lo, hi];
- the 'qr' utility is queue x rate; a scheduled link departs
  min(queue, rate).

The draws come from a `torch.Generator` on the device, arrivals first,
then rates, one call each of the whole shape, so a generator seeded as the
program's gives the program's numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def poisson_cdf(lam: float, tail: float = 1e-9) -> np.ndarray:
    """Poisson(lam) CDF up to the (1 - tail) quantile, float64."""
    if lam <= 0:
        return np.ones(1)
    p0 = np.exp(-lam)
    if p0 < np.finfo(np.float64).tiny:
        raise ValueError(f"Poisson rate {lam} underflows the CDF table")
    pmf = [p0]
    while sum(pmf) < 1.0 - tail and len(pmf) < int(8 * lam + 64):
        pmf.append(pmf[-1] * lam / len(pmf))
    return np.cumsum(pmf)


class Draws:
    """draw(generator, m) -> (arrivals, rates) for a float mask `m`, both
    zero where `m` is 0."""

    def __init__(self, load: float, rate_lo: float, rate_hi: float,
                 device):
        lam = 0.5 * (rate_lo + rate_hi) * load
        self.cdf = torch.from_numpy(poisson_cdf(lam).astype(np.float32)
                                    ).to(device)
        self.mean = 0.5 * (rate_lo + rate_hi)
        self.std = 0.25 * (rate_hi - rate_lo)
        self.lo, self.hi = rate_lo, rate_hi

    def __call__(self, generator: torch.Generator, m: torch.Tensor):
        u = torch.rand(m.shape, generator=generator, device=m.device)
        arrivals = torch.searchsorted(self.cdf, u).to(m.dtype) * m
        g = torch.randn(m.shape, generator=generator, device=m.device)
        rates = torch.clamp(torch.trunc(g * self.std + self.mean), self.lo,
                            self.hi) * m
        return arrivals, rates


def utilities(queue: torch.Tensor, rates: torch.Tensor,
              wt_sel: str) -> torch.Tensor:
    if wt_sel != "qr":
        raise ValueError(f"the reference implements wt_sel='qr', not "
                         f"{wt_sel!r}")
    return queue * rates


def depart(queue: torch.Tensor, rates: torch.Tensor,
           sel: torch.Tensor) -> torch.Tensor:
    """Queues after the scheduled links (sel == 1) sent min(queue, rate)."""
    on = (sel == 1).to(queue.dtype)
    return queue - torch.minimum(queue, rates * on)
