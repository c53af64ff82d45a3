"""Forced first interaction of the port (counterpart of
``hyperion_tpu/transport/ffi.py``; ref src/main/forced_interaction.f90).

- **WR99** (Wood & Reynolds 1999): the first interaction depth from the
  exponential truncated at the escape optical depth,
  tau = -ln(1 - xi (1 - e^-tau_esc)), and the packet weight
  1 - e^-tau_esc (ref :23-57).
- **Baes16** (Baes et al. 2016 composite biasing): a mixture of that
  truncated exponential and a uniform density with mixing parameter xi_b;
  the CDF alpha (1 - e^-tau) + beta tau is inverted by 60 bisection trips,
  and the weight is 1 / (alpha + beta e^tau) (ref :59-135).

Lanes where forcing does not apply draw an ordinary exponential. The
functions take their uniforms as arguments."""

import torch

from .sampling import random_exp

TAU_THRES = 1e-6


def _one_minus_exp(tau_escape):
    return torch.where(tau_escape > TAU_THRES, -torch.expm1(-tau_escape),
                       tau_escape)


def forced_interaction_wr99(u, tau_escape):
    """(tau, weight) per lane from the uniforms ``u``."""
    one_minus_exp = _one_minus_exp(tau_escape)
    return -torch.log1p(-u * one_minus_exp), one_minus_exp


def forced_interaction_baes16(u, tau_escape, xi_b, n_bisect=60):
    """(tau, weight) per lane from the uniforms ``u``; ``xi_b`` is the
    mixing parameter (0: pure WR99, 1: pure uniform)."""
    one_minus_exp = _one_minus_exp(tau_escape)
    alpha = (1.0 - xi_b) / one_minus_exp.clamp_min(1e-300)
    beta = xi_b / tau_escape.clamp_min(1e-300)
    lo = torch.zeros_like(tau_escape)
    hi = tau_escape
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        cdf = torch.where(mid > TAU_THRES,
                          alpha * -torch.expm1(-mid) + beta * mid,
                          (alpha + beta) * mid)
        above = cdf > u
        lo = torch.where(above, lo, mid)
        hi = torch.where(above, mid, hi)
    tau = 0.5 * (lo + hi)
    return tau, 1.0 / (alpha + beta * torch.exp(tau))


def sample_first_interaction(u_force, u_plain, tau_escape, applies,
                             algorithm, xi_b):
    """The first interaction depth and the energy factor per lane: forced
    by ``algorithm`` ('wr99' or 'baes16') from ``u_force`` where
    ``applies``, an ordinary exponential from ``u_plain`` (factor 1)
    elsewhere."""
    if algorithm == 'baes16':
        tau_f, w = forced_interaction_baes16(u_force, tau_escape, xi_b)
    else:
        tau_f, w = forced_interaction_wr99(u_force, tau_escape)
    tau = torch.where(applies, tau_f, random_exp(u_plain))
    return tau, torch.where(applies, w, torch.ones_like(w))
