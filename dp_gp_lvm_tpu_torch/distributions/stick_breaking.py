r"""Truncated stick-breaking Dirichlet process posterior (counterpart of
`dp_gp_lvm_tpu/distributions/stick_breaking.py`).

q(v_t) = Beta(gamma_t1, gamma_t2), t = 1..T-1, v_T := 1, and a categorical
assignment posterior phi (D, T) over output dimensions.
"""
from __future__ import annotations

import torch
from torch.special import digamma


def expected_log_sticks(gamma1, gamma2):
    """E[log v_t], E[log(1 - v_t)] for q(v_t) = Beta(gamma1, gamma2)."""
    tot = digamma(gamma1 + gamma2)
    return digamma(gamma1) - tot, digamma(gamma2) - tot


def expected_log_pi(gamma1, gamma2):
    """E[log pi_t] for t = 1..T from T-1 Beta sticks. (T,)."""
    e_log_v, e_log_1mv = expected_log_sticks(gamma1, gamma2)
    zero = torch.zeros(1, dtype=e_log_v.dtype, device=e_log_v.device)
    csum = torch.cat([zero, torch.cumsum(e_log_1mv, dim=0)])
    return torch.cat([e_log_v, zero]) + csum


def beta_kl(gamma1, gamma2, alpha):
    """sum_t KL[Beta(gamma_t1, gamma_t2) || Beta(1, alpha)]."""
    a, b = gamma1, gamma2
    a0 = torch.ones_like(a)
    b0 = torch.ones_like(b) * alpha
    kl = (
        torch.lgamma(a + b)
        - torch.lgamma(a)
        - torch.lgamma(b)
        - torch.lgamma(a0 + b0)
        + torch.lgamma(a0)
        + torch.lgamma(b0)
        + (a - a0) * digamma(a)
        + (b - b0) * digamma(b)
        - (a + b - a0 - b0) * digamma(a + b)
    )
    return torch.sum(kl)


def assignment_entropy(phi):
    """-sum phi log phi with 0 log 0 := 0."""
    return -torch.sum(torch.special.xlogy(phi, phi))


def expected_assignment_log_prior(phi, gamma1, gamma2):
    """sum_{d,t} phi_dt E[log pi_t]."""
    return torch.sum(phi @ expected_log_pi(gamma1, gamma2))


def dp_kl_terms(phi, gamma1, gamma2, alpha, logits=None):
    """E_q[log p(z|v)] + H[q(z)] - KL[q(v)||p(v)], to be added to the ELBO.

    With the assignment `logits` the entropy takes the log-softmax form,
    exact and finite where softmax saturates to exact zeros (xlogy's
    gradient is NaN there)."""
    if logits is not None:
        entropy = -torch.sum(phi * torch.log_softmax(logits, dim=-1))
    else:
        entropy = assignment_entropy(phi)
    return (
        expected_assignment_log_prior(phi, gamma1, gamma2)
        + entropy
        - beta_kl(gamma1, gamma2, alpha)
    )


def alpha_log_prior(alpha, a0: float = 1.0, b0: float = 1.0):
    """log Gamma(alpha | a0, b0) up to constants."""
    return (a0 - 1.0) * torch.log(alpha) - b0 * alpha


def alpha_cavi_update(gamma1, gamma2, a0: float = 1.0, b0: float = 1.0):
    """Variational mean of alpha under a Gamma(a0, b0) prior (Blei and
    Jordan 2006): q(alpha) = Gamma(a0 + T - 1, b0 - sum_t E[log(1 - v_t)]),
    one pseudo-count per stick."""
    _, e_log_1mv = expected_log_sticks(gamma1, gamma2)
    return (a0 + gamma1.shape[0]) / (b0 - torch.sum(e_log_1mv))


def gamma_cavi_update(phi, alpha):
    """Closed-form stick update, t = 1..T-1:
    gamma_t1 = 1 + sum_d phi_dt, gamma_t2 = alpha + sum_d sum_{s>t} phi_ds.
    """
    counts = torch.sum(phi, dim=0)                          # (T,)
    # rev_csum[t] = sum_{s >= t} counts_s; the tail starts one later
    rev_csum = torch.flip(torch.cumsum(torch.flip(counts, (0,)), dim=0),
                          (0,))
    return 1.0 + counts[:-1], alpha + rev_csum[1:]


def phi_cavi_update(per_dim_bound, gamma1, gamma2):
    """Closed-form assignment update phi_dt ∝ exp(F_dt + E[log pi_t]) from
    the (D, T) per-dimension, per-atom free energies."""
    logits = per_dim_bound + expected_log_pi(gamma1, gamma2)[None, :]
    return torch.softmax(logits, dim=-1)
