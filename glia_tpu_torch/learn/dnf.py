"""DNF path-consistency energies (the SSHMT core) in PyTorch (the port of
glia_tpu.learn.dnf).

Reference: code/alg/dnf.hxx.  For a root-path of n boundary predictions
f1..fn (f = classifier merge probability at each level), build the
n x (n+1) matrix whose column j is [f1..fj, ~f(j+1)..~fn] -- each column is
one *monotonically consistent* labeling (a boundary persists up to level j
then disappears):

  - MonotonicDNF (dnf.hxx:127-326):
      value = 1 - prod_j (target^n - colprod_j)
  - RelaxedMonotonicDNF (dnf.hxx:11-123):
      value = sum_j colprod_j
  - UniqueDNF (dnf.hxx:330-492): n x n, column j = [~f.., f_j, ..~f]:
      value = 1 - prod_j (target^n - f_j * prod_{i!=j} ~f_i)

Values are tensor expressions; ``torch.autograd`` gives the derivatives
that the reference writes by hand (dnf.hxx:235-311).
"""

from __future__ import annotations

import torch


def _col_prods(f: torch.Tensor) -> torch.Tensor:
    """colprod_j = prod_{i<j} f_i * prod_{i>=j} (1-f_i), j = 0..n.

    f: [..., n] -> [..., n+1]."""
    ones = f.new_ones(f.shape[:-1] + (1,))
    cum_f = torch.cat([ones, torch.cumprod(f, dim=-1)], dim=-1)
    nf = 1.0 - f
    rev = torch.flip(torch.cumprod(torch.flip(nf, (-1,)), dim=-1), (-1,))
    cum_nf = torch.cat([rev, ones], dim=-1)
    return cum_f * cum_nf


def monotonic_dnf(f: torch.Tensor, target: float) -> torch.Tensor:
    """f: [..., n] classifier outputs along path -> [...] DNF value."""
    n = f.shape[-1]
    cp = _col_prods(f)
    return 1.0 - torch.prod(target ** n - cp, dim=-1)


def relaxed_monotonic_dnf(f: torch.Tensor) -> torch.Tensor:
    return _col_prods(f).sum(dim=-1)


def unique_dnf(f: torch.Tensor, target: float) -> torch.Tensor:
    """Column j = f_j * prod_{i != j} (1 - f_i)."""
    n = f.shape[-1]
    nf = 1.0 - f
    # prod_{i != j} (1-f_i) without dividing: prefix times suffix cumprods
    ones = f.new_ones(f.shape[:-1] + (1,))
    left = torch.cat([ones, torch.cumprod(nf, dim=-1)[..., :-1]], dim=-1)
    right = torch.cat(
        [torch.flip(torch.cumprod(torch.flip(nf, (-1,)), dim=-1),
                    (-1,))[..., 1:], ones], dim=-1)
    col = f * (left * right)
    return 1.0 - torch.prod(target ** n - col, dim=-1)
