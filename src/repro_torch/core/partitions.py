"""Integer partitions and Faa di Bruno coefficient tables.

n-TangentProp propagates *scaled Taylor coefficients* ``c_k = f^(k)/k!``
instead of raw derivatives (DESIGN.md section 2).  In that normalization the
composition rule for ``h = f(g(t))`` with inner coefficients ``u_j`` (j>=1)
and outer coefficients ``F_m = f^(m)(g_0)/m!`` reads

    h_k = sum_{p in P(k)}  (|p|! / prod_j p_j!) * F_{|p|} * prod_j u_j^{p_j}

where ``P(k)`` is the set of integer partitions of ``k`` written as exponent
vectors ``p = (p_1, .., p_k)`` with ``sum_j j*p_j = k`` and ``|p| = sum_j p_j``.
The multinomial coefficients are small exact integers -- contrast the raw
derivative normalization whose Bell-polynomial constants grow like ``k!``.

Everything here is pure Python / exact integer arithmetic, executed once and
cached.  This is the port's own copy of ``repro.core.partitions``: the
PyTorch package imports nothing from the JAX package.  The tables are tiny: ``p(12) = 77`` partitions.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Sequence, Tuple


class FdBTerm(NamedTuple):
    """One partition term of the Taylor-normalized Faa di Bruno sum."""

    coef: int                         # |p|! / prod_j p_j!
    order: int                        # |p| = which outer coefficient F_m to use
    powers: Tuple[Tuple[int, int], ...]  # ((j, p_j), ...) for p_j != 0


@lru_cache(maxsize=None)
def partitions(n: int) -> Tuple[Tuple[int, ...], ...]:
    """All integer partitions of ``n`` as descending tuples, e.g. 4 -> (4),(3,1),(2,2),(2,1,1),(1,1,1,1)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if n == 0:
        return ((),)

    out = []

    def rec(remaining: int, maxpart: int, prefix: Tuple[int, ...]) -> None:
        if remaining == 0:
            out.append(prefix)
            return
        for part in range(min(maxpart, remaining), 0, -1):
            rec(remaining - part, part, prefix + (part,))

    rec(n, n, ())
    return tuple(out)


def partition_count(n: int) -> int:
    """The partition function p(n) = |P(n)|."""
    return len(partitions(n))


@lru_cache(maxsize=None)
def faa_di_bruno_table(k: int) -> Tuple[FdBTerm, ...]:
    """Taylor-normalized Faa di Bruno terms for output order ``k >= 1``."""
    if k < 1:
        raise ValueError(f"order must be >= 1, got {k}")
    terms = []
    for part in partitions(k):
        # exponent representation: p_j = multiplicity of j in the partition
        exps = {}
        for j in part:
            exps[j] = exps.get(j, 0) + 1
        m = len(part)  # |p|
        denom = 1
        for e in exps.values():
            denom *= math.factorial(e)
        coef = math.factorial(m) // denom
        terms.append(FdBTerm(coef=coef, order=m, powers=tuple(sorted(exps.items()))))
    # deterministic ordering: by |p| then lexicographic powers
    terms.sort(key=lambda t: (t.order, t.powers))
    return tuple(terms)


@lru_cache(maxsize=None)
def bell_number(n: int) -> int:
    """Bell number B_n = number of set partitions; used as a property-test oracle.

    Identity used by tests: the *raw-derivative* Bell coefficients sum to B_n.
    In our Taylor normalization the equivalent identity is

        sum_{p in P(n)} coef(p) * n! / prod_j (j!)^{p_j} / |p|!  * |p|!  ... (reduces back)

    We instead verify via the classical recurrence below.
    """
    if n == 0:
        return 1
    return sum(math.comb(n - 1, j) * bell_number(j) for j in range(n))


def raw_bell_coefficient(part: Sequence[int], n: int) -> int:
    """Coefficient of a partition in the classical (raw-derivative) Faa di Bruno formula.

    For raw derivatives: C_p = n! / ( prod_j (j!)^{p_j} * p_j! ).  Summing
    C_p over all partitions of n yields the Bell number B_n -- a property the
    tests exploit to validate the partition generator end-to-end.
    """
    exps = {}
    for j in part:
        exps[j] = exps.get(j, 0) + 1
    denom = 1
    for j, e in exps.items():
        denom *= math.factorial(j) ** e * math.factorial(e)
    return math.factorial(n) // denom


@lru_cache(maxsize=None)
def total_fdb_terms(n: int) -> int:
    """sum_{k<=n} p(k): total contraction terms a full order-n propagation runs."""
    return sum(partition_count(k) for k in range(1, n + 1))
