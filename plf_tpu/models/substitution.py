"""Substitution models: rate matrices, eigensystem, PLF branch matrices.

The reference accelerator consumes pre-computed 64-float branch matrices
and a 16-float eigenvector matrix as opaque inputs (its host fills them
randomly, app/src/host_mem.cpp:190-196) because production RAxML computes
them on the CPU from the substitution model eigendecomposition.  A complete
engine needs the producer side too; this module implements it.

The PLF dataflow (app/src/plf.cpp:29-50) computes, per category ``c``:

    x3 = EVarr^T [ (left_c . x1) * (right_c . x2) ]        (* = Hadamard)

For this to realise Felsenstein pruning, CLVs are kept in **eigen
coordinates**: with a reversible ``Q = U diag(lam) W`` (``W = U^-1``), a
conditional likelihood vector ``L`` (state space) is stored as
``x = W . L``.  Then

    left_c[k, a]  = U[k, a] * exp(lam_a * t_left * r_c)
    EVarr[k, l]   = W[l, k]                       (i.e. W^T)

gives ``left_c . x1 = P(t_left, r_c) . L1`` (state space), the Hadamard
product is the pruning product, and ``EVarr^T`` maps the parent partial
back into eigen coordinates.  Tips enter as ``x_tip = W . e_obs`` (the
RAxML "tipVector") and the root likelihood per site is
``(pi^T U) . x_root``.

Gamma rate heterogeneity uses the standard mean-normalised discretisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SubstitutionModel", "jc69", "hky85", "gtr", "random_gtr",
           "discrete_gamma_rates", "branch_matrices",
           "SENSE_CODONS", "codon_gy94", "f3x4_frequencies",
           "f3x4_from_codes", "encode_codon_alignment"]

# ACGT index order for DNA convenience helpers.
DNA_STATES = "ACGT"


def _normalise_q(q: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Scale Q so the expected substitution rate is 1."""
    rate = -np.sum(pi * np.diag(q))
    return q / rate


def _reversible_eigen(q: np.ndarray, pi: np.ndarray):
    """Real eigensystem of a reversible Q via the symmetrised form.

    B = D^{1/2} Q D^{-1/2} (D = diag(pi)) is symmetric; with B = V L V^T:
    U = D^{-1/2} V (right eigenvectors, columns), W = V^T D^{1/2} = U^{-1}.
    """
    d = np.sqrt(pi)
    b = (q * d[:, None]) / d[None, :]
    b = 0.5 * (b + b.T)
    lam, v = np.linalg.eigh(b)
    u = v / d[:, None]
    w = v.T * d[None, :]
    return lam, u, w


@dataclasses.dataclass(frozen=True)
class SubstitutionModel:
    """An eigendecomposed reversible substitution model."""

    pi: np.ndarray           # (S,) stationary frequencies
    eigenvalues: np.ndarray  # (S,)
    u: np.ndarray            # (S, S) right eigenvectors, u[state, eigidx]
    w: np.ndarray            # (S, S) inverse, w[eigidx, state]

    @property
    def states(self) -> int:
        return self.pi.shape[0]

    @property
    def plf_ev(self) -> np.ndarray:
        """The EV array the PLF consumes (stage 3): EVarr[k, l] = W[l, k]."""
        return np.ascontiguousarray(self.w.T.astype(np.float32))

    @property
    def root_vector(self) -> np.ndarray:
        """v with per-site likelihood = v . x_root (eigen coords)."""
        return (self.pi @ self.u).astype(np.float64)

    def p_matrix(self, t: float, rate: float = 1.0) -> np.ndarray:
        """Full transition matrix P[from, to] = (U diag(e^{lam t r}) W)."""
        e = np.exp(self.eigenvalues * t * rate)
        return (self.u * e[None, :]) @ self.w

    def tip_clv(self, states_idx: np.ndarray, categories: int = 4,
                dtype=np.float32) -> np.ndarray:
        """Tip CLV in eigen coordinates, replicated per rate category.

        ``states_idx``: (n,) int array of observed states; values >= S (or
        negative) mean fully ambiguous/gap (likelihood 1 for every state).
        Returns (n, categories, S).
        """
        n = states_idx.shape[0]
        s = self.states
        onehot = np.zeros((n, s), dtype=np.float64)
        valid = (states_idx >= 0) & (states_idx < s)
        onehot[np.arange(n)[valid], states_idx[valid]] = 1.0
        onehot[~valid] = 1.0  # gap/ambiguity: all states possible
        x = onehot @ self.w.T                      # (n, S) eigen coords
        x = np.repeat(x[:, None, :], categories, axis=1)
        return x.astype(dtype)


def _make(qsym: np.ndarray, pi: np.ndarray) -> SubstitutionModel:
    pi = np.asarray(pi, dtype=np.float64)
    pi = pi / pi.sum()
    q = qsym * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    q = _normalise_q(q, pi)
    lam, u, w = _reversible_eigen(q, pi)
    return SubstitutionModel(pi=pi, eigenvalues=lam, u=u, w=w)


def jc69() -> SubstitutionModel:
    """Jukes-Cantor 1969 (equal rates and frequencies)."""
    qsym = np.ones((4, 4)) - np.eye(4)
    return _make(qsym, np.full(4, 0.25))


def hky85(kappa: float = 2.0, pi=None) -> SubstitutionModel:
    """HKY85 with transition/transversion ratio kappa (ACGT order)."""
    if pi is None:
        pi = np.full(4, 0.25)
    qsym = np.ones((4, 4)) - np.eye(4)
    qsym[0, 2] = qsym[2, 0] = kappa  # A<->G
    qsym[1, 3] = qsym[3, 1] = kappa  # C<->T
    return _make(qsym, pi)


def gtr(rates, pi) -> SubstitutionModel:
    """General time-reversible model from S*(S-1)/2 exchangeabilities."""
    pi = np.asarray(pi, dtype=np.float64)
    s = pi.shape[0]
    qsym = np.zeros((s, s))
    qsym[np.triu_indices(s, 1)] = rates
    qsym = qsym + qsym.T
    return _make(qsym, pi)


def random_gtr(states: int = 4, seed: int = 0) -> SubstitutionModel:
    """Random GTR-class model of any state count (e.g. 20 for protein)."""
    rng = np.random.default_rng(seed)
    rates = rng.random(states * (states - 1) // 2) + 0.1
    pi = rng.random(states) + 0.1
    return gtr(rates, pi / pi.sum())


# ---------------------------------------------------------------------------
# Codon models (61 sense codons, universal genetic code) — the hardest
# stress of the S-generic node op (rows = 61*C; the dot variants carry
# it; the element-wise form unrolls S^2 products and is built for small S).
# ---------------------------------------------------------------------------

# NCBI translation table 1, codon order TTT,TTC,TTA,TTG,TCT,... (bases in
# T,C,A,G order, first position slowest).
_CODE_TCAG = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _standard_code():
    bases = "TCAG"
    table = {}
    i = 0
    for b1 in bases:
        for b2 in bases:
            for b3 in bases:
                table[b1 + b2 + b3] = _CODE_TCAG[i]
                i += 1
    return table


GENETIC_CODE = _standard_code()
#: The 61 sense codons in ACGT-lexicographic order — the codon-model
#: state indexing used throughout.
SENSE_CODONS = tuple(sorted(c for c, aa in GENETIC_CODE.items()
                            if aa != "*"))

_TRANSITIONS = {frozenset("AG"), frozenset("CT")}


def codon_gy94(kappa: float = 2.0, omega: float = 1.0,
               pi=None) -> SubstitutionModel:
    """Goldman-Yang (1994) codon model over the 61 sense codons.

    Instantaneous rate between codons differing at exactly one position:
    ``pi_j * kappa^[transition] * omega^[nonsynonymous]``; zero for
    multi-position changes.  Reversible (the kappa/omega factor is
    symmetric), so it plugs into the same eigendecomposed PLF machinery
    as the DNA/protein models.  ``pi``: (61,) codon frequencies (e.g.
    from :func:`f3x4_frequencies`); uniform by default.
    """
    S = len(SENSE_CODONS)
    if pi is None:
        pi = np.full(S, 1.0 / S)
    qsym = np.zeros((S, S))
    for i in range(S):
        ci = SENSE_CODONS[i]
        for j in range(i + 1, S):
            cj = SENSE_CODONS[j]
            diff = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diff) != 1:
                continue
            rate = 1.0
            if frozenset(diff[0]) in _TRANSITIONS:
                rate *= kappa
            if GENETIC_CODE[ci] != GENETIC_CODE[cj]:
                rate *= omega
            qsym[i, j] = qsym[j, i] = rate
    return _make(qsym, pi)


def f3x4_frequencies(pos_freqs: np.ndarray) -> np.ndarray:
    """F3x4 codon frequencies from per-position nucleotide frequencies.

    ``pos_freqs``: (3, 4) in ACGT order.  Stop codons are excluded and
    the rest renormalised (the standard F3x4 estimator).
    """
    pos_freqs = np.asarray(pos_freqs, np.float64)
    assert pos_freqs.shape == (3, 4)
    nuc = {b: i for i, b in enumerate(DNA_STATES)}
    pi = np.array([pos_freqs[0, nuc[c[0]]] * pos_freqs[1, nuc[c[1]]]
                   * pos_freqs[2, nuc[c[2]]] for c in SENSE_CODONS])
    return pi / pi.sum()


def f3x4_from_codes(codes: np.ndarray,
                    wgt: Optional[np.ndarray] = None) -> np.ndarray:
    """F3x4 codon frequencies estimated from observed codon codes.

    ``codes``: (n_leaves, n_sites) codon state codes (values >= 61 =
    gap/ambiguous, ignored).  Decomposes each observed sense codon into
    its three nucleotide positions, accumulates per-position ACGT
    counts (optionally ``wgt``-weighted) and applies the standard F3x4
    estimator (:func:`f3x4_frequencies`).  This is the data-driven
    frequency step of the GY94 fitting workflow (codeml's F3x4).
    """
    codes = np.asarray(codes)
    S = len(SENSE_CODONS)
    nuc = {b: i for i, b in enumerate(DNA_STATES)}
    # (61, 3) nucleotide index of each sense codon position
    pos_idx = np.asarray([[nuc[c[p]] for p in range(3)]
                          for c in SENSE_CODONS])
    w = (np.ones(codes.shape[1]) if wgt is None
         else np.asarray(wgt, np.float64))
    counts = np.full((3, 4), 1e-6)
    valid = (codes >= 0) & (codes < S)
    for p in range(3):
        nucs = np.where(valid, pos_idx[np.clip(codes, 0, S - 1), p], -1)
        for b in range(4):
            counts[p, b] += ((nucs == b) * w[None, :]).sum()
    counts /= counts.sum(axis=1, keepdims=True)
    return f3x4_frequencies(counts)


def encode_codon_alignment(dna_states: np.ndarray) -> np.ndarray:
    """(n_leaves, 3*n_codons) DNA state codes -> (n_leaves, n_codons)
    codon state codes.

    Any triplet containing a gap/ambiguous base (codes outside 0..3) or
    forming a stop codon maps to the gap code 61 (fully ambiguous).
    """
    dna = np.asarray(dna_states)
    L, n3 = dna.shape
    if n3 % 3:
        raise ValueError(f"DNA alignment length {n3} not a codon multiple")
    idx_of = {c: i for i, c in enumerate(SENSE_CODONS)}
    tri = dna.reshape(L, n3 // 3, 3)
    out = np.full((L, n3 // 3), len(SENSE_CODONS), dtype=np.int32)
    valid = ((tri >= 0) & (tri < 4)).all(axis=2)
    li, si = np.nonzero(valid)
    for l, s in zip(li, si):
        codon = "".join(DNA_STATES[b] for b in tri[l, s])
        out[l, s] = idx_of.get(codon, len(SENSE_CODONS))
    return out


def discrete_gamma_rates(alpha: float, categories: int = 4) -> np.ndarray:
    """Mean-normalised discrete Gamma rates (median discretisation)."""
    from scipy.stats import gamma as _gamma
    c = categories
    quantiles = (2 * np.arange(c) + 1) / (2.0 * c)
    rates = _gamma.ppf(quantiles, a=alpha, scale=1.0 / alpha)
    return (rates * c / rates.sum()).astype(np.float64)


AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYV"  # PAML canonical order


def parse_paml_matrix(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a PAML ``.dat`` empirical amino-acid model file.

    The standard distribution format of LG/WAG/JTT etc.: 190 lower-
    triangular exchangeabilities (row i of 2..20 holds i-1 numbers),
    followed by 20 equilibrium frequencies, free-form whitespace;
    anything after the 210th number (comments, ancestral sequences) is
    ignored.  Returns ``(exchangeabilities (20, 20) symmetric, pi (20,))``
    in PAML amino-acid order ARNDCQEGHILKMFPSTWYV.
    """
    vals: list = []
    for tok in text.replace(",", " ").split():
        try:
            vals.append(float(tok))
        except ValueError:
            break  # first non-numeric token ends the numeric block
        if len(vals) == 210:
            break
    if len(vals) < 210:
        raise ValueError(
            f"PAML matrix needs 190 rates + 20 frequencies, got "
            f"{len(vals)} numbers")
    S = 20
    R = np.zeros((S, S))
    k = 0
    for i in range(1, S):
        for j in range(i):
            R[i, j] = R[j, i] = vals[k]
            k += 1
    pi = np.asarray(vals[190:210], dtype=np.float64)
    pi = pi / pi.sum()
    return R, pi


#: Empirical models shipped as PAML-format data files under models/data/.
#: lg.dat: Le & Gascuel (2008) MBE 25(7):1307-1320; wag.dat: Whelan &
#: Goldman (2001) MBE 18(5):691-699; jtt.dat: Jones, Taylor & Thornton
#: (1992) CABIOS 8:275-282; dayhoff.dat: Dayhoff, Schwartz & Orcutt
#: (1978); mtrev.dat: Adachi & Hasegawa (1996) mtREV24; cprev.dat:
#: Adachi et al. (2000) cpREV.  Transcribed from the published
#: PAML-distribution tables (this build has no network access); the
#: structural checks in tests/test_empirical.py validate row counts,
#: frequency sums and the models' documented extremes — for regulated
#: production use, byte-compare against your own PAML .dat copies.
BUILTIN_PROTEIN_MODELS = ("lg", "wag", "jtt", "dayhoff", "mtrev", "cprev")


def empirical_protein(source: str,
                      pi: Optional[np.ndarray] = None
                      ) -> SubstitutionModel:
    """Build a 20-state model from PAML ``.dat`` text, a file path, or a
    built-in name ("lg", "wag", "jtt", "dayhoff", "mtrev", "cprev") —
    any PAML-distribution file parses directly.  ``pi`` overrides the
    matrix's published equilibrium frequencies (the "+F" convention:
    empirical exchangeabilities with frequencies observed from the
    data)."""
    import os
    text = source
    if source.lower() in BUILTIN_PROTEIN_MODELS:
        path = os.path.join(os.path.dirname(__file__), "data",
                            f"{source.lower()}.dat")
        with open(path) as f:
            text = f.read()
    elif "\n" not in source and os.path.exists(source):
        with open(source) as f:
            text = f.read()
    R, pi_file = parse_paml_matrix(text)
    iu = np.triu_indices(20, k=1)
    return gtr(R[iu], pi_file if pi is None else np.asarray(pi))


def gamma_invariant_rates(alpha: Optional[float], p_inv: float,
                          categories: int = 4):
    """Rate mixture for the +I(+G) model: invariant sites + gamma.

    Returns ``(rates, weights)`` of length ``categories + 1``: category 0
    has rate 0 with weight ``p_inv`` (a site that cannot change — its
    branch matrix is exp(0) = identity in eigen coordinates), and the
    ``categories`` gamma categories carry weight ``(1-p_inv)/categories``
    with their rates scaled by ``1/(1-p_inv)`` so the mixture's mean rate
    stays 1 (the standard RAxML/phyml +I+G parameterisation).
    ``alpha=None`` gives plain +I (single variable-rate class).
    """
    if not 0.0 <= p_inv < 1.0:
        raise ValueError(f"p_inv must be in [0, 1), got {p_inv}")
    g = (np.ones(categories) if alpha is None
         else discrete_gamma_rates(alpha, categories))
    rates = np.concatenate([[0.0], g / (1.0 - p_inv)])
    weights = np.concatenate([[p_inv],
                              np.full(categories, (1.0 - p_inv) / categories)])
    return rates.astype(np.float64), weights.astype(np.float64)


def branch_matrices(model: SubstitutionModel, t: float,
                    rates: Optional[np.ndarray] = None,
                    categories: int = 4) -> np.ndarray:
    """Per-category PLF branch matrix: (C, S, S), [c, k, a].

    ``left[c, k, a] = U[k, a] * exp(lam_a * t * r_c)`` so that contracting
    a child's eigen-coordinate CLV reproduces the full P-matrix action in
    state space (see module docstring).  This is the 64-float ``left``/
    ``right`` input the reference streams per call (host_mem.cpp:232-236).
    """
    if rates is None:
        rates = np.ones((categories,))
    out = np.empty((len(rates), model.states, model.states), dtype=np.float64)
    for c, r in enumerate(rates):
        e = np.exp(model.eigenvalues * t * r)
        out[c] = model.u * e[None, :]
    return out.astype(np.float32)
