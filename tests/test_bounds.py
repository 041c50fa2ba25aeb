"""Distance spectrum + union bounds (harness/bounds.py) — validated
against published spectra and a brute-force enumeration, the same
anchoring role the reference's MATLAB distspec/bercoding pair plays
(berCurveCoded.m:46-51)."""

import numpy as np
import pytest

from convolutionalencdec.harness.bounds import (
    bound_curve, distance_spectrum, union_bound_ber)
from convolutionalencdec.params import (
    NASA_K7, REF_K7, TOY_K3, CodeSpec)


def test_nasa_k7_spectrum_matches_published():
    """(133,171) K=7: the Odenwalder/Proakis table, exact."""
    dfree, a, c = distance_spectrum(NASA_K7, 20)
    assert dfree == 10
    assert [int(a[d]) for d in (10, 12, 14, 16, 18, 20)] == \
        [11, 38, 193, 1331, 7275, 40406]
    assert [int(c[d]) for d in (10, 12, 14, 16, 18, 20)] == \
        [36, 211, 1404, 11633, 77433, 502690]
    assert all(int(a[d]) == 0 for d in range(20) if d % 2)  # odd-d free


def test_classic_57_spectrum():
    """K=3 (5,7): dfree 5, a_d = 2^(d-5), c_d = 1, 4, 12, 32, 80."""
    spec = CodeSpec(K=3, g=(0o5, 0o7))
    dfree, a, c = distance_spectrum(spec, 9)
    assert dfree == 5
    assert [int(a[d]) for d in range(5, 10)] == [1, 2, 4, 8, 16]
    assert [int(c[d]) for d in range(5, 10)] == [1, 4, 12, 32, 80]


def _brute_min_weight(spec, max_len=10):
    """Min Hamming weight over all nonzero terminated codewords —
    equals dfree for a non-catastrophic code once max_len covers the
    shortest error event."""
    from convolutionalencdec.ops.encode import encode_bits_np
    best = None
    for m in range(1, max_len + 1):
        for msg in range(1, 1 << m):
            bits = np.array([(msg >> i) & 1 for i in range(m)], np.uint8)
            if bits[0] == 0:
                continue                      # canonical: starts with 1
            segs = encode_bits_np(spec, bits)
            w = sum(bin(int(s)).count("1") for s in segs)
            best = w if best is None else min(best, w)
    return best


def test_toy_k3_spectrum_vs_brute_force():
    """The hand-traced (7,6) toy code has no published table — check
    dfree against exhaustive codeword enumeration."""
    dfree, a, _ = distance_spectrum(TOY_K3, 12)
    assert dfree == _brute_min_weight(TOY_K3)
    assert int(a[dfree]) >= 1


def test_ref_k7_spectrum_sane():
    """(113,171): weaker than (133,171) — the generator-discrepancy
    resolution (SURVEY §4) made quantitative: dfree 9 < 10."""
    dfree, a, _ = distance_spectrum(REF_K7, 14)
    assert dfree == 9
    assert int(a[9]) > 0


def test_catastrophic_code_rejected():
    # g share the factor (1 + D): the classic catastrophic case —
    # a zero-distance loop keeps paths in flight forever.
    with pytest.raises(ValueError, match="catastrophic"):
        distance_spectrum(CodeSpec(K=3, g=(0o6, 0o3)), 10)


def _brute_spectrum(spec, max_steps):
    """Independent enumeration of first-error events through the
    ENCODER (not the trellis tables the spectrum code uses): walk every
    input sequence of <= max_steps symbols starting nonzero, keep paths
    that first return to state 0 exactly at the end, histogram
    (distance -> count, total input weight)."""
    from convolutionalencdec.ops.encode import encode_one_input
    import collections
    a = collections.Counter()
    c = collections.Counter()
    NE = spec.num_edges_per_state

    def walk(state, steps_left, d, w):
        for u in range(NE):
            seg, ns = encode_one_input(spec, state, u)
            ns, seg = int(ns), int(seg)
            d2 = d + bin(seg).count("1")
            w2 = w + bin(u).count("1")
            if ns == 0:
                a[d2] += 1
                c[d2] += w2
            elif steps_left > 1:
                walk(ns, steps_left - 1, d2, w2)

    # first symbol nonzero (divergence), then free walk
    for u in range(1, NE):
        seg, ns = encode_one_input(spec, 0, u)
        ns, seg = int(ns), int(seg)
        d0, w0 = bin(seg).count("1"), bin(u).count("1")
        if ns == 0:
            a[d0] += 1
            c[d0] += w0
        else:
            walk(ns, max_steps - 1, d0, w0)
    return a, c


@pytest.mark.parametrize("spec", [
    TOY_K3,
    CodeSpec(K=4, g=(0o15, 0o17)),
    CodeSpec(K=3, g=(0o5, 0o7, 0o7)),
    CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13)),
])
def test_spectrum_matches_brute_force_enumeration(spec):
    """Property check against an INDEPENDENT enumeration that goes
    through the encoder step function rather than the trellis tables:
    a_d and c_d must agree exactly on every distance whose brute-force
    count has converged (same at depth M and M+2 — longer paths can no
    longer contribute below that distance)."""
    aM, cM = _brute_spectrum(spec, 10)
    aM2, cM2 = _brute_spectrum(spec, 12)
    df_brute = min(d for d in sorted(aM2) if aM2[d])
    # compare only where the brute count converged between depths AND
    # close to dfree (paths longer than 12 steps cannot reach these
    # distances for such short codes)
    stable = [d for d in sorted(aM2)
              if d <= df_brute + 5
              and aM.get(d) == aM2[d] and cM.get(d) == cM2[d]]
    dfree, a, c = distance_spectrum(spec, max(stable))
    assert dfree == df_brute
    assert len(stable) >= 3          # meaningful comparison range
    for d in stable:
        assert int(a[d]) == aM2[d], (d, int(a[d]), aM2[d])
        assert int(c[d]) == cM2[d], (d, int(c[d]), cM2[d])


def test_bounds_upper_bound_measured_hard():
    """The hard bound must sit ABOVE the measured kernel BER
    (RESULTS.md Eb/N0 table) and converge toward it with SNR."""
    measured = {4.0: 5.01e-3, 5.0: 5.00e-4, 6.0: 3.52e-5}
    for e, m in measured.items():
        b = union_bound_ber(NASA_K7, e, "hard")
        assert b >= m, (e, b, m)
        assert b <= 30 * m, (e, b, m)         # and not uselessly loose


def test_bounds_monotone_and_soft_gain():
    rows = bound_curve(NASA_K7, [5.0, 6.0, 7.0, 8.0, 9.0, 10.0])
    hard = [r["hard_ber_bound"] for r in rows]
    soft = [r["soft_ber_bound"] for r in rows]
    assert all(h2 < h1 for h1, h2 in zip(hard, hard[1:]))
    assert all(s2 < s1 for s1, s2 in zip(soft, soft[1:]))
    assert all(s < h for h, s in zip(hard, soft))   # ~2 dB coding gain
