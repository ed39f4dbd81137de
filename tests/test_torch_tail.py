"""The port's scalar tail layer where it departs from the reference on
purpose: a dominant pole shared by two stations (ROADMAP C2, C7).

The reference's exponential-tail asymptote takes the residue at a simple
pole; for a tandem of identical stations the pole is double and
``repro.core.tail._wait_mgf`` divides by zero (or the residue comes out
non-finite and the quantile inf). The port resolves such a quantile on the
Euler path, so these cases are held against the port's own Euler path
(exactly: it is the same function), not against the reference, and stay out
of the parity tests. Where the poles stand apart, the port's asymptote still
equals the reference's bit for bit (the same arithmetic).
"""

import math

import pytest

from repro.core import tail as JT
from repro_torch.core import tail as T


def _stations(mod, params):
    """(mu, rho, kind, cv2) tuples as tests/test_tail_properties.py draws them."""
    out = []
    for mu, rho, kind, cv2 in params:
        mean = 1.0 / mu
        var = cv2 * mean * mean if kind == mod.KIND_GAMMA else 0.0
        out.append(mod.proc_station(rho * mu, kind, mean, var, 1.0))
    return out


# the falsifying cases of C2: two M/D/1 stations at lambda = 1, mean 0.5, and
# tests/test_tail_properties.py:82,200's [(1.0, 0.4375, det, 1.0)] x 2
C2_CASES = {
    "md1_lam1_mean05_x2": [(2.0, 0.5, 0, 0.0)] * 2,
    "det_rho04375_x2": [(1.0, 0.4375, 0, 1.0)] * 2,
}
# C3: tests/test_tail_properties.py:166, exponential wait poles 0.83% apart
C3_CASE = [(1.0, 0.0625, 1, 0.0), (1.0, 0.0546875, 1, 0.0)]


@pytest.mark.parametrize("name", sorted(C2_CASES))
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, T.EULER_Q_MAX])
def test_shared_pole_asymptote_resolves_on_the_euler_path(name, q):
    sts = _stations(T, C2_CASES[name])
    got = T.sojourn_quantile(sts, q, method="asymptote")
    assert math.isfinite(got) and got > 0.0
    assert got == T._quantile_euler(sts, q) == T.sojourn_quantile(sts, q, method="euler")


@pytest.mark.parametrize("name", sorted(C2_CASES))
def test_shared_pole_past_q_max_stays_finite_and_ordered(name):
    sts = _stations(T, C2_CASES[name])
    at = T.sojourn_quantile(sts, T.EULER_Q_MAX, method="euler")
    past = T.sojourn_quantile(sts, 1.0 - 1e-8, method="euler")  # resolves to the asymptote
    assert math.isfinite(past) and past >= at


def test_c3_handoff_gap_is_reported():
    """Crossing EULER_Q_MAX with poles 0.83% apart: the reference jumps 10.7%
    (17.72 vs 19.85); the port stays on the Euler path on both sides."""
    sts = _stations(T, C3_CASE)
    q = T.EULER_Q_MAX
    below = T.sojourn_quantile(sts, q, method="euler")
    above = T.sojourn_quantile(sts, math.nextafter(q, 1.0), method="euler")
    gap = abs(above - below) / below
    print(f"C3 handoff: euler {below!r} -> {above!r}, relative gap {gap:.3e}")
    assert gap <= 1e-6
    jsts = _stations(JT, C3_CASE)
    jgap = abs(JT.sojourn_quantile(jsts, math.nextafter(q, 1.0), method="euler")
               - JT.sojourn_quantile(jsts, q, method="euler"))
    assert jgap / below > 0.10  # the reference's C3, for the record


@pytest.mark.parametrize("params", [
    [(1.0, 0.5, 1, 0.0)],  # one M/M/1 station (its closed form)
    [(2.0, 0.3, 0, 0.0), (1.0, 0.6, 1, 0.0)],  # poles far apart
    [(5.0, 0.7, 2, 0.5), (1.0, 0.2, 1, 0.0), (3.0, 0.4, 0, 0.0)],
])
def test_separated_poles_equal_the_reference(params):
    for q in (0.9, 0.999, 1.0 - 1e-8):
        got = T.sojourn_quantile(_stations(T, params), q, method="asymptote")
        want = JT.sojourn_quantile(_stations(JT, params), q, method="asymptote")
        assert got == want


def test_shares_dominant_pole():
    assert T.shares_dominant_pole([(1.0, 0, True), (1.0, 1, True)])
    assert T.shares_dominant_pole([(1.0, 0, True), (1.0 + 0.5 * T.POLE_GAP_REL, 1, True)])
    assert not T.shares_dominant_pole([(1.0, 0, True), (1.0 + 2 * T.POLE_GAP_REL, 1, True)])
    assert not T.shares_dominant_pole([(1.0, 0, True), (math.inf, 0, False)])
    assert not T.shares_dominant_pole([(0.5, 0, True)])
