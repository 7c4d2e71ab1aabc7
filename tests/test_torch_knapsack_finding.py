"""A finding in the reference's 1-D knapsack DP, pinned in both packages.

``solve_dp`` (``src/repro/core/knapsack.py:92-155``) scales float
weights to integers at ``scale=4096`` and rounds each weight UP (so the
result is never infeasible).  On a near-tight instance the rounding can
make the true optimum look infeasible to the DP: here the optimum uses
1.001741 of the capacity 1.002090, and after rounding its items no
longer fit.  The DP then returns 1.46260729 where ``solve_brute`` finds
1.66378436, a ratio of 0.879.

``tests/test_knapsack.py::test_dp_matches_brute_1d`` asserts a ratio of
at least 0.95 on 30 random instances drawn anew in each run, so it fails
in the runs that draw such an instance.  The port keeps the reference's
algorithm (``repro_torch.core.solve_dp``), and this test holds both to
the same numbers on the smallest instance found, with no randomness.
"""
import numpy as np

from repro.core import solve_brute as jsolve_brute
from repro.core import solve_dp as jsolve_dp
from repro_torch.core import solve_brute, solve_dp

V = np.array([0.20117707, 0.32147035, 0.60793782, 0.6222493, 0.22725851,
              0.41902895, 0.29162913])
W = np.array([[0.09712952, 0.11411417, 0.81833426, 0.34718557, 0.43257148,
               0.64199003, 0.01074026]])
C = np.array([1.00209019])


def test_dp_loses_a_near_tight_optimum_in_both_packages():
    x_dp = [False, True, False, True, True, False, True]
    x_best = [True, True, False, True, True, False, True]
    for dp, brute in ((jsolve_dp, jsolve_brute), (solve_dp, solve_brute)):
        r, b = dp(V, W, C), brute(V, W, C)
        assert r.x.tolist() == x_dp and r.feasible
        np.testing.assert_allclose(r.value, 1.46260729, rtol=0, atol=1e-8)
        assert b.x.tolist() == x_best
        np.testing.assert_allclose(b.value, 1.66378436, rtol=0, atol=1e-8)
        np.testing.assert_allclose(float(W[0] @ b.x), 1.001741, atol=1e-6)
        assert r.value < 0.95 * b.value          # the property test's bound
        np.testing.assert_allclose(r.value / b.value, 0.879, atol=1e-3)
