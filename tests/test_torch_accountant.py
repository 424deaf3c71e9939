"""The port's Theorem-4 accountant and DP planning (repro_torch.dp)
against the live reference (repro.dp): every case of
tests/test_dp_accountant.py through both packages.  The port repeats
the reference's Python float arithmetic, so results are equal (``==``),
not merely close; errors are raised for the same inputs."""
import dataclasses
import math

import pytest

import repro.dp as J
import repro_torch.dp as T

SEL_CASES = {
    "example3": dict(s0c=16, N_c=10_000, p=1.0, epsilon=1.0, sigma=8.0,
                     K=25_000, r0=1.0 / math.e),
    "example5": dict(s0c=16, N_c=25_000, p=1.0, epsilon=2.0, sigma=8.0,
                     K=5 * 25_000, r0=1.0 / math.e),
    "r0sigma_default": dict(s0c=16, N_c=10_000, p=1.0, epsilon=1.0,
                            sigma=8.0, K=25_000),
    "p_half": dict(s0c=32, N_c=60_000, p=0.5, epsilon=2.0, sigma=5.0,
                   K=200_000),
}


@pytest.mark.parametrize("sigma,p", [(3.0, 1.0), (5.0, 1.0), (8.0, 1.0),
                                     (1.137, 1.0), (8.0, 0.5), (4.0, 2.0)])
def test_r0_sigma_equals_reference(sigma, p):
    assert T.r0_sigma(sigma, p) == J.r0_sigma(sigma, p)


@pytest.mark.parametrize("r0,sigma", [(1.0 / math.e, 8.0), (0.0247, 8.0),
                                      (0.011, 3.0), (0.1, 2.0)])
def test_r_from_r0_equals_reference(r0, sigma):
    assert T.r_from_r0(r0, sigma) == J.r_from_r0(r0, sigma)


@pytest.mark.parametrize("fn,args", [
    ("r0_sigma", (1.0,)), ("r_from_r0", (0.36, 1.2)),
    ("r_from_r0", (8.0, 8.0)), ("r_from_r0", (9.5, 8.0)),
    ("r_from_r0", (0.0, 8.0)), ("r_from_r0", (-0.1, 8.0))])
def test_guards_raise_like_the_reference(fn, args):
    with pytest.raises(ValueError) as want:
        getattr(J, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(T, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("p", [1.0, 0.5, 2.0])
def test_theorem4_simple_B_equals_reference(p):
    assert T.theorem4_simple_B(p) == J.theorem4_simple_B(p)


@pytest.mark.parametrize("kw", [
    dict(p=1.0, r0=1.0 / math.e, sigma=8.0, gamma=0.0),
    dict(p=1.0, r0=0.0247, sigma=8.0, gamma=0.0623),
    dict(p=0.5, r0=0.02, sigma=5.0, gamma=0.1, alpha=0.01)],
    ids=["example3", "gamma", "alpha"])
def test_theorem4_constants_equal_reference(kw):
    j, t = J.Theorem4Constants(**kw), T.Theorem4Constants(**kw)
    for name in ("r", "rho", "rho_hat", "tau", "alpha", "A", "B", "D"):
        assert getattr(t, name) == getattr(j, name), name
    for eps, q, n in ((1.0, 1e-4, 10_000), (2.0, 3e-3, 25_000)):
        assert t.K_minus(eps, q, n) == j.K_minus(eps, q, n)
        assert t.K_plus(eps, q, n) == j.K_plus(eps, q, n)
        assert t.K_star(q, n) == j.K_star(q, n)


def test_budget_and_sigma_bounds_equal_reference():
    for eps, delta in ((2.0, 1e-5), (1.0, 1e-6), (0.5, 5.5e-8)):
        B = J.privacy_budget_B(eps, delta)
        assert T.privacy_budget_B(eps, delta) == B
        assert T.delta_from_budget(B, eps) == J.delta_from_budget(B, eps)
    for gamma in (0.0, 0.1):
        kw = dict(p=1.0, r0=0.0247, sigma=8.0, gamma=gamma)
        assert (T.sigma_lower_bound_case1(1.0, 1e-6, **kw)
                == J.sigma_lower_bound_case1(1.0, 1e-6, **kw))
        kw2 = dict(kw, K=50_000.0, K_plus=20_000.0)
        assert (T.sigma_lower_bound_case2(1.0, 1e-6, **kw2)
                == J.sigma_lower_bound_case2(1.0, 1e-6, **kw2))


@pytest.mark.parametrize("case", sorted(SEL_CASES))
def test_select_parameters_equals_reference(case):
    want = J.select_parameters(**SEL_CASES[case])
    got = T.select_parameters(**SEL_CASES[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("sizes,N_c,sigma,eps", [
    ([32] * 100, 10_000, 4.0, 0.5), ([32] * 100, 10_000, 8.0, 0.5),
    ([16] * 100, 10_000, 8.0, 0.5), ([16] * 1000, 10_000, 8.0, 0.5)])
def test_moments_delta_equals_reference(sizes, N_c, sigma, eps):
    assert (T.moments_delta(sizes, N_c, sigma, eps)
            == J.moments_delta(sizes, N_c, sigma, eps))


def test_moments_epsilon_equals_reference():
    sizes = [16] * 500
    assert (T.moments_epsilon(sizes, 10_000, sigma=4.0, delta=1e-6)
            == J.moments_epsilon(sizes, 10_000, sigma=4.0, delta=1e-6))
    inc = [16 + int(1.322 * i) for i in range(60)]
    assert (T.moments_epsilon(inc, 10_000, sigma=8.0, delta=5.5e-8)
            == J.moments_epsilon(inc, 10_000, sigma=8.0, delta=5.5e-8))


@pytest.mark.parametrize("kw", [
    dict(n_clients=5, N_c=10_000, K=25_000, epsilon=1.0, sigma=8.0),
    dict(n_clients=16, N_c=25_000, K=125_000, epsilon=2.0, sigma=8.0,
         s0c=16, p=1.0, clip_norm=0.2, r0=None, eta0=0.1, beta=0.002,
         granularity="client")], ids=["default", "r0sigma-client"])
def test_plan_dp_fl_and_compare_constant_equal_reference(kw):
    jfl, jsel = J.plan_dp_fl(**kw)
    tfl, tsel = T.plan_dp_fl(**kw)
    assert dataclasses.asdict(tsel) == dataclasses.asdict(jsel)
    # every field of the planned FLConfig, the engine among them
    jd, td = dataclasses.asdict(jfl), dataclasses.asdict(tfl)
    assert td.keys() == jd.keys()
    for key in jd:
        assert td[key] == jd[key], key
    assert T.compare_constant(tsel) == J.compare_constant(jsel)
    assert tfl.dp.enabled and tfl.sample_seq.kind == "power"
