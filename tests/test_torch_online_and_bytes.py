"""The port's online allocator (``repro_torch.core.online``), byte-complexity
models (``core.bytes_model``) and ``data.wordcount_corpus`` on the CPU vs
the JAX package's.

Mirrors ``tests/test_online_and_bytes.py``: ``workload_stream`` loads,
``online_allocate``'s per-workload picks, costs, all-red costs and
residual capacity, the models' sizes and ``byte_complexity`` equal the JAX
functions' on the same inputs (arrays bitwise, floats with ``==``); then
the JAX test's own checks run on the port's results. Tolerances: none.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as C
from repro.data.pipeline import wordcount_corpus as j_wordcount_corpus
from repro_torch.data import wordcount_corpus
from test_torch_soar_fast import trees

STRATEGIES = ("soar", "top", "max", "level", "random")


def same_stream(jt, t, n, seed):
    a, b = J.workload_stream(jt, n, seed=seed), C.workload_stream(t, n,
                                                                 seed=seed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    return b


def same_online(jt, t, ws, **kw):
    """``online_allocate`` in both packages, held equal per workload."""
    a, b = J.online_allocate(jt, ws, **kw), C.online_allocate(t, ws, **kw)
    assert isinstance(b, C.OnlineResult)
    assert len(a.picks) == len(b.picks)
    for x, y in zip(a.picks, b.picks):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for f in ("costs", "red_costs", "residual_capacity", "normalized"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    return b


@pytest.fixture(scope="module")
def small_net():
    jt, t = trees("bt", 32)
    return jt, t, same_stream(jt, t, 8, seed=0)


def test_online_capacity_respected(small_net):
    jt, t, ws = small_net
    res = same_online(jt, t, ws, k=4, capacity=2, strategy="soar")
    used = np.zeros(t.n, dtype=np.int64)
    for p in res.picks:
        used += p.astype(np.int64)
        assert p.sum() <= 4
    assert np.all(used <= 2)
    assert np.all(res.residual_capacity == 2 - used)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_online_strategies_match_jax(small_net, strategy):
    jt, t, ws = small_net
    same_online(jt, t, ws, k=4, capacity=2, strategy=strategy, seed=3)


def test_online_soar_beats_baselines_on_average(small_net):
    jt, t, ws = small_net
    totals = {s: same_online(jt, t, ws, k=4, capacity=2,
                             strategy=s).costs.sum() for s in STRATEGIES}
    assert totals["soar"] <= min(v for k_, v in totals.items()
                                 if k_ != "soar") + 1e-9


def test_online_unbounded_capacity_is_per_workload_optimal(small_net):
    jt, t, ws = small_net
    res = same_online(jt, t, ws, k=4, capacity=len(ws), strategy="soar")
    for load, cost in zip(ws, res.costs):
        assert abs(cost - C.soar(t, load, 4).cost) < 1e-9


def test_online_saturation_tends_to_all_red(small_net):
    jt, t, _ = small_net
    ws = same_stream(jt, t, 40, seed=1)
    res = same_online(jt, t, ws, k=8, capacity=1, strategy="soar")
    assert res.normalized[-1] > res.normalized[4]
    assert res.costs[-1] == pytest.approx(res.red_costs[-1])


# ---------------------------------------------------------------------------
# Byte complexity
# ---------------------------------------------------------------------------

def test_ps_model_sizes():
    kw = dict(features=10_000, dropout=0.5, bytes_per_kv=1)
    ps, jps = C.ParameterServerModel(**kw), J.ParameterServerModel(**kw)
    for n in (1, 2, 3, 50):
        assert ps.size(n) == jps.size(n)
    assert ps.size(1) == pytest.approx(5000.0)
    assert ps.size(2) == pytest.approx(7500.0)
    assert ps.size(50) == pytest.approx(10_000.0, rel=1e-6)


def test_wc_model_monotone_sublinear():
    kw = dict(total_words=100_000, vocab=5_000, n_servers=100,
              bytes_per_kv=1)
    wc, jwc = C.WordCountModel(**kw), J.WordCountModel(**kw)
    for n in (1, 2, 4, 64):
        assert wc.size(n) == jwc.size(n)
    s1, s2, s4 = wc.size(1), wc.size(2), wc.size(4)
    assert s1 < s2 < s4
    assert s2 < 2 * s1
    assert s4 <= 5_000


def test_byte_complexity_red_vs_blue():
    jt, t = trees("bt", 16)
    load = np.zeros(t.n, dtype=np.int64)
    load[t.leaves] = 4
    ps = C.ParameterServerModel()
    red = C.byte_complexity(t, load, C.all_red(t), ps.size)
    blue = C.byte_complexity(t, load, C.all_blue(t), ps.size)
    assert red == J.byte_complexity(jt, load, J.all_red(jt), ps.size)
    assert blue == J.byte_complexity(jt, load, J.all_blue(jt), ps.size)
    assert blue < red
    depth_cost = sum((t.depth[v] + 1) * load[v] for v in t.leaves)
    assert red == pytest.approx(ps.size(1) * depth_cost)


@pytest.mark.parametrize("weight_by_rho", [True, False])
def test_byte_complexity_soar_between_extremes(weight_by_rho):
    jt, t = trees("bt", 64, "linear")
    rng = np.random.default_rng(0)
    load = np.zeros(t.n, dtype=np.int64)
    load[t.leaves] = rng.integers(1, 10, size=len(t.leaves))
    kw = dict(total_words=200_000, vocab=10_000, n_servers=200)
    wc, jwc = C.WordCountModel(**kw), J.WordCountModel(**kw)
    res = C.soar(t, load, 6)
    bc = lambda tree, m, blue, size: m.byte_complexity(
        tree, load, blue, size, weight_by_rho=weight_by_rho)
    b = bc(t, C, res.blue, wc.size)
    assert b == bc(jt, J, res.blue, jwc.size)
    assert bc(t, C, C.all_blue(t), wc.size) <= b + 1e-6
    assert b <= bc(t, C, C.all_red(t), wc.size) + 1e-6


@pytest.mark.parametrize("n_words,vocab,zipf_s,seed", [
    (1, 1, 1.07, 0), (10_000, 800, 1.07, 0), (5_000, 50_000, 1.2, 3),
    (100_000, 10_000, 0.9, 11)])
def test_wordcount_corpus_bitwise(n_words, vocab, zipf_s, seed):
    a = j_wordcount_corpus(n_words, vocab, zipf_s=zipf_s, seed=seed)
    b = wordcount_corpus(n_words, vocab, zipf_s=zipf_s, seed=seed)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert b.shape == (n_words,) and (b >= 0).all() and (b < vocab).all()
