"""Port parity: Gram terms, the four similarity epilogues, user statistics
and the fused-similarity wrapper (its plain CPU path) against the JAX
reference — bitwise where the reference claims integer exactness, at the
reference's own atol 2e-5 against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro.core import similarity as ref_sim
from repro.kernels import ref as ref_kref
from repro.kernels.similarity import fused_similarity as ref_fused
from repro_torch.core import similarity as sim
from repro_torch.kernels import ref as kref
from repro_torch.kernels.similarity import (fused_similarity,
                                            similarity_plain,
                                            similarity_route)

GRAM_FIELDS = ("n_common", "dot", "sum_a", "sum_b", "sq_a", "sq_b",
               "count_a", "count_b", "norm_a", "norm_b")


def _edge_ratings(seed, u=29, d=37):
    """Integer ratings with an all-zero row, a single rater (one rating),
    and a duplicated row."""
    rng = np.random.default_rng(seed)
    r = int_ratings(rng, u, d)
    r[3] = 0.0                       # all-zero row
    r[5] = 0.0
    r[5, 7] = 4.0                    # a single rater
    r[9] = r[2]                      # duplicate user
    return r


@pytest.mark.parametrize("seed", [0, 1])
def test_gram_terms_bitwise(seed):
    ra = _edge_ratings(seed)
    rb = _edge_ratings(seed + 10, u=17)
    g_ref = ref_sim.gram_terms(jnp.asarray(ra), jnp.asarray(rb))
    g = sim.gram_terms(torch.from_numpy(ra), torch.from_numpy(rb))
    for f in GRAM_FIELDS:
        assert_parity(f"gram.{f}", getattr(g, f), getattr(g_ref, f))


@pytest.mark.parametrize("measure", sim.SIMILARITY_MEASURES)
def test_epilogues_bitwise(measure):
    ra = _edge_ratings(2)
    rb = _edge_ratings(3, u=23)
    want = ref_sim.pairwise_similarity(jnp.asarray(ra), jnp.asarray(rb),
                                       measure=measure)
    got = sim.pairwise_similarity(torch.from_numpy(ra),
                                  torch.from_numpy(rb), measure=measure)
    assert_parity(f"similarity.{measure}", got, want)


@pytest.mark.parametrize("beta", [50.0, 7.3])
def test_pcc_sig_beta_bitwise(beta):
    ra = _edge_ratings(4)
    want = ref_sim.pairwise_similarity(jnp.asarray(ra), jnp.asarray(ra),
                                       measure="pcc_sig", beta=beta)
    got = sim.pairwise_similarity(torch.from_numpy(ra), torch.from_numpy(ra),
                                  measure="pcc_sig", beta=beta)
    assert_parity(f"similarity.pcc_sig.beta{beta}", got, want)


def test_all_measures_and_resolve_beta():
    ra = _edge_ratings(5)
    got = sim.all_measures(torch.from_numpy(ra), torch.from_numpy(ra))
    want = ref_sim.all_measures(jnp.asarray(ra), jnp.asarray(ra))
    for name, g, w in zip(("jaccard", "cosine", "pcc"), got, want):
        assert_parity(f"all_measures.{name}", g, w)
    assert sim.resolve_beta(None) == ref_sim.resolve_beta(None)
    assert sim.resolve_beta(7) == ref_sim.resolve_beta(7)
    with pytest.raises(ValueError):
        sim.resolve_beta(0)
    with pytest.raises(ValueError):
        sim.pairwise_similarity(torch.zeros(2, 2), torch.zeros(2, 2),
                                measure="euclid")


def test_user_stats_bitwise():
    r = _edge_ratings(6)
    cnt, tot, means = sim.user_stats(torch.from_numpy(r))
    r_cnt, r_tot, r_means = ref_sim.user_stats(jnp.asarray(r))
    assert cnt.dtype == torch.int32
    assert_parity("user_stats.cnt", cnt, r_cnt)
    assert_parity("user_stats.tot", tot, r_tot)
    assert_parity("user_stats.means", means, r_means)
    # the 0-rater gets the global mean, the single rater its one rating
    assert float(means[3]) == float(r_tot.sum() / r_cnt.sum())
    assert float(means[5]) == 4.0
    assert_parity("means_from_stats",
                  sim.means_from_stats(cnt, tot),
                  ref_sim.means_from_stats(r_cnt, r_tot))


SHAPES = [((13, 37), (11, 37)), ((1, 17), (33, 17)), ((40, 70), (19, 70))]


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("measure", ["all", "jaccard", "cosine", "pcc"])
def test_fused_similarity_plain_vs_pallas_interpret(shapes, measure):
    rng = np.random.default_rng(sum(shapes[0]) + sum(shapes[1]))
    ra = int_ratings(rng, *shapes[0])
    rb = int_ratings(rng, *shapes[1])
    got = fused_similarity(torch.from_numpy(ra), torch.from_numpy(rb),
                           measure=measure)
    want = ref_fused(jnp.asarray(ra), jnp.asarray(rb), measure=measure,
                     bm=16, bn=16, bk=32, interpret=True)
    oracle = ref_kref.similarity_ref(jnp.asarray(ra), jnp.asarray(rb),
                                     measure)
    port_oracle = kref.similarity_ref(torch.from_numpy(ra),
                                      torch.from_numpy(rb), measure)
    if measure != "all":
        got, want, oracle, port_oracle = ((got,), (want,), (oracle,),
                                          (port_oracle,))
    for j, (g, w, o, po) in enumerate(zip(got, want, oracle, port_oracle)):
        name = f"fused_similarity.{measure}[{j}]{shapes}"
        assert_parity(name + ".vs_pallas", g, w, atol=2e-5)
        assert_parity(name + ".vs_ref", g, o)
        assert_parity(name + ".port_ref", po, o)


@pytest.mark.parametrize("beta", [50.0, 7.3])
def test_fused_similarity_pcc_sig_plain_vs_pallas_interpret(beta):
    rng = np.random.default_rng(7)
    ra = int_ratings(rng, 21, 45, density=0.6)
    rb = int_ratings(rng, 18, 45, density=0.6)
    got = fused_similarity(torch.from_numpy(ra), torch.from_numpy(rb),
                           measure="pcc_sig", beta=beta)
    want = ref_fused(jnp.asarray(ra), jnp.asarray(rb), measure="pcc_sig",
                     bm=16, bn=16, bk=32, interpret=True, beta=beta)
    oracle = ref_sim.pcc_sig_from_gram(
        ref_sim.gram_terms(jnp.asarray(ra), jnp.asarray(rb)), beta=beta)
    assert_parity(f"fused_similarity.pcc_sig.beta{beta}.vs_pallas", got,
                  want, atol=2e-5)
    assert_parity(f"fused_similarity.pcc_sig.beta{beta}.vs_ref", got, oracle)


def test_fused_similarity_wrapper_contract():
    ra = torch.zeros(4, 6)
    assert similarity_plain(ra, ra, measure="cosine").shape == (4, 4)
    with pytest.raises(ValueError, match="unknown measure"):
        fused_similarity(ra, ra, measure="euclid")
    with pytest.raises(ValueError):
        fused_similarity(ra, torch.zeros(4, 5))
    before = fused_similarity.launches
    fused_similarity(ra, ra, measure="pcc")      # CPU: plain, no launch
    assert fused_similarity.launches == before


@pytest.mark.parametrize("measure", ["all", "jaccard", "cosine", "pcc",
                                     "pcc_sig"])
def test_fused_similarity_int8_blocks_plain_vs_reference(measure):
    """int8 blocks (the fit's operand on integer ratings) give the f32
    blocks' scores bit for bit, and the reference's oracle's."""
    rng = np.random.default_rng(17)
    ra = int_ratings(rng, 31, 90, density=0.5)
    rb = int_ratings(rng, 22, 90, density=0.5)
    got = fused_similarity(torch.from_numpy(ra).to(torch.int8),
                           torch.from_numpy(rb).to(torch.int8),
                           measure=measure, max_value=5)
    f32 = fused_similarity(torch.from_numpy(ra), torch.from_numpy(rb),
                           measure=measure)
    g_ref = ref_sim.gram_terms(jnp.asarray(ra), jnp.asarray(rb))
    if measure == "all":
        oracle = (ref_sim.jaccard_from_gram(g_ref),
                  ref_sim.cosine_from_gram(g_ref),
                  ref_sim.pcc_from_gram(g_ref))
    elif measure == "pcc_sig":
        oracle = (ref_sim.pcc_sig_from_gram(g_ref),)
    else:
        oracle = (ref_kref.similarity_ref(jnp.asarray(ra), jnp.asarray(rb),
                                          measure),)
    if measure != "all":
        got, f32 = (got,), (f32,)
    for j, (g, f, o) in enumerate(zip(got, f32, oracle)):
        assert_parity(f"fused_similarity.int8.{measure}[{j}].vs_f32", g, f)
        assert_parity(f"fused_similarity.int8.{measure}[{j}].vs_ref", g, o)


@pytest.mark.parametrize("a,b,d,max_value,want", [
    (torch.int8, torch.int8, 3952, 5, "imma"),
    (torch.int8, torch.int8, 4096, 64, "imma"),       # 64² · 4096 = 2^24
    (torch.int8, torch.int8, 1024, None, "imma"),     # 128² · 1024 = 2^24
    (torch.float32, torch.float32, 3952, None, "simt"),
    (torch.float32, torch.float32, 10 ** 6, 127, "simt"),
    (torch.int8, torch.int8, 4097, 64, ValueError),
    (torch.int8, torch.int8, 3952, None, ValueError),
    (torch.int8, torch.int8, 3952, 66, ValueError),
    (torch.float32, torch.int8, 16, 5, TypeError),
    (torch.int8, torch.float32, 16, 5, TypeError),
    (torch.float64, torch.float64, 16, None, TypeError),
])
def test_similarity_route_choice_and_domain(a, b, d, max_value, want):
    """The card's route follows the dtypes; the int8 route's exact
    domain is max_value² · D ≤ 2^24 (int8's own 128 without max_value)."""
    if isinstance(want, str):
        assert similarity_route(a, b, d, max_value) == want
    else:
        with pytest.raises(want, match="exact domain" if want is ValueError
                           else "matching"):
            similarity_route(a, b, d, max_value)


def test_fused_similarity_routes_counter_on_cpu():
    """A CPU call runs the plain version and counts no launch and no
    route, on either dtype."""
    ra = torch.from_numpy(int_ratings(np.random.default_rng(1), 6, 20))
    before = (fused_similarity.launches, dict(fused_similarity.routes))
    assert set(fused_similarity.routes) == {"imma", "simt"}
    for a in (ra, ra.to(torch.int8)):
        fused_similarity(a, a, measure="pcc", max_value=5)
    assert (fused_similarity.launches, fused_similarity.routes) == before
