"""Chain elimination of the PyTorch port vs the JAX reference on the
leaves of the JAX synthetic RTK problem (float64, CPU).

The port's prefix scan is a doubling scan where JAX runs
``lax.associative_scan``: sums are reassociated, so results agree to
roundoff relative to the largest entry, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_ref import per_window
from test_torch_jax_ref import to_numpy as _np

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_rtk_windows
from rtk_visual_inertial_navigation_tpu.parallel.problems_gnss import \
    _anchor_frame
from rtk_visual_inertial_navigation_tpu.solver import chain as jchain
from rtk_visual_inertial_navigation_tpu.solver import chain_factors as jcf
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss import \
    problem_from_numpy, tree_from_numpy
from rtk_visual_inertial_navigation_tpu_torch.solver import chain as tchain
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    chain_factors as tcf

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

NF, NL, NOBS, NSAMP, CAP, NS, NB = 5, 12, 40, 6, 4, 6, 8
B = 2
PBG = np.array([0.02, -0.01, 0.03])
G = np.array([0.0, 0.0, 9.81])


def _close(got, ref, tol=1e-9, err_msg=""):
    """Roundoff relative to the largest entry of each array."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def ref():
    """JAX problem, its chain leaves and the JAX reference results."""
    jp = make_synthetic_rtk_windows(
        jax.random.PRNGKey(11), B, nf=NF, nl=NL, nobs=NOBS, nsamp=NSAMP,
        cap=CAP, ns=NS, nb=NB)
    _, R_e = _anchor_frame()
    lay = JLayout(NF, NL, NB, 2)
    # evaluate away from the truth: nonzero gradients everywhere
    win = jp.state0
    hid = jp.hid0
    pbg, g = jnp.asarray(PBG), jnp.asarray(G)

    def one(w, h, s):
        leaves, _, _ = jax.vmap(
            lambda hh, ss: jcf.chain_leaves(w, hh, ss, R_e, pbg, g, CAP,
                                            NB))(h, s)
        F = jax.vmap(jchain.scan_chain_tail_prefix)(leaves)
        c = jax.vmap(jchain.condensed_from_prefix)(F, s.n_leaves)
        Hb, gb, gidx, cost = jcf.chain_contrib(w, h, s, lay, R_e, pbg, g,
                                               CAP)
        return leaves, F, c, (Hb, gb, gidx, cost)

    leaves, F, c, contrib = per_window(one, (win, hid, jp.st), B)
    return dict(jp=jp, tp=problem_from_numpy(_np(jp), device="cpu"),
                leaves=leaves, F=F, c=c, contrib=contrib)


def _leaves(ref):
    return tree_from_numpy(tchain.ChainTailElem, _np(ref["leaves"]), "cpu")


def test_scan_chain_tail_prefix_matches_jax(ref):
    F = tchain.scan_chain_tail_prefix(_leaves(ref), axis=2)
    for k in F._fields:
        _close(getattr(F, k), getattr(ref["F"], k), err_msg=k)


def test_condensed_from_prefix_matches_jax(ref):
    F = tree_from_numpy(tchain.ChainTailElem, _np(ref["F"]), "cpu")
    tp = ref["tp"]
    for n_leaves in (tp.st.n_leaves, tp.st.n_leaves - 1):
        c = tchain.condensed_from_prefix(F, n_leaves)
        jc = jax.vmap(jax.vmap(jchain.condensed_from_prefix))(
            ref["F"], jnp.asarray(n_leaves.numpy()))
        for k in c._fields:
            _close(getattr(c, k), getattr(jc, k), 0.0, err_msg=k)
    c = tchain.condense_chain_tail(_leaves(ref), tp.st.n_leaves)
    for k in c._fields:
        _close(getattr(c, k), getattr(ref["c"], k), err_msg=k)


def test_solve_chain_interior_affine_matches_jax(ref):
    rng = np.random.default_rng(1)
    D = 15
    dx_i, dx_j = rng.normal(size=(2, B, NF - 1, D)) * 0.01
    dx_N = rng.normal(size=(B, NF - 1, NB)) * 0.01
    n_leaves = np.array([[CAP] * (NF - 1), [CAP, CAP - 1, 2, CAP]])
    jout = jax.jit(jax.vmap(jax.vmap(
        lambda F, lv, n, a, b, c: jchain.solve_chain_interior_affine(
            F, lv, n, a, b, c, CAP))))(
        ref["F"], ref["leaves"], jnp.asarray(n_leaves), jnp.asarray(dx_i),
        jnp.asarray(dx_j), jnp.asarray(dx_N))
    F = tree_from_numpy(tchain.ChainTailElem, _np(ref["F"]), "cpu")
    got = tchain.solve_chain_interior_affine(
        F, _leaves(ref), torch.from_numpy(n_leaves), torch.from_numpy(dx_i),
        torch.from_numpy(dx_j), torch.from_numpy(dx_N), CAP)
    _close(got, jout)


def test_chain_contrib_matches_jax(ref):
    tp = ref["tp"]
    lay = TangentLayout(NF, NL, NB, 2)
    R_e = torch.from_numpy(np.array(_anchor_frame()[1]))
    Hb, gb, gidx, cost = tcf.chain_contrib(
        tp.state0, tp.hid0, tp.st, lay, R_e, torch.from_numpy(PBG),
        torch.from_numpy(G), CAP)
    jHb, jgb, jgidx, jcost = ref["contrib"]
    _close(Hb, jHb, err_msg="Hb")
    _close(gb, jgb, err_msg="gb")
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jgidx))
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-12)


def test_make_tail_leaves_matches_jax():
    rng = np.random.default_rng(2)
    n, d, dn = 5, 15, NB
    args = [rng.normal(size=s) for s in (
        (n - 1, d, d), (n - 1, d, d), (n - 1, d, d), (n - 1, d), (n - 1, d),
        (n, d, d), (n, d, dn), (n, dn, dn), (n, d), (n, dn))]
    ref = jchain.make_tail_leaves(*map(jnp.asarray, args))
    got = tchain.make_tail_leaves(*map(torch.from_numpy, args))
    for k in got._fields:
        _close(getattr(got, k), getattr(ref, k), 0.0, err_msg=k)


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_chain_leaves_with_mid_marginal_match_jax(ref):
    """A live mid-chain marginal (the flagship has none) folds into its
    gap leaf, first-order updated to the current states."""
    rng = np.random.default_rng(3)
    nch, D = NF - 1, 15
    S = 2 * D + NB
    A = rng.normal(size=(B, nch, S + 2, S))
    mid = dict(
        H=A.transpose(0, 1, 3, 2) @ A, g0=rng.normal(size=(B, nch, S)),
        c0=rng.normal(size=(B, nch)),
        k=rng.integers(0, CAP - 1, size=(B, nch)),
        valid=rng.random((B, nch)) < 0.7,
        p0=rng.normal(size=(B, nch, 2, 3)),
        q0=_unit(np.concatenate([np.ones((B, nch, 2, 1)),
                                 0.1 * rng.normal(size=(B, nch, 2, 3))], -1)),
        v0=rng.normal(size=(B, nch, 2, 3)),
        ba0=0.01 * rng.normal(size=(B, nch, 2, 3)),
        bg0=0.01 * rng.normal(size=(B, nch, 2, 3)),
        pb0=rng.normal(size=(B, nch, NB)))
    jp = ref["jp"]
    jst = jp.st._replace(mid=jcf.ChainMid(**{k: jnp.asarray(v)
                                              for k, v in mid.items()}))
    _, R_e = _anchor_frame()
    pbg, g = jnp.asarray(PBG), jnp.asarray(G)
    jleaves, _, jcost = per_window(lambda w, h, s: jax.vmap(
        lambda hh, ss: jcf.chain_leaves(w, hh, ss, R_e, pbg, g, CAP, NB))(
            h, s), (jp.state0, jp.hid0, jst), B)
    tp = ref["tp"]
    tst = tp.st._replace(mid=tree_from_numpy(tcf.ChainMid, mid, "cpu"))
    leaves, _, cost = tcf.chain_leaves(
        tp.state0, tp.hid0, tst, torch.from_numpy(np.array(R_e)),
        torch.from_numpy(PBG), torch.from_numpy(G), CAP, NB)
    for k in leaves._fields:
        _close(getattr(leaves, k), getattr(jleaves, k), err_msg=k)
    _close(cost, jcost)
