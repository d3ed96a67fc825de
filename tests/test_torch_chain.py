"""Chain elimination of the PyTorch port vs the JAX reference on the
leaves of the JAX synthetic RTK problem, and the chain oracles on random
chains (float64, CPU).

The port's prefix scan is a doubling scan where JAX runs
``lax.associative_scan``: sums are reassociated, so results agree to
roundoff relative to the largest entry, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_ref import cheap_jit, per_window
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


# ---------------------------------------------------------------------------
# the JAX package's chain oracles (tests/test_chain.py, test_chain_tail.py,
# test_chain_factors.py): each held to its JAX counterpart on the same
# numpy inputs, and to the assertions of those tests
# ---------------------------------------------------------------------------

def _chain_arrays(rng, n, d):
    """tests/test_chain.py::random_chain's recipe, as numpy arrays."""
    A = rng.normal(size=(n, d, d))
    J = rng.normal(size=(n - 1, d, 2 * d))
    Hf = np.einsum("kri,krj->kij", J, J)
    b_pair = np.einsum("kri,kr->ki", J, rng.normal(size=(n - 1, d)))
    H_unary = (A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(d)) * 0.1
    return (Hf[:, :d, :d], Hf[:, :d, d:], Hf[:, d:, d:], b_pair[:, :d],
            b_pair[:, d:], H_unary, rng.normal(size=(n, d)))


def _tail_arrays(rng, n, d, dn, cap=None):
    """tests/test_chain_tail.py::random_tail_chain's recipe: the arguments
    of make_tail_leaves, and the padding to ``cap`` leaves."""
    J = rng.normal(size=(n - 1, d, 2 * d))
    Hf = np.einsum("kri,krj->kij", J, J) + 0.5 * np.eye(2 * d)
    b_pair = np.einsum("kri,kr->ki", J, rng.normal(size=(n - 1, d)))
    Ju = rng.normal(size=(n, d, d + dn)) * 0.4
    Hu = np.einsum("kri,krj->kij", Ju, Ju)
    bu = np.einsum("kri,kr->ki", Ju, rng.normal(size=(n, d)))
    args = (Hf[:, :d, :d], Hf[:, :d, d:], Hf[:, d:, d:], b_pair[:, :d],
            b_pair[:, d:], Hu[:, :d, :d], Hu[:, :d, d:], Hu[:, d:, d:],
            bu[:, :d], bu[:, d:])
    return args, (0 if cap is None else cap - (n - 1))


def _both_tail_leaves(rng, n, d, dn, cap=None):
    args, pad = _tail_arrays(rng, n, d, dn, cap)
    j = jchain.make_tail_leaves(*map(jnp.asarray, args))
    t = tchain.make_tail_leaves(*map(torch.from_numpy, args))
    padz = lambda x, lib: lib.concatenate(
        [x, lib.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype)])
    j = jax.tree.map(lambda x: padz(x, jnp), j)
    t = tchain.ChainTailElem(*[torch.cat([x, x.new_zeros(
        (pad,) + x.shape[1:])]) for x in t])
    return j, t


def _marg_interior(H, b, keep, drop):
    H, b = np.asarray(H), np.asarray(b)
    Hkd = H[np.ix_(keep, drop)]
    sol = np.linalg.solve(H[np.ix_(drop, drop)], np.c_[Hkd.T, b[drop]])
    return H[np.ix_(keep, keep)] - Hkd @ sol[:, :-1], b[keep] - Hkd @ sol[
        :, -1]


def _dense_ends(out, tail=False):
    """A condensed element as its dense endpoint (and tail) system."""
    f = [x.numpy() for x in out]
    if not tail:
        Hii, Hij, Hjj, bi, bj = f
        return (np.block([[Hii, Hij], [Hij.T, Hjj]]), np.r_[bi, bj])
    Hii, Hij, Hjj, HiN, HjN, HNN, bi, bj, bN = f
    return (np.block([[Hii, Hij, HiN], [Hij.T, Hjj, HjN],
                      [HiN.T, HjN.T, HNN]]), np.r_[bi, bj, bN])


def test_chain_elem_oracles_match_jax():
    """make_leaves, dense_chain_hessian, condense_chain and the sequential
    fold against JAX, dense marginalization and each other
    (tests/test_chain.py's shapes and tolerances)."""
    rng = np.random.default_rng(0)
    n, d = 9, 5
    args = _chain_arrays(rng, n, d)
    jl = jchain.make_leaves(*map(jnp.asarray, args))
    tl = tchain.make_leaves(*map(torch.from_numpy, args))
    for k in tl._fields:
        _close(getattr(tl, k), getattr(jl, k), 0.0, err_msg=k)
    H, b = tchain.dense_chain_hessian(tl, n, d)
    jH, jb = jchain.dense_chain_hessian(jl, n, d)
    _close(H, jH, 0.0)
    _close(b, jb, 0.0)
    keep = np.r_[np.arange(d), np.arange((n - 1) * d, n * d)]
    H_star, b_star = _marg_interior(H, b, keep, np.arange(d, (n - 1) * d))
    H_out, b_out = _dense_ends(tchain.condense_chain(tl))
    np.testing.assert_allclose(H_out, H_star, atol=1e-8)
    np.testing.assert_allclose(b_out, b_star, atol=1e-8)
    # the endpoint solution is the full chain solve's endpoints
    x_full = np.linalg.solve(H.numpy(), b.numpy())
    x_ends = np.linalg.solve(H_out, b_out)
    np.testing.assert_allclose(x_ends, x_full[keep], atol=1e-8)

    # 32 states of 15: the scan, the fold and JAX's scan agree
    n, d = 32, 15
    args = _chain_arrays(rng, n, d)
    tl = tchain.make_leaves(*map(torch.from_numpy, args))
    par, seq = tchain.condense_chain(tl), tchain.condense_chain_sequential(tl)
    jpar = cheap_jit(jchain.condense_chain)(
        jchain.make_leaves(*map(jnp.asarray, args)))
    for k in par._fields:
        np.testing.assert_allclose(getattr(par, k).numpy(),
                                   getattr(seq, k).numpy(), atol=1e-6)
        _close(getattr(par, k), getattr(jpar, k), err_msg=k)
    # batched: two chains at once equal each alone
    two = tchain.ChainElem(*[torch.stack([x, 1.1 * x]) for x in tl])
    out = tchain.condense_chain(two)
    assert out.Hii.shape == (2, 15, 15)
    np.testing.assert_allclose(out.Hii[0].numpy(), par.Hii.numpy(),
                               atol=1e-9)


def test_tail_oracles_match_jax():
    """dense_chain_tail_hessian, condense_chain_tail with padding, and the
    dense interior solve ``solve_chain_interior`` against JAX and the full
    chain solve (tests/test_chain_tail.py:58-138)."""
    rng = np.random.default_rng(2)
    n, d, dn, cap = 11, 6, 5, 16
    jl, tl = _both_tail_leaves(rng, n, d, dn, cap)
    exact = tchain.ChainTailElem(*[x[:n - 1] for x in tl])
    H, b = tchain.dense_chain_tail_hessian(exact, n, d, dn)
    jH, jb = jchain.dense_chain_tail_hessian(
        jax.tree.map(lambda x: x[:n - 1], jl), n, d, dn)
    _close(H, jH, 0.0)
    _close(b, jb, 0.0)
    H, b = H.numpy(), b.numpy()
    x_full = np.linalg.solve(H, b)
    nl = torch.tensor(n - 1)
    x_red = np.linalg.solve(*_dense_ends(
        tchain.condense_chain_tail(tl, nl), tail=True))
    keep = np.r_[np.arange(d), np.arange((n - 1) * d, n * d),
                 np.arange(n * d, n * d + dn)]
    np.testing.assert_allclose(x_red, x_full[keep], atol=1e-8)

    T_ = torch.from_numpy
    interior = tchain.solve_chain_interior(
        tl, nl, T_(x_red[:d]), T_(x_red[d:2 * d]), T_(x_red[2 * d:]), cap)
    jint = cheap_jit(lambda l, a, b_, c: jchain.solve_chain_interior(
        l, jnp.asarray(n - 1), a, b_, c, cap))(
        jl, *map(jnp.asarray, (x_red[:d], x_red[d:2 * d], x_red[2 * d:])))
    _close(interior, jint)
    for s in range(1, n - 1):
        np.testing.assert_allclose(interior[s - 1].numpy(),
                                   x_full[s * d:(s + 1) * d], atol=1e-8)
    assert np.all(interior[n - 2:].numpy() == 0.0)

    # arbitrary conditioning: u = Hdd⁻¹ (bd − Hde xe)
    n, d, dn, cap = 6, 3, 2, 8
    jl, tl = _both_tail_leaves(rng, n, d, dn, cap)
    H, b = (x.numpy() for x in tchain.dense_chain_tail_hessian(
        tchain.ChainTailElem(*[x[:n - 1] for x in tl]), n, d, dn))
    xe = rng.normal(size=2 * d + dn)
    keep = np.r_[np.arange(d), np.arange((n - 1) * d, n * d),
                 np.arange(n * d, n * d + dn)]
    drop = np.arange(d, (n - 1) * d)
    u = np.linalg.solve(H[np.ix_(drop, drop)],
                        b[drop] - H[np.ix_(drop, keep)] @ xe)
    interior = tchain.solve_chain_interior(
        tl, torch.tensor(n - 1), T_(xe[:d]), T_(xe[d:2 * d]),
        T_(xe[2 * d:]), cap)
    np.testing.assert_allclose(interior[:n - 2].reshape(-1).numpy(), u,
                               atol=1e-8)


def test_bidir_scan_and_interior_match_jax():
    """scan_chain_tail_bidir's prefixes reproduce the condensation, its
    suffixes equal JAX's, and solve_chain_interior_bidir equals the dense
    oracle and JAX's, for chains shorter than capacity too
    (tests/test_chain_tail.py:158-195), batched over the three lengths."""
    rng = np.random.default_rng(7)
    cap, d, dn = 9, 4, 3
    ns = (3, 6, 9)
    pairs = [_both_tail_leaves(rng, n + 1, d, dn, cap) for n in ns]
    tl = tchain.ChainTailElem(*[torch.stack(x) for x in
                                zip(*[t for _, t in pairs])])
    jl = jax.tree.map(lambda *x: jnp.stack(x), *[j for j, _ in pairs])
    nl = torch.tensor(ns)
    xe = rng.normal(size=(len(ns), 2 * d + dn))
    dx = [torch.from_numpy(xe[:, s]) for s in (
        slice(0, d), slice(d, 2 * d), slice(2 * d, None))]

    F, G = tchain.scan_chain_tail_bidir(tl, nl, cap)
    jF, jG = cheap_jit(jax.vmap(lambda l, m: jchain.scan_chain_tail_bidir(
        l, m, cap)))(jl, jnp.asarray(ns))
    for k in F._fields:
        _close(getattr(F, k), getattr(jF, k), err_msg=k)
        _close(getattr(G, k), getattr(jG, k), err_msg=k)
    c = tchain.condensed_from_prefix(F, nl)
    c_ref = tchain.condense_chain_tail(tl, nl)
    for a, b in zip(c, c_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)

    got = tchain.solve_chain_interior_bidir(F, G, nl, *dx, cap)
    ref = tchain.solve_chain_interior(tl, nl, *dx, cap)
    jgot = cheap_jit(jax.vmap(
        lambda F_, G_, m, a, b, c_: jchain.solve_chain_interior_bidir(
            F_, G_, m, a, b, c_, cap)))(
        jF, jG, jnp.asarray(ns), *[jnp.asarray(x.numpy()) for x in dx])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-7)
    _close(got, jgot)
    for i, n in enumerate(ns):
        assert np.all(got[i, n - 1:].numpy() == 0.0)
    # transposing twice is the identity
    tt = tchain.transpose_tail_elem(tchain.transpose_tail_elem(F))
    for a, b in zip(tt, F):
        assert torch.equal(a, b)


def test_chain_retract_matches_jax(ref):
    """The standalone retraction (the linearization rebuilt) against JAX's
    chain_retract on the flagship problem's chains, at
    tests/test_chain_factors.py's tolerance."""
    rng = np.random.default_rng(8)
    jp, tp = ref["jp"], ref["tp"]
    lay = TangentLayout(NF, NL, NB, 2)
    dx = rng.normal(size=(B, lay.dim)) * 1e-3
    _, R_e = _anchor_frame()
    pbg, g = jnp.asarray(PBG), jnp.asarray(G)
    jlay = JLayout(NF, NL, NB, 2)
    jh = per_window(lambda w, h, s, x: jcf.chain_retract(
        w, h, s, x, jlay, R_e, pbg, g, CAP),
        (jp.state0, jp.hid0, jp.st, jnp.asarray(dx)), B)
    th = tcf.chain_retract(tp.state0, tp.hid0, tp.st, torch.from_numpy(dx),
                           lay, torch.from_numpy(np.array(R_e)),
                           torch.from_numpy(PBG), torch.from_numpy(G), CAP)
    for k in th._fields:
        np.testing.assert_allclose(getattr(th, k).numpy(),
                                   np.asarray(getattr(jh, k)), atol=1e-9,
                                   err_msg=k)
