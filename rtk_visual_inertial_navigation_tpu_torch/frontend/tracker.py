"""Feature detection and pyramidal LK optical flow as batched torch ops.

The redesign of FeatureTracker (rvi/feature/feature_tracker.cpp) that the
JAX package runs, on whatever device its tensors live:
  - Shi-Tomasi response (min eigenvalue of the structure tensor) computed
    densely with separable box filters; greedy top-K selection with a
    MIN_DIST suppression disk (goodFeaturesToTrack + mask semantics,
    feature_tracker.cpp:44-71,150-165) as a loop of K device steps with no
    host read;
  - pyramidal Lucas-Kanade with fixed iteration counts and bilinear patch
    sampling, batched over features (cv::calcOpticalFlowPyrLK analog,
    :98-141);
  - forward-backward consistency check (FLOW_BACK, :119-130);
  - essential-matrix RANSAC, split into a seeded hypothesis sampler and
    the scoring of given hypotheses.

Everything is static-shape: K feature slots with validity masks.  Images
keep their dtype (the frontend hands in float32); point coordinates may be
wider (the frontend's are float64), and the patch arithmetic follows the
JAX package's dtype promotion: weights in the coordinates' dtype, sums of
image samples in the image's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter(img, r):
    """(2r+1)² box sum via separable cumsum differences.  The cumulative
    sum is padded with zeros on both sides, so the window is cut at the low
    edge and the last r rows/columns read ``0 - lo``, as in the JAX
    package.

    The sums run in float64 and the result is rounded to the image's dtype
    once.  A float32 cumulative sum (the JAX package's) carries an error of
    ~1e-7 of the largest response into every pixel, and its order differs
    between devices, so weak corners would be picked by roundoff and a
    CUDA frontend would detect other corners than a CPU one on the same
    image; in float64 both round to the same float32 values."""
    def along(a, dim):
        c = torch.cumsum(a, dim=dim, dtype=torch.float64)
        n = a.shape[dim]
        # F.pad lists (last dim lo, hi, second-last lo, hi)
        pad = (r + 1, r, 0, 0) if dim == 1 else (0, 0, r + 1, r)
        cp = F.pad(c, pad)
        hi = cp.narrow(dim, 2 * r + 1, n)
        lo = cp.narrow(dim, 0, n)
        return hi - lo

    return along(along(img, 0), 1).to(img.dtype)


def gradients(img):
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy = torch.zeros_like(img)
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def shi_tomasi_response(img, win: int = 2):
    gx, gy = gradients(img)
    sxx = _box_filter(gx * gx, win)
    syy = _box_filter(gy * gy, win)
    sxy = _box_filter(gx * gy, win)
    tr = 0.5 * (sxx + syy)
    det = torch.sqrt(torch.clamp_min((0.5 * (sxx - syy)) ** 2 + sxy ** 2,
                                     0.0))
    return tr - det          # min eigenvalue


def select_features(response, k: int, min_dist: int, border: int = 8,
                    mask=None):
    """Greedy top-K with MIN_DIST suppression. Returns (xy (K,2), ok (K,)).

    Each of the K steps takes the first maximum of the response (as
    ``jnp.argmax``), keeps its index and value, and suppresses the disk
    around it; nothing is read back to the host, and the K picks become
    points in one step at the end."""
    H, W = response.shape
    dev = response.device
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)
    inb = ((yy >= border) & (yy < H - border)
           & (xx >= border) & (xx < W - border))
    if mask is not None:
        inb = inb & mask
    r = response.masked_fill(~inb, -float("inf")).reshape(-1)
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    md2 = min_dist * min_dist
    picks, values = [], []
    for _ in range(k):
        idx = torch.argmax(r).reshape(1)
        picks.append(idx)
        values.append(r.gather(0, idx))
        supp = (yy - idx // W) ** 2 + (xx - idx % W) ** 2 <= md2
        r = r.masked_fill(supp, -float("inf"))
    idx = torch.cat(picks)
    pts = torch.stack([idx % W, idx // W], dim=-1).to(response.dtype)
    return pts, torch.cat(values) > 1e-6


def build_pyramid(img, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        a = pyr[-1]
        H, W = a.shape
        a = a[: H - H % 2, : W - W % 2]
        pyr.append(0.25 * (a[0::2, 0::2] + a[1::2, 0::2]
                           + a[0::2, 1::2] + a[1::2, 1::2]))
    return pyr


def _bilinear(img, ys, xs):
    """``img`` sampled at (ys, xs) (any matching shapes): linear
    interpolation with the floor and floor+1 indices clamped to the image
    and the weights taken from the unclamped coordinate, the samples
    weighted and summed in the coordinates' and image's promoted dtype and
    cast back to the image's (``map_coordinates(order=1, mode="nearest")``
    of the JAX package, term by term in its order)."""
    H, W = img.shape
    flat = img.reshape(-1)
    wdt = torch.promote_types(ys.dtype, img.dtype)
    terms = []
    for c, size in ((ys, H), (xs, W)):
        lower = torch.floor(c)
        w_hi = c - lower
        w_lo = 1 - w_hi
        i0 = lower.to(torch.int64)
        terms.append(((i0.clamp(0, size - 1), w_lo),
                      (torch.clamp(i0 + 1, 0, size - 1), w_hi)))
    out = None
    for iy, wy in terms[0]:
        for ix, wx in terms[1]:
            v = (wy * wx).to(wdt) * flat[iy * W + ix].to(wdt)
            out = v if out is None else out + v
    return out.to(img.dtype)


def _patch(img, center_xy, r):
    """Bilinear (2r+1)² patches around centers (..., 2) = (x, y): shape
    (..., 2r+1, 2r+1)."""
    d = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    ys = center_xy[..., 1, None, None] + d[:, None]
    xs = center_xy[..., 0, None, None] + d[None, :]
    n = 2 * r + 1
    shape = center_xy.shape[:-1] + (n, n)
    return _bilinear(img, ys.expand(shape), xs.expand(shape))


def _lk_level(img0, img1, pt0, guess, r, iters):
    """One pyramid level of LK for every feature (K, 2); returns the
    refined flows (K, 2) and the per-feature det > 1e-6 flags."""
    def shifted(dx, dy):       # pt0 + (dx, dy), in pt0's dtype
        return torch.stack([pt0[..., 0] + dx, pt0[..., 1] + dy], dim=-1)

    T = _patch(img0, pt0, r)
    gx = 0.5 * (_patch(img0, shifted(1.0, 0.0), r)
                - _patch(img0, shifted(-1.0, 0.0), r))
    gy = 0.5 * (_patch(img0, shifted(0.0, 1.0), r)
                - _patch(img0, shifted(0.0, -1.0), r))
    a11 = torch.sum(gx * gx, dim=(-2, -1))
    a12 = torch.sum(gx * gy, dim=(-2, -1))
    a22 = torch.sum(gy * gy, dim=(-2, -1))
    det = a11 * a22 - a12 * a12
    ok = det > 1e-6
    det = torch.where(ok, det, torch.ones_like(det))

    d = guess
    for _ in range(iters):
        P = _patch(img1, pt0 + d, r)
        e = P - T
        b1 = torch.sum(e * gx, dim=(-2, -1))
        b2 = torch.sum(e * gy, dim=(-2, -1))
        dx = (a22 * b1 - a12 * b2) / det
        dy = (a11 * b2 - a12 * b1) / det
        d = d - torch.stack([dx, dy], dim=-1)
    return d, ok


def lk_track(pyr0, pyr1, pts, valid, win: int = 7, iters: int = 10,
             guess=None):
    """Track points from pyramid pyr0 to pyr1 (coarse-to-fine).

    Args:
      pyr0, pyr1: lists of images (level 0 = full resolution).
      pts: (K,2) pixel coordinates in level 0; valid: (K,) mask.
      guess: optional (K,2) predicted positions in pyr1 (IMU-propagated
        prediction, feature_tracker.cpp:98-117 hasPrediction path) — the
        coarse-to-fine search starts from guess - pts instead of 0.
    Returns (new_pts (K,2), ok (K,)).
    """
    levels = len(pyr0)
    r = win // 2
    if guess is None:
        guess = pts
    d = guess - pts
    ok = valid
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        d_lv, ok_lv = _lk_level(pyr0[lv], pyr1[lv], pts / scale, d / scale,
                                r, iters)
        d = d_lv * scale
        ok = ok & ok_lv
    new = pts + d
    H, W = pyr0[0].shape
    inb = ((new[:, 0] >= 2) & (new[:, 0] < W - 2)
           & (new[:, 1] >= 2) & (new[:, 1] < H - 2))
    return new, ok & inb


def lk_track_fb(pyr0, pyr1, pts, valid, win: int = 7, iters: int = 10,
                fb_thresh: float = 0.5, guess=None):
    """LK with the forward-backward consistency check (FLOW_BACK).

    The reverse pass is SEEDED with the original points — the reference
    sets reverse_pts = prev_pts and passes OPTFLOW_USE_INITIAL_FLOW
    (feature_tracker.cpp FLOW_BACK branch).  Starting the reverse search
    at ``fwd`` instead silently discards every large-motion track the
    forward (possibly gyro-guessed) pass recovered: the backward flow is
    just as large, and an unseeded search can't reach it.
    """
    fwd, ok1 = lk_track(pyr0, pyr1, pts, valid, win, iters, guess)
    back, ok2 = lk_track(pyr1, pyr0, fwd, ok1, win, iters, guess=pts)
    dist = torch.linalg.norm(back - pts, dim=-1)
    return fwd, ok1 & ok2 & (dist < fb_thresh)


def ransac_hypotheses(valid, n_hyp: int = 128, seed: int = 0):
    """(n_hyp, 8) row indices of the 8-point hypotheses: drawn with
    replacement from the valid rows, uniformly, by a CPU
    ``torch.Generator`` seeded with ``seed`` (the same draws on every
    device).  ``valid`` is read on the host.  Fewer than one valid row
    draws from all rows (the gate is off then)."""
    v = torch.as_tensor(valid).to("cpu", torch.float64)
    p = v if bool(v.any()) else torch.ones_like(v)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.multinomial(p, n_hyp * 8, replacement=True,
                             generator=gen).reshape(n_hyp, 8)


def distinct_rows(idx):
    """(n_hyp,) True where the 8 rows of hypothesis ``idx[h]`` are all
    distinct: an exact integer test, the same on every device."""
    return torch.all(torch.diff(torch.sort(idx, dim=-1).values, dim=-1)
                     != 0, dim=-1)


def ransac_masks(xy0, xy1, valid, idx, thresh: float = 3.0 / 460.0):
    """(n_hyp, K) inlier mask of each 8-point essential-matrix hypothesis
    ``idx`` (n_hyp, 8) on unit-plane correspondences: each solved as a
    batched SVD, the inliers counted by the symmetric epipolar distance.
    A hypothesis whose 8 rows are not all distinct has no inliers: its
    system has rank < 8, so its null space has more than one dimension and
    the SVD's last vector is whichever one the SVD implementation returns
    (the reference's sampler never forms such a set)."""
    one0 = torch.cat([xy0, torch.ones_like(xy0[:, :1])], dim=-1)
    one1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    a0, a1 = one0[idx], one1[idx]                       # (n_hyp, 8, 3)
    # x1ᵀ E x0 = 0 -> A vec(E) = 0, A rows = kron(x0, x1)
    A = torch.einsum("hki,hkj->hkij", a0, a1).reshape(idx.shape[0], 8, 9)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    E = Vt[:, -1].reshape(-1, 3, 3).transpose(-1, -2)   # (x1ᵀ E x0)
    Ex0 = one0 @ E.transpose(-1, -2)                    # (n_hyp, K, 3)
    Etx1 = one1 @ E
    num = torch.sum(one1 * Ex0, dim=-1)
    d2 = num * num * (
        1.0 / torch.clamp_min(Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2, 1e-12)
        + 1.0 / torch.clamp_min(Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2,
                                1e-12))
    return (d2 < thresh * thresh) & valid & distinct_rows(idx)[:, None]


def ransac_score(xy0, xy1, valid, idx, thresh: float = 3.0 / 460.0):
    """The inlier mask of the first hypothesis of ``idx`` with the most
    inliers (``ransac_masks``).  Returns (inlier_mask (K,), ok) — ok False
    when <8 valid points or no hypothesis has 8 distinct rows (gate
    disabled, mask = valid)."""
    ok = (torch.sum(valid) >= 8) & torch.any(distinct_rows(idx))
    masks = ransac_masks(xy0, xy1, valid, idx, thresh)
    best = torch.argmax(masks.sum(dim=-1)).reshape(1)
    inliers = masks.index_select(0, best)[0]
    return torch.where(ok, inliers, valid), ok


def ransac_essential(xy0, xy1, valid, thresh: float = 3.0 / 460.0,
                     n_hyp: int = 128, seed: int = 0):
    """Essential-matrix RANSAC on unit-plane correspondences — the
    rejectWithF outlier gate (rvi/feature/feature_tracker.cpp:265; the
    reference runs cv::findFundamentalMat on undistorted, re-projected
    points, which is this up to the virtual focal scaling): ``n_hyp``
    hypotheses from ``ransac_hypotheses(valid, n_hyp, seed)`` scored by
    ``ransac_score``.  Returns (inlier_mask (K,), ok)."""
    idx = ransac_hypotheses(valid, n_hyp, seed).to(xy0.device)
    return ransac_score(xy0, xy1, valid, idx, thresh)
