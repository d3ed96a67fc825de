"""Camera models as batched torch functions.

Replaces the camodocal suite (cam/, ~9.3k LoC C++; SURVEY.md §2.8) with the
full model family as pure functions over (...,2)/(...,3) tensors of any
leading shape, on whatever device the tensors live:

- ``PinholeCamera`` — radial-tangential pinhole
  (cam/src/camera_models/PinholeCamera.cc liftProjective/spaceToPlane);
- ``PinholeFullCamera`` — 8-coefficient rational model, the model the
  shipped config actually runs (yaml/cam0_pinhole.yaml: PINHOLE_FULL;
  cam/src/camera_models/PinholeFullCamera.cc:535-645);
- ``EquidistantCamera`` — Kannala-Brandt fisheye (EquidistantCamera.cc);
- ``CataCamera`` — MEI unified omnidirectional model with mirror parameter
  xi (CataCamera.cc:556-656);
- ``ScaramuzzaCamera`` — OCAM polynomial model
  (ScaramuzzaCamera.cc:598-654).

``lift_projective`` inverts distortion with a fixed number of Newton or
fixed-point iterations (no data-dependent exit, so no host read).
``load_camera_yaml`` mirrors ``CameraFactory::generateCameraFromYamlFile``
(cam/src/camera_models/CameraFactory.cc) over the reference's own
OpenCV-FileStorage YAML files.

The calibration tools (Chessboard/CostFunctionFactory) are intentionally out
of scope: they produce the YAML intrinsics this module consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _newton_undistort(cam, xy_d, iters):
    """Invert ``cam.distort`` at ``xy_d`` by ``iters`` Newton steps, each
    solving the analytic 2x2 Jacobian by Cramer's rule (a near-singular
    Jacobian, |det| < 1e-12, divides by 1 instead)."""
    xy = xy_d
    for _ in range(iters):
        F = cam.distort(xy) - xy_d
        J = cam._distort_jacobian(xy)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
        dx = (J[..., 1, 1] * F[..., 0] - J[..., 0, 1] * F[..., 1]) / det
        dy = (-J[..., 1, 0] * F[..., 0] + J[..., 0, 0] * F[..., 1]) / det
        xy = xy - torch.stack([dx, dy], dim=-1)
    return xy


def _homogeneous(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def distort(self, xy):
        """Apply radial-tangential distortion on unit-plane points (...,2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = self.k1 * r2 + self.k2 * r2 * r2
        dx = x * radial + 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
        dy = y * radial + self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
        return torch.stack([x + dx, y + dy], dim=-1)

    def space_to_plane(self, pts3):
        """3-D camera-frame point -> pixel (spaceToPlane semantics)."""
        xy = pts3[..., 0:2] / pts3[..., 2:3]
        d = self.distort(xy)
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def _distort_jacobian(self, xy):
        """Analytic 2x2 Jacobian of the distortion map, (...,2,2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        k1, k2, p1, p2 = self.k1, self.k2, self.p1, self.p2
        j00 = 1 + k1 * (r2 + 2 * x * x) + k2 * (r4 + 4 * x * x * r2) \
            + 2 * p1 * y + 6 * p2 * x
        j01 = 2 * y * (k1 * x + 2 * k2 * x * r2 + p2) + 2 * p1 * x
        j10 = 2 * x * (k1 * y + 2 * k2 * y * r2 + p1) + 2 * p2 * y
        j11 = 1 + k1 * (r2 + 2 * y * y) + k2 * (r4 + 4 * y * y * r2) \
            + 6 * p1 * y + 2 * p2 * x
        J = torch.stack([j00, j01, j10, j11], dim=-1)
        return J.reshape(xy.shape[:-1] + (2, 2))

    def lift_projective(self, uv, iters: int = 8):
        """Pixel -> unit-plane undistorted ray (liftProjective semantics).

        Newton inversion of the distortion map (converges where camodocal's
        8 recursive iterations do, and also for strong distortion).
        Returns (...,3) homogeneous [x, y, 1].
        """
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        xy = _newton_undistort(self, torch.stack([mx, my], dim=-1), iters)
        return _homogeneous(xy)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt equidistant fisheye (EquidistantCamera semantics)."""

    mu: float
    mv: float
    u0: float
    v0: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0

    def _theta_poly(self, theta):
        t2 = theta * theta
        return theta * (1 + t2 * (self.k2 + t2 * (self.k3 + t2 * (
            self.k4 + t2 * self.k5))))

    def space_to_plane(self, pts3):
        x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        d = self._theta_poly(theta)
        scale = torch.where(r > 1e-12, d / torch.clamp_min(r, 1e-12),
                            torch.ones_like(r))
        u = self.mu * scale * x + self.u0
        v = self.mv * scale * y + self.v0
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 12):
        mx = (uv[..., 0] - self.u0) / self.mu
        my = (uv[..., 1] - self.v0) / self.mv
        d = torch.sqrt(mx * mx + my * my)
        # invert theta-polynomial by Newton iterations
        theta = d
        for _ in range(iters):
            f = self._theta_poly(theta) - d
            t2 = theta * theta
            df = 1 + t2 * (3 * self.k2 + t2 * (5 * self.k3 + t2 * (
                7 * self.k4 + 9 * t2 * self.k5)))
            theta = theta - f / torch.clamp_min(df, 1e-9)
        scale = torch.where(d > 1e-12,
                            torch.tan(theta) / torch.clamp_min(d, 1e-12),
                            torch.ones_like(d))
        return torch.stack([mx * scale, my * scale, torch.ones_like(mx)],
                           dim=-1)


class PinholeFullCamera(NamedTuple):
    """8-coefficient rational pinhole (PINHOLE_FULL; the shipped config's
    model, yaml/cam0_pinhole.yaml) — OpenCV's rational distortion:
    radial = (1 + k1 r² + k2 r⁴ + k3 r⁶)/(1 + k4 r² + k5 r⁴ + k6 r⁶)
    plus the usual tangential terms
    (PinholeFullCamera::distortion/spaceToPlane semantics,
    cam/src/camera_models/PinholeFullCamera.cc:623-645)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def distort(self, xy):
        """Distorted unit-plane point (...,2) from undistorted."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        cdist = 1 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6
        icdist2 = 1.0 / (1 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6)
        a1 = 2 * x * y
        xd = x * cdist * icdist2 + self.p1 * a1 + self.p2 * (r2 + 2 * x * x)
        yd = y * cdist * icdist2 + self.p1 * (r2 + 2 * y * y) + self.p2 * a1
        return torch.stack([xd, yd], dim=-1)

    def space_to_plane(self, pts3):
        d = self.distort(pts3[..., 0:2] / pts3[..., 2:3])
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 10):
        """Pixel -> unit-plane ray [x,y,1] by the compensated fixed-point
        iteration (x = (x0 − tangential)·icdist, the OpenCV undistortPoints
        scheme the reference iterates 8 times,
        PinholeFullCamera.cc:566-581)."""
        x0 = (uv[..., 0] - self.cx) / self.fx
        y0 = (uv[..., 1] - self.cy) / self.fy
        x, y = x0, y0
        for _ in range(iters):
            r2 = x * x + y * y
            r4 = r2 * r2
            r6 = r4 * r2
            icdist = ((1 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6)
                      / (1 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6))
            dx = 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
            dy = self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
            x = (x0 - dx) * icdist
            y = (y0 - dy) * icdist
        return _homogeneous(torch.stack([x, y], dim=-1))


class CataCamera(NamedTuple):
    """MEI unified omnidirectional model: unit-sphere projection with mirror
    parameter xi, then radial-tangential distortion, then the generalised
    projection (gamma1, gamma2) (CataCamera::liftProjective/spaceToPlane,
    cam/src/camera_models/CataCamera.cc:556-656)."""

    xi: float
    gamma1: float
    gamma2: float
    u0: float
    v0: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def _radtan(self):
        # the distortion map is the pinhole radtan map on the sphere-plane
        return PinholeCamera(1.0, 1.0, 0.0, 0.0,
                             self.k1, self.k2, self.p1, self.p2)

    def space_to_plane(self, pts3):
        norm = torch.linalg.norm(pts3, dim=-1)
        zp = pts3[..., 2] + self.xi * norm
        p_u = pts3[..., 0:2] / zp[..., None]
        p_d = self._radtan().distort(p_u)
        u = self.gamma1 * p_d[..., 0] + self.u0
        v = self.gamma2 * p_d[..., 1] + self.v0
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv, iters: int = 8):
        """Pixel -> projective ray.  Undistorts by Newton inversion, then
        un-mirrors: z = 1 − xi (ρ²+1)/(xi + √(1+(1−xi²)ρ²)) (the ξ=1
        branch z = (1−ρ²)/2 is its analytic limit, CataCamera.cc:616-626)."""
        mx = (uv[..., 0] - self.u0) / self.gamma1
        my = (uv[..., 1] - self.v0) / self.gamma2
        xy = _newton_undistort(self._radtan(),
                               torch.stack([mx, my], dim=-1), iters)
        rho2 = torch.sum(xy * xy, dim=-1)
        if self.xi == 1.0:
            z = (1.0 - rho2) / 2.0
        else:
            z = 1.0 - self.xi * (rho2 + 1.0) / (
                self.xi + torch.sqrt(1.0 + (1.0 - self.xi ** 2) * rho2))
        return torch.cat([xy, z[..., None]], dim=-1)


class ScaramuzzaCamera(NamedTuple):
    """OCAM polynomial omnidirectional model (SCARAMUZZA): forward poly(ρ)
    of degree 4 for lifting, inverse poly(θ) of degree 19 for projection,
    with affine stretch [C D; E 1] and image center
    (OCAMCamera::liftProjective/spaceToPlane,
    cam/src/camera_models/ScaramuzzaCamera.cc:598-654)."""

    poly: tuple          # SCARAMUZZA_POLY_SIZE = 5 coefficients, low->high
    inv_poly: tuple      # SCARAMUZZA_INV_POLY_SIZE = 20, low->high
    center_x: float
    center_y: float
    C: float = 1.0
    D: float = 0.0
    E: float = 0.0

    def space_to_plane(self, pts3):
        x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
        norm = torch.sqrt(x * x + y * y)
        theta = torch.atan2(-z, norm)
        rho = torch.zeros_like(theta)
        for c in reversed(self.inv_poly):
            rho = rho * theta + c
        inv_norm = 1.0 / torch.clamp_min(norm, 1e-12)
        xn = x * inv_norm * rho
        yn = y * inv_norm * rho
        u = xn * self.C + yn * self.D + self.center_x
        v = xn * self.E + yn + self.center_y
        return torch.stack([u, v], dim=-1)

    def lift_projective(self, uv):
        xc0 = uv[..., 0] - self.center_x
        xc1 = uv[..., 1] - self.center_y
        inv_scale = 1.0 / (self.C - self.D * self.E)
        xa0 = inv_scale * (xc0 - self.D * xc1)
        xa1 = inv_scale * (-self.E * xc0 + self.C * xc1)
        phi = torch.sqrt(xa0 * xa0 + xa1 * xa1)
        z = torch.zeros_like(phi)
        for c in reversed(self.poly):
            z = z * phi + c
        # camodocal returns the ray over the *uncorrected* centered pixel
        # (CataCamera-consistent sensor-plane convention,
        # ScaramuzzaCamera.cc:621)
        return torch.stack([xc0, xc1, -z], dim=-1)


def make_camera(model: str, **kw):
    """Factory mirroring camodocal::CameraFactory name dispatch
    (cam/src/camera_models/CameraFactory.cc model_type strings)."""
    model = model.lower()
    if model in ("pinhole",):
        return PinholeCamera(**kw)
    if model in ("pinhole_full",):
        return PinholeFullCamera(**kw)
    if model in ("kannala_brandt", "equidistant", "fisheye"):
        return EquidistantCamera(**kw)
    if model in ("mei", "cata", "catadioptric"):
        return CataCamera(**kw)
    if model in ("scaramuzza", "ocam"):
        return ScaramuzzaCamera(**kw)
    raise ValueError(f"unknown camera model {model!r}")


def load_camera_yaml(path):
    """Build a camera from a reference-format OpenCV-FileStorage YAML
    (CameraFactory::generateCameraFromYamlFile parity; the reference's own
    yaml/cam0_pinhole.yaml loads unmodified).  Dependency-free parser for
    the '%YAML:1.0' FileStorage dialect (nested scalar maps only)."""
    import re

    maps: dict = {}
    stack = [(-1, maps)]
    with open(path) as f:
        for line in f:
            if line.startswith("%YAML") or line.strip() in ("---", ""):
                continue
            m = re.match(r"^(\s*)([A-Za-z_][\w]*):\s*(.*?)\s*$", line)
            if not m:
                continue
            indent, key, val = len(m.group(1)), m.group(2), m.group(3)
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            if val == "":
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                try:
                    parent[key] = float(val) if re.match(
                        r"^[-+0-9.eE]+$", val) else val.strip('"')
                except ValueError:
                    parent[key] = val
                stack.append((indent, parent))

    model = str(maps.get("model_type", "PINHOLE")).lower()
    dist = maps.get("distortion_parameters", {})
    proj = maps.get("projection_parameters", {})
    if model == "pinhole":
        return PinholeCamera(
            fx=proj["fx"], fy=proj["fy"], cx=proj["cx"], cy=proj["cy"],
            k1=dist.get("k1", 0.0), k2=dist.get("k2", 0.0),
            p1=dist.get("p1", 0.0), p2=dist.get("p2", 0.0))
    if model == "pinhole_full":
        return PinholeFullCamera(
            fx=proj["fx"], fy=proj["fy"], cx=proj["cx"], cy=proj["cy"],
            k1=dist.get("k1", 0.0), k2=dist.get("k2", 0.0),
            k3=dist.get("k3", 0.0), k4=dist.get("k4", 0.0),
            k5=dist.get("k5", 0.0), k6=dist.get("k6", 0.0),
            p1=dist.get("p1", 0.0), p2=dist.get("p2", 0.0))
    if model in ("kannala_brandt", "equidistant"):
        return EquidistantCamera(
            mu=proj["mu"], mv=proj["mv"], u0=proj["u0"], v0=proj["v0"],
            k2=dist.get("k2", 0.0), k3=dist.get("k3", 0.0),
            k4=dist.get("k4", 0.0), k5=dist.get("k5", 0.0))
    if model == "mei":
        mirror = maps.get("mirror_parameters", {})
        return CataCamera(
            xi=mirror.get("xi", 1.0),
            gamma1=proj["gamma1"], gamma2=proj["gamma2"],
            u0=proj["u0"], v0=proj["v0"],
            k1=dist.get("k1", 0.0), k2=dist.get("k2", 0.0),
            p1=dist.get("p1", 0.0), p2=dist.get("p2", 0.0))
    if model == "scaramuzza":
        pp = maps.get("poly_parameters", {})
        ip = maps.get("inv_poly_parameters", {})
        af = maps.get("affine_parameters", {})
        return ScaramuzzaCamera(
            poly=tuple(pp.get(f"p{i}", 0.0) for i in range(5)),
            inv_poly=tuple(ip.get(f"p{i}", 0.0) for i in range(20)),
            center_x=maps.get("center_x", af.get("cx", 0.0)),
            center_y=maps.get("center_y", af.get("cy", 0.0)),
            C=af.get("ac", af.get("c", 1.0)), D=af.get("ad", af.get("d", 0.0)),
            E=af.get("ae", af.get("e", 0.0)))
    raise ValueError(f"unknown model_type {model!r} in {path}")
