"""JPL CAHV / CAHVOR / CAHVORE camera family (port of
``visionworkbench_tpu/camera/cahv.py``; ref ``src/vw/Camera/CAHVModel.cc``,
``CAHVORModel.cc``, ``CAHVOREModel.cc``).

Math follows the published JPL CMOD conventions the reference implements:

* CAHV projection (``CAHVModel.cc:167-185``):
  ``u = (p-C).H / (p-C).A``, ``v = (p-C).V / (p-C).A``; ray =
  ``normalize((V - y A) x (H - x A))`` sign-fixed against ``(V x H).A``.
* CAHVOR adds radial distortion about optical axis O with coefficients R:
  forward (``CAHVORModel.cc:431-460``): ``mu = R0 + R1 tau + R2 tau^2``
  applied along lambda; inverse (``:297-346``): 20 Newton steps on
  ``k5 u^5 + k3 u^3 + k1 u = 1``.
* CAHVORE (``CAHVOREModel.cc:170-303``) adds a moving entrance pupil (E
  terms) and a linearity parameter P: P=1 perspective, P=0 fisheye,
  0<P<1 general. Forward: 30 Newton steps for theta, then ``chi``, ``mu``
  and the projection; inverse: 30 Newton steps on
  ``(1+R0)chi + R1 chi^3 + R2 chi^5 = chip``.

The Newton loops are Python loops of the JAX package's fixed counts (no
convergence test). Vectors stay float64 NumPy arrays, rounded to fp32 where
they meet the input; the sign term ``(V x H).A`` is computed on the host in
float64. File IO, ``linearize_camera``'s host arithmetic and
``pinhole_to_cahv`` are the JAX package's NumPy code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, cross, dot, norm_rn, qdiv
from visionworkbench_torch.core.exceptions import ArgumentErr, IOErr
from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.math.quaternion import matrix_to_quat

_CAHVOR_MAXITER = 20


class CAHVModel(CameraModel):
    def __init__(self, C, A, H, V):
        self.C = np.asarray(C, np.float64)
        self.A = np.asarray(A, np.float64)
        self.H = np.asarray(H, np.float64)
        self.V = np.asarray(V, np.float64)

    def _vhdota(self) -> float:
        """``(V x H) . A`` in float64 on the host."""
        return float(np.dot(np.cross(self.V, self.H), self.A))

    def point_to_pixel(self, point):
        p = as_f32(point)
        d = p - as_f32(self.C, p)
        den = dot(d, self.A)
        return torch.stack([dot(d, self.H) / den, dot(d, self.V) / den], -1)

    def pixel_to_vector(self, pixel):
        pix = as_f32(pixel)
        a, h, v = as_f32(self.A, pix), as_f32(self.H, pix), as_f32(self.V, pix)
        f = v - pix[..., 1:2] * a
        g = h - pix[..., 0:1] * a
        vec = cross(f, g)
        vec = vec / norm_rn(vec)[..., None]
        return vec * float(np.sign(self._vhdota()))

    def camera_center(self, pixel=None, dtype=torch.float32):
        return as_f32(self.C, pixel, dtype)

    def camera_pose(self, pixel=None):
        # Orthonormal frame from A and image axes (approximate; exact for
        # pinhole-compatible CAHV).
        a = self.A / np.linalg.norm(self.A)
        hp = self.H - np.dot(self.H, a) * a
        hp /= max(np.linalg.norm(hp), 1e-12)
        vp = np.cross(a, hp)
        r = np.stack([hp, vp, a], axis=1)
        return torch.as_tensor(matrix_to_quat(r), dtype=torch.float32)


class CAHVORModel(CAHVModel):
    def __init__(self, C, A, H, V, O, R):
        super().__init__(C, A, H, V)
        self.O = np.asarray(O, np.float64)
        self.Rd = np.asarray(R, np.float64)

    def point_to_pixel(self, point):
        p = as_f32(point)
        vec = p - as_f32(self.C, p)
        o = as_f32(self.O, p)
        omega = dot(vec, self.O)
        lam = vec - omega[..., None] * o
        tau = dot(lam, lam) / (omega * omega)
        r0, r1, r2 = [float(v) for v in self.Rd]
        mu = r0 + r1 * tau + r2 * tau * tau
        pp = vec + mu[..., None] * lam
        den = dot(pp, self.A)
        return torch.stack([dot(pp, self.H) / den, dot(pp, self.V) / den], -1)

    def pixel_to_vector(self, pixel):
        rr = CAHVModel.pixel_to_vector(self, pixel)
        o = as_f32(self.O, rr)
        omega = dot(rr, self.O)
        lam = rr - omega[..., None] * o
        tau = dot(lam, lam) / (omega * omega)
        r0, r1, r2 = [float(v) for v in self.Rd]
        k1 = 1 + r0
        k3 = r1 * tau
        k5 = r2 * tau * tau
        u = 1.0 - (r0 + k3 + k5)
        for _ in range(_CAHVOR_MAXITER):
            u2 = u * u
            poly = ((k5 * u2 + k3) * u2 + k1) * u - 1
            deriv = (5 * k5 * u2 + 3 * k3) * u2 + k1
            deriv = torch.where(deriv <= 0, 1.0, deriv)
            u = u - poly / deriv
        out = rr - (1 - u)[..., None] * lam
        return out / norm_rn(out)[..., None]


class CAHVOREModel(CAHVORModel):
    """Full CAHVORE (ref ``CAHVOREModel.cc:170-303``, JPL
    ``cmod_cahvore_2d_to_3d`` / ``3d_to_2d_general``).  ``linearity`` is the
    reference's P: 1 = perspective, 0 = fisheye, in between = general."""

    _ITERS = 30

    def __init__(self, C, A, H, V, O, R, E, linearity: float = 1.0):
        super().__init__(C, A, H, V, O, R)
        self.E = np.asarray(E, np.float64)
        self.linearity = float(linearity)
        if not (-1e-9 <= self.linearity <= 1 + 1e-9):
            raise ArgumentErr(f"CAHVORE: invalid linearity {linearity}")

    def point_to_pixel(self, point):
        p = as_f32(point)
        o = as_f32(self.O, p)
        e0, e1, e2 = [float(v) for v in self.E]
        r0, r1, r2 = [float(v) for v in self.Rd]
        P = self.linearity

        p_c = p - as_f32(self.C, p)
        zeta = dot(p_c, self.O)
        lam3 = p_c - zeta[..., None] * o
        lam = norm_rn(lam3)

        # Newton solve for the off-axis angle theta of the incoming ray,
        # accounting for the theta-dependent pupil offset (E terms).
        th = torch.atan2(lam, zeta)
        for _ in range(self._ITERS):
            costh, sinth = torch.cos(th), torch.sin(th)
            th2 = th * th
            th3, th4 = th * th2, th2 * th2
            ups = (zeta * costh + lam * sinth
                   - (1 - costh) * (e0 + e1 * th2 + e2 * th4)
                   - (th - sinth) * (2 * e1 * th + 4 * e2 * th3))
            ups = torch.where(torch.abs(ups) < 1e-12,
                              torch.where(ups < 0, -1e-12, 1e-12), ups)
            dth = (zeta * sinth - lam * costh
                   - (th - sinth) * (e0 + e1 * th2 + e2 * th4)) / ups
            th = th - dth
        theta = th

        if P > 1e-15:
            chi = qdiv(torch.tan(P * theta), P)
        elif P < -1e-15:
            chi = qdiv(torch.sin(P * theta), P)
        else:
            chi = theta
        chi = torch.where(torch.abs(chi) < 1e-8, 1e-8, chi)
        chi2 = chi * chi
        mu = r0 + chi2 * (r1 + chi2 * r2)
        rp = ((lam / chi)[..., None] * o + (1 + mu)[..., None] * lam3)
        # Small-theta rays project directly (ref :278-280).
        rp = torch.where((theta < 1e-8)[..., None], p_c, rp)
        den = dot(rp, self.A)
        return torch.stack([dot(rp, self.H) / den, dot(rp, self.V) / den], -1)

    def pixel_to_vector(self, pixel):
        pix = as_f32(pixel)
        o, a = as_f32(self.O, pix), as_f32(self.A, pix)
        h, v = as_f32(self.H, pix), as_f32(self.V, pix)
        r0, r1, r2 = [float(v_) for v_ in self.Rd]
        P = self.linearity

        w3 = cross(v - pix[..., 1:2] * a, h - pix[..., 0:1] * a)
        rp = qdiv(w3, float(np.float32(self._vhdota())))
        zetap = dot(rp, self.O)
        lamp3 = rp - zetap[..., None] * o
        lamp = norm_rn(lamp3)
        chip = lamp / zetap

        # Newton solve (1+R0)chi + R1 chi^3 + R2 chi^5 = chip  (ref :192-207).
        chi = chip
        for _ in range(self._ITERS):
            chi2 = chi * chi
            poly = (1 + r0) * chi + r1 * chi * chi2 + r2 * chi * chi2 * chi2
            deriv = (1 + r0) + 3 * r1 * chi2 + 5 * r2 * chi2 * chi2
            deriv = torch.where(torch.abs(deriv) < 1e-12, 1e-12, deriv)
            chi = chi - (poly - chip) / deriv
        if P < -1e-15:
            theta = qdiv(torch.arcsin(torch.clamp(P * chi, -1.0, 1.0)), P)
        elif P > 1e-15:
            theta = qdiv(torch.arctan(P * chi), P)
        else:
            theta = chi
        unit_lam = lamp3 / torch.clamp(lamp, min=1e-20)[..., None]
        ray = torch.sin(theta)[..., None] * unit_lam + torch.cos(theta)[..., None] * o
        return torch.where((chip < 1e-8)[..., None], o, ray)


def read_cahv_model(path: str):
    """Read CAHV/CAHVOR/CAHVORE text files (ref ``CAHVModel::read_cahv`` etc.)."""
    vals = {}
    linearity = 1.0
    t_code = None
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if "=" not in ln:
                    continue
                key, _, rest = ln.partition("=")
                key = key.strip().rstrip("0123456789").strip()
                try:
                    vec = np.array([float(v) for v in rest.replace(",", " ").split()])
                except ValueError:
                    continue
                if key.upper() in ("C", "A", "H", "V", "O", "R", "E"):
                    vals[key.upper()] = vec
                elif key.upper() == "T":
                    t_code = int(vec[0])
                elif key.upper() in ("LINEARITY", "P"):
                    linearity = float(vec[0])
    except OSError as e:
        raise IOErr(f"read_cahv_model: cannot open {path!r}: {e}")
    if not {"C", "A", "H", "V"} <= set(vals):
        raise IOErr(f"read_cahv_model: {path!r} missing C/A/H/V vectors")
    if "E" in vals:
        # Type codes override P (ref CAHVOREModel.cc:91-99): 1 -> perspective,
        # 2 -> fisheye, 3 -> use the P value as read.
        if t_code == 1:
            linearity = 1.0
        elif t_code == 2:
            linearity = 0.0
        return CAHVOREModel(vals["C"], vals["A"], vals["H"], vals["V"],
                            vals["O"], vals["R"], vals["E"], linearity)
    if "O" in vals:
        return CAHVORModel(vals["C"], vals["A"], vals["H"], vals["V"],
                           vals["O"], vals["R"])
    return CAHVModel(vals["C"], vals["A"], vals["H"], vals["V"])


def write_cahv_model(path: str, model: CAHVModel) -> None:
    """Write CAHV/CAHVOR/CAHVORE text files (ref ``CAHVModel::write`` etc.)."""
    def line(k, vec):
        return f"{k} = " + " ".join(repr(float(x)) for x in vec) + "\n"

    with open(path, "w") as f:
        f.write(line("C", model.C) + line("A", model.A)
                + line("H", model.H) + line("V", model.V))
        if isinstance(model, CAHVORModel):
            f.write(line("O", model.O) + line("R", model.Rd))
        if isinstance(model, CAHVOREModel):
            f.write(line("E", model.E))
            p = model.linearity
            f.write(f"T = {2 if p == 0 else (1 if p == 1 else 3)}\n")
            f.write(f"P = {repr(p)}\n")


def linearize_camera(model: CAHVOREModel, cahvore_image_size,
                     cahv_image_size) -> CAHVModel:
    """Fit a distortion-free CAHV covering the CAHVORE's field of view
    (ref ``CAHVOREModel.cc:305-381``): axis from the image-center ray,
    scale from the minimum common FOV over perimeter landmarks, clamped
    to 135 degrees. The rays are the model's fp32 ones (on the CPU)."""
    limfov = np.pi * 3 / 4
    w, h = int(cahvore_image_size[0]), int(cahvore_image_size[1])
    nw, nh = int(cahv_image_size[0]), int(cahv_image_size[1])

    hpts = np.array([[0, 0], [0, (h - 1) / 2], [0, h - 1],
                     [w - 1, 0], [w - 1, (h - 1) / 2], [w - 1, h - 1]], float)
    vpts = np.array([[0, 0], [(w - 1) / 2, 0], [w - 1, 0],
                     [0, h - 1], [(w - 1) / 2, h - 1], [w - 1, h - 1]], float)

    axis = model.pixel_to_vector([(w - 1) / 2.0, (h - 1) / 2.0]).numpy().astype(np.float64)
    axis /= np.linalg.norm(axis)

    dn = np.cross(model.A, model.H)
    rt = np.cross(dn, axis)
    dn = np.cross(axis, rt)
    dn /= np.linalg.norm(dn)
    rt /= np.linalg.norm(rt)

    def min_cos(pts, perp):
        u3 = model.pixel_to_vector(pts).numpy().astype(np.float64)
        proj = u3 - (u3 @ perp)[:, None] * perp
        proj /= np.linalg.norm(proj, axis=1, keepdims=True)
        return float(np.max(proj @ axis))  # minfov: use max cosine

    cos_h = min(min_cos(hpts, dn), 1.0)
    cos_v = min(min_cos(vpts, rt), 1.0)
    cos_h = max(cos_h, np.cos(limfov))
    cos_v = max(cos_v, np.cos(limfov))
    sh = (nw / 2.0) * cos_h / np.sqrt(1 - cos_h ** 2)
    sv = (nh / 2.0) * cos_v / np.sqrt(1 - cos_v ** 2)
    cx, cy = (nw - 1) / 2.0, (nh - 1) / 2.0
    return CAHVModel(model.C, axis, sh * rt + cx * axis, sv * dn + cy * axis)


def pinhole_to_cahv(pinhole) -> CAHVModel:
    """Convert a distortion-free pinhole to CAHV (ref ``CAHVModel`` pinhole
    constructor): A = forward axis, H = fu*h + cu*A, V = fv*v + cv*A."""
    r = pinhole.R  # camera-to-world, columns = camera axes in world
    a = r[:, 2]
    h = pinhole.fu * r[:, 0] + pinhole.cu * a
    v = pinhole.fv * r[:, 1] + pinhole.cv * a
    return CAHVModel(pinhole.C, a, h, v)
