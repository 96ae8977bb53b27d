"""Pinhole camera model (port of ``visionworkbench_tpu/camera/pinhole.py``;
ref ``src/vw/Camera/PinholeModel.h:82-229`` / ``PinholeModel.cc``), with
TSAI file IO.

Projection (ref ``PinholeModel.cc:351-368``): pixel = distort(K [Rᵀ(X − C)])
/ pixel_pitch with K = [[fu, 0, cu], [0, fv, cv], [0, 0, 1]]; ``R`` is the
camera-to-world rotation. Ray (ref ``:422-430``): undistort, unproject,
rotate to world, normalize. Batched over (..., 3)/(..., 2) fp32 tensors
on the input's device; ``C`` and ``R`` stay float64 NumPy arrays and are
rounded to fp32 where they meet the input (``point_to_pixel`` subtracts the
fp32 centre from fp32 points, as the JAX package does). The ``.tsai`` reader
and writer are the JAX package's, copied: a written file equals the JAX
package's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from visionworkbench_torch.core.device import as_f32, matmul, norm_rn, qdiv
from visionworkbench_torch.core.exceptions import IOErr
from visionworkbench_torch.camera.model import CameraModel
from visionworkbench_torch.camera.distortion import (
    DISTORTION_TYPES, NullLensDistortion, TsaiLensDistortion,
)
from visionworkbench_torch.math.quaternion import matrix_to_quat


class PinholeModel(CameraModel):
    def __init__(self, camera_center=(0, 0, 0), rotation=np.eye(3),
                 focal=(1.0, 1.0), offset=(0.0, 0.0),
                 distortion=None, pixel_pitch: float = 1.0):
        self.C = np.asarray(camera_center, np.float64)
        self.R = np.asarray(rotation, np.float64)          # camera-to-world
        self.fu, self.fv = float(focal[0]), float(focal[1])
        self.cu, self.cv = float(offset[0]), float(offset[1])
        self.distortion = distortion or NullLensDistortion()
        self.pixel_pitch = float(pixel_pitch)

    # --- core ---------------------------------------------------------------
    def point_to_pixel(self, point):
        p = as_f32(point)
        cam = matmul(p - as_f32(self.C, p), self.R)    # camera-frame coords
        x = cam[..., 0] / cam[..., 2]
        y = cam[..., 1] / cam[..., 2]
        # normalized focal-plane coords -> distortion -> pixels
        nd = self.distortion.distort(torch.stack([x, y], -1))
        px = nd[..., 0] * self.fu + self.cu
        py = nd[..., 1] * self.fv + self.cv
        return qdiv(torch.stack([px, py], -1), self.pixel_pitch)

    def pixel_to_vector(self, pixel):
        pix = as_f32(pixel) * self.pixel_pitch
        x = qdiv(pix[..., 0] - self.cu, self.fu)
        y = qdiv(pix[..., 1] - self.cv, self.fv)
        ud = self.distortion.undistort(torch.stack([x, y], -1))
        ones = torch.ones(ud.shape[:-1], dtype=torch.float32, device=ud.device)
        ray_cam = torch.stack([ud[..., 0], ud[..., 1], ones], -1)
        ray = matmul(ray_cam, self.R.T)
        return ray / norm_rn(ray)[..., None]

    def camera_center(self, pixel=None, dtype=torch.float32):
        return as_f32(self.C, pixel, dtype)

    def camera_pose(self, pixel=None):
        return torch.as_tensor(matrix_to_quat(self.R), dtype=torch.float32)

    def intrinsics_matrix(self) -> np.ndarray:
        return np.array([[self.fu, 0, self.cu], [0, self.fv, self.cv], [0, 0, 1]])

    def __repr__(self):
        return (f"PinholeModel(C={self.C.tolist()}, f=({self.fu}, {self.fv}), "
                f"c=({self.cu}, {self.cv}), dist={self.distortion.name})")


# --------------------------------------------------------------------------
# TSAI file IO (ref PinholeModel.cc read/write_file; format: VERSION_4 text)
# --------------------------------------------------------------------------

def _parse_vec(line: str) -> np.ndarray:
    return np.array([float(v) for v in line.split("=", 1)[1].split()], np.float64)


def read_pinhole_model(path: str) -> PinholeModel:
    """Read a ``.tsai`` pinhole file (ref ``PinholeModel::read_file``)."""
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError as e:
        raise IOErr(f"read_pinhole_model: cannot open {path!r}: {e}")
    kv = {}
    dist_name = "NULL"
    dist_params = {}
    section = "main"
    for ln in lines:
        if ln.startswith("VERSION") or ln == "PINHOLE":
            continue
        if ln.upper() in ("NULL", "TSAI", "FOV", "FISHEYE", "BROWNCONRADY",
                          "PHOTOMETRIX", "ADJUSTABLETSAI"):
            section = "dist"
            dist_name = ln.upper()
            continue
        if "=" not in ln:
            continue
        key = ln.split("=", 1)[0].strip()
        if section == "main":
            kv[key] = ln
        else:
            dist_params[key.lower()] = float(ln.split("=", 1)[1])
    try:
        fu = float(kv["fu"].split("=")[1])
        fv = float(kv["fv"].split("=")[1])
        cu = float(kv["cu"].split("=")[1])
        cv = float(kv["cv"].split("=")[1])
        c = _parse_vec(kv["C"])
        r = _parse_vec(kv["R"]).reshape(3, 3)
    except KeyError as e:
        raise IOErr(f"read_pinhole_model: missing field {e} in {path!r}")
    pitch = float(kv["pitch"].split("=")[1]) if "pitch" in kv else 1.0
    if dist_name == "TSAI":
        dist = TsaiLensDistortion(dist_params.get("k1", 0), dist_params.get("k2", 0),
                                  dist_params.get("p1", 0), dist_params.get("p2", 0),
                                  dist_params.get("k3", 0))
    elif dist_name in ("NULL",):
        dist = NullLensDistortion()
    else:
        cls = {"FOV": "FOV", "FISHEYE": "FISHEYE", "BROWNCONRADY": "BrownConrady",
               "PHOTOMETRIX": "Photometrix"}.get(dist_name)
        if cls is None:
            dist = NullLensDistortion()
        else:
            dist = DISTORTION_TYPES[cls](*dist_params.values())
    # The file stores fu/fv/cu/cv in metric units alongside pitch; the model
    # API keeps them as given (projection divides by pitch at the end).
    return PinholeModel(c, r, (fu, fv), (cu, cv), dist, pitch)


def write_pinhole_model(path: str, model: PinholeModel) -> None:
    """Write ``.tsai`` (ref ``PinholeModel::write``)."""
    with open(path, "w") as f:
        f.write("VERSION_4\nPINHOLE\n")
        f.write(f"fu = {model.fu}\n")
        f.write(f"fv = {model.fv}\n")
        f.write(f"cu = {model.cu}\n")
        f.write(f"cv = {model.cv}\n")
        f.write("u_direction = 1 0 0\n")
        f.write("v_direction = 0 1 0\n")
        f.write("w_direction = 0 0 1\n")
        f.write("C = " + " ".join(repr(float(v)) for v in model.C) + "\n")
        f.write("R = " + " ".join(repr(float(v)) for v in model.R.reshape(-1)) + "\n")
        f.write(f"pitch = {model.pixel_pitch}\n")
        d = model.distortion
        if isinstance(d, NullLensDistortion):
            f.write("NULL\n")
        elif isinstance(d, TsaiLensDistortion):
            k1, k2, p1, p2, k3 = d.params
            f.write("TSAI\n")
            f.write(f"k1 = {k1}\nk2 = {k2}\np1 = {p1}\np2 = {p2}\nk3 = {k3}\n")
        else:
            f.write(d.name.upper() + "\n")
            for i, v in enumerate(d.params):
                f.write(f"p{i} = {v}\n")
