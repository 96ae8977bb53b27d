"""Bundle-adjustment control networks (port of
``visionworkbench_tpu/ba/control_network.py``; ref
``src/vw/BundleAdjustment/ControlNetwork.h:38-107`` and
``ControlNetworkLoader.cc``): tie-point graph of ground points and their
per-image pixel measures, with binary IO and a loader that triangulates
initial ground points from match files + cameras.

The graph, its binary IO and ``CameraRelationNetwork`` are the JAX
package's host code, copied. :func:`build_control_network` triangulates
the points of one camera pair in one batched ``StereoModel.triangulate``
call on the device (the JAX package calls it once a point): the same
points, in the same order, with the same validity; the positions are the
port's float64 intersection (``stereo/stereo_model.py``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from visionworkbench_torch.core.exceptions import IOErr


class ControlMeasure:
    """Pixel observation in one image (ref ``ControlMeasure``)."""

    def __init__(self, col: float, row: float, sigma_col: float = 1.0,
                 sigma_row: float = 1.0, image_id: int = 0):
        self.col = float(col)
        self.row = float(row)
        self.sigma_col = float(sigma_col)
        self.sigma_row = float(sigma_row)
        self.image_id = int(image_id)

    def position(self) -> Tuple[float, float]:
        return (self.col, self.row)

    def __repr__(self):
        return f"ControlMeasure(img={self.image_id}, ({self.col}, {self.row}))"


class ControlPoint:
    """Ground point + its measures (ref ``ControlPoint``)."""
    GroundControlPoint = "gcp"
    TiePoint = "tie"

    def __init__(self, point_type: str = TiePoint):
        self.type = point_type
        self.position = np.zeros(3)
        self.sigma = np.ones(3)
        self.measures: List[ControlMeasure] = []
        self.ignore = False

    def add_measure(self, m: ControlMeasure) -> None:
        self.measures.append(m)

    def size(self) -> int:
        return len(self.measures)


class ControlNetwork:
    """(ref ``ControlNetwork``)"""

    def __init__(self, name: str = ""):
        self.name = name
        self.points: List[ControlPoint] = []
        self.image_names: List[str] = []

    def add_point(self, p: ControlPoint) -> None:
        self.points.append(p)

    def __len__(self) -> int:
        return len(self.points)

    def num_measures(self) -> int:
        return sum(p.size() for p in self.points)

    # --- binary IO (own compact format; ref binary cnet IO) ----------------
    _MAGIC = b"VWTPUCN1"

    def write_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self._MAGIC)
            names = "\n".join(self.image_names).encode()
            f.write(struct.pack("<I", len(names)))
            f.write(names)
            f.write(struct.pack("<I", len(self.points)))
            for p in self.points:
                f.write(struct.pack("<B", 1 if p.type == ControlPoint.GroundControlPoint else 0))
                f.write(struct.pack("<3d", *p.position))
                f.write(struct.pack("<3d", *p.sigma))
                f.write(struct.pack("<I", len(p.measures)))
                for m in p.measures:
                    f.write(struct.pack("<Iffff", m.image_id, m.col, m.row,
                                        m.sigma_col, m.sigma_row))

    @classmethod
    def read_binary(cls, path: str) -> "ControlNetwork":
        with open(path, "rb") as f:
            if f.read(8) != cls._MAGIC:
                raise IOErr(f"{path}: not a control network file")
            (nlen,) = struct.unpack("<I", f.read(4))
            names = f.read(nlen).decode()
            cn = cls()
            cn.image_names = names.split("\n") if names else []
            (npts,) = struct.unpack("<I", f.read(4))
            for _ in range(npts):
                (is_gcp,) = struct.unpack("<B", f.read(1))
                p = ControlPoint(ControlPoint.GroundControlPoint if is_gcp
                                 else ControlPoint.TiePoint)
                p.position = np.array(struct.unpack("<3d", f.read(24)))
                p.sigma = np.array(struct.unpack("<3d", f.read(24)))
                (nm,) = struct.unpack("<I", f.read(4))
                for _ in range(nm):
                    img, col, row, sc, sr = struct.unpack("<Iffff", f.read(20))
                    p.add_measure(ControlMeasure(col, row, sc, sr, img))
                cn.add_point(p)
            return cn


def build_control_network(image_names: Sequence[str], cameras: Sequence,
                          matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]],
                          min_angle_tol: float = 1e-4, device=None) -> ControlNetwork:
    """Build a network from pairwise matches + cameras, triangulating initial
    ground points (ref ``ControlNetworkLoader.cc``). ``matches[(i, j)]`` =
    ((N, 2) pixels in image i, (N, 2) pixels in image j). Transitive match
    chains merge into multi-measure points via union-find on (image, pixel)
    keys. Each point triangulates from its first two measures; the points of
    one camera pair go through one ``StereoModel.triangulate`` call on
    ``device`` (``None`` = the card)."""
    from visionworkbench_torch.stereo.stereo_model import StereoModel

    parent: Dict[Tuple[int, int, int], Tuple[int, int, int]] = {}

    def key(img, x, y):
        return (img, int(round(x * 8)), int(round(y * 8)))

    def find(k):
        while parent.get(k, k) != k:
            parent[k] = parent.get(parent[k], parent[k])
            k = parent[k]
        return k

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    obs: Dict[Tuple[int, int, int], Tuple[int, float, float]] = {}
    for (i, j), (p1, p2) in matches.items():
        for (x1, y1), (x2, y2) in zip(np.asarray(p1), np.asarray(p2)):
            k1, k2 = key(i, x1, y1), key(j, x2, y2)
            obs[k1] = (i, float(x1), float(y1))
            obs[k2] = (j, float(x2), float(y2))
            parent.setdefault(k1, k1)
            parent.setdefault(k2, k2)
            union(k1, k2)

    groups: Dict[Tuple[int, int, int], List[Tuple[int, float, float]]] = {}
    for k, o in obs.items():
        groups.setdefault(find(k), []).append(o)

    candidates: List[ControlPoint] = []
    for _, members in sorted(groups.items()):
        if len(members) < 2:
            continue
        p = ControlPoint()
        seen_imgs = set()
        for img, x, y in sorted(members):
            if img in seen_imgs:
                continue
            seen_imgs.add(img)
            p.add_measure(ControlMeasure(x, y, image_id=img))
        if len(p.measures) >= 2:
            candidates.append(p)

    # Triangulate from the first two measures, one call a camera pair.
    by_pair: Dict[Tuple[int, int], List[int]] = {}
    for n, p in enumerate(candidates):
        by_pair.setdefault((p.measures[0].image_id, p.measures[1].image_id), []).append(n)
    ok = np.zeros(len(candidates), bool)
    for (i0, i1), idx in by_pair.items():
        pix = np.array([[(candidates[n].measures[k].col, candidates[n].measures[k].row)
                         for n in idx] for k in (0, 1)])
        model = StereoModel(cameras[i0], cameras[i1], min_angle_tol)
        pt, _, valid = model.triangulate(pix[0], pix[1], device=device)
        pt, valid = pt.cpu().numpy(), valid.cpu().numpy()
        for row, n in enumerate(idx):
            ok[n] = valid[row]
            candidates[n].position = pt[row].astype(np.float64)

    cn = ControlNetwork()
    cn.image_names = list(image_names)
    for n, p in enumerate(candidates):
        if ok[n]:
            cn.add_point(p)
    return cn


class CameraRelationNetwork:
    """Image-pair relation graph (ref ``CameraRelation.cc``): which image
    pairs share measurements, with match counts — drives pairwise processing
    order in bundle adjustment."""

    def __init__(self):
        self._edges: Dict[Tuple[int, int], int] = {}

    def add_matches(self, image_a: int, image_b: int, count: int = 1) -> None:
        key = (min(image_a, image_b), max(image_a, image_b))
        self._edges[key] = self._edges.get(key, 0) + int(count)

    @classmethod
    def from_control_network(cls, cn: "ControlNetwork") -> "CameraRelationNetwork":
        g = cls()
        for p in cn.points:
            ids = [m.image_id for m in p.measures]
            for i in range(len(ids)):
                for j in range(i + 1, len(ids)):
                    g.add_matches(ids[i], ids[j])
        return g

    def pairs(self):
        """[(image_a, image_b, count)] sorted by descending count."""
        return sorted(((a, b, c) for (a, b), c in self._edges.items()),
                      key=lambda t: -t[2])

    def neighbors(self, image_id: int):
        out = []
        for (a, b), c in self._edges.items():
            if a == image_id:
                out.append((b, c))
            elif b == image_id:
                out.append((a, c))
        return sorted(out)
