"""Named coordinate-frame tree (port of
``visionworkbench_tpu/geometry/frame_tree.py``, its NumPy code copied; ref
``FrameStore`` / ``FrameTreeNode``, ``src/vw/Geometry/FrameStore.cc``,
``ATrans.h``): rigid transforms between frames resolved through their
common ancestor. Host float64 NumPy."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from visionworkbench_torch.core.exceptions import ArgumentErr, NotFoundErr


class ATrans:
    """Rigid affine transform: 3x3 rotation + translation (ref ``ATrans``)."""

    def __init__(self, rotation=np.eye(3), translation=(0.0, 0.0, 0.0)):
        self.rotation = np.asarray(rotation, np.float64)
        self.translation = np.asarray(translation, np.float64)

    def apply(self, points):
        p = np.asarray(points, np.float64)
        return p @ self.rotation.T + self.translation

    def compose(self, other: "ATrans") -> "ATrans":
        """self o other (other applied first)."""
        return ATrans(self.rotation @ other.rotation,
                      self.rotation @ other.translation + self.translation)

    def inverse(self) -> "ATrans":
        rt = self.rotation.T
        return ATrans(rt, -rt @ self.translation)


class FrameTreeNode:
    def __init__(self, name: str, transform: Optional[ATrans] = None,
                 parent: Optional["FrameTreeNode"] = None):
        self.name = name
        self.transform = transform or ATrans()  # this frame in parent coords
        self.parent = parent
        self.children: List["FrameTreeNode"] = []
        if parent is not None:
            parent.children.append(self)

    def ancestry(self) -> List["FrameTreeNode"]:
        chain = [self]
        while chain[-1].parent is not None:
            chain.append(chain[-1].parent)
        return chain[::-1]


class FrameStore:
    """(ref ``FrameStore``): registry of frames + transform queries."""

    def __init__(self):
        self._frames: Dict[str, FrameTreeNode] = {}

    def add(self, name: str, parent: Optional[str] = None,
            transform: Optional[ATrans] = None) -> FrameTreeNode:
        if name in self._frames:
            raise ArgumentErr(f"frame {name!r} already exists")
        pnode = None
        if parent is not None:
            pnode = self._lookup(parent)
        node = FrameTreeNode(name, transform, pnode)
        self._frames[name] = node
        return node

    def _lookup(self, name: str) -> FrameTreeNode:
        if name not in self._frames:
            raise NotFoundErr(f"unknown frame {name!r}")
        return self._frames[name]

    def set_transform(self, name: str, transform: ATrans) -> None:
        self._lookup(name).transform = transform

    def to_world(self, name: str) -> ATrans:
        """Frame -> root transform."""
        t = ATrans()
        for node in self._lookup(name).ancestry():
            t = t.compose(node.transform)
        return t

    def transform_between(self, src: str, dst: str) -> ATrans:
        """Transform taking src-frame coordinates to dst-frame coordinates
        (ref ``FrameStore::getTransformOf``)."""
        return self.to_world(dst).inverse().compose(self.to_world(src))

    def frame_names(self) -> List[str]:
        return sorted(self._frames)
