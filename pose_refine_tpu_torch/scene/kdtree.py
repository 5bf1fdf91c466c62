"""Host-side kd-tree construction into flat SoA arrays (numpy; a copy of
``pose_refine_tpu/scene/kdtree.py``'s numpy builder).

The reference builds its kd-tree on the CPU even for the CUDA path
(pcd_scene.cu:5-6), level by level without recursion
(pcd_scene.cpp:45-184). The NN scene keeps the tree's point ORDER: leaf
ranges are contiguous, so consecutive 128-point chunks of the reordered
cloud are spatially tight, which is what the gated flash-NN kernel's chunk
pruning needs. ``KDTreeDevice`` packs the traversal arrays for the kd
traversal (``scene/nn_kdtree.py``).

Build semantics preserved (so the order matches the reference exactly):
  * split along the widest bbox dimension at the bbox midpoint
  * stable partition with tie-alternation for balance (pcd_scene.cpp:118-133)
  * split value re-centered to the midpoint of the gap between the two sides
    (pcd_scene.cpp:135)
  * leaves hold <= leaf_size points (default 10, pcd_scene.cpp:45)
  * points/normals reordered so leaf ranges are contiguous
    (pcd_scene.cpp:173-183)

A native C++ builder with identical output (``native/``, compiled at
first use) is taken by ``backend="auto"`` when it is built, as in the JAX
package; this numpy builder is the portable fallback and the parity oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pose_refine_tpu_torch import native


@dataclass
class KDTree:
    """Flat kd-tree. Node i is a leaf iff child[i, 0] < 0.

    Arrays:
      points:  (P, 3) float32 - reordered scene points
      normals: (P, 3) float32 - reordered normals
      parent:  (M,) int32
      child:   (M, 2) int32, -1 for leaves
      split_dim: (M,) int32
      split_v:  (M,) float32
      bbox:    (M, 6) float32 [xmin xmax ymin ymax zmin zmax]
      bounds:  (M, 2) int32 leaf point range [left, right)
    """

    points: np.ndarray
    normals: np.ndarray
    parent: np.ndarray
    child: np.ndarray
    split_dim: np.ndarray
    split_v: np.ndarray
    bbox: np.ndarray
    bounds: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.parent)

    def max_leaf_points(self) -> int:
        leaf = self.child[:, 0] < 0
        if not leaf.any():
            return 0
        return int((self.bounds[leaf, 1] - self.bounds[leaf, 0]).max())


def ensure_leaf_bboxes(points, child, bounds, bbox):
    """Fill missing (all-zero) LEAF bbox rows from the reordered points
    (JAX kdtree.py:65-81). Trees saved before the JAX package's round 3
    carry boxes for interior nodes only; the kd traversal reads the descend
    target's box, and a zero leaf box would prune correct descents -
    silently wrong neighbours. Returns bbox (updated copy, numpy)."""
    bbox = np.array(bbox, np.float32, copy=True)
    pts = np.asarray(points)
    bounds = np.asarray(bounds)
    leaf = np.asarray(child)[:, 0] < 0
    stale = leaf & (np.abs(bbox).sum(axis=1) == 0.0)
    for i in np.nonzero(stale)[0]:
        left, right = bounds[i]
        if right > left:
            seg = pts[left:right]
            lo, hi = seg.min(axis=0), seg.max(axis=0)
            bbox[i] = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])
    return bbox


def build_kdtree(points, normals, leaf_size: int = 10, backend: str = "auto") -> KDTree:
    """Build a kd-tree. backend: 'auto' (the native C++ builder when it is
    built, else numpy), 'native' (raises when it cannot be built) or
    'numpy'. Both builders give the same tree bit for bit."""
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(
            f"unknown kd-tree backend {backend!r}: expected 'auto', 'native' or 'numpy'")
    points = np.ascontiguousarray(points, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    n = len(points)
    if n == 0:
        # a sensor-dropout frame (all-zero depth / everything gated) must
        # fail loudly here, not as an argmax-of-empty deep in the split loop
        raise ValueError(
            "build_kdtree: empty cloud - the depth frame produced no valid "
            "scene points (sensor dropout?); projective scenes tolerate "
            "such frames, NN scenes cannot be built from them"
        )
    if len(normals) != n:
        raise ValueError(
            f"build_kdtree: {n} points but {len(normals)} normals"
        )
    if leaf_size < 1:
        # leaf_size=0 never terminates a 1-point node (the single point
        # ties at the bbox midpoint and re-splits forever)
        raise ValueError(f"build_kdtree: leaf_size must be >= 1, got {leaf_size}")

    if backend in ("auto", "native"):
        out = native.build_kdtree_native(points, leaf_size)
        if out is not None:
            order, parent, child, split_dim, split_v, bbox, bounds, _m = out
            return KDTree(points=points[order], normals=normals[order], parent=parent,
                          child=child, split_dim=split_dim, split_v=split_v, bbox=bbox,
                          bounds=bounds)
        if backend == "native":
            raise RuntimeError(
                f"native kd-tree builder unavailable: {native.unavailable_reason()}")

    # worst case node count: every split peels off >= 1 point per side
    cap = max(2 * n, 16)
    parent = np.full(cap, -1, np.int32)
    child = np.full((cap, 2), -1, np.int32)
    split_dim = np.zeros(cap, np.int32)
    split_v = np.zeros(cap, np.float32)
    bbox = np.zeros((cap, 6), np.float32)
    bounds = np.zeros((cap, 2), np.int32)

    index = np.arange(n, dtype=np.int64)
    bounds[0] = (0, n)
    n_nodes = 1
    frontier = [0]  # nodes created last level, to be examined this level

    while frontier:
        next_frontier = []
        for node in frontier:
            left, right = bounds[node]
            seg = index[left:right]
            pts = points[seg]

            lo = pts.min(axis=0)
            hi = pts.max(axis=0)
            # every node (leaves included) carries its subtree bbox
            bbox[node] = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])
            if right - left <= leaf_size:
                continue  # stays a leaf
            dim = int(np.argmax(hi - lo))
            mid = (lo[dim] + hi[dim]) / 2.0

            coord = pts[:, dim]
            less = coord < mid
            eq = coord == mid
            # tie-alternation (pcd_scene.cpp:118-133): the toggle starts True
            # and flips *before* each tie is tested, so ties alternate
            # right, left, right, ... - even-numbered (2nd, 4th, ...) go left.
            tie_rank = np.cumsum(eq)
            go_left = less | (eq & (tie_rank % 2 == 0))

            left_idx = seg[go_left]
            right_idx = seg[~go_left]
            if len(left_idx) == 0 or len(right_idx) == 0:
                # f32-degenerate node: the widest extent is <= 1 ULP, so
                # mid rounded onto the boundary and one side came out
                # empty. Points this node cannot separate at f32 resolution
                # stay one (oversized) leaf.
                continue
            # reference appends right-side elements from the back, reversing
            # their relative order (pcd_scene.cpp:129-130)
            index[left:left + len(left_idx)] = left_idx
            index[left + len(left_idx):right] = right_idx[::-1]

            split_low = coord[go_left].max()
            split_high = coord[~go_left].min()
            sv = (split_low + split_high) / 2.0

            c1, c2 = n_nodes, n_nodes + 1
            child[node] = (c1, c2)
            split_dim[node] = dim
            split_v[node] = sv

            m = left + len(left_idx)
            bounds[c1] = (left, m)
            bounds[c2] = (m, right)
            parent[c1] = node
            parent[c2] = node
            n_nodes += 2
            next_frontier += [c1, c2]
        frontier = next_frontier

    return KDTree(
        points=points[index],
        normals=normals[index],
        parent=parent[:n_nodes].copy(),
        child=child[:n_nodes].copy(),
        split_dim=split_dim[:n_nodes].copy(),
        split_v=split_v[:n_nodes].copy(),
        bbox=bbox[:n_nodes].copy(),
        bounds=bounds[:n_nodes].copy(),
    )


@dataclass(frozen=True)
class KDTreeDevice:
    """The traversal arrays of a KDTree on a device, packed as the kd
    traversal kernel (csrc/nn_kdtree.cu) reads them: one table of 16-byte
    rows, so a step reads its node in one load, a far child's box in two
    and a leaf point in one, and the kernel stages a prefix of each part
    into shared memory. The field views (``child``, ``parent``, ...) are
    the JAX SceneNN's arrays (JAX nn.py:77-83); the plain version of the
    traversal reads the same records, so kernel and plain version walk the
    same data.

      table: (3 M + P, 4) float32, three parts:
        records (M rows, int32 bits; ``records``): an interior node
              [parent, child0, split_v (float32 bits), split_dim], a leaf
              [parent, -1, left, right] with [left, right) its point range.
              The builder numbers nodes breadth first and creates siblings
              together, so child1 = child0 + 1 and the top levels of the
              tree are a prefix of the records;
        boxes (2 M rows; ``boxes``, (M, 8)): every node's subtree box
              [xmin, ymin, zmin, 0, xmax, ymax, zmax, 0], leaves included;
        points (P rows; ``points``): [x, y, z, 0], kd-reordered
      leaf_cap: the next power of two at or above the most points in a leaf
      max_steps: 3 * n_nodes + 2, a bound the walk never reaches (each node
              is ``cur`` at most three times: entered, and left back from
              each child; JAX nn.py:77-83)
    """

    table: torch.Tensor
    n_nodes: int
    leaf_cap: int
    max_steps: int

    @classmethod
    def from_tree(cls, tree: KDTree, device) -> "KDTreeDevice":
        m, p = tree.n_nodes, len(tree.points)
        leaf = tree.child[:, 0] < 0
        if not (tree.child[~leaf, 1] == tree.child[~leaf, 0] + 1).all():
            raise ValueError("KDTreeDevice needs consecutive siblings (child1 = child0 + 1)")
        # the kernel's split-plane test (csrc/nn_kdtree.cu) skips a far box
        # only where split_v lies between the two children's boxes
        inner = np.flatnonzero(~leaf)
        sd, c0 = tree.split_dim[inner].astype(np.int64), tree.child[inner, 0]
        sv = tree.split_v[inner].astype(np.float32)
        if not ((tree.bbox[c0, 2 * sd + 1] <= sv) & (sv <= tree.bbox[c0 + 1, 2 * sd])).all():
            raise ValueError("KDTreeDevice needs each split_v between its children's boxes "
                             "(child0's max <= split_v <= child1's min on split_dim)")
        table = np.zeros((3 * m + p, 4), np.float32)
        rec = table[:m].view(np.int32)
        rec[:, 0] = tree.parent
        rec[:, 1] = np.where(leaf, -1, tree.child[:, 0])
        split_bits = tree.split_v.astype(np.float32).view(np.int32)
        rec[:, 2] = np.where(leaf, tree.bounds[:, 0], split_bits)
        rec[:, 3] = np.where(leaf, tree.bounds[:, 1], tree.split_dim)
        boxes = table[m:3 * m].reshape(m, 8)
        boxes[:, 0:3] = tree.bbox[:, 0::2]
        boxes[:, 4:7] = tree.bbox[:, 1::2]
        table[3 * m:, :3] = tree.points
        leaf_cap = int(2 ** int(np.ceil(np.log2(max(tree.max_leaf_points(), 1)))))
        return cls(table=torch.as_tensor(table, device=device), n_nodes=m, leaf_cap=leaf_cap,
                   max_steps=3 * m + 2)

    def to(self, device) -> "KDTreeDevice":
        return KDTreeDevice(self.table.to(device), self.n_nodes, self.leaf_cap, self.max_steps)

    @property
    def records(self) -> torch.Tensor:
        """(M, 4) int32 node records."""
        return self.table[:self.n_nodes].view(torch.int32)

    @property
    def boxes(self) -> torch.Tensor:
        """(M, 8) float32 [xmin, ymin, zmin, 0, xmax, ymax, zmax, 0]."""
        m = self.n_nodes
        return self.table[m:3 * m].view(m, 8)

    @property
    def points(self) -> torch.Tensor:
        """(P, 4) float32 [x, y, z, 0]."""
        return self.table[3 * self.n_nodes:]

    @property
    def is_leaf(self) -> torch.Tensor:
        return self.records[:, 1] < 0

    @property
    def child(self) -> torch.Tensor:
        c0 = self.records[:, 1]
        leaf = c0 < 0
        return torch.stack([c0, torch.where(leaf, c0, c0 + 1)], dim=1)

    @property
    def parent(self) -> torch.Tensor:
        return self.records[:, 0]

    @property
    def split_dim(self) -> torch.Tensor:
        return torch.where(self.is_leaf, 0, self.records[:, 3])

    @property
    def split_v(self) -> torch.Tensor:
        v = self.table[:self.n_nodes, 2]
        return torch.where(self.is_leaf, torch.zeros_like(v), v)

    @property
    def bounds(self) -> torch.Tensor:
        """(M, 2) int32 [left, right): a leaf's from its record; an interior
        node's spans its children's, c0's left to c1's right, filled in from
        the leaves up."""
        rec = self.records
        leaf = rec[:, 1] < 0
        c0 = rec[:, 1].clamp(min=0).long()
        left = torch.where(leaf, rec[:, 2], torch.iinfo(torch.int32).max)
        right = torch.where(leaf, rec[:, 3], -1)
        while True:
            nl = torch.where(leaf, left, left[c0])
            nr = torch.where(leaf, right, right[(c0 + 1).clamp(max=rec.shape[0] - 1)])
            if torch.equal(nl, left) and torch.equal(nr, right):
                return torch.stack([left, right], dim=1)
            left, right = nl, nr

    @property
    def bbox(self) -> torch.Tensor:
        """(M, 6) [xmin, xmax, ymin, ymax, zmin, zmax], the KDTree layout."""
        return self.boxes[:, [0, 4, 1, 5, 2, 6]]
