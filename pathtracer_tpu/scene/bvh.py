"""Host-side SAH BVH build, emitted directly in flattened DFS-preorder layout.

Algorithm replicates reference src/bvhnode.cpp:
  - split axis = maximum extent of the NODE bounds (not centroid bounds)
    (bvhnode.cpp:172 via BVHBounds::maximumExtent, :38-50)
  - 12-bucket SAH over centroid offsets with cost
    0.125 + (N_l*SA_l + N_r*SA_r) / SA_parent (bvhnode.cpp:93-146)
  - degenerate splits fall back to the median (bvhnode.cpp:141-144,178-180)
  - flattened layout: DFS preorder; left child at i+1; right child offset
    stored; leaf stores a contiguous range into the DFS-ordered triangle
    array (bvhnode.cpp:243-268)

Two deliberate departures from the reference (bvhnode.cpp:165-169 uses
exactly one triangle per leaf):
  - `max_leaf` triangles per leaf (default 4; the loader's MAX_LEAF). Leaf
    triangles are contiguous in the reordered array; fewer, fatter leaves
    shorten the walk. max_leaf=1 reproduces the reference shape.
  - parent/sibling links for the stackless walks (ops/intersect.py,
    ops/bvh_walk.py).

The builder is vectorized NumPy over per-triangle precomputed bounds/centroids.
"""
from __future__ import annotations

import ctypes
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

N_BUCKETS = 12

_NATIVE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libbvh.so")
_native_lib: Optional[ctypes.CDLL] = None


def _load_native() -> Optional[ctypes.CDLL]:
    """ctypes-load the C++ builder (native/bvh_builder.cpp, `make -C native`);
    None if not built — the NumPy builder is a full fallback."""
    global _native_lib
    if _native_lib is not None:
        return _native_lib
    if not os.path.exists(_NATIVE_PATH):
        # best-effort one-time build (g++ is in the base image; ~2s)
        import subprocess
        try:
            subprocess.run(["make", "-C", os.path.dirname(_NATIVE_PATH)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(_NATIVE_PATH):
        return None
    lib = ctypes.CDLL(_NATIVE_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.build_bvh_sah.restype = ctypes.c_int
    lib.build_bvh_sah.argtypes = [
        ctypes.c_int, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, i64p]
    _native_lib = lib
    return lib


def builder_name() -> str:
    """Which builder `build_bvh(backend="auto")` uses here."""
    return "native" if _load_native() is not None else "numpy"


def _build_bvh_native(lib, tris, use_sah: bool, max_leaf: int):
    T = tris["v0"].shape[0]
    cap = 2 * T - 1 if T > 1 else 1
    v0 = np.ascontiguousarray(tris["v0"], dtype=np.float32)
    v1 = np.ascontiguousarray(tris["v1"], dtype=np.float32)
    v2 = np.ascontiguousarray(tris["v2"], dtype=np.float32)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    tf = np.empty(cap, np.int32)
    tc = np.empty(cap, np.int32)
    sc = np.empty(cap, np.int32)
    par = np.empty(cap, np.int32)
    sib = np.empty(cap, np.int32)
    lo = np.empty(T, np.int64)
    n = lib.build_bvh_sah(T, v0, v1, v2, max_leaf, int(use_sah),
                          bmin.reshape(-1), bmax.reshape(-1), tf, tc, sc,
                          par, sib, lo)
    nodes = {
        "bounds_min": bmin[:n].copy(), "bounds_max": bmax[:n].copy(),
        "tri_first": tf[:n].copy(), "tri_count": tc[:n].copy(),
        "second_child": sc[:n].copy(), "parent": par[:n].copy(),
        "sibling": sib[:n].copy(),
    }
    reordered = {k: tris[k][lo] for k in
                 ("v0", "v1", "v2", "n0", "n1", "n2", "material_id")}
    return nodes, reordered


def build_bvh(tris: Dict[str, np.ndarray], use_sah: bool = True,
              max_leaf: int = 4, backend: str = "auto"
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Build a flattened BVH for one mesh.

    Args:
      tris: triangle SoA dict with v0,v1,v2,n0,n1,n2 [T,3] and material_id [T].
      use_sah: SAH bucket split (reference USE_SAH 1); else median split.
      max_leaf: max triangles per leaf (1 = reference layout).
      backend: "auto" (native C++ if built, else NumPy), "native", "numpy".
        Both produce IDENTICAL trees (double-precision math, same operation
        order; tested in tests/test_native_bvh.py).

    Returns:
      (nodes, reordered_tris): nodes dict with bounds_min/bounds_max [N,3],
      tri_first [N] (-1 interior), tri_count [N] (0 interior), second_child,
      parent, sibling [N]; triangles reordered to DFS leaf order.
    """
    if backend != "numpy":
        lib = _load_native()
        if lib is not None:
            return _build_bvh_native(lib, tris, use_sah, max_leaf)
        if backend == "native":
            raise RuntimeError(
                f"native builder not built ({_NATIVE_PATH}); run "
                "`make -C native`")
    T = tris["v0"].shape[0]
    assert T > 0, "empty mesh"
    v0 = tris["v0"].astype(np.float64)
    v1 = tris["v1"].astype(np.float64)
    v2 = tris["v2"].astype(np.float64)
    tri_min = np.minimum(np.minimum(v0, v1), v2)          # [T,3]
    tri_max = np.maximum(np.maximum(v0, v1), v2)          # [T,3]
    centroid = (v0 + v1 + v2) / 3.0                        # [T,3]

    bounds_min, bounds_max = [], []
    tri_first, tri_count = [], []
    second_child, parent, sibling = [], [], []
    leaf_order = []

    def surface_area(mn, mx):
        d = mx - mn
        return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))

    def emit(mn, mx):
        my = len(bounds_min)
        bounds_min.append(mn)
        bounds_max.append(mx)
        tri_first.append(-1)
        tri_count.append(0)
        second_child.append(0)
        parent.append(-1)
        sibling.append(-1)
        return my

    def build(idx: np.ndarray) -> int:
        """Emit node for triangle subset `idx`; return its node index."""
        mn = tri_min[idx].min(axis=0)
        mx = tri_max[idx].max(axis=0)
        my = emit(mn.astype(np.float32), mx.astype(np.float32))

        if idx.shape[0] <= max_leaf:
            tri_first[my] = len(leaf_order)
            tri_count[my] = idx.shape[0]
            leaf_order.extend(idx.tolist())
            return my

        axis = int(np.argmax(np.abs(mx - mn)))
        c = centroid[idx][:, axis]
        cmin, cmax = c.min(), c.max()

        left_sel = None
        if use_sah and cmax > cmin and idx.shape[0] > 2:
            # Bucket assignment (bvhnode.cpp:102-107)
            b = (N_BUCKETS * (c - cmin) / (cmax - cmin)).astype(np.int64)
            b = np.minimum(b, N_BUCKETS - 1)
            costs = np.empty(N_BUCKETS - 1)
            sa_parent = surface_area(mn, mx)
            bmins = np.full((N_BUCKETS, 3), np.inf)
            bmaxs = np.full((N_BUCKETS, 3), -np.inf)
            counts = np.zeros(N_BUCKETS, dtype=np.int64)
            for k in range(N_BUCKETS):
                sel = b == k
                counts[k] = sel.sum()
                if counts[k]:
                    bmins[k] = tri_min[idx[sel]].min(axis=0)
                    bmaxs[k] = tri_max[idx[sel]].max(axis=0)
            # Prefix/suffix sweep (bvhnode.cpp:109-122)
            pre_min = np.minimum.accumulate(bmins, axis=0)
            pre_max = np.maximum.accumulate(bmaxs, axis=0)
            suf_min = np.minimum.accumulate(bmins[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(bmaxs[::-1], axis=0)[::-1]
            pre_cnt = np.cumsum(counts)
            suf_cnt = np.cumsum(counts[::-1])[::-1]
            for i in range(N_BUCKETS - 1):
                sa0 = surface_area(pre_min[i], pre_max[i]) if pre_cnt[i] else 0.0
                sa1 = (surface_area(suf_min[i + 1], suf_max[i + 1])
                       if suf_cnt[i + 1] else 0.0)
                costs[i] = 0.125 + (pre_cnt[i] * sa0
                                    + suf_cnt[i + 1] * sa1) / sa_parent
            split_bucket = int(np.argmin(costs))
            left_sel = b <= split_bucket
            nl = int(left_sel.sum())
            if nl == 0 or nl == idx.shape[0]:
                left_sel = None  # degenerate -> median fallback

        if left_sel is not None:
            left_idx = idx[left_sel]
            right_idx = idx[~left_sel]
        else:
            # Median split after centroid sort (bvhnode.cpp:141-144,184-188)
            order = np.argsort(c, kind="stable")
            midn = idx.shape[0] // 2
            left_idx = idx[order[:midn]]
            right_idx = idx[order[midn:]]

        left = build(left_idx)                # lands at my+1
        right = build(right_idx)
        second_child[my] = right
        parent[left] = my
        parent[right] = my
        sibling[left] = right
        return my

    build(np.arange(T, dtype=np.int64))
    sys.setrecursionlimit(old_limit)
    assert len(leaf_order) == T

    nodes = {
        "bounds_min": np.asarray(bounds_min, dtype=np.float32),
        "bounds_max": np.asarray(bounds_max, dtype=np.float32),
        "tri_first": np.asarray(tri_first, dtype=np.int32),
        "tri_count": np.asarray(tri_count, dtype=np.int32),
        "second_child": np.asarray(second_child, dtype=np.int32),
        "parent": np.asarray(parent, dtype=np.int32),
        "sibling": np.asarray(sibling, dtype=np.int32),
    }
    lo = np.asarray(leaf_order, dtype=np.int64)
    reordered = {k: tris[k][lo] for k in
                 ("v0", "v1", "v2", "n0", "n1", "n2", "material_id")}
    return nodes, reordered
