"""Allreduce topology computation: binomial tree + tree-sharing ring.

Replicates the reference's topology contract (tracker/dmlc_tracker/
tracker.py:164-252): a binary-heap tree over ranks (parent/children) for
reduce/broadcast, a DFS-derived ring that shares tree edges for bandwidth
recovery, and a relabeling so ring order is 0..n-1 (neighbors differ by 1 mod
n). The port's ``torch.distributed`` collectives need no tracker-computed
topology, so this math serves *legacy Rabit consumers*; the tracker keeps
serving it so existing workers run unchanged. A copy of
``dmlc_core_tpu/tracker/topology.py``: both packages' trackers hand out the
same maps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

TreeMap = Dict[int, List[int]]
ParentMap = Dict[int, int]
RingMap = Dict[int, Tuple[int, int]]


def heap_neighbors(rank: int, n: int) -> List[int]:
    """Neighbors of `rank` in the 1-indexed binary heap over n ranks."""
    h = rank + 1
    out = []
    if h > 1:
        out.append(h // 2 - 1)
    if h * 2 - 1 < n:
        out.append(h * 2 - 1)
    if h * 2 < n:
        out.append(h * 2)
    return out


def build_tree(n: int) -> Tuple[TreeMap, ParentMap]:
    """Binomial reduction tree over `n` workers; returns (tree_map,
    parent_map) (reference tracker.py)."""
    tree: TreeMap = {}
    parent: ParentMap = {}
    for r in range(n):
        tree[r] = heap_neighbors(r, n)
        parent[r] = (r + 1) // 2 - 1
    return tree, parent


def _dfs_ring(tree: TreeMap, parent: ParentMap, r: int) -> List[int]:
    """DFS order visiting children, reversing the last subtree so the walk
    returns adjacent to the start (the reference's find_share_ring)."""
    children = [v for v in tree[r] if v != parent[r]]
    if not children:
        return [r]
    out = [r]
    for i, v in enumerate(children):
        sub = _dfs_ring(tree, parent, v)
        if i == len(children) - 1:
            sub.reverse()
        out += sub
    return out


def build_ring(tree: TreeMap, parent: ParentMap) -> RingMap:
    """Ring order over `n` workers rooted at `r` (reference tracker.py ring
    construction)."""
    order = _dfs_ring(tree, parent, 0)
    if len(order) != len(tree):
        # a real error, not an assert: `python -O` strips asserts, and a
        # malformed tree map must fail the rendezvous loudly
        raise RuntimeError(
            f"ring order covers {len(order)} of {len(tree)} workers")
    n = len(tree)
    ring: RingMap = {}
    for i in range(n):
        ring[order[i]] = (order[(i - 1) % n], order[(i + 1) % n])
    return ring


def build_link_maps(n: int) -> Tuple[TreeMap, ParentMap, RingMap]:
    """Tree/parent/ring maps relabeled so ring order is the identity
    (reference get_link_map): rank r's ring neighbors are r±1 mod n."""
    tree, parent = build_tree(n)
    ring = build_ring(tree, parent)
    relabel = {0: 0}
    cur = 0
    for i in range(n - 1):
        cur = ring[cur][1]
        relabel[cur] = i + 1
    tree2: TreeMap = {relabel[k]: sorted(relabel[x] for x in v)
                      for k, v in tree.items()}
    parent2: ParentMap = {relabel[k]: (relabel[v] if k != 0 else -1)
                          for k, v in parent.items()}
    ring2: RingMap = {relabel[k]: (relabel[v[0]], relabel[v[1]])
                      for k, v in ring.items()}
    return tree2, parent2, ring2
