"""Draft-tree specifications and the host-side tree-buffer compiler
(the port's own copy of ``lantern_tpu/trees.py``, ``optimize_tree`` included).

A *draft tree* is a prefix-closed set of paths; each path element is the rank of
the chosen child among its parent's top-k drafter proposals.  Example:
``[0, 2]`` is the 3rd-ranked child of the 1st-ranked child of the root.

This module compiles a path-list tree spec into the static buffers both sides of
speculative decoding need:

- **verifier side** (one base-model forward over the whole tree): ancestor
  attention mask, per-node depth (position id), the map from the drafter's flat
  top-k sample grid into tree slots, and the leaf->root path table used to
  gather per-path logits.
- **drafter side** (level-by-level tree expansion): per-level sample-row
  bookkeeping so the drafter can run one forward per tree level with static
  shapes.

Everything here runs once on the host in numpy; results are immutable arrays
that get closed over by jitted device code.

Reference semantics: the reference repo's models/drafters/utils.py:80-217
(verifier buffers), the reference repo's models/drafters/utils_c.py:100-179
(drafter-level buffers), the reference repo's models/drafters/choices.py (shapes).
The implementation below is an independent re-derivation in terms of parent
pointers and node ranks rather than the reference's stateful scans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Stride of the drafter's flattened top-k sample grid.  The drafter samples
# TOPK candidates per expanded node; tree slot -> grid index uses this stride.
# (reference: utils.py:13)
TOPK = 10

Path = Tuple[int, ...]

# ---------------------------------------------------------------------------
# Static tree library (reference: models/drafters/choices.py:1-32).
# Path lists are data, not code: they define the six published tree shapes.
# ---------------------------------------------------------------------------

mc_sim_7b_63 = [
    [0], [1], [2], [3], [0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [2, 0], [2, 1],
    [3, 0], [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 1, 1], [0, 2, 0],
    [0, 2, 1], [1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 1],
]

mc_sim_7b_63_balanced = [
    [0], [1], [2],
    [0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [1, 2], [2, 0], [2, 1],
    [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 1, 1], [1, 0, 0],
    [1, 0, 1], [1, 1, 0], [1, 1, 1],
    [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 0, 0, 0], [0, 0, 0, 0, 1],
]

naive_extend_57 = [
    [0], [1], [2], [3], [4],
    [0, 0], [0, 1], [0, 2], [0, 3], [1, 0], [1, 1], [1, 2], [2, 0], [2, 1],
    [2, 2], [3, 0], [3, 1], [4, 0],
    [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 1, 0], [0, 1, 1],
    [0, 1, 2], [0, 2, 0], [0, 2, 1], [0, 2, 2], [0, 3, 0], [0, 3, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [2, 0, 0],
    [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 0, 3], [0, 0, 1, 0],
    [0, 0, 1, 1], [0, 0, 1, 2], [0, 0, 2, 0], [0, 0, 2, 1], [0, 0, 3, 0],
    [0, 1, 0, 0], [0, 1, 0, 1], [0, 1, 1, 0], [0, 2, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 1], [0, 0, 0, 0, 2], [0, 0, 0, 1, 0],
    [0, 0, 0, 1, 1], [0, 0, 1, 0, 0], [0, 0, 1, 0, 1], [0, 0, 1, 1, 0],
    [0, 0, 2, 0, 0],
]

medusa_2_7b_63 = [
    [0], [1], [2], [3], [4], [5], [6], [7], [8], [9],
    [0, 0], [0, 1], [0, 2], [0, 3], [0, 4], [0, 5], [0, 6], [0, 7], [0, 8],
    [0, 9], [1, 0], [1, 1], [1, 2], [1, 3], [1, 4], [2, 0], [2, 1], [3, 0],
    [3, 1], [4, 0], [5, 0], [6, 0], [7, 0],
    [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4], [0, 0, 5],
    [0, 0, 6], [0, 0, 7], [0, 0, 8], [0, 1, 0], [0, 1, 1], [0, 1, 2],
    [0, 1, 3], [0, 2, 0], [0, 2, 1], [0, 3, 0], [0, 4, 0], [0, 5, 0],
    [1, 0, 0], [1, 0, 1], [1, 0, 2], [1, 1, 0], [2, 0, 0],
    [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 0, 3], [0, 0, 1, 0],
    [0, 0, 2, 0], [0, 1, 0, 0],
]

reverse_balanced_25 = [
    [0], [1], [2],
    [0, 0], [0, 1], [1, 0], [2, 0],
    [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 1, 1], [1, 0, 0],
    [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 1, 0], [0, 0, 1, 1],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 1], [0, 0, 0, 0, 2], [0, 0, 0, 0, 3],
    [0, 0, 0, 1, 0], [0, 0, 0, 1, 1], [0, 0, 0, 1, 2],
]

chain = [[0], [0, 0], [0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0, 0]]

# First-party small shape for batched serving / big-model operating points:
# the verification forward's MXU cost scales with node count, so once
# weight streaming is amortized (many slots, or a 7B-class model whose
# tree rows reach MXU-visible compute) small chain-heavy shapes win wall
# clock despite lower compression (measured, PERF.md).
chain_bush_8 = [[0], [1], [0, 0], [0, 1], [0, 0, 0], [0, 0, 1],
                [0, 0, 0, 0], [0, 0, 0, 0, 0]]

TREE_LIBRARY: Dict[str, List[List[int]]] = {
    "mc_sim_7b_63": mc_sim_7b_63,
    "mc_sim_7b_63_balanced": mc_sim_7b_63_balanced,
    "naive_extend_57": naive_extend_57,
    "medusa_2_7b_63": medusa_2_7b_63,
    "reverse_balanced_25": reverse_balanced_25,
    "chain": chain,
    "chain_bush_8": chain_bush_8,
}


def sort_paths(paths: Sequence[Sequence[int]]) -> List[Path]:
    """Canonical node order: by (depth, path) lexicographically."""
    return sorted((tuple(p) for p in paths), key=lambda p: (len(p), p))


@dataclasses.dataclass(frozen=True, eq=False)
class DrafterLevel:
    """Static bookkeeping for one drafter expansion level.

    At level ``d`` the drafter has just produced hidden states for the
    ``num_rows`` *internal* nodes of depth ``d`` (the root counts as the single
    depth-0 internal node).  It samples top-k tokens from each row, selects the
    internal nodes of depth ``d+1`` from the flattened ``num_rows * topk``
    grid, and forwards them with an ancestor-masked attention over all internal
    nodes placed so far.
    """

    num_rows: int                 # internal nodes at depth d (sample rows)
    child_flat_idx: np.ndarray    # [n_next] indices into flattened (num_rows*topk) grid
    parent_row: np.ndarray        # [n_next] row of each child's parent within this level
    attn_mask: np.ndarray         # [n_next, cum_internal_after] ancestor|self mask
    block_offset: int             # column offset of this level's first internal node
                                  # within the drafter's tree KV block


@dataclasses.dataclass(frozen=True, eq=False)
class TreeSpec:
    """Compiled static draft tree.  All arrays are host numpy; slot 0 = root.
    ``eq=False`` -> identity hash, usable as a jit static argument."""

    paths: Tuple[Path, ...]          # sorted node paths (slot i+1 <-> paths[i])
    topk: int
    num_nodes: int                   # N+1 including root
    max_depth: int                   # deepest node's depth (root = 0)
    num_paths: int                   # number of leaves == verification paths

    parent_slot: np.ndarray          # [N+1] int32, parent slot (root -> 0)
    depth: np.ndarray                # [N+1] int32, root = 0
    attn_mask: np.ndarray            # [N+1, N+1] bool, ancestor-or-self (col 0 = root)
    tree_indices: np.ndarray         # [N+1] int32, slot -> flat sample-grid index
    retrieve_indices: np.ndarray     # [P, max_depth+1] int32, -1 padded leaf paths
    retrieve_valid: np.ndarray       # [P, max_depth+1] bool
    p_indices: np.ndarray            # [P, max_depth+1] int32: parent's rank within
                                     #   the internal nodes of its level (EAGLE-1
                                     #   multi-round sampling bookkeeping)
    b_indices: np.ndarray            # [P, max_depth+1, S] int32 tree slots of
                                     #   earlier-drafted siblings, -1 padded
    children: np.ndarray             # [N+1, C_max] child slots in slot order, -1 pad
    inlevel_rank: np.ndarray         # [N+1] rank among the internal nodes of the
                                     #   node's own level (root = 0); 0 for leaves
    levels: Tuple[DrafterLevel, ...] # drafter-side per-level buffers
    num_internal: int                # total internal nodes (drafter forward rows)

    @property
    def path_len(self) -> int:
        return self.retrieve_indices.shape[1]


def compile_tree(tree_paths: Sequence[Sequence[int]], topk: int = TOPK) -> TreeSpec:
    """Compile a path-list tree spec into static verifier + drafter buffers.

    Matches the buffer semantics of the reference compiler
    (the reference repo's models/drafters/utils.py:80-217) but derives everything
    from parent pointers and node ranks.
    """
    paths = sort_paths(tree_paths)
    n = len(paths)
    idx_of: Dict[Path, int] = {p: i for i, p in enumerate(paths)}  # 0-based node idx
    if len(idx_of) != n:
        raise ValueError("duplicate paths in tree spec")
    for p in paths:
        if not p:
            raise ValueError("tree spec contains an empty path")
        if len(p) > 1 and p[:-1] not in idx_of:
            raise ValueError(f"tree spec not prefix-closed at {p}")
        if max(p) >= topk:
            raise ValueError(f"path rank {max(p)} exceeds topk={topk}")

    # slot s in 1..n <-> paths[s-1]; slot 0 is the root.
    depth = np.zeros(n + 1, dtype=np.int32)
    parent_slot = np.zeros(n + 1, dtype=np.int32)
    value = np.zeros(n + 1, dtype=np.int32)  # child rank under its parent
    for i, p in enumerate(paths):
        s = i + 1
        depth[s] = len(p)
        value[s] = p[-1]
        parent_slot[s] = 0 if len(p) == 1 else idx_of[p[:-1]] + 1

    max_depth = int(depth.max())

    # Ancestor-or-self mask (row attends to col).  Root column always visible.
    attn_mask = np.eye(n + 1, dtype=bool)
    attn_mask[:, 0] = True
    for s in range(1, n + 1):
        a = parent_slot[s]
        while a != 0:
            attn_mask[s, a] = True
            a = parent_slot[a]

    # Internal nodes (have children) in slot order; their rank is the row
    # index of their top-k sample group in the drafter's flat output grid.
    has_child = np.zeros(n + 1, dtype=bool)
    for s in range(1, n + 1):
        has_child[parent_slot[s]] = True
    internal_slots = [s for s in range(n + 1) if has_child[s]]  # includes root (0)
    internal_rank = {s: r for r, s in enumerate(internal_slots)}
    num_internal = len(internal_slots)

    # slot -> flat grid index: 1 + parent_internal_rank * topk + child rank.
    # (Grid row order == internal-node slot order == order the drafter emits
    # its per-level top-k sample blocks; index 0 is the committed root token.)
    tree_indices = np.zeros(n + 1, dtype=np.int32)
    for s in range(1, n + 1):
        tree_indices[s] = 1 + internal_rank[parent_slot[s]] * topk + value[s]

    # Leaf->root path table.  Rows are leaves; each row lists slots from root
    # (always 0) down to the leaf, padded with -1.  Row order: lexicographic
    # over slot sequences with pads sorted last (matches reference custom sort).
    leaves = [s for s in range(1, n + 1) if not has_child[s]]
    rows = []
    for s in leaves:
        chain_slots = []
        a = s
        while a != 0:
            chain_slots.append(a)
            a = parent_slot[a]
        rows.append([0] + chain_slots[::-1])
    path_len = max_depth + 1
    big = n + 10
    rows.sort(key=lambda r: [x if x >= 0 else big for x in r] + [big] * (path_len - len(r)))
    retrieve_indices = np.full((len(rows), path_len), -1, dtype=np.int32)
    for r, row in enumerate(rows):
        retrieve_indices[r, : len(row)] = row
    retrieve_valid = retrieve_indices >= 0

    # EAGLE-1 rejection-sampling bookkeeping, gathered along paths:
    #  p_indices: rank of the node's parent within the internal nodes OF THE
    #    PARENT'S LEVEL (selects the drafter-probability row at that level).
    #  b_indices: tree slots of same-parent siblings drafted before this node.
    level_internal: Dict[int, List[int]] = {}
    for s in internal_slots:
        level_internal.setdefault(int(depth[s]), []).append(s)
    inlevel_rank = {}
    for d, slots in level_internal.items():
        for r, s in enumerate(slots):
            inlevel_rank[s] = r

    node_p = np.zeros(n + 1, dtype=np.int32)
    node_p[0] = -1
    for s in range(1, n + 1):
        node_p[s] = inlevel_rank[parent_slot[s]]

    children: Dict[int, List[int]] = {}
    for s in range(1, n + 1):
        children.setdefault(int(parent_slot[s]), []).append(s)
    node_b: Dict[int, List[int]] = {0: []}
    for pslot, kids in children.items():
        kids_sorted = sorted(kids, key=lambda s: value[s])
        for j, s in enumerate(kids_sorted):
            node_b[s] = kids_sorted[:j]

    # children table (slot order == child-rank order) for the tree-walk
    # verifier; inlevel rank for indexing drafter level distributions
    c_max = max((len(v) for v in children.values()), default=1)
    children_arr = np.full((n + 1, max(c_max, 1)), -1, dtype=np.int32)
    for pslot, kids in children.items():
        for j, s in enumerate(sorted(kids, key=lambda s: value[s])):
            children_arr[pslot, j] = s
    inlevel_arr = np.zeros((n + 1,), dtype=np.int32)
    for s, r in inlevel_rank.items():
        inlevel_arr[s] = r

    P = len(rows)
    p_indices = np.zeros((P, path_len), dtype=np.int32)
    max_sib = max((len(v) for v in node_b.values()), default=0)
    b_indices = np.full((P, path_len, max(max_sib, 1)), -1, dtype=np.int32)
    for r in range(P):
        for c in range(path_len):
            s = retrieve_indices[r, c]
            if s < 0:
                continue
            p_indices[r, c] = node_p[s]
            for k, sib in enumerate(node_b[int(s)]):
                b_indices[r, c, k] = sib

    # ---- drafter-side level buffers -------------------------------------
    levels: List[DrafterLevel] = []
    # cum_offsets[d]: column offset of depth-(d+1) internal block in the
    # drafter's tree KV area (internal nodes at depth >= 1, level-major).
    internal_depths = sorted(d for d in level_internal if d >= 1)
    offset = 0
    offsets = {}
    for d in internal_depths:
        offsets[d] = offset
        offset += len(level_internal[d])
    for d in range(0, max_depth - 1):
        rows_slots = level_internal.get(d, [])      # sampled-from rows (depth d)
        next_slots = level_internal.get(d + 1, [])  # nodes to forward (depth d+1)
        if not next_slots:
            break
        row_rank = {s: r for r, s in enumerate(rows_slots)}
        child_flat = np.array(
            [row_rank[parent_slot[s]] * topk + value[s] for s in next_slots],
            dtype=np.int32,
        )
        parent_row = np.array([row_rank[parent_slot[s]] for s in next_slots], dtype=np.int32)
        # ancestor mask over internal nodes of depth 1..d+1 (cols, level-major)
        cum = offsets[d + 1] + len(next_slots)
        col_slot = []
        for dd in internal_depths:
            if dd <= d + 1:
                col_slot.extend(level_internal[dd])
        mask = np.zeros((len(next_slots), cum), dtype=bool)
        for r, s in enumerate(next_slots):
            for c, cs in enumerate(col_slot):
                mask[r, c] = attn_mask[s, cs]
        levels.append(
            DrafterLevel(
                num_rows=len(rows_slots),
                child_flat_idx=child_flat,
                parent_row=parent_row,
                attn_mask=mask,
                block_offset=offsets[d + 1],
            )
        )

    return TreeSpec(
        paths=tuple(paths),
        topk=topk,
        num_nodes=n + 1,
        max_depth=max_depth,
        num_paths=P,
        parent_slot=parent_slot,
        depth=depth,
        attn_mask=attn_mask,
        tree_indices=tree_indices,
        retrieve_indices=retrieve_indices,
        retrieve_valid=retrieve_valid,
        p_indices=p_indices,
        b_indices=b_indices,
        children=children_arr,
        inlevel_rank=inlevel_arr,
        levels=tuple(levels),
        num_internal=num_internal,
    )


def optimize_tree(
    rank_probs: Sequence[float],
    num_nodes: int,
    max_depth: int = 8,
) -> List[Path]:
    """The expected-accept-length-optimal static tree shape for a node
    budget.

    Model: the r-th ranked draft child of a correct node is itself correct
    with probability ``rank_probs[r]`` (``engine.calibrate``), independently
    across depth, so a node reached by ranks (r1..rd) adds its path
    probability ``prod rank_probs[ri]`` to the expected accepted tokens.
    The sum over a fixed budget is largest for the ``num_nodes``
    most probable nodes, a set that is prefix-closed because a child's
    probability never exceeds its parent's: best-first expansion is optimal.

    ``rank_probs`` may also be a 2-D ``[depth][rank]`` matrix whose row d
    holds the probabilities of depth-(d+1) nodes (a drafter whose proposals
    decay with depth); depths beyond the matrix reuse its last row.

    Returns a path list for ``compile_tree`` / ``get_tree``.
    """
    import heapq

    probs = np.asarray(rank_probs, dtype=float)
    if probs.ndim == 1:
        probs = probs[None]                       # one row, reused per depth
    if probs.size == 0 or num_nodes < 1:
        raise ValueError("need at least one rank probability and one node")
    if ((probs <= 0) | (probs > 1)).any():
        raise ValueError(f"rank_probs must be in (0, 1], got {probs.tolist()}")
    R = probs.shape[1]

    def row(depth):                               # depth-(d+1) node probs
        return probs[min(depth, probs.shape[0] - 1)]

    # heap of (-path_prob, path), seeded with the depth-1 candidates
    heap = [(-row(0)[r], (r,)) for r in range(R)]
    heapq.heapify(heap)
    chosen: List[Path] = []
    while heap and len(chosen) < num_nodes:
        neg_p, path = heapq.heappop(heap)
        chosen.append(list(path))
        if len(path) < max_depth:
            for r in range(R):
                heapq.heappush(heap, (neg_p * row(len(path))[r], path + (r,)))
    return sort_paths(chosen)


def _compile_fit(paths) -> TreeSpec:
    """compile_tree with topk widened to the paths' max rank (calibrated
    trees built with --max-rank > 10 would otherwise fail the rank check)."""
    widest = max((max(p) + 1 for p in paths if len(p)), default=0)
    return compile_tree(paths, topk=max(TOPK, widest))


def get_tree(name_or_paths) -> TreeSpec:
    """Compile a tree by library name, explicit path list, or a ``.json``
    file written by the calibration flows: either a bare path list
    (scripts/select_lumina_tree.py) or ``{"paths": [[...], ...]}``
    (scripts/optimize_bench_tree.py)."""
    if isinstance(name_or_paths, str):
        if name_or_paths.endswith(".json"):
            import json

            with open(name_or_paths) as f:
                data = json.load(f)
            return _compile_fit(data["paths"]
                                if isinstance(data, dict) else data)
        try:
            paths = TREE_LIBRARY[name_or_paths]
        except KeyError:
            raise KeyError(
                f"unknown tree {name_or_paths!r}; available: {sorted(TREE_LIBRARY)}"
            ) from None
        return compile_tree(paths)
    return _compile_fit(name_or_paths)
