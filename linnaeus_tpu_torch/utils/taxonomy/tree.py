"""TaxonomyTree: the taxonomic hierarchy as a validated forest.

Port of linnaeus_tpu/utils/taxonomy/tree.py, which is numpy only: the same
class with the same file format, kept as this package's own copy. It parses
the ``hierarchy_map`` produced by the dataset processor
(``{child_task_key: {child_idx: parent_idx}}``) into a bidirectional graph
and produces the dense parent -> child hierarchy matrices and the pairwise
distances that hierarchical heads and taxonomy-aware label smoothing use;
the serving handler asks it for parents.

Conventions
-----------
``task_keys`` is ordered fine -> coarse (e.g. ``["taxa_L10", ..., "taxa_L40"]``,
species first). ``hierarchy_map[task_keys[i]]`` maps class indices at level i
to parent class indices at level i+1. ``build_hierarchy_matrices()`` returns
``{f"{parent_task}_{child_task}": ndarray[num_parent, num_child]}`` with
parent = task_keys[i+1] (the coarser level).
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

Node = tuple[str, int]


class TaxonomyTree:
    """Represents the taxonomic hierarchy as a tree or forest."""

    def __init__(
        self,
        hierarchy_map: dict[str, dict[Any, Any]],
        task_keys: list[str],
        num_classes: dict[str, int],
    ):
        self.task_keys = list(task_keys)
        self.num_classes = dict(num_classes)
        self._hierarchy_map_raw = self._sanitize_raw_map(hierarchy_map)

        self._parent_to_children: dict[Node, list[Node]] = {}
        self._child_to_parent: dict[Node, Node | None] = {}
        self._nodes_by_level: dict[str, list[Node]] = {}
        self._all_nodes: set[Node] = set()

        self._build_internal_graph()
        self.roots: list[Node] = self._find_roots()
        self.leaves: list[Node] = self._find_leaves()
        for task in self.task_keys:
            if task in self.num_classes:
                self._nodes_by_level[task] = [
                    (task, idx) for idx in range(self.num_classes[task])
                ]
        self._validate()

    # ------------------------------------------------------------------ build
    @staticmethod
    def _sanitize_raw_map(raw_map: dict) -> dict[str, dict[int, int]]:
        sanitized: dict[str, dict[int, int]] = {}
        for child_task_key, level_map in (raw_map or {}).items():
            if not isinstance(level_map, dict):
                logger.warning(
                    f"Expected dict for level '{child_task_key}', got "
                    f"{type(level_map).__name__}; skipping."
                )
                continue
            out: dict[int, int] = {}
            for c_raw, p_raw in level_map.items():
                try:
                    out[int(c_raw)] = int(p_raw)
                except (TypeError, ValueError):
                    logger.warning(
                        f"Skipping non-integer pair ({c_raw}, {p_raw}) at level "
                        f"{child_task_key}"
                    )
            sanitized[child_task_key] = out
        return sanitized

    def _build_internal_graph(self) -> None:
        for task in self.task_keys:
            n_cls = self.num_classes.get(task)
            if n_cls is None:
                raise KeyError(f"Task key '{task}' not found in num_classes.")
            for idx in range(n_cls):
                node: Node = (task, idx)
                self._all_nodes.add(node)
                self._parent_to_children[node] = []
                self._child_to_parent[node] = None

        for i in range(len(self.task_keys) - 1):
            child_task = self.task_keys[i]
            parent_task = self.task_keys[i + 1]
            level_map = self._hierarchy_map_raw.get(child_task, {})
            for child_idx, parent_idx in level_map.items():
                if not (0 <= child_idx < self.num_classes[child_task]):
                    logger.warning(
                        f"Child index {child_idx} out of bounds for {child_task}; "
                        "skipping link."
                    )
                    continue
                if not (0 <= parent_idx < self.num_classes[parent_task]):
                    logger.warning(
                        f"Parent index {parent_idx} out of bounds for {parent_task}; "
                        "skipping link."
                    )
                    continue
                child_node: Node = (child_task, child_idx)
                parent_node: Node = (parent_task, parent_idx)
                existing = self._child_to_parent.get(child_node)
                if existing is not None and existing != parent_node:
                    raise ValueError(
                        f"Node {child_node} has multiple parents: {existing} and "
                        f"{parent_node}"
                    )
                self._child_to_parent[child_node] = parent_node
                self._parent_to_children[parent_node].append(child_node)

    def _find_roots(self) -> list[Node]:
        return sorted(
            n for n in self._all_nodes if self._child_to_parent.get(n) is None
        )

    def _find_leaves(self) -> list[Node]:
        return sorted(n for n in self._all_nodes if not self._parent_to_children[n])

    def _validate(self) -> None:
        # Acyclicity: walking parents from any node must terminate within
        # len(task_keys) hops (links only go fine->coarse by construction, but
        # defend against malformed maps anyway).
        max_hops = len(self.task_keys) + 1
        for node in self._all_nodes:
            cur, hops = node, 0
            while cur is not None:
                cur = self._child_to_parent.get(cur)
                hops += 1
                if hops > max_hops:
                    raise ValueError(f"Cycle detected in hierarchy near {node}")

    # ------------------------------------------------------------------ queries
    def get_parent(self, node: Node) -> Node | None:
        return self._child_to_parent.get(node)

    def get_children(self, node: Node) -> list[Node]:
        return list(self._parent_to_children.get(node, []))

    def get_ancestors(self, node: Node) -> list[Node]:
        """Ancestors ordered nearest-first (parent, grandparent, ...)."""
        out = []
        cur = self.get_parent(node)
        while cur is not None:
            out.append(cur)
            cur = self.get_parent(cur)
        return out

    def get_descendants(self, node: Node) -> list[Node]:
        out, queue = [], deque(self.get_children(node))
        while queue:
            cur = queue.popleft()
            out.append(cur)
            queue.extend(self.get_children(cur))
        return out

    def get_siblings(self, node: Node) -> list[Node]:
        parent = self.get_parent(node)
        if parent is None:
            return []
        return [c for c in self.get_children(parent) if c != node]

    def get_root(self, node: Node) -> Node:
        cur = node
        while (p := self.get_parent(cur)) is not None:
            cur = p
        return cur

    def get_distance(self, node_a: Node, node_b: Node) -> int | None:
        """Graph distance via lowest common ancestor; None if disconnected."""
        if node_a == node_b:
            return 0
        path_a = [node_a] + self.get_ancestors(node_a)
        path_b = [node_b] + self.get_ancestors(node_b)
        index_a = {n: i for i, n in enumerate(path_a)}
        for j, n in enumerate(path_b):
            if n in index_a:
                return index_a[n] + j
        return None

    def get_nodes_at_level(self, task_key: str) -> list[Node]:
        return list(self._nodes_by_level.get(task_key, []))

    @property
    def num_levels(self) -> int:
        return len(self.task_keys)

    # ------------------------------------------------------------------ matrices
    def build_hierarchy_matrices(self) -> dict[str, np.ndarray]:
        """Dense 0/1 matrices M[parent_idx, child_idx] per adjacent level pair.

        Keyed ``f"{parent_task}_{child_task}"`` with parent = the coarser level
        (task_keys[i+1]).
        """
        matrices: dict[str, np.ndarray] = {}
        for i in range(len(self.task_keys) - 1):
            child_task = self.task_keys[i]
            parent_task = self.task_keys[i + 1]
            pair_key = f"{parent_task}_{child_task}"
            n_parent = self.num_classes[parent_task]
            n_child = self.num_classes[child_task]
            matrix = np.zeros((n_parent, n_child), dtype=np.float32)
            for child_idx in range(n_child):
                parent = self.get_parent((child_task, child_idx))
                if parent is not None and parent[0] == parent_task:
                    matrix[parent[1], child_idx] = 1.0
            matrices[pair_key] = matrix
        return matrices

    def build_distance_matrix(self, task_key: str) -> np.ndarray:
        """Pairwise taxonomic distances between classes at one level.

        Disconnected pairs get distance ``2 * num_levels`` (a large finite
        value so smoothing decays to ~0).
        """
        n = self.num_classes[task_key]
        far = 2 * self.num_levels
        dist = np.full((n, n), far, dtype=np.float32)
        # Distance is symmetric and determined by steps-to-LCA on each side.
        ancestor_paths = []
        for idx in range(n):
            node = (task_key, idx)
            ancestor_paths.append([node] + self.get_ancestors(node))
        index_maps = [{n_: i for i, n_ in enumerate(path)} for path in ancestor_paths]
        for a in range(n):
            dist[a, a] = 0.0
            for b in range(a + 1, n):
                imap = index_maps[a]
                for j, node in enumerate(ancestor_paths[b]):
                    if node in imap:
                        dist[a, b] = dist[b, a] = imap[node] + j
                        break
        return dist

    # ------------------------------------------------------------------ serialization
    def save(self, filepath: str) -> None:
        data = {
            "__taxonomy_tree_version__": "1.0",
            "task_keys": self.task_keys,
            "num_classes": self.num_classes,
            "hierarchy_map_raw": {
                k: {str(c): int(p) for c, p in v.items()}
                for k, v in self._hierarchy_map_raw.items()
            },
        }
        dirpath = os.path.dirname(os.path.abspath(filepath))
        os.makedirs(dirpath, exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(data, f, indent=2)

    @classmethod
    def load(cls, filepath: str) -> "TaxonomyTree":
        with open(filepath) as f:
            data = json.load(f)
        return cls(
            hierarchy_map=data["hierarchy_map_raw"],
            task_keys=data["task_keys"],
            num_classes={k: int(v) for k, v in data["num_classes"].items()},
        )

    def __repr__(self) -> str:
        return (
            f"TaxonomyTree(levels={self.task_keys}, "
            f"nodes={len(self._all_nodes)}, roots={len(self.roots)})"
        )
