"""Carried from olavm_tpu/tree/smt.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Depth-256 sparse Merkle account tree with Poseidon hashing and per-update
HashTrace witness capture.

Functionally equivalent to the reference's batched zkSync-style tree
(core/src/merkle_tree/tree.rs, patch.rs, tree_config.rs) for sequential
updates, with identical hashing semantics:
- leaf "hash" = the raw 4-limb value (empty leaf = zeros);
- level-1 nodes: compress(left_value, right_value, Leaf) with input[8] = 1;
- higher nodes: compress(left, right, Branch) (core/src/crypto/poseidon.rs);
- per update, a HashTrace entry per level (depth 0..255) carrying the post
  and pre Poseidon rows, child path values and the sibling.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..hash import poseidon as pos
from ..runtime.trace import PoseidonRow

ROOT_TREE_DEPTH = 256


def tree_key_to_int(key) -> int:
    """key[0] is the most significant 64-bit limb (merkle_tree/mod.rs:106)."""
    out = 0
    for limb in key:
        out = (out << 64) | int(limb)
    return out


@dataclass
class HashTrace:
    row: PoseidonRow  # post compress row
    path: tuple  # current child hash
    sibling: tuple
    pre_hash: tuple  # pre parent hash
    pre_path: tuple  # previous child hash
    pre_row: PoseidonRow


def _compress(left, right, is_leaf: bool):
    """-> (hash4, PoseidonRow with storage filter set)."""
    state = list(left) + list(right) + [0, 0, 0, 0]
    if is_leaf:
        state[8] = 1
    from ..runtime.process import poseidon_with_row

    if is_leaf:
        out, row = poseidon_with_row(state, filter_looked_storage=True)
    else:
        out, row = poseidon_with_row(state, filter_looked_storage_branch=True)
    return tuple(out[:4]), row


def _compress_pair(left, right, pre_left, pre_right, is_leaf: bool):
    """Batched (post, pre) compress: ONE native Poseidon-trace call for both
    chains of a level (the TPU analogue of the reference's rayon-batched
    node hashing, core/src/merkle_tree/patch.rs:159,187)."""
    from ..runtime.process import poseidon_rows_batch

    states = np.zeros((2, 12), dtype=np.uint64)
    states[0, 0:4] = left
    states[0, 4:8] = right
    states[1, 0:4] = pre_left
    states[1, 4:8] = pre_right
    if is_leaf:
        states[:, 8] = 1
        outs, rows = poseidon_rows_batch(states, filter_looked_storage=True)
    else:
        outs, rows = poseidon_rows_batch(
            states, filter_looked_storage_branch=True)
    return (tuple(outs[0, :4].tolist()), rows[0],
            tuple(outs[1, :4].tolist()), rows[1])


_DEFAULT_HASHES = None


def default_hashes() -> list[tuple]:
    """default_hashes[k] = hash of an empty subtree with k levels below
    (tree_config.rs:83-100); cached to disk (256 Poseidon hashes)."""
    global _DEFAULT_HASHES
    if _DEFAULT_HASHES is None:
        cache = os.path.join(os.path.dirname(__file__), "default_hashes.json")
        if os.path.exists(cache):
            with open(cache) as f:
                _DEFAULT_HASHES = [tuple(x) for x in json.load(f)]
        else:
            out = [(0, 0, 0, 0)]
            for k in range(ROOT_TREE_DEPTH):
                h, _ = _compress(out[-1], out[-1], is_leaf=(k == 0))
                out.append(h)
            _DEFAULT_HASHES = out
            with open(cache, "w") as f:
                json.dump([list(x) for x in out], f)
    return _DEFAULT_HASHES


class AccountTree:
    """In-memory SMT with optional JSON persistence."""

    def __init__(self, db_path: str | None = None):
        self.db_path = db_path
        self.nodes: dict[tuple[int, int], tuple] = {}
        self.defaults = default_hashes()
        self._root = None
        if db_path and os.path.exists(db_path):
            self._load(db_path)

    # ------------------------------------------------------------------

    def root_hash(self) -> tuple:
        if self._root is not None:
            return self._root
        return self.defaults[ROOT_TREE_DEPTH]

    def get_leaf(self, tree_key) -> tuple | None:
        idx = tree_key_to_int(tree_key)
        return self.nodes.get((0, idx))

    def _node(self, level: int, index: int) -> tuple:
        return self.nodes.get((level, index), self.defaults[level])

    def process_block(self, storage_logs) -> list[HashTrace]:
        """Apply a block of logs; returns ROOT_TREE_DEPTH HashTraces per log
        (per-log depth order 0..255, leaf compress first), bit-identical to
        sequential application.

        LEVEL-SYNCHRONOUS BATCHING (the analogue of the reference's
        rayon-parallel per-level node hashing, core/src/merkle_tree/
        patch.rs:159,187): all logs' (post, pre) compresses of one depth go
        through ONE native Poseidon-trace call. Sequential semantics are
        preserved exactly because at depth d the sibling a log sees is
        either an untouched stored node or the depth-d chain value of the
        LAST earlier log sharing that node — both known before hashing the
        level."""
        logs = list(storage_logs)
        if len(logs) > 1:
            return self._process_block_level_sync(logs)
        return self._process_block_sequential(logs)

    def _process_block_level_sync(self, logs) -> list[HashTrace]:
        from ..runtime.process import poseidon_rows_batch

        L = len(logs)
        idxs = []
        curs = []  # post chain values per log, current depth
        pres = []  # pre chain values per log
        last_leaf: dict[int, tuple] = {}
        for log in logs:
            idx = tree_key_to_int(log["key"])
            pre_value = last_leaf.get(idx)
            if pre_value is None:
                pre_value = self.nodes.get((0, idx), (0, 0, 0, 0))
            if log["kind"] == "read":
                new_value = pre_value
            else:
                new_value = tuple(int(v) for v in log["value"])
            last_leaf[idx] = new_value
            idxs.append(idx)
            curs.append(new_value)
            pres.append(pre_value)
        # ALL node writes are deferred to the end of the block: self.nodes
        # must keep the PRE-block state throughout, because a log's stored-
        # node fallback must not see updates from LATER logs in this block
        # (in-block earlier-log updates are resolved via level_last instead).
        writes: dict[tuple[int, int], tuple] = {
            (0, idx): v for idx, v in last_leaf.items()}

        traces_per_log: list[list[HashTrace]] = [[] for _ in range(L)]
        for depth in range(ROOT_TREE_DEPTH):
            # resolve siblings: last earlier log on the sibling node wins
            sibs = []
            level_last: dict[int, tuple] = {}
            for j in range(L):
                node_index = idxs[j] >> depth
                s = node_index ^ 1
                sib = level_last.get(s)
                if sib is None:
                    sib = self._node(depth, s)
                sibs.append(sib)
                level_last[node_index] = curs[j]
            # build the level's hash batch: (post, pre) per changed log,
            # one shared state per unchanged (read) log
            states = np.zeros((2 * L, 12), dtype=np.uint64)
            slots = []  # (post_row_idx, pre_row_idx or None)
            n = 0
            for j in range(L):
                odd = (idxs[j] >> depth) & 1
                if odd:
                    states[n, 0:4], states[n, 4:8] = sibs[j], curs[j]
                else:
                    states[n, 0:4], states[n, 4:8] = curs[j], sibs[j]
                if curs[j] == pres[j]:
                    slots.append((n, None))
                    n += 1
                else:
                    if odd:
                        states[n + 1, 0:4] = sibs[j]
                        states[n + 1, 4:8] = pres[j]
                    else:
                        states[n + 1, 0:4] = pres[j]
                        states[n + 1, 4:8] = sibs[j]
                    slots.append((n, n + 1))
                    n += 2
            if depth == 0:
                states[:n, 8] = 1
                outs, rows = poseidon_rows_batch(
                    states[:n], filter_looked_storage=True)
            else:
                outs, rows = poseidon_rows_batch(
                    states[:n], filter_looked_storage_branch=True)
            new_curs, new_pres = [], []
            for j, (pi, qi) in enumerate(slots):
                parent = tuple(outs[pi, :4].tolist())
                if qi is None:
                    pre_parent, pre_row = parent, rows[pi]
                else:
                    pre_parent = tuple(outs[qi, :4].tolist())
                    pre_row = rows[qi]
                traces_per_log[j].append(
                    HashTrace(rows[pi], tuple(curs[j]), tuple(sibs[j]),
                              pre_parent, tuple(pres[j]), pre_row)
                )
                new_curs.append(parent)
                new_pres.append(pre_parent)
            curs, pres = new_curs, new_pres
            for j in range(L):
                writes[(depth + 1, idxs[j] >> (depth + 1))] = curs[j]
        self.nodes.update(writes)
        self._root = curs[-1]
        traces: list[HashTrace] = []
        for tl in traces_per_log:
            traces.extend(tl)
        return traces

    def _process_block_sequential(self, storage_logs) -> list[HashTrace]:
        traces: list[HashTrace] = []
        for log in storage_logs:
            key = log["key"]
            kind = log["kind"]
            idx = tree_key_to_int(key)
            pre_value = self.nodes.get((0, idx), (0, 0, 0, 0))
            if kind == "read":
                new_value = pre_value
            else:
                new_value = tuple(int(v) for v in log["value"])
            cur = new_value
            pre = pre_value
            self.nodes[(0, idx)] = cur
            for depth in range(ROOT_TREE_DEPTH):
                node_index = idx >> depth
                sib = self._node(depth, node_index ^ 1)
                odd = node_index & 1
                if odd:
                    left, right = sib, cur
                    pre_left, pre_right = sib, pre
                else:
                    left, right = cur, sib
                    pre_left, pre_right = pre, sib
                if cur == pre:
                    # read (or same-value write): pre and post chains are
                    # identical — hash once, share the row
                    parent, row = _compress(left, right, depth == 0)
                    pre_parent, pre_row = parent, row
                else:
                    # one batched native call for the (post, pre) pair
                    parent, row, pre_parent, pre_row = _compress_pair(
                        left, right, pre_left, pre_right, depth == 0
                    )
                traces.append(
                    HashTrace(row, tuple(cur), tuple(sib), pre_parent,
                              tuple(pre), pre_row)
                )
                cur = parent
                pre = pre_parent
                self.nodes[(depth + 1, idx >> (depth + 1))] = cur
            self._root = cur
        return traces

    # ------------------------------------------------------------------

    def save(self):
        if self.db_path:
            data = {
                "root": list(self.root_hash()),
                "nodes": [
                    [lvl, str(idx), list(h)] for (lvl, idx), h in self.nodes.items()
                ],
            }
            with open(self.db_path, "w") as f:
                json.dump(data, f)

    def _load(self, path: str):
        with open(path) as f:
            data = json.load(f)
        self._root = tuple(data["root"])
        self.nodes = {
            (lvl, int(idx)): tuple(h) for lvl, idx, h in data["nodes"]
        }
