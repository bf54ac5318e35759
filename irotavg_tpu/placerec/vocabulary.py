"""Hierarchical binary-descriptor vocabulary (DBoW2-compatible).

Array layout replaces the reference's pointer tree
(TemplatedVocabulary.h:297-428): ``children (n_nodes, k)`` int32 (-1 pad),
``node_desc (n_nodes, 8)`` uint32, ``weight``, ``word_id``, ``is_leaf``.
The runtime transform is a batched level-synchronous descent: at each of
the L levels every descriptor gathers its current node's k child
descriptors and takes the Hamming argmin (ties -> first child, matching
the reference's scan order, TemplatedVocabulary.h:1236-1247).

Text (de)serialisation is byte-compatible with ORB-SLAM vocabularies
(`loadFromTextFile`/`saveToTextFile`, TemplatedVocabulary.h:1337-1461):
header ``k L scoring weighting``; one node per line ``parent is_leaf
d0..d31 weight``; word ids assigned in file order of leaves.

Training (`train_vocabulary`) reimplements the capability of
`create`/`HKmeansStep` (TemplatedVocabulary.h:557-915): kmeans++ seeding,
Hamming assignment, bit-majority means, recursive splitting, TF-IDF
weights from the training images.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SCORING_NAMES = ["L1", "L2", "CHI_SQUARE", "KL", "BHATTACHARYYA", "DOT_PRODUCT"]
WEIGHTING_NAMES = ["TF_IDF", "TF", "IDF", "BINARY"]


def _desc_to_words(desc_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32 little-endian words."""
    return desc_bytes.reshape(-1, 8, 4).astype(np.uint32) @ (
        256 ** np.arange(4, dtype=np.uint32)
    )


def _words_to_bytes(words: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 32) uint8."""
    out = np.zeros((len(words), 32), np.uint8)
    for w in range(8):
        for b in range(4):
            out[:, 4 * w + b] = (words[:, w] >> (8 * b)) & 0xFF
    return out


@functools.partial(jax.jit, static_argnames=("n_levels", "nid_level"))
def _descend(desc, valid, children, node_desc, is_leaf, n_levels, nid_level):
    """Batched greedy descent.  Returns (leaf_node (N,), nid_node (N,))."""
    n = desc.shape[0]
    cur = jnp.zeros((n,), jnp.int32)
    nid = jnp.zeros((n,), jnp.int32)
    for level in range(1, n_levels + 1):
        ch = children[cur]                      # (N, k)
        has_child = ch >= 0
        ch_safe = jnp.maximum(ch, 0)
        cd = node_desc[ch_safe]                 # (N, k, 8)
        x = jnp.bitwise_xor(cd, desc[:, None, :])
        xx = x
        # popcount (SWAR)
        xx = xx - ((xx >> 1) & 0x55555555)
        xx = (xx & 0x33333333) + ((xx >> 2) & 0x33333333)
        xx = (xx + (xx >> 4)) & 0x0F0F0F0F
        d = jnp.sum((xx * 0x01010101) >> 24, axis=-1).astype(jnp.int32)
        d = jnp.where(has_child, d, 1 << 20)
        best = jnp.argmin(d, axis=1)            # first min: reference order
        nxt = jnp.take_along_axis(ch_safe, best[:, None], axis=1)[:, 0]
        stop = ~has_child[:, 0]                 # current node is a leaf
        cur = jnp.where(stop, cur, nxt)
        if level == nid_level:
            nid = cur
    cur = jnp.where(valid, cur, -1)
    nid = jnp.where(valid, nid, -1)
    return cur, nid


class Vocabulary:
    """Flat-array vocabulary with batched transform and DBoW2 text IO."""

    def __init__(self, k, L, children, node_desc, weight, word_id, is_leaf,
                 scoring="L1", weighting="TF_IDF"):
        self.k = int(k)
        self.L = int(L)
        self.children = np.asarray(children, np.int32)
        self.node_desc = np.asarray(node_desc, np.uint32)
        self.weight = np.asarray(weight, np.float64)
        self.word_id = np.asarray(word_id, np.int32)
        self.is_leaf = np.asarray(is_leaf, bool)
        self.scoring = scoring
        self.weighting = weighting
        self.n_words = int(self.is_leaf.sum())
        self._children_j = jnp.asarray(self.children)
        self._node_desc_j = jnp.asarray(self.node_desc)
        self._is_leaf_j = jnp.asarray(self.is_leaf)

    # -- runtime ------------------------------------------------------------

    def descend(self, desc, valid=None, levelsup: int = 4):
        """Dispatch the tree descent for one frame; returns the DEVICE
        ``(leaf, nid)`` pair without fetching.

        The building block for pipelined callers (frontend/prefetch.py):
        queue descents for a whole look-ahead batch, fetch once, and
        assemble host-side with :meth:`assemble` — per-frame
        ``transform`` would block on one device fetch each.
        """
        if valid is None:
            valid = jnp.ones((desc.shape[0],), bool)
        nid_level = max(self.L - levelsup, 0)
        return _descend(
            desc, valid, self._children_j, self._node_desc_j,
            self._is_leaf_j, self.L, nid_level,
        )

    def assemble(self, leaf, nid):
        """Host assembly of fetched descent results -> (bow, feat_nodes)."""
        return self._assemble(np.asarray(leaf), np.asarray(nid))

    def transform(self, desc, valid=None, levelsup: int = 4):
        """(N, 8) uint32 descriptors -> (bow, feat_nodes).

        bow: dict word_id -> weight, L1-normalised (TF-IDF x L1 scorer,
        the ORB-SLAM configuration).  feat_nodes: (N,) int32 node id at
        level L-levelsup (the FeatureVector grouping), -1 for invalid.
        """
        desc = jnp.asarray(desc)
        n = desc.shape[0]
        if valid is None:
            valid = jnp.ones((n,), bool)
        else:
            valid = jnp.asarray(valid)
        leaf, nid = self.descend(desc, valid, levelsup)
        import jax

        leaf, nid = jax.device_get((leaf, nid))  # one bundled fetch
        return self._assemble(leaf, nid)

    def _assemble(self, leaf, nid):
        """Host assembly of (bow dict, feat_nodes) from descent results —
        vectorised (np.unique/bincount), no per-descriptor Python loop."""
        ok = leaf >= 0
        wids = self.word_id[leaf[ok]]
        ws = self.weight[leaf[ok]]
        pos = ws > 0
        bow: dict[int, float] = {}
        if pos.any():
            uids, inv = np.unique(wids[pos], return_inverse=True)
            sums = np.bincount(inv, weights=ws[pos])
            total = sums.sum()
            if total > 0:
                sums = sums / total
            bow = dict(zip(uids.tolist(), sums.tolist()))
        # stopped words (weight 0) get no feature-vector entry either
        stopped = np.zeros(len(leaf), bool)
        stopped[ok] = ws <= 0
        nid = np.where(stopped, -1, nid)
        return bow, nid.astype(np.int32)

    def transform_batch(self, descs, valids=None, levelsup: int = 4):
        """Batched transform over ``(B, N, 8)`` stacked descriptors.

        One device program + one fetch for the whole batch (the descent is
        per-descriptor, so frames flatten into one call); returns a list of
        ``(bow, feat_nodes)`` pairs.  This is the throughput path the
        reference's per-descriptor recursion cannot express
        (TemplatedVocabulary.h:1126-1194).
        """
        descs = jnp.asarray(descs)
        B, N = descs.shape[:2]
        if valids is None:
            valids = jnp.ones((B, N), bool)
        else:
            valids = jnp.asarray(valids)
        nid_level = max(self.L - levelsup, 0)
        leaf, nid = _descend(
            descs.reshape(B * N, -1), valids.reshape(B * N),
            self._children_j, self._node_desc_j, self._is_leaf_j,
            self.L, nid_level,
        )
        import jax

        leaf, nid = jax.device_get((leaf, nid))
        leaf = leaf.reshape(B, N)
        nid = nid.reshape(B, N)
        return [self._assemble(leaf[b], nid[b]) for b in range(B)]

    # -- text IO (ORB-SLAM format) -----------------------------------------

    @classmethod
    def load_text(cls, path: str) -> "Vocabulary":
        """Load a DBoW2 text vocabulary (the ORB-SLAM format;
        TemplatedVocabulary::loadFromTextFile,
        third_party/DBoW2/DBoW2/TemplatedVocabulary.h:1337-1424).

        Parses through the native C++ reader when available (~1 s for the
        145 MB ORB vocabulary vs minutes in Python), falling back to a
        pure-Python line parser."""
        from irotavg_tpu import native

        parsed = native.parse_vocab_text(path)
        if parsed is not None:
            k, L, n1, n2, parents_a, leaf_a, byte_rows, weights_a = parsed
        else:
            with open(path) as fh:
                header = fh.readline().split()
                k, L, n1, n2 = (int(v) for v in header[:4])
                parents, leaf_flags, descs, weights = [], [], [], []
                for line in fh:
                    parts = line.split()
                    if len(parts) < 35:
                        continue
                    parents.append(int(parts[0]))
                    leaf_flags.append(int(parts[1]) > 0)
                    descs.append([int(v) for v in parts[2:34]])
                    weights.append(float(parts[34]))
            parents_a = np.asarray(parents, np.int64)
            leaf_a = np.asarray(leaf_flags, bool)
            byte_rows = np.asarray(descs, np.uint8)
            weights_a = np.asarray(weights, np.float64)

        n_body = len(parents_a)
        n_nodes = n_body + 1  # + implicit root (node 0)
        children = np.full((n_nodes, k), -1, np.int32)
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        weight = np.zeros(n_nodes, np.float64)
        is_leaf = np.zeros(n_nodes, bool)
        word_id = np.full(n_nodes, -1, np.int32)

        node_desc[1:] = _desc_to_words(byte_rows)
        weight[1:] = weights_a
        is_leaf[1:] = leaf_a
        # word ids in ascending node order (the file's leaf order)
        leaf_ids = np.flatnonzero(is_leaf)
        word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        # children slots: file order within each parent group
        order = np.argsort(parents_a, kind="stable")
        sp = parents_a[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sp)) + 1]
        sizes = np.diff(np.r_[starts, len(order)])
        rank = np.arange(len(order)) - np.repeat(starts, sizes)
        children[sp, rank] = order + 1  # body node i is line i-1
        return cls(k, L, children, node_desc, weight, word_id, is_leaf,
                   scoring=SCORING_NAMES[n1], weighting=WEIGHTING_NAMES[n2])

    def save_text(self, path: str) -> None:
        n1 = SCORING_NAMES.index(self.scoring)
        n2 = WEIGHTING_NAMES.index(self.weighting)
        n_nodes = len(self.children)
        # vectorised parent table (a python double loop is minutes at the
        # real ORB vocabulary's ~1M nodes)
        parent = np.zeros(n_nodes, np.int32)
        mask = self.children >= 0
        parent[self.children[mask]] = np.repeat(
            np.arange(n_nodes, dtype=np.int32), mask.sum(axis=1)
        )
        all_bytes = _words_to_bytes(self.node_desc)
        with open(path, "w") as fh:
            fh.write(f"{self.k} {self.L} {n1} {n2}\n")
            for i in range(1, n_nodes):
                db = " ".join(str(int(v)) for v in all_bytes[i])
                fh.write(
                    f"{parent[i]} {1 if self.is_leaf[i] else 0} {db} "
                    f"{self.weight[i]:.6g}\n"
                )


_POP = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.uint8)  # byte popcount LUT


def _complete_tree_arrays(k: int, L: int):
    """Index plumbing for a complete k-ary tree of depth L (the layout
    `make_random_vocabulary` uses): (n_nodes, children, first_per_level)."""
    level_sizes = [k ** d for d in range(L + 1)]
    n_nodes = sum(level_sizes)
    children = np.full((n_nodes, k), -1, np.int32)
    first = np.cumsum([0] + level_sizes)
    for d in range(L):
        p0, p1 = first[d], first[d + 1]
        n_p = p1 - p0
        children[p0:p1] = (
            first[d + 1] + np.arange(n_p * k, dtype=np.int32).reshape(n_p, k)
        )
    return n_nodes, children, first


def train_vocabulary_flat(images_desc, k: int = 10, L: int = 5,
                          seed: int = 0, iters: int = 6,
                          weighting: str = "TF_IDF",
                          scoring: str = "L1") -> Vocabulary:
    """Production-scale trainer: level-synchronous hierarchical k-means.

    Capability parity with `TemplatedVocabulary::create`/`HKmeansStep`
    (TemplatedVocabulary.h:557-915) at the tree sizes the reference
    actually ships (the ORB-SLAM vocabulary is k=10/L=6, ~1M nodes):
    where `train_vocabulary` recurses per node (fine for k=8/L=3, hours
    at 100k+ words), this trains ALL nodes of a level in one vectorised
    pass — gather each descriptor's k candidate children, byte-LUT
    popcount, argmin, then one sort + `np.add.reduceat` segment sum for
    the bit-majority center update (FORB::meanValue semantics: strict
    majority, ties -> 0, FORB.cpp:63-69).

    Divergences from the reference trainer, both documented:
    * seeding is per-cluster random members, not kmeans++ (at these
      scales Lloyd washes out the seeding; the recursive trainer keeps
      kmeans++ parity for small vocabularies);
    * the tree is complete (every interior node has exactly k children);
      clusters that lose all members keep their center and become
      weight-0 leaves — exactly how stop words behave at runtime.

    Returns a :class:`Vocabulary` with IDF weights from a final greedy
    descent of the training images (setNodeWeights, :962-1000).
    """
    rng = np.random.default_rng(seed)
    per_image = [np.asarray(d, np.uint32) for d in images_desc]
    all_words = np.concatenate(per_image)
    B = _words_to_bytes(all_words)                      # (N, 32) uint8
    N = len(B)
    bits = np.unpackbits(B, axis=1, bitorder="little")  # (N, 256)

    assign = np.zeros(N, np.int64)   # cluster id within the current level
    centers_levels: list[np.ndarray] = []
    for level in range(L):
        n_clusters = k ** level
        n_child = n_clusters * k
        # seed: k distinct random members per cluster (clusters with
        # fewer members replicate their first member; the duplicate
        # centers attract no points and fall out as weight-0 leaves)
        order = rng.permutation(N)
        a_sh = assign[order]
        s_idx = np.argsort(a_sh, kind="stable")
        members = order[s_idx]
        sorted_a = a_sh[s_idx]
        starts = np.searchsorted(sorted_a, np.arange(n_clusters))
        ends = np.searchsorted(sorted_a, np.arange(n_clusters), side="right")
        centers = np.zeros((n_child, 32), np.uint8)
        base = np.arange(n_clusters, dtype=np.int64) * k
        for j in range(k):
            pos = starts + j
            ok = pos < ends
            centers[base[ok] + j] = B[members[pos[ok]]]
            if j > 0:
                centers[base[~ok] + j] = centers[base[~ok]]

        child = assign * k
        grid = centers.reshape(n_clusters, k, 32)
        for _ in range(iters):
            cand = grid[assign]                          # (N, k, 32)
            d = _POP[cand ^ B[:, None, :]].sum(axis=-1, dtype=np.int32)
            new_child = assign * k + d.argmin(axis=1)    # first-min ties
            if (new_child == child).all():
                break
            child = new_child
            # bit-majority center update as one segment-sum
            cs = np.argsort(child, kind="stable")
            sorted_c = child[cs]
            uniq, first_pos, counts = np.unique(
                sorted_c, return_index=True, return_counts=True
            )
            sums = np.add.reduceat(bits[cs].astype(np.int32), first_pos,
                                   axis=0)
            maj = sums * 2 > counts[:, None]             # strict majority
            packed = np.packbits(maj, axis=1, bitorder="little")
            centers[uniq] = packed
            grid = centers.reshape(n_clusters, k, 32)
        centers_levels.append(centers)
        assign = child

    n_nodes, children, first = _complete_tree_arrays(k, L)
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    for d in range(L):
        node_desc[first[d + 1]:first[d + 2]] = _desc_to_words(
            centers_levels[d]
        )
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[first[L]:] = True
    n_words = k ** L
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(n_words, dtype=np.int32)
    vocab = Vocabulary(k, L, children, node_desc, np.zeros(n_nodes),
                       word_id, is_leaf, scoring=scoring,
                       weighting=weighting)

    # IDF weights from a final numpy greedy descent of the training
    # images (what the runtime transform will do, not the last Lloyd
    # assignment — they can differ where Lloyd stopped early)
    leaf = _descend_np(centers_levels, B, k)
    counts = np.zeros(n_words, np.int64)
    off = 0
    for d_img in per_image:
        wid = np.unique(leaf[off:off + len(d_img)])
        counts[wid] += 1
        off += len(d_img)
    if weighting in ("TF_IDF", "IDF"):
        w = np.zeros(n_words)
        nz = counts > 0
        w[nz] = np.log(len(per_image) / counts[nz])
    else:
        w = (counts > 0).astype(np.float64)
    vocab.weight[first[L]:] = w
    return vocab


def _descend_np(centers_levels, B, k):
    """Greedy first-min descent over complete-tree level centers (numpy
    mirror of `_descend`); returns the leaf path id per descriptor."""
    cur = np.zeros(len(B), np.int64)
    for centers in centers_levels:
        cand = centers.reshape(-1, k, 32)[cur]
        d = _POP[cand ^ B[:, None, :]].sum(axis=-1, dtype=np.int32)
        cur = cur * k + d.argmin(axis=1)
    return cur


def make_random_vocabulary(k: int = 10, L: int = 5, seed: int = 0,
                           scoring: str = "L1",
                           weighting: str = "TF_IDF") -> Vocabulary:
    """Complete k-ary tree of depth L with random descriptors — the
    real-scale stand-in for the 1M-node ORB-SLAM vocabulary
    (TemplatedVocabulary.h:1337-1424; k=10, L=6 there).  k=10/L=5 gives
    100k words / 111k nodes, enough to exercise the parser, the level-
    synchronous descent, and the scoring cascade at production shape
    without shipping a 145 MB file.
    """
    rng = np.random.default_rng(seed)
    level_sizes = [k ** d for d in range(L + 1)]       # nodes per level
    n_nodes = sum(level_sizes)
    children = np.full((n_nodes, k), -1, np.int32)
    first = np.cumsum([0] + level_sizes)               # first node per level
    for d in range(L):                                  # internal levels
        p0, p1 = first[d], first[d + 1]
        c0 = first[d + 1]
        n_p = p1 - p0
        children[p0:p1] = (
            c0 + np.arange(n_p * k, dtype=np.int32).reshape(n_p, k)
        )
    node_desc = rng.integers(0, 2 ** 32, (n_nodes, 8), dtype=np.uint64
                             ).astype(np.uint32)
    node_desc[0] = 0
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[first[L]:] = True
    weight = np.zeros(n_nodes, np.float64)
    weight[is_leaf] = rng.uniform(0.1, 3.0, level_sizes[L])
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(level_sizes[L], dtype=np.int32)
    return Vocabulary(k, L, children, node_desc, weight, word_id, is_leaf,
                      scoring=scoring, weighting=weighting)


# -- training ---------------------------------------------------------------


def _bit_majority(words: np.ndarray) -> np.ndarray:
    """FORB::meanValue: per-bit majority vote (ties -> 0, like the
    reference's strict > half comparison, FORB.cpp:63-69)."""
    bits = np.unpackbits(
        _words_to_bytes(words), axis=1, bitorder="little"
    )
    maj = bits.sum(axis=0) * 2 > len(words)
    by = np.packbits(maj, bitorder="little").reshape(1, 32)
    return _desc_to_words(by)[0]


def _hamming_np(a, b):
    x = _words_to_bytes(np.atleast_2d(a))[:, None, :] ^ _words_to_bytes(
        np.atleast_2d(b)
    )[None, :, :]
    return np.unpackbits(x, axis=-1).sum(axis=-1)


def _kmeans_binary(words, k, rng, iters=10):
    """kmeans++ seeding + Lloyd iterations with bit-majority means."""
    n = len(words)
    if n <= k:
        return words.copy(), np.arange(n) % max(len(words), 1)
    centers = [words[rng.integers(n)]]
    d = _hamming_np(words, centers[-1][None])[:, 0].astype(np.float64)
    for _ in range(1, k):
        p = d * d
        if p.sum() <= 0:
            centers.append(words[rng.integers(n)])
            continue
        centers.append(words[rng.choice(n, p=p / p.sum())])
        d = np.minimum(d, _hamming_np(words, centers[-1][None])[:, 0])
    C = np.stack(centers)
    assign = None
    for _ in range(iters):
        D = _hamming_np(words, C)
        new_assign = D.argmin(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            sel = words[assign == j]
            if len(sel):
                C[j] = _bit_majority(sel)
    return C, assign


def train_vocabulary(images_desc, k: int = 10, L: int = 3, seed: int = 0,
                     weighting: str = "TF_IDF",
                     scoring: str = "L1") -> Vocabulary:
    """Train from a list of per-image (Ni, 8) uint32 descriptor arrays."""
    rng = np.random.default_rng(seed)
    all_words = np.concatenate([np.asarray(d, np.uint32) for d in images_desc])

    children_rows = [[]]  # per node
    node_desc = [np.zeros(8, np.uint32)]
    is_leaf = [False]
    levels = [0]

    def split(node, words, level):
        if level == L or len(words) == 0:
            is_leaf[node] = True
            return
        C, assign = _kmeans_binary(words, k, rng)
        for j in range(len(C)):
            cid = len(node_desc)
            children_rows[node].append(cid)
            children_rows.append([])
            node_desc.append(C[j])
            is_leaf.append(False)
            levels.append(level + 1)
            split(cid, words[assign == j], level + 1)

    split(0, all_words, 0)

    n_nodes = len(node_desc)
    children = np.full((n_nodes, k), -1, np.int32)
    for i, row in enumerate(children_rows):
        children[i, : len(row)] = row
    is_leaf = np.asarray(is_leaf)
    # any node without children is a leaf (incomplete branches)
    is_leaf |= (children < 0).all(axis=1)
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(is_leaf.sum())

    vocab = Vocabulary(
        k, L, children, np.stack(node_desc), np.zeros(n_nodes), word_id,
        is_leaf, scoring=scoring, weighting=weighting,
    )

    # IDF weights: log(N_images / N_images_containing_word)
    # (TemplatedVocabulary::setNodeWeights, :962-1000)
    n_im = len(images_desc)
    counts = np.zeros(vocab.n_words, np.int64)
    for d in images_desc:
        leaf, _ = _descend(
            jnp.asarray(np.asarray(d, np.uint32)),
            jnp.ones((len(d),), bool),
            vocab._children_j, vocab._node_desc_j, vocab._is_leaf_j,
            vocab.L, 0,
        )
        wids = vocab.word_id[np.asarray(leaf)]
        counts[np.unique(wids[wids >= 0])] += 1
    if weighting in ("TF_IDF", "IDF"):
        w = np.zeros(vocab.n_words)
        nz = counts > 0
        w[nz] = np.log(n_im / counts[nz])
    else:
        w = np.ones(vocab.n_words)
    leaf_nodes = np.where(vocab.is_leaf)[0]
    vocab.weight[leaf_nodes] = w[vocab.word_id[leaf_nodes]]
    return vocab
