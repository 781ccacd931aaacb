"""Length-limited Huffman code construction.

Same two-queue algorithm + count-limit doubling retry as the reference
(encoder/enc_huffman_tree.cc:65-142), including its tie-breaking (leaves
inserted in descending symbol order, stable ascending sort by count, leaf
preferred over internal node on equal count). Matching tie-breaking keeps our
code lengths identical to the reference's for identical histograms, which keeps
compressed sizes directly comparable.
"""
import numpy as np


def create_huffman_depths(counts, tree_limit: int) -> np.ndarray:
    counts = np.asarray(counts, np.uint32)
    length = len(counts)
    depths = np.zeros(length, np.uint8)
    count_limit = 1
    while True:
        depths[:] = 0
        # Leaves in descending symbol order.
        leaves = [
            (max(int(counts[i]), count_limit - 1), i)
            for i in range(length - 1, -1, -1)
            if counts[i]
        ]
        n = len(leaves)
        if n == 0:
            return depths
        if n == 1:
            depths[leaves[0][1]] = 1
            return depths
        leaves.sort(key=lambda t: t[0])  # stable
        # Two-queue merge: leaf queue and internal-node queue (FIFO, counts
        # naturally ascending). On ties pick the leaf.
        INF = float("inf")
        leaf_counts = [c for c, _ in leaves] + [INF, INF]
        internal = []  # (count, left_child_ref, right_child_ref)
        # child refs: ('L', idx) or ('I', idx)
        li = 0
        ii = 0
        for _ in range(n - 1):
            children = []
            for _pick in range(2):
                lc = leaf_counts[li]
                ic = internal[ii][0] if ii < len(internal) else INF
                if lc <= ic:
                    children.append(("L", li, lc))
                    li += 1
                else:
                    children.append(("I", ii, ic))
                    ii += 1
            internal.append(
                (children[0][2] + children[1][2], children[0][:2], children[1][:2])
            )
        # Depth assignment by traversal from the last internal node (root).
        stack = [(("I", len(internal) - 1), 0)]
        max_depth = 0
        while stack:
            (kind, idx), level = stack.pop()
            if kind == "L":
                depths[leaves[idx][1]] = level
                max_depth = max(max_depth, level)
            else:
                _, left, right = internal[idx]
                stack.append((left, level + 1))
                stack.append((right, level + 1))
        if max_depth <= tree_limit:
            return depths
        count_limit *= 2


def depths_to_bits(depths) -> np.ndarray:
    """Canonical code assignment with bit reversal (enc_entropy_code.cc:296-322)."""
    depths = np.asarray(depths, np.uint8)
    bits = np.zeros(len(depths), np.uint16)
    bl_count = np.bincount(depths, minlength=16)[:16]
    bl_count[0] = 0
    next_code = np.zeros(16, np.uint32)
    code = 0
    for i in range(1, 16):
        code = (code + int(bl_count[i - 1])) << 1
        next_code[i] = code
    for i in range(len(depths)):
        d = int(depths[i])
        if d:
            bits[i] = _reverse_bits(d, int(next_code[d]))
            next_code[d] += 1
    return bits


def _reverse_bits(num_bits: int, value: int) -> int:
    r = 0
    for _ in range(num_bits):
        r = (r << 1) | (value & 1)
        value >>= 1
    return r
