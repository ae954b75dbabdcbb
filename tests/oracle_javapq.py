"""Independent java.util.PriorityQueue simulation — differential test oracle.

This is a SECOND, deliberately separate implementation of the reference's
Huffman tree build (``core/CanonicalHuffman.java:55-92``), transcribed from
the OpenJDK PriorityQueue specification (siftUpComparable /
siftDownComparable, JDK 21) rather than from the framework's ``_JavaHeap``
(``datacomp/core/huffman.py``).  The two implementations share no code;
``tests/test_huffman.py`` differential-fuzzes them for identical code
*lengths* across random histograms, so a wrong sift detail in either one
fails loudly.  Code lengths are exactly what plain optimality checks cannot
pin down — equal-cost trees differ in shape on frequency ties, and the
reference's emitted bitstream depends on the PriorityQueue's tie behavior.

Kept under tests/ on purpose: it is an oracle, not product code.
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 256


class _Node:
    """Mirror of the reference HuffmanNode: leaf(symbol, freq) or
    internal(left, right) with symbol == -1 and summed frequency."""

    __slots__ = ("symbol", "frequency", "left", "right")

    def __init__(self, symbol, frequency, left=None, right=None):
        self.symbol = symbol
        self.frequency = frequency
        self.left = left
        self.right = right

    def compare_to(self, other: "_Node") -> int:
        # HuffmanNode.compareTo: Long.compare(freq), then Integer.compare(symbol)
        if self.frequency != other.frequency:
            return -1 if self.frequency < other.frequency else 1
        if self.symbol != other.symbol:
            return -1 if self.symbol < other.symbol else 1
        return 0


class JavaPriorityQueueOracle:
    """Array-based binary min-heap following the OpenJDK PriorityQueue
    algorithm text: offer → siftUp from the tail; poll → move the tail
    element to the root and siftDown.  Comparisons use ``compare_to`` with
    the exact >= / <= break conditions of the JDK source."""

    def __init__(self):
        self._queue: list = []
        self._size = 0

    def offer(self, e: _Node) -> None:
        i = self._size
        if i >= len(self._queue):
            self._queue.append(None)
        self._size = i + 1
        if i == 0:
            self._queue[0] = e
        else:
            self._sift_up(i, e)

    def _sift_up(self, k: int, key: _Node) -> None:
        q = self._queue
        while k > 0:
            parent = (k - 1) >> 1
            e = q[parent]
            if key.compare_to(e) >= 0:
                break
            q[k] = e
            k = parent
        q[k] = key

    def poll(self) -> _Node | None:
        if self._size == 0:
            return None
        s = self._size - 1
        self._size = s
        q = self._queue
        result = q[0]
        x = q[s]
        q[s] = None
        if s != 0:
            self._sift_down(0, x)
        return result

    def _sift_down(self, k: int, key: _Node) -> None:
        q = self._queue
        half = self._size >> 1
        while k < half:
            child = 2 * k + 1
            c = q[child]
            right = child + 1
            if right < self._size and c.compare_to(q[right]) > 0:
                child = right
                c = q[child]
            if key.compare_to(c) <= 0:
                break
            q[k] = c
            k = child
        q[k] = key

    def size(self) -> int:
        return self._size


def oracle_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Reference-exact code lengths via the independent PQ simulation,
    including the 0-symbol and 1-symbol edge cases
    (``CanonicalHuffman.java:31-45``)."""
    freqs = np.asarray(freqs)
    lengths = np.zeros(ALPHABET_SIZE, dtype=np.int32)
    nz = np.nonzero(freqs > 0)[0]
    if nz.size == 0:
        return lengths
    if nz.size == 1:
        lengths[int(nz[0])] = 1
        return lengths

    pq = JavaPriorityQueueOracle()
    for sym in nz:
        pq.offer(_Node(int(sym), int(freqs[sym])))
    while pq.size() > 1:
        left = pq.poll()
        right = pq.poll()
        pq.offer(_Node(-1, left.frequency + right.frequency, left, right))

    root = pq.poll()
    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        if node.left is None and node.right is None:
            lengths[node.symbol] = depth
        else:
            stack.append((node.left, depth + 1))
            stack.append((node.right, depth + 1))
    return lengths
