"""Reference-exact mapQual sort order.

DetInDel::getReads sorts reads by decreasing mapQual with std::sort
(reference DInDel.cpp:889-894,1218) — libstdc++'s UNSTABLE
introsort.  Because most reads share the same mapQual, the introsort's
permutation of ties (not any stable order) determines the read order all
downstream sequential float folds consume; reproducing the reference's
GLF bytes requires reproducing that exact permutation
(tests/test_reads_ref.py pins it against the compiled reference).

Primary implementation: native/stdsort.cpp runs the actual libstdc++
std::sort over (key, index) pairs.  Fallback: a faithful Python replica
of the libstdc++ 12 algorithm (__introsort_loop / heap fallback /
__final_insertion_sort), differential-tested against the native one in
tests/test_std_sort.py."""

from __future__ import annotations


import numpy as np


_S_THRESHOLD = 16


def mapqual_sort_order(keys) -> np.ndarray:
    """Permutation p with keys[p] in the exact order the reference's
    std::sort(reads, mapQual-descending) produces."""
    keys = np.ascontiguousarray(keys, np.float64)
    return np.asarray(introsort_order_py(keys), np.int64)


# ---------------------------------------------------------------------------
# Python replica of libstdc++ 12 std::sort (bits/stl_algo.h, stl_heap.h)
# on (key, index) pairs with a key-only `>` comparator.  Structure and
# index arithmetic mirror the headers line-for-line so the permutation
# matches the native path bit-for-bit.


def introsort_order_py(keys) -> list:
    arr = list(range(len(keys)))
    k = list(map(float, keys))

    def comp(x, y):  # "less" in sort order == greater mapQual
        return k[x] > k[y]

    n = len(arr)
    if n:
        _introsort_loop(arr, 0, n, 2 * (n.bit_length() - 1), comp)
        _final_insertion_sort(arr, 0, n, comp)
    return arr


def _introsort_loop(a, first, last, depth, comp):
    while last - first > _S_THRESHOLD:
        if depth == 0:
            _heap_select(a, first, last, last, comp)
            _sort_heap(a, first, last, comp)
            return
        depth -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth, comp)
        last = cut


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _move_median_to_first(a, result, x, y, z, comp):
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, comp):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _final_insertion_sort(a, first, last, comp):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, comp)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, first, last, comp)


def _insertion_sort(a, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _unguarded_linear_insert(a, last, comp):
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


def _heap_select(a, first, middle, last, comp):
    _make_heap(a, first, middle, comp)
    for i in range(middle, last):
        if comp(a[i], a[first]):
            _pop_heap(a, first, middle, i, comp)


def _make_heap(a, first, last, comp):
    if last - first < 2:
        return
    ln = last - first
    parent = (ln - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, ln, value, comp)
        if parent == 0:
            return
        parent -= 1


def _adjust_heap(a, first, hole, ln, value, comp):
    top = hole
    second = hole
    while second < (ln - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (ln & 1) == 0 and second == (ln - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, comp)


def _push_heap(a, first, hole, top, value, comp):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _pop_heap(a, first, last, result, comp):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value, comp)


def _sort_heap(a, first, last, comp):
    while last - first > 1:
        last -= 1
        _pop_heap(a, first, last, last, comp)
