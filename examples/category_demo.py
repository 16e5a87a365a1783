"""nvcategory walkthrough — port of the reference notebook
python/notebooks/category_demo.ipynb (keyset build, add_strings,
indexes_for_key, gather) and category_merge1.ipynb (merge_category
append-preserving semantics),.

Run:  python examples/category_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from custrings import nvcategory, nvstrings


def demo_basic():
    print("== keyset build ==")
    lhs = nvstrings.to_device(["apple", "orange", "apple", "banana", "grape"])
    rhs = nvstrings.to_device(["apple", "grape", "pear"])
    c1 = nvcategory.from_strings(lhs)
    print("keys:  ", c1.keys())
    print("values:", c1.values())

    print("== add_strings ==")
    c2 = c1.add_strings(rhs)
    print("keys:  ", c2.keys())
    print("values:", c2.values())
    print("indexes_for_key('apple'):", c2.indexes_for_key("apple"))
    print("to_strings:", c2.to_strings())

    print("== from_strings(lhs, rhs) + gather ==")
    c12 = nvcategory.from_strings(lhs, rhs)
    print("keys:  ", c12.keys())
    print("gather_strings([0,0,1,3]):", c12.gather_strings([0, 0, 1, 3]))


def demo_merge():
    print("\n== merge_category (append-preserving) ==")
    s1 = nvstrings.to_device(["a", "a", "d", "c", "c", "e"])
    s2 = nvstrings.to_device(["a", "b", "b", "f", "c", "f"])
    c1 = nvcategory.from_strings(s1)
    c2 = nvcategory.from_strings(s2)
    print("c1:", c1.keys(), c1.values())
    print("c2:", c2.keys(), c2.values())

    nc = c1.merge_category(c2)
    print("c1.merge(c2):", nc.keys(), nc.values())

    s22 = nvstrings.to_device(["b", "a", "a", "e", "g", "b"])
    c22 = nvcategory.from_strings(s22)
    nc2 = nc.merge_category(c22)
    print("…merge(c22): ", nc2.keys(), nc2.values())

    # merge is order-sensitive: the left keyset keeps its ordering and
    # new keys append (NVCategory.cu merge_category contract)
    print("c2.merge(c1):", c2.merge_category(c1).keys())


if __name__ == "__main__":
    demo_basic()
    demo_merge()
