"""Category merge walkthrough — port of the reference notebook
python/notebooks/category_merge1.ipynb: build categories from two string
columns, merge them both ways (merge_category keeps the callee's keyset
order semantics, merge_and_remap re-sorts), and chain merges.

Run:  python examples/category_merge.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from custrings import nvcategory, nvstrings


def show(tag, cat):
    print(f"{tag}: keys={cat.keys().to_host()} values={list(cat.values())}")


def main():
    s1 = nvstrings.to_device(["a", "a", "d", "c", "c", "e"])
    s2 = nvstrings.to_device(["a", "b", "b", "f", "c", "f"])

    c1 = nvcategory.from_strings(s1)
    c2 = nvcategory.from_strings(s2)
    show("c1", c1)
    show("c2", c2)

    # merge: c1's keys keep their codes, c2's new keys append
    nc = c1.merge_category(c2)
    show("c1.merge(c2)", nc)

    s22 = nvstrings.to_device(["b", "a", "a", "e", "g", "b"])
    c22 = nvcategory.from_strings(s22)
    show("c22", c22)

    # chaining merges accumulates the combined keyset
    nc = nc.merge_category(c22)
    show("chained", nc)

    # order matters: the callee's keyset wins the low codes
    nc = c1.merge_category(c2)
    nc = c22.merge_category(nc)
    show("c22.merge(c1.merge(c2))", nc)

    nc = c2.merge_category(c1)
    show("c2.merge(c1)", nc)

    # merge_and_remap gives a fully sorted combined keyset instead
    nc = c1.merge_and_remap(c2)
    show("c1.merge_and_remap(c2)", nc)


if __name__ == "__main__":
    main()
