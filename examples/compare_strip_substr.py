"""Compare / strip / substr / case walkthroughs — ports of the reference
notebooks python/notebooks/test_compare.ipynb, test_strip.ipynb,
test_substr.ipynb and test_case.ipynb (the early "cudastrings" API demos).

Run:  python examples/compare_strip_substr.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from custrings import nvstrings


def compare_demo():
    print("== compare (test_compare.ipynb) ==")
    strs = nvstrings.to_device(["hello", "there", "world"])
    print("compare('there'):", strs.compare("there"))
    print("find('o')    :", strs.find("o"))
    print("rfind('e')   :", strs.rfind("e"))
    # index/rindex throw when the substring is missing from ANY string
    # (reference python/nvstrings.py:1740 "throws an error if arg is not
    # found in all strings"; the notebook's [-1,-1,-1] output predates it)
    try:
        strs.index("h")
    except ValueError as e:
        print("index('h')   : ValueError:", e)
    sub = nvstrings.to_device(["hello", "world"])
    print("index('l')   :", sub.index("l"))
    print("rindex('l')  :", sub.rindex("l"))


def strip_demo():
    print("== strip (test_strip.ipynb) ==")
    strs = nvstrings.to_device(["  hello  ", "  there  ", "  world  ", None])
    print("strip() :", strs.strip().to_host())
    print("lstrip():", strs.lstrip().to_host())
    print("rstrip():", strs.rstrip().to_host())
    print("strip().strip('e'):", strs.strip().strip("e").to_host())


def substr_demo():
    print("== substr (test_substr.ipynb) ==")
    strs = nvstrings.to_device(["abcdefghij", "0123456789", "9876543210", None])
    print("slice(2,8)   :", strs.slice(2, 8).to_host())
    print("slice(2,15)  :", strs.slice(2, 15).to_host())
    print("slice(2,8,2) :", strs.slice(2, 8, 2).to_host())
    print("slice(2,8,5) :", strs.slice(2, 8, 5).to_host())
    print("slice_replace(2,5,'z'):", strs.slice_replace(2, 5, "z").to_host())
    print("slice_replace(8,8,'z'):", strs.slice_replace(8, 8, "z").to_host())
    print("get(3)       :", strs.get(3).to_host())


def case_demo():
    print("== case (test_case.ipynb) ==")
    strs = nvstrings.to_device(
        ["abc", "Def", None, "jLl", "mnO", "PqR", "sTT", "dog and cat"]
    )
    print("lower()     :", strs.lower().to_host())
    print("upper()     :", strs.upper().to_host())
    print("swapcase()  :", strs.swapcase().to_host())
    print("capitalize():", strs.capitalize().to_host())
    print("rjust(4).capitalize():", strs.rjust(4).capitalize().to_host())


if __name__ == "__main__":
    compare_demo()
    strip_demo()
    substr_demo()
    case_demo()
