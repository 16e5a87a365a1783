"""Device-path replace_with_backrefs vs the Python re oracle
(reference: replace_backref.cu:122-207, python tests/test_regex.py).

The device assembly (regex/ops.py _replace_backrefs_device) routes all
byte movement through the streaming writers; these tests run it on the
CPU mesh in interpret/XLA fallback form.
"""

import re

import numpy as np
import pytest

from custrings import column
from custrings.regex import ops as rx


def _oracle(pat, tpl, strs):
    pytpl = re.sub(r"\\(\d+)", lambda m: "\\g<%s>" % m.group(1), tpl)
    return [None if s is None else re.sub(pat, pytpl, s) for s in strs]


CASES = [
    (r"(\w+)@(\w+)", r"\2 at \1",
     ["john@example com", "a@b c@d x", "no match here", "", None, "x@y"]),
    (r"(\d+)", r"[\1]", ["abc 123 def 45", "999", "", "nope", None]),
    (r"th(e|at)", r"<\1>", ["the cat and that dog", "thee that", "none"]),
    (r"(a+)(b*)", r"\2-\1", ["aaabb xab", "b", "aa"]),
    (r"(\w)(\w)", r"\2\1", ["abcd", "xyz", ""]),
    # literal-only template (no group refs)
    (r"\d+", "N", ["a1b22c333", "4", ""]),
    # repeated group reference
    (r"(\w+)-", r"\1\1 ", ["ab-cd-", "x-"]),
]


@pytest.mark.parametrize("pat,tpl,strs", CASES)
def test_backref_parity(pat, tpl, strs):
    col = column.from_host_strings(strs)
    got = column.to_host_strings(rx.replace_with_backrefs(col, pat, tpl))
    assert got == _oracle(pat, tpl, strs)


def test_backref_device_matches_host_path(monkeypatch):
    pat, tpl = r"(\w+)@(\w+)", r"\2:\1"
    strs = ["a@b", "c@d e@f g", None, "", "plain"]
    col = column.from_host_strings(strs)
    dev = column.to_host_strings(rx.replace_with_backrefs(col, pat, tpl))
    monkeypatch.setenv("CUSTRINGS_BREF_HOST", "1")
    host = column.to_host_strings(rx.replace_with_backrefs(col, pat, tpl))
    assert dev == host


def test_backref_fuzz():
    rng = np.random.default_rng(42)
    pats = [r"(\w+)@(\w+)", r"(\d+)", r"(a+)(b*)"]
    tpls = [r"\2_\1", r"<\1>", r"\1"]
    alphabet = "ab1@ xy"
    for trial in range(6):
        strs = [
            "".join(rng.choice(list(alphabet), rng.integers(0, 20)))
            for _ in range(30)
        ]
        for pat, tpl in zip(pats, tpls):
            col = column.from_host_strings(strs)
            got = column.to_host_strings(
                rx.replace_with_backrefs(col, pat, tpl)
            )
            assert got == _oracle(pat, tpl, strs), (trial, pat)
