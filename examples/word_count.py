"""WordCount notebook equivalent (reference python/notebooks/WordCount)."""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from collections import Counter

from custrings import nvstrings, nvtext

text = [
    "the quick brown fox", "jumped over the lazy dog",
    "the dog slept and the fox ran",
]
s = nvstrings.to_device(text).lower()
tokens = nvtext.tokenize(s)
uniq = nvtext.unique_tokens(s)
counts = nvtext.tokens_counts(s, uniq)
import numpy as np

totals = np.asarray(counts).sum(axis=0)
top = sorted(zip(uniq.to_host(), totals.tolist()), key=lambda kv: -kv[1])[:10]
print("top tokens:", top)
