"""CSV sentiment scoring — port of the reference notebook
python/notebooks/CSV_testing.ipynb: load a CSV column of sentences,
tokenize, hash tokens, score rows against positive/negative word lists
via hash joins — all column ops on device.

Run:  python examples/sentiment_csv.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from custrings import nvstrings, nvtext


SENTENCES = [
    "great and good",
    "weakest bad",
    "successfully winning team effort",
    "loss and failure hurt",
    "good win good",
    "neutral words only here",
]
POSITIVE = ["great", "good", "winning", "win", "successfully", "effort"]
NEGATIVE = ["bad", "weakest", "loss", "failure", "hurt"]


def main():
    # csv ingest (utils/csv.py mirrors the reference's flags/quoting)
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "string-test.csv")
    with open(path, "w") as f:
        f.write("number,text\n")
        for i, s in enumerate(SENTENCES):
            f.write(f"{i},{s}\n")
    strs = nvstrings.from_csv(path, 1)
    print("rows:", strs.to_host())

    # lower + tokenize + hash each token (the notebook's word_hash column)
    toks = nvtext.tokenize(strs.lower())
    tok_hash = np.asarray(toks.hash())
    pos_hash = set(np.asarray(nvstrings.to_device(POSITIVE).hash()).tolist())
    neg_hash = set(np.asarray(nvstrings.to_device(NEGATIVE).hash()).tolist())

    # per-row score: +1 per positive token, -1 per negative token
    counts = np.asarray(nvtext.token_count(strs))
    row_of_token = np.repeat(np.arange(len(SENTENCES)), counts)
    score = np.zeros(len(SENTENCES), np.int64)
    for h, r in zip(tok_hash.tolist(), row_of_token.tolist()):
        score[r] += (h in pos_hash) - (h in neg_hash)

    print("\nsentiment scores:")
    for s, sc in zip(SENTENCES, score):
        print(f"  {sc:+d}  {s}")
    assert score[0] > 0 and score[1] < 0 and score[3] < 0


if __name__ == "__main__":
    main()
