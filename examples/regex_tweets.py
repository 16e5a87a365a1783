"""Tweet regex workload (BASELINE config 3): hashtags/mentions/urls."""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.corpus import tweets as make_tweets
from custrings import nvstrings

tweets = nvstrings.to_device(make_tweets(200, seed=0))

hashtags = tweets.findall_record(r"#\w+")
mentions = tweets.count(r"@\w+")
cleaned = tweets.replace(r"https?://\S+", "<url>")
print("rows:", tweets.size())
print("first hashtags:", [h.to_host() for h in hashtags[:3] if h])
print("mention counts:", mentions[:10])
print("cleaned sample:", cleaned[:1].to_host())
